#!/usr/bin/env python
"""Write ``tests/data/jax_nel/``: a small entity-linking pipeline trained and
saved by the JAX package, with its ``entity_linker.kb.npz`` sidecar and
``answers.json``, the JAX package's own entities and kb_ids on a few dev
texts.

The layout is ``chip_smoke.nel_config`` with the NER and the entity ruler
sourced (frozen) from the JAX-written ``tests/data/jax_md/``, the NER
annotating, and an entity linker over a HashEmbedCNN of width 32, depth 1,
embed_size 200; the KB is ``chip_smoke.nel_assets``'s with 16-wide entity
vectors, over a seeded pseudo-UD corpus (160 train, 40 dev docs); 40 JAX
steps. ``chip_smoke.py`` (phase ``slice:nel_jax``) serves it with the port
on the card, where JAX is not installed; ``tests/test_torch_entity_linker.py``
loads it in the port on the CPU.

    JAX_PLATFORMS=cpu python bin/make_jax_nel_fixture.py
"""

import json
import shutil
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SIZES = {"width": 32, "depth": 1, "embed_size": 200, "sourced": ["ner", "entity_ruler"]}
KB_WIDTH = 16
N_ANSWERS = 12


def main() -> int:
    import spacy_ray_tpu as J
    from spacy_ray_tpu.training.loop import train

    import chip_smoke
    from spacy_ray_tpu_torch.training.corpus import read_jsonl_docs
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    out = ROOT / "tests" / "data" / "jax_nel"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for split, n, seed in (("train", 160, 0), ("dev", 40, 1)):
            write_ud_jsonl(work / f"{split}.jsonl", n, seed=seed, max_sents=2)
            write_docbin(work / f"{split}.spacy", read_jsonl_docs(work / f"{split}.jsonl"))
        kb, paths, _ = chip_smoke.nel_assets((work / "train.spacy", work / "dev.spacy"),
                                             work / "nel", dim=KB_WIDTH)
        cfg = chip_smoke.nel_config(paths, ROOT / "tests" / "data" / "jax_md", kb, **SIZES)
        cfg["training"].update(max_steps=40, eval_frequency=20)
        cfg["training"]["batcher"]["size"] = 400
        del cfg["training"]["before_update"]
        with redirect_stdout(sys.stderr):
            nlp, _ = train(J.Config.from_str(cfg.to_str()), work / "out", n_workers=1,
                           stdout_log=False)
        shutil.rmtree(out, ignore_errors=True)
        # the model directory without this run's temporary paths (the KB
        # travels as the sidecar)
        nlp.config["paths"] = {"train": None, "dev": None}
        for split in ("train", "dev"):
            nlp.config["corpora"][split]["path"] = "${paths.%s}" % split
        nlp.config["components"]["entity_linker"]["kb_path"] = None
        nlp.to_disk(out)
        texts = [" ".join(eg.reference.words) for eg in J.training.corpus.Corpus(paths[1])()
                 if eg.reference.ents][:N_ANSWERS]
        docs = list(nlp.pipe(texts))
    answers = {"texts": texts,
               "ents": [[[e.start, e.end, e.label, e.kb_id] for e in d.ents] for d in docs]}
    (out / "answers.json").write_text(json.dumps(answers, indent=1), encoding="utf8")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
