#!/usr/bin/env python
"""Write ``tests/data/jax_md/``: a small md-layout model directory trained
and saved by the JAX package, with ``vectors.npz`` and ``components.json``.

``chip_smoke.py`` (phase ``slice:md_jax``) serves it with the port on the
card, where JAX is not installed; ``tests/test_torch_vectors.py`` loads it
in both packages on the CPU. The layout is ``chip_smoke.md_config`` at
width 32, depth 2, tables of 500/100/250/250 rows, hidden 32, over 1000 x 24
vectors, trained 40 steps on a seeded pseudo-UD corpus (160 docs).

    JAX_PLATFORMS=cpu python bin/make_jax_md_fixture.py
"""

import shutil
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: the fixture's sizes (chip_smoke.md_config's keyword arguments)
SIZES = {"width": 32, "depth": 2, "rows": (500, 100, 250, 250), "hidden": 32}
VECTORS = (1000, 24)


def main() -> int:
    import spacy_ray_tpu as J
    from spacy_ray_tpu.training.loop import train

    import chip_smoke
    from spacy_ray_tpu_torch.training.corpus import read_jsonl_docs
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin
    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    out = ROOT / "tests" / "data" / "jax_md"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        for split, n, seed in (("train", 160, 0), ("dev", 40, 1)):
            write_ud_jsonl(work / f"{split}.jsonl", n, seed=seed, max_sents=2)
            write_docbin(work / f"{split}.spacy", read_jsonl_docs(work / f"{split}.jsonl"))
        with redirect_stdout(sys.stderr):
            vectors, attr, ents, _ = chip_smoke.md_assets(
                work / "train.spacy", work, rows=VECTORS[0], dim=VECTORS[1])
        cfg = chip_smoke.md_config((work / "train.spacy", work / "dev.spacy"), vectors,
                                   attr, ents, **SIZES)
        cfg["training"].update(max_steps=40, eval_frequency=20)
        cfg["training"]["batcher"]["size"] = 400
        nlp, _ = train(J.Config.from_str(cfg.to_str()), work / "out", n_workers=1,
                       stdout_log=False)
        shutil.rmtree(out, ignore_errors=True)
        # the model directory without this run's temporary paths
        nlp.config["paths"] = {"train": None, "dev": None}
        for split in ("train", "dev"):
            nlp.config["corpora"][split]["path"] = "${paths.%s}" % split
        nlp.config["initialize"]["vectors"] = "vectors.npz"
        nlp.to_disk(out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
