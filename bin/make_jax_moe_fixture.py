#!/usr/bin/env python
"""Write ``tests/data/jax_moe/``: a small switch-MoE transformer pipeline
(tagger, parser and NER over one trunk) trained and saved by the JAX
package, with ``answers.json``: the JAX package's own tags, heads, deps and
entities on a few dev texts, each predicted alone at its serving bucket
(B 1, T its length bucket: an expert's capacity depends on the padded
B x T), and the trunk's output of the first texts.

The layout is ``configs/trf.cfg``'s at width 64, depth 2, 4 heads, FFN 64,
embed_size 200, max_len 128, 4 experts (``compute_dtype`` float32),
parser and NER hidden 32, trained 40 steps (400 words a batch, lr 0.004) on
a seeded pseudo-UD corpus (160 train, 40 dev docs). ``chip_smoke.py``
(phase ``slice:moe_jax``) serves it with the port on the card, where JAX is
not installed; ``tests/test_torch_moe.py`` loads it in the port on the CPU.

    JAX_PLATFORMS=cpu python bin/make_jax_moe_fixture.py
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TRUNK = {"width": 64, "depth": 2, "n_heads": 4, "ffn_mult": 1, "embed_size": 200,
         "max_len": 128, "n_experts": 4, "compute_dtype": "float32", "remat": False}
N_ANSWERS = 12
N_TRUNK = 3  # texts whose trunk output answers.json keeps


def moe_config(J, paths):
    """configs/trf.cfg at the fixture's sizes, on ``paths`` (train, dev)."""
    cfg = J.Config.from_disk(ROOT / "configs" / "trf.cfg")
    cfg["components"]["transformer"]["model"].update(TRUNK)
    for head in ("tagger", "parser", "ner"):
        cfg["components"][head]["model"]["tok2vec"]["width"] = TRUNK["width"]
    for head in ("parser", "ner"):
        cfg["components"][head]["model"]["hidden_width"] = 32
    cfg["paths"] = {"train": str(paths[0]), "dev": str(paths[1])}
    cfg["training"].update(max_steps=40, eval_frequency=20, accumulate_gradient=1)
    cfg["training"]["batcher"]["size"] = 400
    cfg["training"]["optimizer"]["learn_rate"] = 0.004
    return cfg


def main() -> int:
    import numpy as np

    import spacy_ray_tpu as J
    from spacy_ray_tpu.pipeline.doc import Doc
    from spacy_ray_tpu.training.batcher import bucket_length
    from spacy_ray_tpu.training.corpus import Corpus
    from spacy_ray_tpu.training.loop import train
    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    out = ROOT / "tests" / "data" / "jax_moe"
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        paths = (work / "train.jsonl", work / "dev.jsonl")
        write_ud_jsonl(paths[0], 160, seed=0, max_sents=2)
        write_ud_jsonl(paths[1], 40, seed=1, max_sents=2)
        nlp, _ = train(moe_config(J, paths), work / "out", n_workers=1, stdout_log=False)
        shutil.rmtree(out, ignore_errors=True)
        nlp.config["paths"] = {"train": None, "dev": None}
        nlp.to_disk(out)
        texts = [" ".join(eg.reference.words) for eg in Corpus(paths[1])()
                 if eg.reference.ents and len(eg.reference.words) <= 64][:N_ANSWERS]
    nlp = J.Pipeline.from_disk(out)
    forward = nlp.make_forward_fn()
    answers = {"texts": texts, "buckets": [], "tags": [], "heads": [], "deps": [],
               "ents": [], "trunk": []}
    for i, text in enumerate(texts):
        doc = nlp.tokenizer(text)
        T = bucket_length(len(doc), nlp.length_buckets)
        nlp.predict_docs([doc], batch_size=1, pad_batch_to=1, pad_len_to=T)
        answers["buckets"].append([1, T])
        answers["tags"].append(list(doc.tags))
        answers["heads"].append([int(h) for h in doc.heads])
        answers["deps"].append(list(doc.deps))
        answers["ents"].append([[e.start, e.end, e.label] for e in doc.ents])
        if i < N_TRUNK:
            batch = nlp.collate([J.Example.from_gold(Doc(words=list(doc.words)))],
                                with_targets=False, pad_batch_to=1, pad_len_to=T)
            X = np.asarray(forward(nlp.params, batch["tokens"])["transformer"].X)
            answers["trunk"].append(X[0, :len(doc)].astype(float).tolist())
    (out / "answers.json").write_text(json.dumps(answers), encoding="utf8")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
