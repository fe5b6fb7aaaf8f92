#!/usr/bin/env python3
"""Dev scores of configs/trf.cfg trained by the port, over more steps and
on other paths than ``chip_smoke.py``'s ``train:full`` takes.

    cd <checkout> && python3 bin/torch_train_full_curve.py [--arms full,plain,narrow]
        [--device cuda|cpu]

Each arm trains trf.cfg's tagger, parser and NER with
``spacy_ray_tpu_torch.training.loop.train`` on the seeded pseudo-UD corpus
``train:full`` uses (2000 train and 200 dev docs, seeds 0 and 1):

* ``full``: trf.cfg as written for 240 steps, evaluated every 40;
* ``plain``: the same for 40 steps (evaluated every 20, as ``train:full``),
  with every trunk kernel swapped for its plain PyTorch version
  (``chip_smoke.plain_kernels``; the fused optimizer update stays);
* ``narrow``: 40 steps of trf.cfg with every width 64, depth 2, 4 heads.

Prints one JSON line per arm: dev ``tag_acc``/``dep_uas``/``dep_las``/
``ents_f`` at each evaluation, each head's loss (means of the first and
last 5 steps, and each of the first 10 steps), the median step time (CUDA
events on the card) and the run's seconds. ``full`` and ``plain`` are full width: run them on the card.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SCORES = ("tag_acc", "dep_uas", "dep_las", "ents_f")
FULL_STEPS = 240  # 6 x train:full's 40: past the early loss spike and the climb


def narrow(cfg) -> None:
    """Every width of ``cfg`` 768 -> 64 (the trunk's and the listeners'),
    depth 2, 4 heads, in place."""
    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "width" and v == 768:
                d[k] = 64
    walk(cfg)
    model = cfg["components"]["transformer"]["model"]
    model["depth"], model["n_heads"] = 2, 4


def run_arm(arm: str, device: str, work: Path, smoke) -> dict:
    import torch

    from spacy_ray_tpu_torch.training.loop import train

    cfg = smoke.trf_full_config()
    cfg["paths"] = {"train": str(work / "train.jsonl"), "dev": str(work / "dev.jsonl")}
    max_steps, every = (FULL_STEPS, 40) if arm == "full" else (40, 20)
    cfg["training"]["max_steps"] = max_steps
    cfg["training"]["eval_frequency"] = every
    if arm == "narrow":
        narrow(cfg)
    t0 = time.perf_counter()
    with smoke.plain_kernels() if arm == "plain" else nullcontext():
        nlp, result = train(cfg, None, device=device, stdout_log=False)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = {}
    for head in ("tagger", "parser", "ner"):
        xs = [s[head] for s in result.step_head_losses]
        losses[head] = {"first5_last5": [statistics.mean(xs[:5]), statistics.mean(xs[-5:])],
                        "steps_1_to_10": xs[:10]}
    step_ms = (statistics.median(a.elapsed_time(b) for a, b in result.step_events)
               if result.step_events else None)
    return {"arm": arm, "device": device, "steps": result.final_step,
            "params": sum(p.numel() for p in nlp.model.parameters()),
            "dev_scores": [(h["step"], {k: h["other_scores"].get(k) for k in SCORES})
                           for h in result.history],
            "head_losses": losses, "step_ms_median_events": step_ms,
            "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", default="full,plain,narrow")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    import torch

    from spacy_ray_tpu_torch.udgen import write_ud_jsonl

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("torch_train_full_curve: no CUDA device is available", file=sys.stderr)
            return 2
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    work = ROOT / ".smoke" / f"curve-{os.getpid()}"
    work.mkdir(parents=True)
    try:
        write_ud_jsonl(work / "train.jsonl", 2000, seed=0)
        write_ud_jsonl(work / "dev.jsonl", 200, seed=1)
        for arm in args.arms.split(","):
            print(json.dumps(run_arm(arm, args.device, work, smoke)), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
