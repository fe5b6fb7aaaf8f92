#!/usr/bin/env python
"""Run ``chip_smoke.py``'s ``serve:fleet`` phase on its own, once for each
canary-guard sample count given, and keep what the guard compared.

Each run boots a fresh two-replica fleet of a cnn.cfg model trained here (60
steps; sm.cfg, 20 steps, gives the mismatched tree) and drives the whole
phase: the SIGKILL under load, the restart, the emptied latency windows, the
rollout, the refused tree, placement and ``collect-trace``. The guard's p99
bound stays at its default; ``--min-samples`` sets ``--guard-min-samples``.
For each run the output file holds the phase's result or its failure, the
fleet's output lines and, from both replicas' traces, the swap's spans and
the slowest requests beside them (their start in ms from the swap's
staging). Needs one CUDA card:

    python3 bin/fleet_rollout_check.py --min-samples 10,400 \\
        --out chiprun_out/fleet_rollout_check.json
"""

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def train(corpus, name: str, cfg: str, steps: int, every: int) -> Path:
    out = smoke.WORK / name
    r = subprocess.run([sys.executable, "-m", "spacy_ray_tpu_torch", "train", cfg, "--output",
                        str(out), "--paths.train", str(corpus[0]), "--paths.dev", str(corpus[1]),
                        "--training.max_steps", str(steps), "--training.eval_frequency",
                        str(every)], capture_output=True, text=True, cwd=str(ROOT))
    if r.returncode != 0:
        raise SystemExit(f"training {cfg} failed:\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
    return out


def swap_view(port: int) -> dict:
    """A replica's swap spans and, around its first, its slowest requests."""
    _, trace = smoke.get(port, "/trace")
    events = trace["traceEvents"]
    swaps = [e for e in events if e.get("name") in ("swap_stage", "swap_flip")]
    view = {"swaps": [{"name": e["name"], "ms": e["dur"] / 1e3,
                       "generation": e.get("args", {}).get("generation")} for e in swaps]}
    if swaps:
        t = swaps[0]["ts"]
        near = [((e["ts"] - t) / 1e3, e["dur"] / 1e3) for e in events
                if e.get("name") == "request" and -2e6 < e["ts"] - t < 3e6]
        view["requests_near_swap"] = len(near)
        view["slowest_near_swap"] = [{"start_ms": a, "ms": b}
                                     for a, b in sorted(near, key=lambda r: -r[1])[:6]]
    return view


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--min-samples", default="10,400",
                    help="comma-separated --guard-min-samples, one fleet each")
    ap.add_argument("--out", default="chiprun_out/fleet_rollout_check.json")
    args = ap.parse_args()
    import torch

    from spacy_ray_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    _cuda.build()
    corpus = smoke.write_spacy_corpus(smoke.write_udgen_corpus())
    cnn = train(corpus, "cnn", "configs/cnn.cfg", 60, 20)
    sm = train(corpus, "sm", "configs/sm.cfg", 20, 10)
    gens = smoke.WORK / "fleet_gens"
    gens.mkdir(parents=True, exist_ok=True)
    for name in ("params-60.npz", "train_meta-60.json"):
        shutil.copyfile(cnn / "last-model" / name, gens / name)

    rollout = smoke.fleet_rollout
    runs = []
    for n in (int(x) for x in args.min_samples.split(",")):
        smoke.FLEET_GUARD_MIN_SAMPLES = n
        row = {"card": smi, "guard_min_samples": n}

        def traced(phase, run, port, ports, *rest, row=row):
            try:
                return rollout(phase, run, port, ports, *rest)
            finally:
                row["replicas"] = {str(rid): swap_view(p) for rid, p in sorted(ports.items())}

        smoke.fleet_rollout = traced
        run = smoke.start_serve_fleet(cnn / "best-model")
        t = time.perf_counter()
        try:
            result = smoke.phase_serve_fleet(torch, run, corpus[1], smi,
                                             {"dir": gens, "stamp": 60,
                                              "mismatch": sm / "last-model"})
            row["rollout"] = result["rollout"]
        except RuntimeError as e:
            row["failed"] = str(e).split("\n", 1)[0]
        finally:
            smoke.fleet_rollout = rollout
        row["seconds"] = time.perf_counter() - t
        row["guard_lines"] = [l for l in run["lines"] if "[canary-" in l or "[live-" in l]
        print(json.dumps({k: v for k, v in row.items() if k != "replicas"}), flush=True)
        runs.append(row)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
