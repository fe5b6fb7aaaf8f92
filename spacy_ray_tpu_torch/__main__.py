"""Command line of the port::

    python -m spacy_ray_tpu_torch train <config.cfg> --output <dir> [--device cuda|cpu]
        [--resume] [--paths.train x.jsonl --training.max_steps 40 ...]
    python -m spacy_ray_tpu_torch evaluate <model-dir> <data.jsonl> [--device cuda|cpu]
    python -m spacy_ray_tpu_torch serve <model-dir> [options]

``train`` trains the config's pipeline on one device, evaluating every
``eval_frequency`` steps, and writes ``best-model/`` and ``last-model/``
(with its training generations, which ``--resume`` continues from).
Dotted ``--section.key value`` arguments override the config.
``evaluate`` prints the scores of a saved model on a gold corpus as the JAX
package's table (per-type scores as rows of p/r/f), then the prediction's
words/s, then the scores as one JSON line (the same keys as the JAX
package's).
``serve`` loads a model directory (written by this package or by the JAX
package), builds the precision overlay, starts the HTTP listener (the bound
port is printed), runs the bucket warmup sweep and serves ``/v1/parse``
until SIGTERM/SIGINT, which drains in-flight work and exits. Every command
runs on the card unless ``--device cpu`` is given, and fails without one.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

from .serving.engine import SERVING_DEFAULTS
from .serving.overlay import PRECISION_CHOICES

USAGE = (
    "usage: python -m spacy_ray_tpu_torch train <config.cfg> [--output DIR] [--device cuda|cpu]"
    " [--resume] [--section.key value ...]\n"
    "       python -m spacy_ray_tpu_torch evaluate <model-dir> <data.jsonl> [--device cuda|cpu]\n"
    "       python -m spacy_ray_tpu_torch serve <model-dir> [--port N] [--max-batch N] "
    "[--max-doc-len N] [--precision auto|f32|bf16|int8] [--device cuda|cpu]"
)


def _serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch serve",
        description="Serve a saved pipeline as a JSON HTTP API (/v1/parse, /healthz).",
    )
    p.add_argument("model_path", type=Path)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 = ephemeral; the bound port is printed")
    p.add_argument("--max-batch", type=int, default=SERVING_DEFAULTS["max_batch_docs"],
                   help="max docs coalesced into one device batch")
    p.add_argument("--max-doc-len", type=int, default=SERVING_DEFAULTS["max_doc_len"],
                   help="longest admissible doc in tokens (the warmed shape cap)")
    p.add_argument("--precision", choices=PRECISION_CHOICES,
                   default=SERVING_DEFAULTS["precision"],
                   help="serving precision overlay: auto = bf16 on cuda, f32 on cpu")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def build_server(argv: List[str]):
    """Parse ``serve`` arguments, load the model and build the (not yet
    started) :class:`~.serving.server.Server`."""
    from .pipeline.language import Pipeline
    from .serving.engine import InferenceEngine
    from .serving.server import Server

    args = _serve_parser().parse_args(argv)
    nlp = Pipeline.from_disk(args.model_path, device=args.device)
    engine = InferenceEngine(nlp, max_batch_docs=args.max_batch,
                             max_doc_len=args.max_doc_len, precision=args.precision)
    return Server(engine, args.host, args.port)


def serve_command(argv: List[str]) -> int:
    server = build_server(argv)
    print(f"serving device={server.engine.nlp.device} "
          f"precision={server.engine.overlay.label}", flush=True)
    return server.run()


def train_command(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch train",
        description="Train a pipeline from a config on one device.", allow_abbrev=False,
    )
    parser.add_argument("config_path", type=Path)
    parser.add_argument("--output", "-o", type=Path, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest intact generation in <output>/last-model")
    parser.add_argument("--verbose", "-V", action="store_true")
    args, extra = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")

    from .config import load_config, parse_cli_overrides
    from .training.loop import train

    config = load_config(args.config_path, parse_cli_overrides(extra))
    nlp, result = train(config, args.output, device=args.device, resume=args.resume)
    print(f"Done. steps={result.final_step} best_score={result.best_score:.4f} "
          f"(step {result.best_step}) words/sec={result.wps:,.0f}", flush=True)
    for comp_name in nlp.pipe_names:
        stats = getattr(nlp.components[comp_name], "oracle_stats", None)
        if stats and (stats["projectivized"] or stats["skipped"]):
            print(f"[{comp_name}] collation: {stats['docs']} doc-passes, "
                  f"{stats['projectivized']} pseudo-projectivized, "
                  f"{stats['skipped']} skipped (unusable trees)", flush=True)
    return 0


def evaluate_command(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(prog="python -m spacy_ray_tpu_torch evaluate")
    parser.add_argument("model_path", type=Path)
    parser.add_argument("data_path", type=Path)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)

    from .pipeline.language import Pipeline
    from .training.corpus import Corpus

    nlp = Pipeline.from_disk(args.model_path, device=args.device)
    scores, words_per_s = nlp.evaluate_timed(list(Corpus(args.data_path)()))
    for key, value in sorted(scores.items()):
        if isinstance(value, dict):  # per-type tables (ents_per_type, ...)
            for sub, prf in sorted(value.items()):
                line = "  ".join(f"{m}={prf[m]:.4f}" for m in ("p", "r", "f"))
                print(f"{key:24s} {sub:14s} {line}")
        elif value is None:
            print(f"{key:24s} -")  # no gold annotation for this metric
        else:
            print(f"{key:24s} {value:.4f}")
    print(f"{'words/s':24s} {words_per_s:.1f}")
    print(json.dumps(scores, sort_keys=True), flush=True)
    return 0


COMMANDS = {"train": train_command, "evaluate": evaluate_command, "serve": serve_command}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
