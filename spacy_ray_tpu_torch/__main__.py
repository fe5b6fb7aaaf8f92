"""Command line: ``python -m spacy_ray_tpu_torch serve <model-dir> [options]``.

``serve`` loads a model directory (written by this package or by the JAX
package), builds the precision overlay, starts the HTTP listener (the
bound port is printed), runs the bucket warmup sweep and serves
``/v1/parse`` until SIGTERM/SIGINT, which drains in-flight work and exits.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .serving.engine import SERVING_DEFAULTS
from .serving.overlay import PRECISION_CHOICES


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


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m spacy_ray_tpu_torch serve <model-dir> "
              "[--port N] [--max-batch N] [--max-doc-len N] "
              "[--precision auto|f32|bf16|int8] [--device cuda|cpu]", file=sys.stderr)
        return 2
    server = build_server(argv[1:])
    print(f"serving device={server.engine.nlp.device} "
          f"precision={server.engine.overlay.label}", flush=True)
    return server.run()


if __name__ == "__main__":
    sys.exit(main())
