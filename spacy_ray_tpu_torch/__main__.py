"""Command line of the port::

    python -m spacy_ray_tpu_torch train <config.cfg> --output <dir> [--device cuda|cpu]
        [--code F] [--resume] [--max-restarts N]
        [--paths.train x.jsonl --training.max_steps 40 ...]
        [--fleet-workers N [--quorum Q] [--max-staleness S] [--fleet-base-port P]
        [--peer-lease-s S] [--grad-compression C] [--param-delta-window K]]
    python -m spacy_ray_tpu_torch pretrain <config.cfg> <output-dir> [--device cuda|cpu]
        [--code F] [--section.key value ...]
    python -m spacy_ray_tpu_torch evaluate <model-dir> <data.jsonl> [--device cuda|cpu]
        [--code F]
    python -m spacy_ray_tpu_torch serve <model-dir> [options]
    python -m spacy_ray_tpu_torch init-vectors <input> <output.npz> [--truncate N]

``train`` trains the config's pipeline on one device, evaluating every
``eval_frequency`` steps, and writes ``best-model/`` and ``last-model/``
(with its training generations, which ``--resume`` continues from, a
fleet's generations too). SIGTERM or SIGINT stops it at a step boundary
with a generation written, and it exits 75. ``--max-restarts N`` runs the
training as a child process and starts it again with ``--resume`` after a
nonzero exit, at most N times (a relayed signal is not restarted).
Dotted ``--section.key value`` arguments override the config.
``--fleet-workers N`` trains as N worker processes (the asynchronous
trainer fleet, ``training/fleet/``): each owns a slice of every parameter,
pushes gradients to their owners and applies at ``--quorum``; worker 0
evaluates and writes the models. With ``--peer-lease-s`` > 0 (60 by
default) a dead worker is evicted once its lease expired and its slices
re-shard over the survivors. With ``--max-restarts N`` each worker runs
under a supervisor that relaunches it with ``--resume`` (at most N times):
it reloads the last generation, whose optimizer parts each owner wrote, and
rejoins. The coordinator exits 0 when the survivors finish
(``fleet-degraded-success``), 75 when it was stopped by a signal, else the
first bad worker's code. ``--grad-compression`` (``auto``: bf16 on
the card, int8 on the CPU) and ``--param-delta-window`` (4) set the fleet's
wire: the codec of gradient pushes, with error feedback, and how many
versions of compressed parameter deltas an owner keeps for pulls.
``--code`` imports a Python file first, so that the functions it registers
(callbacks, architectures, readers, augmenters) resolve in the config.
``pretrain`` runs the config's ``[pretraining]`` block (the characters or
vectors objective over raw-text lines) and writes the trunk's weights as
``model-last.npz``, which ``[initialize] init_tok2vec`` loads; it ends with
"Pretraining done. ...".
``evaluate`` prints the scores of a saved model on a gold corpus as the JAX
package's table (per-type scores as rows of p/r/f), then the prediction's
words/s, then the scores as one JSON line (the same keys as the JAX
package's).
``serve`` loads a model directory (written by this package or by the JAX
package), builds the precision overlay, starts the HTTP listener (the bound
port is printed), runs the bucket warmup sweep and serves ``/v1/parse``
with ``/metrics``, ``/trace`` and ``/admin/exemplars`` (``--no-telemetry``
turns them off) and, for each ``--swap-dir``, ``/admin/swap`` and
``/admin/rollback`` between that directory's checkpoint generations,
until SIGTERM/SIGINT, which drains in-flight work and exits.
``--batching window --max-wait-ms N`` coalesces a batch for up to N ms
(continuous admission is the default); ``--watch DIR`` follows a training
run's ``last-model/`` and hot-swaps each new intact generation;
``--model-manifest M`` serves the manifest's models (``/v1/models/<name>/
parse``), its tenants' quotas and SLO classes, with ``--resident-models``
engines warm at once (the default model pinned); ``--metrics-dir`` writes
the trace and the last metrics snapshot at exit. Every command runs on the
card unless ``--device cpu`` is given, and fails without one.
``init-vectors`` converts word2vec or GloVe text (``.gz`` too) or an
``.npz`` of words and vectors into the ``vectors.npz`` that ``[initialize]
vectors`` reads (the JAX package's command: the same file, the same errors).
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
    " [--code F] [--resume] [--max-restarts N] [--fleet-workers N [--quorum Q]"
    " [--max-staleness S]"
    " [--fleet-base-port P] [--peer-lease-s S] [--grad-compression C]"
    " [--param-delta-window K]] [--section.key value ...]\n"
    "       python -m spacy_ray_tpu_torch pretrain <config.cfg> <output-dir> [--device cuda|cpu]"
    " [--code F] [--section.key value ...]\n"
    "       python -m spacy_ray_tpu_torch evaluate <model-dir> <data.jsonl> [--device cuda|cpu]"
    " [--code F]\n"
    "       python -m spacy_ray_tpu_torch serve <model-dir> [--port N] [--max-batch N] "
    "[--max-doc-len N] [--precision auto|f32|bf16|int8] [--device cuda|cpu]"
    " [--batching continuous|window] [--max-wait-ms MS] [--queue-size N] [--timeout-ms MS]"
    " [--drain-timeout-s S] [--no-telemetry] [--swap-dir CKPT_DIR ...] [--watch CKPT_DIR]"
    " [--watch-interval-s S] [--no-warmup] [--model-manifest M] [--resident-models N]"
    " [--metrics-dir DIR]\n"
    "       python -m spacy_ray_tpu_torch init-vectors <input> <output.npz> [--truncate N]"
)


def _serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch serve",
        description="Serve a saved pipeline as a JSON HTTP API (/v1/parse, /healthz, "
                    "/metrics, /trace, /admin/exemplars, /admin/swap, /admin/rollback; "
                    "with a manifest /v1/models/<name>/parse and /admin/models/load).",
    )
    p.add_argument("model_path", type=Path)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 = ephemeral; the bound port is printed")
    p.add_argument("--max-batch", type=int, default=SERVING_DEFAULTS["max_batch_docs"],
                   help="max docs coalesced into one device batch")
    p.add_argument("--batching", choices=["continuous", "window"],
                   default=SERVING_DEFAULTS["batching"],
                   help="admission: 'continuous' (default) fills the next dispatch with "
                        "whatever is queued; 'window' coalesces up to --max-wait-ms from "
                        "the first queued request")
    p.add_argument("--max-wait-ms", type=float, dest="max_wait_ms",
                   default=SERVING_DEFAULTS["max_wait_s"] * 1e3,
                   help="window batching only: the coalescing window")
    p.add_argument("--queue-size", type=int, default=SERVING_DEFAULTS["max_queue_docs"],
                   help="bounded admission queue (docs); beyond it requests get 429")
    p.add_argument("--timeout-ms", type=float, default=SERVING_DEFAULTS["timeout_s"] * 1e3,
                   help="default per-request deadline (a request may lower it)")
    p.add_argument("--max-doc-len", type=int, default=SERVING_DEFAULTS["max_doc_len"],
                   help="longest admissible doc in tokens (the warmed shape cap)")
    p.add_argument("--precision", choices=PRECISION_CHOICES,
                   default=SERVING_DEFAULTS["precision"],
                   help="serving precision overlay: auto = bf16 on cuda, f32 on cpu")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--no-telemetry", action="store_true",
                   help="no metrics registry, trace buffer or exemplars: /metrics, /trace "
                        "and /admin/exemplars answer 'disabled'")
    p.add_argument("--swap-dir", type=Path, action="append", default=[],
                   metavar="CKPT_DIR",
                   help="a training run's checkpoint directory (its last-model/) that "
                        "/admin/swap may load generations from; repeatable. Without one "
                        "/admin/swap and /admin/rollback answer 403")
    p.add_argument("--drain-timeout-s", type=float, default=30.0)
    p.add_argument("--watch", type=Path, default=None, metavar="CKPT_DIR",
                   help="follow this checkpoint directory (a training run's "
                        "<output>/last-model): hot-swap each new digest-verified "
                        "generation; torn ones are skipped (allowed for /admin/swap too)")
    p.add_argument("--watch-interval-s", type=float, default=2.0,
                   help="checkpoint-directory poll interval")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the bucket warmup sweep (first requests then build "
                        "and capture; testing only)")
    p.add_argument("--model-manifest", type=Path, default=None,
                   help="multi-model serving: a JSON manifest of model name -> pipeline "
                        "dir, SLO classes and tenant quotas; requests route by "
                        "/v1/models/<name>/parse or X-SRT-Model, /v1/parse serves the "
                        "manifest's default (model_path is then ignored)")
    p.add_argument("--resident-models", type=int, default=2,
                   help="multi-model only: warmed engines kept at once (LRU eviction "
                        "past it; the default model is pinned)")
    p.add_argument("--metrics-dir", type=Path, default=None,
                   help="write serving_trace.json and the final metrics snapshot "
                        "(serving_metrics.json, a row of metrics.jsonl) here at exit")
    return p


def build_server(argv: List[str]):
    """Parse ``serve`` arguments, load the model (with a manifest, its
    default model) and build the (not yet started)
    :class:`~.serving.server.Server`, with its registry, residency,
    admission and watcher as the flags ask. ``server.args`` keeps the
    parsed arguments."""
    from .pipeline.language import Pipeline
    from .serving.engine import InferenceEngine, ServingTelemetry
    from .serving.server import Server

    args = _serve_parser().parse_args(argv)
    registry = admission = residency = None
    if args.model_manifest is not None:
        from .serving.multimodel import AdmissionController, ModelRegistry

        registry = ModelRegistry.from_manifest(args.model_manifest)
        admission = AdmissionController(registry)
    class_weights = registry.class_weights() if registry is not None else None

    def build_engine(path: Path, tel) -> InferenceEngine:
        return InferenceEngine(
            Pipeline.from_disk(path, device=args.device), max_batch_docs=args.max_batch,
            max_wait_s=max(args.max_wait_ms, 0.0) / 1e3, max_queue_docs=args.queue_size,
            timeout_s=max(args.timeout_ms, 1.0) / 1e3, max_doc_len=args.max_doc_len,
            batching=args.batching, precision=args.precision, telemetry=tel,
            class_weights=class_weights)

    default_path = args.model_path
    if registry is not None:
        default_path = Path(registry.spec(registry.default_model).path)
    tel = None if args.no_telemetry else ServingTelemetry()
    engine = build_engine(default_path, tel)
    if registry is not None:
        from .serving.multimodel import ResidencyManager

        def engine_factory(spec) -> InferenceEngine:
            # each resident model has its own telemetry and warmed buckets;
            # a load runs on a request thread, never a dispatch thread
            return build_engine(Path(spec.path),
                                None if args.no_telemetry else ServingTelemetry()
                                ).start(warmup=not args.no_warmup)

        residency = ResidencyManager(
            registry, engine_factory, capacity=max(args.resident_models, 1),
            evict_drain_s=min(args.drain_timeout_s, 10.0), pinned={registry.default_model})
        # the server's lifecycle warms and starts the default engine
        residency.adopt(registry.default_model, engine)
    watcher = None
    if args.watch is not None:
        from .serving.live import CheckpointWatcher

        def swap(stamp: int, state: dict) -> None:
            engine.swap_params(state["params"], stamp)

        watcher = CheckpointWatcher(args.watch, swap, interval_s=args.watch_interval_s)
    server = Server(engine, args.host, args.port, telemetry=tel,
                    drain_timeout_s=args.drain_timeout_s,
                    swap_dirs=[str(d) for d in args.swap_dir], watcher=watcher,
                    registry=registry, residency=residency, admission=admission)
    server.args = args
    return server


def serve_command(argv: List[str]) -> int:
    server = build_server(argv)
    engine, registry, args = server.engine, server.registry, server.args
    print(f"serving batching={engine.batching} precision={engine.overlay.label}"
          + (f" models={','.join(registry.names())} default={registry.default_model}"
             if registry is not None else ""), flush=True)
    rc = server.run(warmup=not args.no_warmup)
    tel = server.tel
    if tel is not None and args.metrics_dir is not None:
        import time

        from .training.telemetry import sanitize_json

        args.metrics_dir.mkdir(parents=True, exist_ok=True)
        tel.trace.flush(args.metrics_dir / "serving_trace.json")
        snap = tel.snapshot()
        snap["generation"] = engine.serving_generation
        snap["swap_count"] = engine.swap_count
        (args.metrics_dir / "serving_metrics.json").write_text(
            json.dumps(sanitize_json(snap), indent=2) + "\n", encoding="utf8")
        with open(args.metrics_dir / "metrics.jsonl", "a", encoding="utf8") as f:
            f.write(json.dumps(sanitize_json(
                {"kind": "serving", "unix_time": time.time(), **snap})) + "\n")
        print(f"serving telemetry written to {args.metrics_dir}", flush=True)
    return rc


#: a supervised one-process run's SIGTERM -> SIGKILL window
SHUTDOWN_GRACE_S = 10.0


def _strip_flags(argv: List[str], flags: List[str]) -> List[str]:
    """``argv`` without the ``--flag value`` and ``--flag=value`` pairs of
    ``flags``."""
    out: List[str] = []
    skip_next = False
    for a in argv:
        if skip_next:
            skip_next = False
        elif a in flags:
            skip_next = True
        elif not any(a.startswith(f + "=") for f in flags):
            out.append(a)
    return out


def _supervise_train(argv: List[str], max_restarts: int) -> int:
    """``train --max-restarts N`` without a fleet: training runs as a child
    process, started again with ``--resume`` after a nonzero exit; signals
    reach it through the supervisor (SIGTERM, SIGKILL after the grace)."""
    from .training.resilience import Supervisor, relaunch_argv

    cmd = [sys.executable, "-m", "spacy_ray_tpu_torch", "train",
           *_strip_flags(argv, ["--max-restarts"])]
    return Supervisor(lambda attempt: relaunch_argv(cmd, attempt), max_restarts,
                      grace_s=SHUTDOWN_GRACE_S).run()


def train_command(argv: List[str]) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch train",
        description="Train a pipeline from a config on one device.", allow_abbrev=False,
    )
    parser.add_argument("config_path", type=Path)
    parser.add_argument("--output", "-o", type=Path, default=None)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--code", type=Path, default=None,
                        help="a Python file to import first (its registered functions)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the newest intact generation in <output>/last-model")
    parser.add_argument("--max-restarts", type=int, default=0, dest="max_restarts",
                        help="supervisor mode: relaunch the training child up to N times on "
                        "nonzero exit, resuming from the last intact checkpoint (0 = train "
                        "in-process)")
    parser.add_argument("--verbose", "-V", action="store_true")
    parser.add_argument("--fleet-workers", type=int, default=0, dest="fleet_workers",
                        help="asynchronous trainer fleet: spawn N worker processes that own "
                        "parameter slices, push gradients to their owners over HTTP and "
                        "apply at quorum (0 = one process)")
    parser.add_argument("--quorum", type=int, default=0,
                        help="fleet: gradients from this many distinct workers trigger an "
                        "owner's apply (0 = auto: all but one, at least 1)")
    parser.add_argument("--max-staleness", type=int, default=1, dest="max_staleness",
                        help="fleet: accept gradients stamped up to S versions behind the "
                        "owner's; staler ones are discarded and counted")
    parser.add_argument("--fleet-base-port", type=int, default=None, dest="fleet_base_port",
                        help="fleet: worker k's peer endpoint binds 127.0.0.1:base+k "
                        "(default 47200)")
    parser.add_argument("--peer-lease-s", type=float, default=60.0, dest="peer_lease_s",
                        help="fleet: evict a peer that answered no liveness probe for this "
                        "many seconds and missed 3 in a row; its slices re-shard over the "
                        "survivors (0 = never evict)")
    parser.add_argument("--grad-compression", type=str, default="auto",
                        dest="grad_compression", choices=("auto", "f32", "bf16", "int8"),
                        help="fleet: wire codec for gradient pushes. auto = int8 with error "
                        "feedback where the convergence suite has run, bf16 elsewhere; "
                        "per-peer negotiated, so mixed fleets degrade to f32 instead of "
                        "erroring")
    parser.add_argument("--param-delta-window", type=int, default=4,
                        dest="param_delta_window",
                        help="fleet: owners retain K versions of compressed param deltas so "
                        "a puller at most K versions behind ships a delta frame instead of "
                        "its full slice; 0 = full pulls only. Window misses degrade to full "
                        "pulls")
    parser.add_argument("--fleet-worker-id", type=int, default=None, dest="fleet_worker_id",
                        help="(set by the coordinator) run as fleet worker K")
    args, extra = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    if args.fleet_workers < 0:
        parser.error("--fleet-workers must be >= 0")
    if args.peer_lease_s < 0:
        parser.error("--peer-lease-s must be >= 0")
    if args.param_delta_window < 0:
        parser.error("--param-delta-window must be >= 0")
    if args.max_restarts < 0:
        parser.error("--max-restarts must be >= 0")
    if args.fleet_workers > 0 and args.fleet_worker_id is None:
        # the coordinator: supervises the workers and waits; never touches the
        # card. --max-restarts is each worker's cap and reaches no child
        from .training.fleet.coordinator import run_fleet
        from .training.fleet.worker import resolve_quorum

        if not 1 <= resolve_quorum(args.quorum, args.fleet_workers) <= args.fleet_workers:
            parser.error(f"--quorum {args.quorum} outside [1, {args.fleet_workers}]")
        return run_fleet(_strip_flags(argv, ["--max-restarts"]), n_workers=args.fleet_workers,
                         max_restarts=args.max_restarts)
    if args.max_restarts > 0:
        # the supervisor: runs and relaunches the training child; never
        # touches the card
        return _supervise_train(argv, args.max_restarts)

    from .config import load_config, parse_cli_overrides
    from .registry import import_code
    from .training.loop import train

    fleet = None
    if args.fleet_worker_id is not None:
        if args.fleet_workers <= 0:
            parser.error("--fleet-worker-id requires --fleet-workers N")
        from .training.fleet.worker import DEFAULT_FLEET_BASE_PORT

        fleet = {"worker_id": args.fleet_worker_id, "n_workers": args.fleet_workers,
                 "quorum": args.quorum, "max_staleness": args.max_staleness,
                 "peer_lease_s": args.peer_lease_s,
                 "grad_compression": args.grad_compression,
                 "param_delta_window": args.param_delta_window,
                 "base_port": (args.fleet_base_port if args.fleet_base_port is not None
                               else DEFAULT_FLEET_BASE_PORT)}
    import_code(str(args.code) if args.code else None)
    config = load_config(args.config_path, parse_cli_overrides(extra))
    nlp, result = train(config, args.output, device=args.device, resume=args.resume,
                        fleet=fleet)
    if result.interrupted:
        from .training.resilience import RC_PREEMPTED

        print(f"Interrupted at step {result.final_step} (exit {RC_PREEMPTED})", flush=True)
        return RC_PREEMPTED
    if fleet is not None and fleet["worker_id"] != 0:
        # a worker other than the lead evaluates nothing
        print(f"Done. fleet worker {fleet['worker_id']}: steps={result.final_step} "
              f"shard version={result.fleet['version']} words/sec={result.wps:,.0f}",
              flush=True)
        return 0
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
    parser.add_argument("--code", type=Path, default=None,
                        help="a Python file to import first (its registered functions)")
    args = parser.parse_args(argv)

    from .pipeline.language import Pipeline
    from .registry import import_code
    from .training.corpus import Corpus

    import_code(str(args.code) if args.code else None)

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


def pretrain_command(argv: List[str]) -> int:
    """Pretrain the trunk from the config's ``[pretraining]`` block; the
    weights go to ``<output-dir>/model-last.npz`` for ``[initialize]
    init_tok2vec``."""
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch pretrain",
        description="Pretrain the tok2vec/transformer trunk on raw text "
        "([pretraining] config block); load results with "
        "[initialize] init_tok2vec.", allow_abbrev=False,
    )
    parser.add_argument("config_path", type=Path)
    parser.add_argument("output_dir", type=Path)
    parser.add_argument("--n-workers", type=int, default=None, dest="n_workers",
                        help="cards to pretrain on (only 1 in this port)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--code", type=Path, default=None,
                        help="a Python file to import first (its registered functions)")
    args, extra = parser.parse_known_args(argv)

    from .config import load_config, parse_cli_overrides
    from .registry import import_code
    from .training.pretrain import pretrain

    import_code(str(args.code) if args.code else None)
    config = load_config(args.config_path, parse_cli_overrides(extra))
    stats = pretrain(config, args.output_dir, device=args.device, n_workers=args.n_workers)
    print(f"Pretraining done. steps={stats['steps']} loss={stats['loss']:.4f} "
          f"words={stats['words']:,} -> {stats['output']}", flush=True)
    return 0


def init_vectors_command(argv: List[str]) -> int:
    """Convert word2vec text (an ``N D`` header line), GloVe text (no
    header), either gzipped, or an ``.npz`` with words and vectors into the
    npz ``[initialize] vectors`` loads; ``--truncate N`` keeps the first N
    rows."""
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch init-vectors",
        description="Convert word embeddings (word2vec/glove text, optionally "
        ".gz, or an npz with words+vectors) for [initialize] vectors.",
    )
    parser.add_argument("input_path", type=Path)
    parser.add_argument("output_path", type=Path)
    parser.add_argument("--truncate", type=int, default=0,
                        help="keep only the first N rows (0 = all)")
    args = parser.parse_args(argv)

    import gzip

    import numpy as np

    from .pipeline.vectors import Vectors

    if args.input_path.suffix == ".npz":
        vec = Vectors.from_disk(args.input_path)
        words, table = list(vec.key_to_row), vec.table
        if args.truncate:
            words, table = words[: args.truncate], table[: args.truncate]
    else:
        opener = gzip.open if args.input_path.suffix == ".gz" else open
        words, rows = [], []
        with opener(args.input_path, "rt", encoding="utf8") as f:
            parts = f.readline().split()
            if len(parts) == 2 and all(p.isdigit() for p in parts):
                pass  # the word2vec "N D" header line
            elif len(parts) >= 2:  # GloVe: no header, the first line is a row
                words.append(parts[0])
                rows.append(np.asarray(parts[1:], dtype=np.float32))
            for line in f:
                if args.truncate and len(words) >= args.truncate:
                    break
                parts = line.split()
                if len(parts) < 2:
                    continue
                words.append(parts[0])
                rows.append(np.asarray(parts[1:], dtype=np.float32))
        if not rows:
            print("No vectors found in input", file=sys.stderr)
            return 1
        widths = {r.shape[0] for r in rows}
        if len(widths) != 1:
            print(f"Inconsistent vector widths in input: {sorted(widths)}", file=sys.stderr)
            return 1
        table = np.stack(rows)
    Vectors(words, table).to_disk(args.output_path)
    print(f"Wrote {len(words)} vectors (dim {table.shape[1]}) to {args.output_path}; "
          f"use via [initialize] vectors = \"{args.output_path}\"")
    return 0


COMMANDS = {"train": train_command, "pretrain": pretrain_command,
            "evaluate": evaluate_command, "serve": serve_command,
            "init-vectors": init_vectors_command}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
