"""Command line of the port::

    python -m spacy_ray_tpu_torch train <config.cfg> --output <dir> [--device cuda|cpu]
        [--code F] [--resume] [--max-restarts N] [--metrics-dir DIR [--metrics-port P]]
        [--paths.train x.jsonl --training.max_steps 40 ...]
        [--fleet-workers N [--quorum Q] [--max-staleness S] [--fleet-base-port P]
        [--peer-lease-s S] [--grad-compression C] [--param-delta-window K]]
    python -m spacy_ray_tpu_torch pretrain <config.cfg> <output-dir> [--device cuda|cpu]
        [--code F] [--section.key value ...]
    python -m spacy_ray_tpu_torch evaluate <model-dir> <data.jsonl> [--device cuda|cpu]
        [--code F]
    python -m spacy_ray_tpu_torch serve <model-dir> [options]
    python -m spacy_ray_tpu_torch serve-fleet <model-dir> [--replicas N] [options]
        [--watch CKPT_DIR [--canary-fraction F] [--guard-* ...]]
    python -m spacy_ray_tpu_torch train-and-serve <config.cfg> --output <dir> [options]
    python -m spacy_ray_tpu_torch telemetry collect-trace [<url>...] --out FILE
    python -m spacy_ray_tpu_torch telemetry summarize <metrics.jsonl | run-dir>
    python -m spacy_ray_tpu_torch init-vectors <input> <output.npz> [--truncate N]

``train`` trains the config's pipeline on one device, evaluating every
``eval_frequency`` steps, and writes ``best-model/`` and ``last-model/``
(with its training generations, which ``--resume`` continues from, a
fleet's generations too). SIGTERM or SIGINT stops it at a step boundary
with a generation written, and it exits 75. ``--max-restarts N`` runs the
training as a child process and starts it again with ``--resume`` after a
nonzero exit, at most N times (a relayed signal is not restarted), a hung
step's watchdog exit (79, ``[training] watchdog_timeout_s``) included.
``--metrics-dir DIR`` turns telemetry on (``DIR/metrics.jsonl``,
``DIR/trace.json``, the anomaly detectors) and ``--metrics-port P`` serves
it over HTTP (``/metrics``, ``/healthz``, ``/trace``); both override their
``[training]`` knobs and reach a supervised child.
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
the trace and the last metrics snapshot at exit.
``serve-fleet`` runs ``--replicas`` ``serve`` processes behind one router
(``serving/fleet/``): least-outstanding picks over the replicas whose
``/healthz`` answers 200, retries elsewhere when one fails or drains, the
generation-stamped response cache (``--cache-mb``), ``--length-routing``,
crash restarts with backoff and, with ``--autoscale``, scaling between
``--min-replicas`` and ``--max-replicas`` on the replicas' p99; SIGTERM
drains the router and then every replica, and it exits 0 only if all were
clean. ``--watch CKPT_DIR`` rolls each new intact generation of a training
run's ``last-model/`` across the replicas: swapped onto
``--canary-fraction`` of them first while the router splits traffic by
generation, then promoted fleet-wide or rolled back by the guard
(``--guard-*``: error rate, window p99, samples, a verdict timeout). With
``--autoscale --model-manifest`` each scaling tick also loads a model whose
window p99 breaches its class target onto another replica (placement).
``train-and-serve`` runs ``train`` as a child process writing
``<output>/last-model`` and a fleet watching it (bootstrapped from the
run's first ``best-model`` unless ``--model`` is given); one SIGTERM drains
both, and it exits 0 when the fleet drained clean and the trainer exited 0
or 75. ``telemetry collect-trace`` merges the ``/trace`` buffers of the
given endpoints (a fleet router's URL brings its replicas) into one
Chrome-trace file by their clock anchors; ``telemetry summarize`` prints
the digest of a ``metrics.jsonl`` (a trainer's or a server's) or of a run
directory. Every command runs on the card
unless ``--device cpu`` is given (``--serve-device cpu`` for
``train-and-serve``'s replicas), and fails without one (``serve-fleet`` and
``train-and-serve`` before they spawn anything).
``init-vectors`` converts word2vec or GloVe text (``.gz`` too) or an
``.npz`` of words and vectors into the ``vectors.npz`` that ``[initialize]
vectors`` reads (the JAX package's command: the same file, the same errors).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path
from typing import List, Optional

from .serving.engine import SERVING_DEFAULTS
from .serving.overlay import PRECISION_CHOICES

USAGE = (
    "usage: python -m spacy_ray_tpu_torch train <config.cfg> [--output DIR] [--device cuda|cpu]"
    " [--code F] [--resume] [--max-restarts N] [--metrics-dir DIR [--metrics-port P]]"
    " [--fleet-workers N [--quorum Q]"
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
    "       python -m spacy_ray_tpu_torch serve-fleet <model-dir> [--replicas N] [--port N]"
    " [--device cuda|cpu] [--min-replicas N] [--max-replicas N] [--cache-mb MB]"
    " [--length-routing] [--autoscale [--p99-target-ms MS]] [--watch CKPT_DIR"
    " [--canary-fraction F] [--guard-p99-frac X] [--guard-error-rate R]"
    " [--guard-min-samples N] [--guard-verdict-timeout-s S]] [serve's replica options]\n"
    "       python -m spacy_ray_tpu_torch train-and-serve <config.cfg> --output DIR"
    " [--model DIR] [--device cuda|cpu] [--serve-device cuda|cpu] [--replicas N]"
    " [--port N] [--train-arg ARG ...] [serve-fleet's rollout options]\n"
    "       python -m spacy_ray_tpu_torch telemetry collect-trace [<url>...]"
    " [--fleet-base-port N --workers K] --out FILE\n"
    "       python -m spacy_ray_tpu_torch telemetry summarize <metrics.jsonl | run-dir>\n"
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


def _add_rollout_args(parser: argparse.ArgumentParser) -> None:
    """The live rollout's flags, JAX's names and defaults (``serve-fleet``
    adds ``--watch``; ``train-and-serve`` watches its own output)."""
    parser.add_argument("--watch-interval-s", type=float, default=2.0,
                        help="how often the controller scans the watched directory")
    parser.add_argument("--canary-fraction", type=float, default=0.25,
                        help="fraction of the replicas (and of the traffic) a new generation "
                        "canaries on before promotion or rollback, within 0..1; 0 or 1 swaps "
                        "every replica at once")
    parser.add_argument("--guard-p99-frac", type=float, default=1.5,
                        help="roll back when the canary's window p99 exceeds this multiple "
                        "of the baseline's")
    parser.add_argument("--guard-error-rate", type=float, default=0.02,
                        help="roll back when the canary's error rate exceeds this (and the "
                        "baseline's)")
    parser.add_argument("--guard-min-samples", type=int, default=20,
                        help="canary requests and window samples needed before any verdict")
    parser.add_argument("--guard-verdict-timeout-s", type=float, default=120.0,
                        help="a canary without a verdict after this long is rolled back")


def _rollout_refusal(args) -> Optional[str]:
    """Why the rollout flags cannot run, or None: the guard's own bounds
    (JAX's messages) and a canary fraction outside 0..1."""
    from .serving.live import CanaryGuard

    if not 0.0 <= args.canary_fraction <= 1.0:
        return (f"--canary-fraction {args.canary_fraction} must lie within 0..1 (0 or 1: "
                "every replica swapped at once, no canary)")
    try:
        CanaryGuard(p99_frac=args.guard_p99_frac, error_rate_high=args.guard_error_rate,
                    min_window_samples=args.guard_min_samples,
                    min_canary_requests=args.guard_min_samples)
    except ValueError as e:
        return str(e)
    return None


def _cpu_core_masks(spec: Optional[str]) -> Optional[List[str]]:
    """``--cpu-cores``: 'auto' (one core per replica, round-robin over this
    process's affinity) or comma-separated ``taskset -c`` masks."""
    if not spec:
        return None
    if spec.strip().lower() == "auto":
        return [str(c) for c in sorted(os.sched_getaffinity(0))]
    return [m.strip() for m in spec.split(",") if m.strip()]


def serve_fleet_command(argv: List[str]) -> int:
    """``serve-fleet``: a router over ``--replicas`` ``serve`` processes
    (JAX ``cli.py`` ``serve_fleet_command``, less the incident recorder).
    This process proxies, probes, spawns and rolls generations out; the
    replicas run the model on the card."""
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch serve-fleet", allow_abbrev=False,
        description="Serve a saved pipeline from N replica processes behind one "
                    "load-balancing router (/v1/parse, /healthz, /metrics).")
    parser.add_argument("model_path", type=Path)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8090,
                        help="router port (0 = ephemeral; printed in the 'fleet serving on "
                        "http://...' banner)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda (default; fails without a card before spawning a "
                        "replica) or cpu, for every replica")
    parser.add_argument("--replicas", type=int, default=2, help="initial replica count")
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--max-replicas", type=int, default=4)
    parser.add_argument("--base-port", type=int, default=0,
                        help="replica ports: 0 = ephemeral (read from each replica's "
                        "banner), N = N + the replica's slot")
    parser.add_argument("--visible-devices", type=str, default=None,
                        help="comma-separated visible-device masks cycled per replica slot "
                        "(set in --visible-devices-env); on one card a no-op")
    parser.add_argument("--visible-devices-env", type=str, default="CUDA_VISIBLE_DEVICES")
    parser.add_argument("--cpu-cores", type=str, default=None,
                        help="--device cpu only: 'auto' (one core per replica, round-robin "
                        "over this process's affinity) or comma-separated taskset -c masks "
                        "cycled per replica slot")
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-wait-ms", type=float, dest="max_wait_ms", default=None)
    parser.add_argument("--queue-size", type=int, default=None)
    parser.add_argument("--timeout-ms", type=float, default=None)
    parser.add_argument("--max-doc-len", type=int, default=None)
    parser.add_argument("--batching", choices=["continuous", "window"], default=None,
                        help="the replicas' admission (default: serve's, continuous)")
    parser.add_argument("--precision", choices=PRECISION_CHOICES, default=None,
                        help="the replicas' precision overlay (default: serve's, auto)")
    parser.add_argument("--model-manifest", type=Path, default=None,
                        help="every replica serves the manifest's models; the router "
                        "resolves /v1/models/<name>/parse and X-SRT-Model and routes within "
                        "the replicas hosting the model")
    parser.add_argument("--resident-models", type=int, default=None,
                        help="multi-model only: each replica's warmed engines")
    parser.add_argument("--cache-mb", type=float, default=32.0,
                        help="the router's response cache in MB, keyed by the texts and "
                        "stamped with the serving generation (0 = off)")
    parser.add_argument("--probe-interval-s", type=float, default=0.5,
                        help="how often the router probes each replica's /healthz")
    parser.add_argument("--length-routing", action="store_true",
                        help="steer requests of one length bucket to one replica (within the "
                        "least-outstanding candidates) so batches pad less")
    parser.add_argument("--watch", type=Path, default=None, metavar="CKPT_DIR",
                        help="a training run's <output>/last-model: each new digest-verified "
                        "generation canaries on --canary-fraction of the replicas (the router "
                        "splits traffic by generation), then is promoted fleet-wide or rolled "
                        "back by the guard")
    _add_rollout_args(parser)
    parser.add_argument("--autoscale", action="store_true",
                        help="scale between --min/--max-replicas on the replicas' p99 against "
                        "--p99-target-ms and their queues; with --model-manifest also load a "
                        "model whose window p99 breaches its class target onto another "
                        "replica")
    parser.add_argument("--p99-target-ms", type=float, default=500.0)
    parser.add_argument("--autoscale-interval-s", type=float, default=2.0)
    parser.add_argument("--up-consecutive", type=int, default=3,
                        help="breaching observations required to scale up")
    parser.add_argument("--down-consecutive", type=int, default=10,
                        help="idle observations required to scale down")
    parser.add_argument("--cooldown-s", type=float, default=30.0,
                        help="minimum seconds between scaling decisions")
    parser.add_argument("--drain-timeout-s", type=float, default=60.0,
                        help="the router's wait for its in-flight requests at shutdown")
    parser.add_argument("--ready-timeout-s", type=float, default=300.0)
    parser.add_argument("--no-telemetry", action="store_true",
                        help="no router or replica telemetry")
    parser.add_argument("--verbose", "-V", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.ERROR)
    for name in ("spacy_ray_tpu_torch.training", "spacy_ray_tpu_torch.serving"):
        logging.getLogger(name).setLevel(logging.INFO if args.verbose else logging.WARNING)
    if args.min_replicas < 1 or args.replicas < 1:
        print("--replicas/--min-replicas must be >= 1", file=sys.stderr)
        return 2
    if not (args.min_replicas <= args.replicas <= args.max_replicas):
        print(f"--replicas {args.replicas} must lie within --min-replicas "
              f"{args.min_replicas} .. --max-replicas {args.max_replicas}", file=sys.stderr)
        return 2
    if args.cpu_cores and args.device != "cpu":
        print("--cpu-cores pins CPU replicas and needs --device cpu", file=sys.stderr)
        return 2
    refusal = _rollout_refusal(args)
    if refusal is not None:
        print(f"serve-fleet: {refusal}", file=sys.stderr)
        return 2

    from .serving.fleet import Fleet, FleetConfig

    config = FleetConfig(
        model_path=str(args.model_path), host=args.host, port=args.port, device=args.device,
        replicas=args.replicas, min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, queue_size=args.queue_size,
        timeout_ms=args.timeout_ms, max_doc_len=args.max_doc_len, batching=args.batching,
        precision=args.precision,
        model_manifest=str(args.model_manifest) if args.model_manifest is not None else None,
        resident_models=args.resident_models, base_port=args.base_port,
        visible_devices=([m.strip() for m in args.visible_devices.split(",") if m.strip()]
                         if args.visible_devices else None),
        visible_devices_env=args.visible_devices_env, cpu_cores=_cpu_core_masks(args.cpu_cores),
        cache_mb=args.cache_mb, probe_interval_s=args.probe_interval_s,
        length_routing=args.length_routing,
        watch_dir=str(args.watch) if args.watch is not None else None,
        watch_interval_s=args.watch_interval_s, canary_fraction=args.canary_fraction,
        guard_p99_frac=args.guard_p99_frac, guard_error_rate=args.guard_error_rate,
        guard_min_samples=args.guard_min_samples,
        guard_verdict_timeout_s=args.guard_verdict_timeout_s, autoscale=args.autoscale,
        p99_target_ms=args.p99_target_ms, autoscale_interval_s=args.autoscale_interval_s,
        up_consecutive=args.up_consecutive, down_consecutive=args.down_consecutive,
        cooldown_s=args.cooldown_s, drain_timeout_s=args.drain_timeout_s,
        ready_timeout_s=args.ready_timeout_s, telemetry=not args.no_telemetry)
    try:
        fleet = Fleet(config)
    except RuntimeError as e:  # no card: nothing was spawned
        print(f"serve-fleet: {e}", file=sys.stderr)
        return 1
    rc = fleet.run()
    if rc == 0:
        print("fleet drained; exiting 0", flush=True)
    else:
        print("fleet drain incomplete (router timeout or nonzero replica exit) — "
              f"exiting {rc}", flush=True)
    return rc


def train_and_serve_command(argv: List[str]) -> int:
    """``train-and-serve``: a ``train`` child process writing generations
    into ``<output>/last-model`` and a fleet watching that directory, which
    swaps each new intact generation in without dropping a request (canary
    and guard with more than one replica). One SIGTERM drains both: the
    trainer stops with a generation written (exit 75), the fleet finishes
    its work; exit 0 only if both were clean (JAX ``cli.py``
    ``train_and_serve_command``)."""
    parser = argparse.ArgumentParser(
        prog="python -m spacy_ray_tpu_torch train-and-serve", allow_abbrev=False,
        description="Run training and a hot-swapping serving fleet against one checkpoint "
                    "directory, under one lifecycle.")
    parser.add_argument("config_path", type=Path)
    parser.add_argument("--output", "-o", type=Path, required=True,
                        help="training output dir; the fleet watches <output>/last-model")
    parser.add_argument("--model", type=Path, default=None,
                        help="serve this model dir from the start (e.g. the previous run's "
                        "best-model); default: a copy of this run's first best-model")
    parser.add_argument("--bootstrap-timeout-s", type=float, default=600.0,
                        help="without --model: how long to wait for the first best-model")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="the trainer's and (without --serve-device) every replica's "
                        "device: cuda (default; fails without a card) or cpu")
    parser.add_argument("--serve-device", choices=["cuda", "cpu"], default=None,
                        help="the replicas' device (default: --device)")
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--base-port", type=int, default=0)
    parser.add_argument("--cpu-cores", type=str, default=None,
                        help="serve-fleet's --cpu-cores for CPU replicas")
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-doc-len", type=int, default=None)
    parser.add_argument("--batching", choices=["continuous", "window"], default=None)
    parser.add_argument("--precision", choices=PRECISION_CHOICES, default=None)
    _add_rollout_args(parser)
    parser.add_argument("--drain-timeout-s", type=float, default=60.0)
    parser.add_argument("--no-telemetry", action="store_true")
    parser.add_argument("--train-arg", action="append", default=[], dest="train_args",
                        metavar="ARG",
                        help="an argument appended to the train command (repeatable), e.g. "
                        "--train-arg=--training.max_steps --train-arg=200")
    parser.add_argument("--verbose", "-V", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.ERROR)
    for name in ("spacy_ray_tpu_torch.training", "spacy_ray_tpu_torch.serving"):
        logging.getLogger(name).setLevel(logging.INFO if args.verbose else logging.WARNING)
    serve_device = args.serve_device or args.device
    if args.replicas < 1:
        print("--replicas must be >= 1", file=sys.stderr)
        return 2
    if args.cpu_cores and serve_device != "cpu":
        print("--cpu-cores pins CPU replicas and needs the replicas on the CPU",
              file=sys.stderr)
        return 2
    refusal = _rollout_refusal(args)
    if refusal is not None:
        print(f"train-and-serve: {refusal}", file=sys.stderr)
        return 2
    if "cuda" in (args.device, serve_device):
        from .devices import resolve_device

        try:  # no card: nothing is spawned
            resolve_device("cuda")
        except RuntimeError as e:
            print(f"train-and-serve: {e}", file=sys.stderr)
            return 1

    from .serving.fleet import FleetConfig
    from .serving.live import TrainAndServe

    output = args.output
    train_cmd = [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(args.config_path),
                 "--output", str(output), "--device", args.device, *args.train_args]
    config = FleetConfig(
        model_path=str(args.model) if args.model is not None else "", host=args.host,
        port=args.port, device=serve_device, replicas=args.replicas, min_replicas=1,
        max_replicas=args.replicas, max_batch=args.max_batch, max_doc_len=args.max_doc_len,
        batching=args.batching, precision=args.precision, base_port=args.base_port,
        cpu_cores=_cpu_core_masks(args.cpu_cores), watch_dir=str(output / "last-model"),
        watch_interval_s=args.watch_interval_s, canary_fraction=args.canary_fraction,
        guard_p99_frac=args.guard_p99_frac, guard_error_rate=args.guard_error_rate,
        guard_min_samples=args.guard_min_samples,
        guard_verdict_timeout_s=args.guard_verdict_timeout_s,
        drain_timeout_s=args.drain_timeout_s, telemetry=not args.no_telemetry)
    rc = TrainAndServe(train_cmd, config, output_dir=output,
                       bootstrap_timeout_s=args.bootstrap_timeout_s).run()
    if rc == 0:
        print("train-and-serve: exiting 0", flush=True)
    else:
        print(f"train-and-serve: incomplete drain or trainer failure — exiting {rc}",
              flush=True)
    return rc


#: ``telemetry`` subcommands of the JAX package that wait for the port's
#: observability (its alerting, incidents, run ledger and reports)
TELEMETRY_WAITING = ("top", "postmortem", "report", "ledger")


def telemetry_command(argv: List[str]) -> int:
    """``telemetry summarize``: the digest of a ``metrics.jsonl`` (a
    trainer's or a server's) or of a run directory; ``telemetry
    collect-trace``: merge the ``/trace`` buffers of a serving fleet's router
    and replicas (discovered from the router's ``/healthz``), or of any
    endpoints (a trainer's ``--metrics-port`` among them), into one
    Chrome-trace file aligned by their clock anchors (JAX ``cli.py``
    ``telemetry_command``). The JAX package's other subcommands exit 2."""
    usage = ("Usage: python -m spacy_ray_tpu_torch telemetry {summarize "
             "<metrics.jsonl-or-run-dir> | collect-trace [<url>...] "
             "[--fleet-base-port N --workers K] --out FILE}")
    if not argv or argv[0] not in ("summarize", "collect-trace", *TELEMETRY_WAITING):
        print(usage, file=sys.stderr)
        return 1
    sub, rest = argv[0], argv[1:]
    if sub in TELEMETRY_WAITING:
        print(f"telemetry {sub} is not part of the port yet (ROADMAP.md Queue A item 4.4, "
              "observability)", file=sys.stderr)
        return 2
    if sub == "summarize":
        parser = argparse.ArgumentParser(prog="python -m spacy_ray_tpu_torch telemetry summarize")
        parser.add_argument("metrics_path", type=Path,
                            help="metrics.jsonl written by a [training] metrics_dir / train "
                            "--metrics-dir run or a serve --metrics-dir run — or a "
                            "trainer-fleet RUN DIRECTORY (fleet-worker-*.json ledgers + "
                            "metrics/fleet-worker-*/metrics.jsonl)")
        args = parser.parse_args(rest)

        from .training.telemetry import summarize_metrics

        try:
            print(summarize_metrics(args.metrics_path))
        except OSError as e:
            print(f"Cannot read {args.metrics_path}: {e}", file=sys.stderr)
            return 1
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        return 0
    parser = argparse.ArgumentParser(prog="python -m spacy_ray_tpu_torch telemetry collect-trace")
    parser.add_argument("urls", nargs="*", metavar="URL",
                        help="endpoint base URLs; a fleet router's URL brings its replicas")
    parser.add_argument("--out", type=Path, required=True,
                        help="the merged Chrome-trace JSON (open in ui.perfetto.dev)")
    parser.add_argument("--no-discover", action="store_true",
                        help="do not expand a router's URL into its replicas")
    parser.add_argument("--fleet-base-port", type=int, default=None, dest="fleet_base_port",
                        help="a trainer fleet: worker k at <fleet-host>:base+k for k in "
                        "0..workers-1 (as train --fleet-base-port)")
    parser.add_argument("--workers", type=int, default=None,
                        help="the trainer fleet's worker count (with --fleet-base-port)")
    parser.add_argument("--fleet-host", default="127.0.0.1", dest="fleet_host")
    args = parser.parse_args(rest)

    from .serving.tracecollect import collect_fleet_traces, fleet_worker_urls, write_merged_trace

    urls = list(args.urls)
    if (args.fleet_base_port is None) != (args.workers is None):
        parser.error("--fleet-base-port and --workers go together")
    if args.workers is not None and args.workers <= 0:
        parser.error(f"--workers must be positive, got {args.workers}")
    if args.fleet_base_port is not None:
        urls.extend(fleet_worker_urls(args.fleet_base_port, args.workers, host=args.fleet_host))
    if not urls:
        parser.error("give endpoint URLs, or --fleet-base-port N --workers K for a trainer "
                     "fleet")
    merged = collect_fleet_traces(urls, discover=not args.no_discover)
    info = merged.get("otherData") or {}
    if not info.get("merged_from"):
        print(f"no traces collected (skipped: {info.get('skipped')}) — are the endpoints up "
              "with telemetry enabled?", file=sys.stderr)
        return 1
    path = write_merged_trace(merged, args.out)
    n = sum(1 for e in merged["traceEvents"] if e.get("ph") != "M")
    print(f"merged {n} event(s) from {len(info['merged_from'])} process(es) into {path}"
          + (f" (skipped: {info['skipped']})" if info.get("skipped") else ""))
    return 0


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
    parser.add_argument("--metrics-dir", type=Path, default=None, dest="metrics_dir",
                        help="enable telemetry: metrics.jsonl + Chrome trace + anomaly "
                        "detectors land here (overrides [training] metrics_dir)")
    parser.add_argument("--metrics-port", type=int, default=None, dest="metrics_port",
                        help="serve the trainer's telemetry over HTTP on this port (/metrics "
                        "JSON or ?format=prometheus, /healthz clock anchor, /trace) — "
                        "requires telemetry on via --metrics-dir/[training] metrics_dir; "
                        "overrides [training] metrics_port. Binds 127.0.0.1 unless "
                        "[training] metrics_host (or --training.metrics_host) says otherwise")
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
    if args.metrics_port is not None and not 0 <= args.metrics_port <= 65535:
        parser.error(f"--metrics-port {args.metrics_port} outside [0, 65535]")
    if args.fleet_workers > 0 and (args.metrics_dir is not None or args.metrics_port):
        # before any worker starts (each would refuse it on its own)
        from .training.fleet.worker import refuse_fleet_telemetry

        try:
            refuse_fleet_telemetry(args.metrics_dir, args.metrics_port)
        except ValueError as e:
            parser.error(str(e))
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
    # the telemetry flags a user gave (a fleet worker refused them above)
    telemetry = {k: v for k, v in (("metrics_dir", args.metrics_dir),
                                   ("metrics_port", args.metrics_port)) if v is not None}
    nlp, result = train(config, args.output, device=args.device, resume=args.resume,
                        fleet=fleet, **telemetry)
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
            "serve-fleet": serve_fleet_command, "train-and-serve": train_and_serve_command,
            "telemetry": telemetry_command, "init-vectors": init_vectors_command}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(USAGE, file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
