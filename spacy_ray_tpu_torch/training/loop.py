"""The training loop on one device: config-driven train-while-improving.

Counterpart of ``spacy_ray_tpu/training/loop.py`` with the semantics that
matter on one device:

* ``[training]`` is validated against the JAX package's key surface
  (:data:`DEFAULT_TRAINING`); knobs that only shape multiple devices, the
  profiler, alerting or compiled programs are accepted and ignored
  (:data:`IGNORED_KNOBS`), and a run says once which of them its config set;
* labels are collected from the train corpus at initialize;
* an update takes ``accumulate_gradient`` raw batches, each padded to the
  group's common ``(B_pad, T_pad)`` bucket; the gradient is the mean of the
  microbatch gradients and the loss the mean of their losses; a short last
  group ends the data;
* the optimizer step reports the gradients' global norm (``grad_norm``);
  frozen leaves (static-vector tables) are not the optimizer's: no update,
  no L2, no moments, no share in the norm, no entry in the opt-state file;
* ``frozen_components`` run in the loss with their parameters out of
  autograd (``Pipeline.requires_grad_``): their leaves stay the optimizer's
  with zero gradients, as in JAX (so an L2 decay still moves them), and
  their losses still train a trunk that is not frozen;
  ``annotating_components`` predict each raw batch onto ``eg.predicted``
  with the current parameters before it is collated;
  ``[training.before_update]`` (a ``@callbacks`` block) is called with
  ``(nlp, {"step": step, "epoch": epoch})`` before every update;
* ``eval_frequency``, ``patience``, ``max_steps`` and ``max_epochs``,
  best-model selection by the weighted score, ``use_averages``, and
  ``steps_per_dispatch`` (run as that many single steps, which the JAX
  package proves identical);
* ``best-model/`` and ``last-model/`` written with ``Pipeline.to_disk``, and
  ``last-model/`` also holding the training generations ``--resume``
  continues from (``training/checkpoint.py``), a trainer fleet's too (its
  parts assembled into the one-process optimizer state; as in JAX it has no
  data position, so the resumed run starts its epoch over, and it draws its
  dropout seeds on from the fleet lead's generator);
* SIGTERM or SIGINT (:class:`~.resilience.ShutdownCoordinator`) stops the
  run at the next step boundary: it writes a generation there, sets
  ``result.interrupted`` and logs ``preempted`` (the CLI exits 75);
* resilience: the environment's fault plan (``SPACY_RAY_TPU_FAULT_PLAN``)
  is activated and the retry policy of ``io_retries`` / ``io_retry_base_s``
  installed before the first read; the ``collate``, ``step`` (its ``nan``
  poison reports the step's loss as NaN when the losses are drained) and,
  through the corpus readers and checkpoints, ``corpus-read`` and
  ``checkpoint-write`` fault sites; ``watchdog_timeout_s`` > 0 arms a
  :class:`~.resilience.Watchdog` fed after each step and evaluation (it
  exits 79 on a hung step, after flushing telemetry);
* telemetry (``metrics_dir``, or ``train(metrics_dir=...)``): a
  :class:`~.telemetry.Telemetry` with one clock stamp a step, its
  ``metrics.jsonl``, ``trace.json`` (``trace_steps``), anomaly detectors
  (``anomaly_detection``) and, with ``metrics_port`` > 0, the endpoint of
  :mod:`.telemetry_http` on ``metrics_host``; ``info["telemetry"]`` carries
  its snapshot at each evaluation. Off, nothing of it is constructed or
  called, and on it changes no result.

Dropout seeds come from a ``torch.Generator`` seeded with ``[training]
seed``: one 63-bit seed per microbatch, saved with each generation, so a
resumed run draws the seeds the uninterrupted run would have drawn.
"""

from __future__ import annotations

import difflib
import io
import logging
import random
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..devices import DeviceLike, resolve_device
from ..models.core import param_paths
from ..pipeline.doc import Example
from ..pipeline.language import Pipeline
from ..registry import registry
from . import corpus as _corpus  # noqa: F401  (registers readers)
from . import loggers as _loggers  # noqa: F401  (registers loggers)
from . import optimizers as _optimizers
from . import resilience
from .batcher import bucket_batch_size, bucket_length
from .checkpoint import CheckpointCorrupt, TrainCheckpoint, set_generator_state
from .resilience import ShutdownCoordinator, Watchdog, log_event, maybe_fail

logger = logging.getLogger("spacy_ray_tpu_torch.training")

DEFAULT_TRAINING: Dict[str, Any] = {
    "seed": 0,
    "dropout": 0.1,
    "accumulate_gradient": 1,
    "patience": 1600,
    "max_epochs": 0,
    "max_steps": 20000,
    "eval_frequency": 200,
    "frozen_components": [],
    "annotating_components": [],
    "dev_corpus": "corpora.dev",
    "train_corpus": "corpora.train",
    "score_weights": {},
    "zero1": False,
    "update_sharding": "auto",
    "mesh": {},
    "prefetch_batches": 2,
    "collate_workers": 0,
    "collate_cache_mb": 0,
    "keep_checkpoints": 2,
    "watchdog_timeout_s": 0,
    "io_retries": 3,
    "io_retry_base_s": 0.5,
    "profile_window": [5, 15],
    "metrics_dir": "",
    "trace_steps": [0, 50],
    "metrics_port": 0,
    "metrics_host": "127.0.0.1",
    "anomaly_detection": True,
    "alerting": True,
    "incident_dir": "",
    "fused_update": "auto",
    "bf16_shadow": "auto",
    "steps_per_dispatch": 1,
    "fleet_peer_timeout_s": 10.0,
    "fleet_probe_timeout_s": 5.0,
}
_TRAINING_BLOCK_KEYS = {"optimizer", "batcher", "logger", "before_update"}
#: knobs of the JAX loop that shape multiple devices, the profiler, alerting
#: and incidents, or compiled programs: validated, then ignored
#: (``fleet_peer_timeout_s`` and ``fleet_probe_timeout_s`` bound a fleet
#: worker's peer requests and liveness probes)
IGNORED_KNOBS = (
    "zero1", "update_sharding", "mesh", "prefetch_batches", "collate_workers",
    "collate_cache_mb", "profile_window", "alerting", "incident_dir", "fused_update",
    "bf16_shadow",
)


def _int(lo: int):
    return (lambda v: isinstance(v, int) and not isinstance(v, bool) and v >= lo,
            f"an int >= {lo}")


def _number(lo: float, strict: bool = False):
    return (lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
            and (v > lo if strict else v >= lo),
            f"a number {'>' if strict else '>='} {lo}")


def _is_step_window(v: Any) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) == 2
            and all(isinstance(x, int) and not isinstance(x, bool) for x in v)
            and 0 <= v[0] <= v[1])


_NAMES = (lambda v: isinstance(v, (list, tuple)) and all(isinstance(x, str) for x in v),
          "a list of component names")
_BOOL = (lambda v: isinstance(v, bool), "a bool")
_STR = (lambda v: isinstance(v, str), "a string")
_MODE = (lambda v: v in ("auto", "on", "off"), 'one of "auto", "on", "off"')
_WINDOW = (_is_step_window, "a [start, stop] pair of ints with 0 <= start <= stop")
_TRAINING_TYPES: Dict[str, Tuple[Callable[[Any], bool], str]] = {
    "seed": (lambda v: isinstance(v, int) and not isinstance(v, bool), "an int"),
    "dropout": (lambda v: isinstance(v, (int, float)) and not isinstance(v, bool)
                and 0.0 <= float(v) < 1.0, "a float in [0, 1)"),
    "accumulate_gradient": _int(1),
    "patience": _int(0),
    "max_epochs": _int(-1),
    "max_steps": _int(0),
    "eval_frequency": _int(1),
    "frozen_components": _NAMES,
    "annotating_components": _NAMES,
    "dev_corpus": _STR,
    "train_corpus": _STR,
    "score_weights": (lambda v: isinstance(v, dict), "a mapping of score -> weight"),
    "zero1": _BOOL,
    "update_sharding": (lambda v: v in ("auto", "replicated", "zero1", "full"),
                        'one of "auto", "replicated", "zero1", "full"'),
    "mesh": (lambda v: isinstance(v, dict), "a mapping of mesh axis sizes"),
    "prefetch_batches": _int(0),
    "collate_workers": _int(0),
    "collate_cache_mb": _int(0),
    "keep_checkpoints": _int(1),
    "watchdog_timeout_s": _number(0),
    "io_retries": _int(0),
    "io_retry_base_s": _number(0, strict=True),
    "profile_window": _WINDOW,
    "metrics_dir": _STR,
    "trace_steps": _WINDOW,
    "metrics_port": (lambda v: isinstance(v, int) and not isinstance(v, bool)
                     and 0 <= v <= 65535, "a TCP port int in [0, 65535]"),
    "metrics_host": (lambda v: isinstance(v, str) and bool(v), "a non-empty bind address"),
    "anomaly_detection": _BOOL,
    "alerting": _BOOL,
    "incident_dir": _STR,
    "fused_update": _MODE,
    "bf16_shadow": _MODE,
    "steps_per_dispatch": _int(1),
    "fleet_peer_timeout_s": _number(0, strict=True),
    "fleet_probe_timeout_s": _number(0, strict=True),
}


def validate_training(raw: Dict[str, Any]) -> None:
    """Reject unknown or mistyped [training] keys, with a did-you-mean hint."""
    allowed = set(DEFAULT_TRAINING) | _TRAINING_BLOCK_KEYS
    for key, value in raw.items():
        if key not in allowed:
            close = difflib.get_close_matches(key, sorted(allowed), n=1)
            hint = f" — did you mean {close[0]!r}?" if close else ""
            raise ValueError(f"[training] has unknown key {key!r}{hint} "
                             f"(known: {', '.join(sorted(allowed))})")
        if key in _TRAINING_BLOCK_KEYS:
            if not isinstance(value, dict):
                raise ValueError(f"[training.{key}] must be a registry block "
                                 f"(a [training.{key}] section), got {type(value).__name__}")
            continue
        pred, desc = _TRAINING_TYPES[key]
        if not pred(value):
            raise ValueError(f"[training] {key} must be {desc}, got {value!r} "
                             f"({type(value).__name__})")


def resolve_training(config: Config) -> Dict[str, Any]:
    raw = config.get("training", {})
    validate_training(raw)
    t = dict(DEFAULT_TRAINING)
    t.update(raw)
    return t


def _unknown_name_error(what: str, name: str, allowed) -> ValueError:
    allowed = sorted(allowed)
    close = difflib.get_close_matches(name, allowed, n=1)
    hint = f" — did you mean {close[0]!r}?" if close else ""
    return ValueError(f"{what} {name!r}{hint} (known: {', '.join(allowed)})")


def check_component_lists(nlp: Pipeline, T: Dict[str, Any]) -> None:
    """``annotating_components`` and ``frozen_components`` name pipeline
    components, and a component with ``use_gold_ents = false`` trains on
    what an annotating component that sets entities predicts (the JAX
    loop's checks and messages)."""
    annotating = list(T.get("annotating_components") or [])
    for key in ("annotating_components", "frozen_components"):
        for comp_name in T.get(key) or []:
            if comp_name not in nlp.pipe_names:
                raise _unknown_name_error(f"[training] {key} names", comp_name,
                                          nlp.pipe_names)
    for comp_name in nlp.pipe_names:
        if getattr(nlp.components[comp_name], "use_gold_ents", True):
            continue
        if not any(nlp.components[n].sets_ents for n in annotating):
            raise ValueError(
                f"[components.{comp_name}] sets use_gold_ents = false, so its "
                "training mentions come from predicted doc.ents — but no "
                "[training] annotating_components entry writes entities. Add "
                "an entity-setting component (ner / entity_ruler) to "
                "annotating_components, or set use_gold_ents = true"
            )


def resolve_before_update(T: Dict[str, Any]) -> Optional[Callable]:
    """``[training.before_update]`` resolved through the registry; it must
    be a callable (an ``@callbacks`` block)."""
    if not T.get("before_update"):
        return None
    before_update = registry.resolve(T["before_update"])
    if not callable(before_update):
        raise ValueError(
            "[training.before_update] must resolve to a callable — add "
            "an @callbacks line to the block (got "
            f"{type(before_update).__name__})"
        )
    return before_update


def default_pipeline_score_weights(nlp: Pipeline) -> Dict[str, float]:
    """The components' declared default score weights, the positive ones
    normalised to sum 1 (spaCy's ``combine_score_weights``)."""
    combined: Dict[str, float] = {}
    for name in nlp.pipe_names:
        for key, value in (nlp.components[name].default_score_weights or {}).items():
            combined[key] = float(value)
    total = sum(v for v in combined.values() if v > 0)
    if total > 0:
        combined = {k: (v / total if v > 0 else 0.0) for k, v in combined.items()}
    return combined


def weighted_score(scores: Dict[str, Any], weights: Dict[str, float]) -> float:
    """spaCy's final score: the weighted sum of the weighted scores, with
    None scores (no gold annotation) left out; with no weights at all, the
    mean of the numeric scores."""
    if not weights:
        vals = [v for v in scores.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]
        return float(np.mean(vals)) if vals else 0.0
    total = 0.0
    for key, weight in weights.items():
        if weight in (None, 0.0):
            continue
        value = scores.get(key)
        if value is None:
            continue
        total += float(value) * float(weight)
    return total


class TrainResult:
    def __init__(self):
        self.best_score: float = -1.0
        self.best_step: int = -1
        self.final_step: int = 0
        self.epoch: int = 0
        self.history: List[Dict[str, Any]] = []
        self.words_seen: int = 0
        self.seconds: float = 0.0
        #: per step of this run: its (B_pad, T_pad), its loss, the host
        #: seconds from taking the group to the optimizer step's return
        #: (enqueue, on the card), and on cuda a pair of CUDA events around
        #: the same span
        self.step_shapes: List[Tuple[int, int]] = []
        self.step_losses: List[float] = []
        #: per step, each trained head's loss (``{"tagger": ..., "parser": ...}``)
        self.step_head_losses: List[Dict[str, float]] = []
        self.step_host_seconds: List[float] = []
        self.step_events: List[Tuple[Any, Any]] = []
        #: per step, the host seconds of the annotating pass (its
        #: predictions synchronise with the card), outside the step's span
        self.annotate_seconds: List[float] = []
        #: stopped by a shutdown signal (at a step boundary)
        self.interrupted: bool = False
        #: a fleet worker's ledger
        self.fleet: Optional[Dict[str, Any]] = None

    @property
    def wps(self) -> float:
        return self.words_seen / self.seconds if self.seconds > 0 else 0.0


def _resolve_corpus(config: Config, corpora: Dict[str, Any], dot_name: str):
    parts = dot_name.split(".")
    if parts[0] != "corpora" or len(parts) != 2:
        raise ValueError(f"Unsupported dot name {dot_name!r}")
    if parts[1] not in corpora:
        raise ValueError(f"No [corpora.{parts[1]}] block in config")
    return corpora[parts[1]]


def _named_params(nlp: Pipeline) -> Dict[str, torch.nn.Parameter]:
    """The trainable tensors under their params.npz paths: every leaf of the
    models but the frozen ones (static-vector tables, persistent buffers),
    which the optimizer never sees. Raises unless the two sets together are
    the models' leaves."""
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    frozen = set(param_paths(nlp.model)) - set(params)
    wrong = sorted([k for k in params if _optimizers.is_frozen(k)]
                   + [k for k in frozen if not _optimizers.is_frozen(k)])
    if wrong:
        raise ValueError(f"leaves trained against their frozen_ marking: {wrong[:5]}")
    return params


def train(
    config: Config,
    output_path: Optional[Path] = None,
    *,
    device: DeviceLike = None,
    resume: bool = False,
    max_steps_override: Optional[int] = None,
    stdout_log: bool = True,
    fleet: Optional[Dict[str, Any]] = None,
    metrics_dir: Optional[Path] = None,
    metrics_port: Optional[int] = None,
) -> Tuple[Pipeline, TrainResult]:
    """Train the config's pipeline on one device (``cuda`` unless the caller
    asks for ``cpu``). Returns (pipeline, result). ``resume`` continues the
    newest intact generation in ``<output_path>/last-model``: one this loop
    wrote, or a trainer fleet's. ``metrics_dir`` and ``metrics_port``
    override ``[training] metrics_dir`` and ``metrics_port``. ``fleet``
    (``worker_id``, ``n_workers`` and the other keywords of
    :func:`~.fleet.worker.train_fleet_worker`) runs this process as one
    worker of a trainer fleet instead."""
    if fleet is not None:
        from .fleet.worker import train_fleet_worker

        return train_fleet_worker(config, output_path, device=device, resume=resume,
                                  max_steps_override=max_steps_override,
                                  stdout_log=stdout_log, metrics_dir=metrics_dir,
                                  metrics_port=metrics_port, **fleet)
    config = config.interpolate()
    T = resolve_training(config)
    dev = resolve_device(device)
    seed = int(T.get("seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    ignored = sorted(k for k in config.get("training", {}) if k in IGNORED_KNOBS)
    if ignored:
        logger.warning("[training] %s: multi-device, profiler, alerting and compiled-program "
                       "knobs, accepted and ignored on one device", ", ".join(ignored))

    # the fault plan of the environment (a relaunched child reads its own),
    # the retry policy of the knobs, and no event left over from an earlier
    # run in this process, before the first read
    resilience.activate_env_fault_plan()
    resilience.drain_events()
    resilience.set_default_retry_policy(resilience.RetryPolicy(
        max_retries=int(T["io_retries"]), base_delay=float(T["io_retry_base_s"])))
    tel = tel_http = None
    tel_dir = str(metrics_dir) if metrics_dir is not None else str(T["metrics_dir"] or "")
    tel_port = int(metrics_port if metrics_port is not None else T["metrics_port"] or 0)
    if not tel_dir and tel_port:
        log_event("telemetry-endpoint-skipped",
                  "--metrics-port/[training] metrics_port is set but telemetry is disabled "
                  "(no metrics_dir) — no endpoint started; set --metrics-dir/[training] "
                  "metrics_dir to enable it")
    if tel_dir:
        from .telemetry import Telemetry, warm_flop_counter

        tel = Telemetry(Path(tel_dir), trace_steps=tuple(T["trace_steps"]),
                        anomaly_detection=bool(T["anomaly_detection"]), device=dev)
        warm_flop_counter()  # before the watchdog's first window
        if tel_port > 0:
            from .telemetry_http import TelemetryHTTPServer

            tel_http = TelemetryHTTPServer(tel, host=str(T["metrics_host"]), port=tel_port)
            host, bound = tel_http.start()
            log_event("telemetry-endpoint", f"trainer telemetry on http://{host}:{bound} "
                      "(/metrics, /healthz, /trace)", level=logging.INFO, port=bound)
    try:
        return _train(config, T, dev, seed, output_path, resume, max_steps_override,
                      stdout_log, tel)
    finally:
        if tel_http is not None:
            tel_http.stop()
        if tel is not None:
            # a crashed run's rows and trace are the ones worth reading
            tel.finalize()


def _tspan(tel: Any, name: str, **args: Any):
    """A trace span when telemetry is on, else a free null context."""
    return nullcontext() if tel is None else tel.trace.span(name, cat="loop", **args)


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else seconds * 1e3


def _train(config: Config, T: Dict[str, Any], dev: torch.device, seed: int,
           output_path: Optional[Path], resume: bool, max_steps_override: Optional[int],
           stdout_log: bool, tel: Any) -> Tuple[Pipeline, TrainResult]:
    corpora = {name: registry.resolve(block)
               for name, block in config.get("corpora", {}).items()}
    train_corpus = _resolve_corpus(config, corpora, T["train_corpus"])
    dev_corpus = _resolve_corpus(config, corpora, T["dev_corpus"])

    nlp = Pipeline.from_config(config, device=dev)
    nlp.initialize(train_corpus, seed=seed)
    check_component_lists(nlp, T)
    annotating = list(T.get("annotating_components") or [])
    before_update = resolve_before_update(T)
    nlp.requires_grad_(True)
    params = _named_params(nlp)
    optimizer = registry.resolve(T.get("optimizer") or {"@optimizers": "Adam.v1"})
    if not isinstance(optimizer, _optimizers.Optimizer):
        raise TypeError("[training.optimizer] did not resolve to an optimizer")
    opt_state = optimizer.init(params)
    batcher = registry.resolve(T.get("batcher") or {
        "@batchers": "spacy.batch_by_words.v1", "size": 1000, "tolerance": 0.2})
    accum = max(int(T.get("accumulate_gradient") or 1), 1)
    dropout = float(T["dropout"])
    seeds = torch.Generator().manual_seed(seed)

    step = epoch = 0
    best_score, best_step = -1.0, -1
    resume_skip = 0
    last_dir = Path(output_path) / "last-model" if output_path is not None else None
    if resume and last_dir is not None:
        try:
            with _tspan(tel, "checkpoint_load"):
                ckpt = TrainCheckpoint.load(last_dir)
        except CheckpointCorrupt as e:
            log_event("resume-failed", f"--resume found no intact checkpoint generation ({e}); "
                      "starting from scratch")
            ckpt = None
        if ckpt is None:
            logger.warning("--resume: %s holds no checkpoint; starting from scratch", last_dir)
        else:
            nlp.load_params(ckpt["params"])
            optimizer.load_opt_state(opt_state, ckpt["opt_state"])
            step, epoch = ckpt["step"], ckpt["epoch"]
            best_score, best_step = ckpt["best_score"], ckpt["best_step"]
            extra = ckpt["extra"] or {}
            # a fleet generation keeps no seed_generator and no data position:
            # the lead's generator (the meta's rng) goes on, and the epoch
            # starts over, as JAX's loop does with its rng and a missing
            # batches_in_epoch (ROADMAP C54)
            set_generator_state(seeds, extra.get("seed_generator") or ckpt.get("rng"))
            resume_skip = int(extra.get("batches_in_epoch", 0))
            if extra.get("corpus_epoch") is not None and hasattr(train_corpus, "_epoch"):
                train_corpus._epoch = int(extra["corpus_epoch"])
            log_event("resume", f"resumed from checkpoint step {step} (epoch {epoch}, best "
                      f"{best_score:.4f} @ step {best_step})", level=logging.INFO,
                      step=step, epoch=epoch, fleet=extra.get("fleet") is not None)

    use_averages = bool(optimizer.use_averages)
    avg_params = ({k: p.detach().clone() for k, p in params.items()}
                  if use_averages else None)
    avg_count = 0
    if int(T.get("steps_per_dispatch") or 1) > 1 and (
            annotating or before_update is not None or use_averages):
        logger.info("steps-per-dispatch-bypass: steps_per_dispatch > 1 needs the host "
                    "between steps for annotating_components / before_update / "
                    "use_averages; running with K=1")

    logger_cfg = T.get("logger") or {"@loggers": "spacy_ray_tpu.ConsoleLogger.v1"}
    log_step, log_finalize = registry.resolve(logger_cfg)(
        nlp, sys.stdout if stdout_log else io.StringIO(), sys.stderr)
    dev_examples = list(dev_corpus())
    score_weights = dict(T.get("score_weights") or {}) or default_pipeline_score_weights(nlp)
    max_steps = int(max_steps_override or T["max_steps"] or 0)
    max_epochs = int(T["max_epochs"] or 0)
    eval_frequency = int(T["eval_frequency"] or 200)
    patience = int(T["patience"] or 0)
    keep = int(T.get("keep_checkpoints", 2) or 1)

    result = TrainResult()
    position = {"batches_in_epoch": 0, "corpus_epoch": 0}

    def batches_forever() -> Iterator[Tuple[int, List[Example]]]:
        nonlocal epoch
        skip = resume_skip
        while True:
            position["corpus_epoch"] = getattr(train_corpus, "_epoch", 0)
            got_any = False
            for b in batcher(train_corpus()):
                got_any = True
                position["batches_in_epoch"] += 1
                if skip > 0:  # resume fast-forward within the first epoch
                    skip -= 1
                    continue
                yield epoch, b
            if not got_any:
                raise ValueError("Training corpus is empty")
            skip = 0
            epoch += 1
            position["batches_in_epoch"] = 0
            if max_epochs and epoch >= max_epochs:
                return

    def groups() -> Iterator[Dict[str, Any]]:
        """One update's raw batches, their common padded shape and the data
        position after them; an incomplete last group ends the data."""
        it = batches_forever()
        while True:
            raw: List[List[Example]] = []
            cur_epoch = epoch
            try:
                for _ in range(accum):
                    cur_epoch, b = next(it)
                    raw.append(b)
            except StopIteration:
                return
            T_pad = bucket_length(max(max(len(eg) for eg in b) for b in raw),
                                  nlp.length_buckets)
            B_pad = bucket_batch_size(max(len(b) for b in raw))
            yield {"raw": raw, "B_pad": B_pad, "T_pad": T_pad, "epoch": cur_epoch,
                   **position}

    def swap_in(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Copy ``tree`` into the model's parameters; returns what was there."""
        old = {k: p.detach().clone() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(tree[k])
        return old

    last_saved = [step]

    def save_last(group: Dict[str, Any]) -> None:
        """The generation of the step just taken (once a step: an evaluation
        and a preemption at one step write it once)."""
        if step == last_saved[0]:
            return
        last_saved[0] = step
        TrainCheckpoint.save(
            last_dir, params=param_paths(nlp.model),  # the frozen tables too
            opt_state=opt_state, step=step, epoch=group["epoch"], best_score=best_score,
            best_step=best_step, keep=keep,
            extra={"batches_in_epoch": group["batches_in_epoch"],
                   "corpus_epoch": group["corpus_epoch"],
                   "seed_generator": seeds.get_state().tolist()},
        )

    def record_losses(loss_t: torch.Tensor, m: Dict[str, torch.Tensor],
                      poisoned: bool) -> None:
        """One step's losses to the host; a step a ``nan`` fault rule
        poisoned reports NaN, as the JAX loop's drain does (its training is
        untouched)."""
        nan = float("nan")
        result.step_losses.append(nan if poisoned else float(loss_t))
        result.step_head_losses.append(
            {k[5:]: nan if poisoned else float(v) for k, v in m.items()
             if k.startswith("loss_")})

    loss_accum: Dict[str, float] = {}
    pending: List[Tuple[torch.Tensor, Dict[str, torch.Tensor], bool]] = []
    words_since_log = 0
    start_time = last_log_time = time.perf_counter()
    use_events = dev.type == "cuda"
    group: Optional[Dict[str, Any]] = None
    last_batch: Dict[str, Any] = {}
    steps_run = 0
    stop = False

    def flops_fn() -> Optional[float]:
        """One step's FLOPs, probed on the step's last microbatch; a failed
        probe leaves ``flops_per_step`` and ``mfu`` null and says why."""
        from .telemetry import program_flops

        try:
            return program_flops(lambda: nlp.loss(last_batch["tokens"], last_batch["targets"],
                                                  dropout=dropout, seed=0)[0],
                                 params, n_micro=accum)
        except Exception as e:
            log_event("flops-probe-failed", f"the FLOP probe failed, so no mfu: "
                      f"{type(e).__name__}: {e}", step=step)
            return None

    watchdog: Optional[Watchdog] = None
    if float(T["watchdog_timeout_s"]) > 0:
        def watchdog_stats() -> Dict[str, Any]:
            if tel is not None:
                # the watchdog exits with os._exit right after its dump: the
                # rows and the trace are written now or never
                tel.emergency_flush()
            return {"step": step, **position}

        watchdog = Watchdog(float(T["watchdog_timeout_s"]), stats_fn=watchdog_stats)
    shutdown = ShutdownCoordinator().install()
    if watchdog is not None:
        watchdog.start()
    if tel is not None:
        tel.loop_start()
    try:
        for group in groups():
            if annotating:
                t_ann = time.perf_counter()
                for b in group["raw"]:
                    shells = [eg.reference.copy_shell() for eg in b]
                    nlp.predict_docs(shells, annotate=annotating)
                    for eg, shell in zip(b, shells):
                        eg.predicted = shell
                result.annotate_seconds.append(time.perf_counter() - t_ann)
            if before_update is not None:
                before_update(nlp, {"step": step, "epoch": group["epoch"]})
            # the step site: an error rule crashes here, sigterm preempts at
            # this step, nan poisons its reported loss
            maybe_fail("step")
            poisoned = resilience.consume_poison("step")
            t_host = time.perf_counter()
            if use_events:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            for p in params.values():
                if p.grad is not None:
                    p.grad.zero_()
            micro_losses = []
            micro_metrics: List[Dict[str, torch.Tensor]] = []
            n_words = 0
            for b in group["raw"]:
                maybe_fail("collate")
                batch = nlp.collate(b, with_targets=True, pad_batch_to=group["B_pad"],
                                    pad_len_to=group["T_pad"])
                n_words += batch["n_words"]
                mseed = int(torch.randint(0, 2 ** 62, (1,), generator=seeds))
                loss, metrics = nlp.loss(batch["tokens"], batch["targets"], dropout=dropout,
                                         seed=mseed)
                loss.backward()
                micro_losses.append(loss.detach())
                micro_metrics.append(metrics)
            last_batch = batch
            grads = {}
            for k, p in params.items():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads[k] = p.grad
            if accum > 1:
                torch._foreach_div_(list(grads.values()), float(accum))
            with torch.no_grad():
                grad_norm = optimizer.update(params, grads, opt_state)
            loss = torch.stack(micro_losses).mean()
            metrics = {k: torch.stack([m[k] for m in micro_metrics]).mean()
                       for k in micro_metrics[0]}
            metrics["grad_norm"] = grad_norm
            if use_events:
                ev[1].record()
                result.step_events.append(ev)
            result.step_host_seconds.append(time.perf_counter() - t_host)
            result.step_shapes.append((group["B_pad"], group["T_pad"]))
            pending.append((loss, metrics, poisoned))
            step += 1
            steps_run += 1
            if use_averages:
                avg_count += 1
                _optimizers.average_step(list(avg_params.values()),
                                         [p.detach() for p in params.values()], avg_count)
            result.words_seen += n_words
            words_since_log += n_words
            if tel is not None:
                tel.step_boundary(step=step, epoch=group["epoch"], n_words=n_words,
                                  steps_run=steps_run)

            info: Optional[Dict[str, Any]] = None
            if step % eval_frequency == 0:
                for loss_t, m, poison in pending:
                    record_losses(loss_t, m, poison)
                    for key, value in result.step_head_losses[-1].items():
                        loss_accum[key] = loss_accum.get(key, 0.0) + value
                pending.clear()
                backup = swap_in(avg_params) if use_averages else None
                eval_t0 = time.perf_counter()
                scores, eval_wps = nlp.evaluate_timed(dev_examples)
                eval_seconds = time.perf_counter() - eval_t0
                score = weighted_score(scores, score_weights)
                now = time.perf_counter()
                wps = words_since_log / max(now - last_log_time, 1e-9)
                last_log_time, words_since_log = now, 0
                info = {"epoch": group["epoch"], "step": step, "words": result.words_seen,
                        "losses": dict(loss_accum), "other_scores": scores, "score": score,
                        "wps": wps, "eval_seconds": eval_seconds, "eval_wps": eval_wps,
                        "grad_norm": float(metrics["grad_norm"])}
                if tel is not None:
                    tel.trace.add_span("eval", eval_t0, eval_seconds, cat="loop",
                                       args={"step": step}, force=True)
                    info["telemetry"] = tel.eval_boundary(
                        step=step, epoch=group["epoch"], steps_run=steps_run,
                        losses=dict(loss_accum), score=score, eval_seconds=eval_seconds,
                        flops_fn=flops_fn, wps=wps)
                    info["step_ms_p50"] = _ms(info["telemetry"]["step_seconds_p50"])
                    info["step_ms_p95"] = _ms(info["telemetry"]["step_seconds_p95"])
                result.history.append(info)
                loss_accum = {}
                if score > best_score:
                    best_score, best_step = score, step
                    if output_path is not None:
                        with _tspan(tel, "checkpoint_save", kind="best", step=step):
                            nlp.to_disk(Path(output_path) / "best-model")
                if backup is not None:
                    swap_in(backup)
                if last_dir is not None:
                    with _tspan(tel, "checkpoint_save", kind="last", step=step):
                        save_last(group)
                if tel is not None:
                    # evaluation and checkpoints are not the next step's time
                    tel.rearm_step_clock()
            log_step(info)
            if watchdog is not None:
                watchdog.beat()
            if max_steps and step >= max_steps:
                stop = True
            if patience and best_step >= 0 and (step - best_step) >= patience:
                stop = True
            # the preemption poll, after the step: its generation is this step's
            if not stop and shutdown.requested:
                if last_dir is not None:
                    with _tspan(tel, "preemption_drain", step=step):
                        save_last(group)
                result.interrupted = True
                log_event("preempted", f"shutdown signal at step {step} — checkpoint written at "
                          "the step boundary; resume with --resume", step=step)
                stop = True
            if stop:
                break
    finally:
        if watchdog is not None:
            watchdog.stop()
        shutdown.restore()

    for loss_t, m, poison in pending:
        record_losses(loss_t, m, poison)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.seconds = time.perf_counter() - start_time
    result.best_score, result.best_step = best_score, best_step
    result.final_step = step
    result.epoch = group["epoch"] if (stop and group is not None) else epoch
    nlp.requires_grad_(False)
    if output_path is not None:
        nlp.to_disk(Path(output_path) / "last-model")
    log_finalize()
    return nlp, result
