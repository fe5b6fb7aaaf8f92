"""The training loop on one device: config-driven train-while-improving.

Counterpart of ``spacy_ray_tpu/training/loop.py`` with the semantics that
matter on one device:

* ``[training]`` is validated against the JAX package's key surface
  (:data:`DEFAULT_TRAINING`); knobs that only shape multiple devices,
  telemetry, resilience or compiled programs are accepted and ignored, and
  a run says once which of them its config set;
* labels are collected from the train corpus at initialize;
* an update takes ``accumulate_gradient`` raw batches, each padded to the
  group's common ``(B_pad, T_pad)`` bucket; the gradient is the mean of the
  microbatch gradients and the loss the mean of their losses; a short last
  group ends the data;
* the optimizer step reports the gradients' global norm (``grad_norm``);
* ``eval_frequency``, ``patience``, ``max_steps`` and ``max_epochs``,
  best-model selection by the weighted score, ``use_averages``, and
  ``steps_per_dispatch`` (run as that many single steps, which the JAX
  package proves identical);
* ``best-model/`` and ``last-model/`` written with ``Pipeline.to_disk``, and
  ``last-model/`` also holding the training generations ``--resume``
  continues from (``training/checkpoint.py``).

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
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..devices import DeviceLike, resolve_device
from ..pipeline.doc import Example
from ..pipeline.language import Pipeline
from ..registry import registry
from . import corpus as _corpus  # noqa: F401  (registers readers)
from . import loggers as _loggers  # noqa: F401  (registers loggers)
from . import optimizers as _optimizers
from .batcher import bucket_batch_size, bucket_length
from .checkpoint import CheckpointCorrupt, TrainCheckpoint

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
#: knobs of the JAX loop that shape multiple devices, telemetry, resilience,
#: the fleet or compiled programs: validated, then ignored on one device
IGNORED_KNOBS = (
    "zero1", "update_sharding", "mesh", "prefetch_batches", "collate_workers",
    "collate_cache_mb", "watchdog_timeout_s", "io_retries", "io_retry_base_s",
    "profile_window", "metrics_dir", "trace_steps", "metrics_port", "metrics_host",
    "anomaly_detection", "alerting", "incident_dir", "fused_update", "bf16_shadow",
    "fleet_peer_timeout_s", "fleet_probe_timeout_s",
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
    for key in ("frozen_components", "annotating_components"):
        if raw.get(key):
            raise NotImplementedError(f"[training] {key} is not ported yet")
    if raw.get("before_update"):
        raise NotImplementedError("[training.before_update] is not ported yet")
    t = dict(DEFAULT_TRAINING)
    t.update(raw)
    return t


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
    """The trainable tensors under their params.npz paths."""
    return {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}


def train(
    config: Config,
    output_path: Optional[Path] = None,
    *,
    device: DeviceLike = None,
    resume: bool = False,
    max_steps_override: Optional[int] = None,
    stdout_log: bool = True,
) -> Tuple[Pipeline, TrainResult]:
    """Train the config's pipeline on one device (``cuda`` unless the caller
    asks for ``cpu``). Returns (pipeline, result)."""
    config = config.interpolate()
    T = resolve_training(config)
    dev = resolve_device(device)
    seed = int(T.get("seed") or 0)
    random.seed(seed)
    np.random.seed(seed)
    ignored = sorted(k for k in config.get("training", {}) if k in IGNORED_KNOBS)
    if ignored:
        logger.warning("[training] %s: multi-device, telemetry and resilience knobs, "
                       "accepted and ignored on one device", ", ".join(ignored))

    corpora = {name: registry.resolve(block)
               for name, block in config.get("corpora", {}).items()}
    train_corpus = _resolve_corpus(config, corpora, T["train_corpus"])
    dev_corpus = _resolve_corpus(config, corpora, T["dev_corpus"])

    nlp = Pipeline.from_config(config, device=dev)
    nlp.initialize(train_corpus, seed=seed)
    nlp.model.requires_grad_(True)
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
            ckpt = TrainCheckpoint.load(last_dir)
        except CheckpointCorrupt as e:
            logger.warning("--resume found no intact checkpoint generation (%s); "
                           "starting from scratch", e)
            ckpt = None
        if ckpt is None:
            logger.warning("--resume: %s holds no checkpoint; starting from scratch", last_dir)
        else:
            nlp.load_params(ckpt["params"])
            optimizer.load_opt_state(opt_state, ckpt["opt_state"])
            step, epoch = ckpt["step"], ckpt["epoch"]
            best_score, best_step = ckpt["best_score"], ckpt["best_step"]
            extra = ckpt["extra"]
            seeds.set_state(torch.tensor(extra["seed_generator"], dtype=torch.uint8))
            resume_skip = int(extra.get("batches_in_epoch", 0))
            if extra.get("corpus_epoch") is not None and hasattr(train_corpus, "_epoch"):
                train_corpus._epoch = int(extra["corpus_epoch"])
            logger.info("resumed from checkpoint step %d (epoch %d, best %.4f @ step %d)",
                        step, epoch, best_score, best_step)

    use_averages = bool(optimizer.use_averages)
    avg_params = ({k: p.detach().clone() for k, p in params.items()}
                  if use_averages else None)
    avg_count = 0

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

    def save_last(group: Dict[str, Any]) -> None:
        TrainCheckpoint.save(
            last_dir, params={k: p.detach() for k, p in params.items()},
            opt_state=opt_state, step=step, epoch=group["epoch"], best_score=best_score,
            best_step=best_step, keep=keep,
            extra={"batches_in_epoch": group["batches_in_epoch"],
                   "corpus_epoch": group["corpus_epoch"],
                   "seed_generator": seeds.get_state().tolist()},
        )

    def record_losses(loss_t: torch.Tensor, m: Dict[str, torch.Tensor]) -> None:
        result.step_losses.append(float(loss_t))
        result.step_head_losses.append(
            {k[5:]: float(v) for k, v in m.items() if k.startswith("loss_")})

    loss_accum: Dict[str, float] = {}
    pending: List[Tuple[torch.Tensor, Dict[str, torch.Tensor]]] = []
    words_since_log = 0
    start_time = last_log_time = time.perf_counter()
    use_events = dev.type == "cuda"
    group: Optional[Dict[str, Any]] = None
    stop = False
    for group in groups():
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
            batch = nlp.collate(b, with_targets=True, pad_batch_to=group["B_pad"],
                                pad_len_to=group["T_pad"])
            n_words += batch["n_words"]
            mseed = int(torch.randint(0, 2 ** 62, (1,), generator=seeds))
            loss, metrics = nlp.loss(batch["tokens"], batch["targets"], dropout=dropout,
                                     seed=mseed)
            loss.backward()
            micro_losses.append(loss.detach())
            micro_metrics.append(metrics)
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
        pending.append((loss, metrics))
        step += 1
        if use_averages:
            avg_count += 1
            _optimizers.average_step(list(avg_params.values()),
                                     [p.detach() for p in params.values()], avg_count)
        result.words_seen += n_words
        words_since_log += n_words

        info: Optional[Dict[str, Any]] = None
        if step % eval_frequency == 0:
            for loss_t, m in pending:
                record_losses(loss_t, m)
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
            result.history.append(info)
            loss_accum = {}
            if score > best_score:
                best_score, best_step = score, step
                if output_path is not None:
                    nlp.to_disk(Path(output_path) / "best-model")
            if backup is not None:
                swap_in(backup)
            if last_dir is not None:
                save_last(group)
        log_step(info)
        if max_steps and step >= max_steps:
            stop = True
        if patience and best_step >= 0 and (step - best_step) >= patience:
            stop = True
        if stop:
            break

    for loss_t, m in pending:
        record_losses(loss_t, m)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    result.seconds = time.perf_counter() - start_time
    result.best_score, result.best_step = best_score, best_step
    result.final_step = step
    result.epoch = group["epoch"] if (stop and group is not None) else epoch
    nlp.model.requires_grad_(False)
    if output_path is not None:
        nlp.to_disk(Path(output_path) / "last-model")
    log_finalize()
    return nlp, result
