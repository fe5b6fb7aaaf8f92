"""Trunk pretraining: the ``pretrain`` command and the ``[pretraining]``
config block (counterpart of ``spacy_ray_tpu/training/pretrain.py``; spaCy's
``spacy pretrain``).

* ``characters`` objective (the default): from each token's trunk vector,
  predict its first ``n_characters`` and last ``n_characters`` UTF-8 bytes,
  as ``2 * n_characters`` independent 257-way softmaxes (256 byte values and
  one "absent" class for a token shorter than the window), averaged over the
  real tokens. The head is a Linear, or a Maxout of ``hidden_size`` and a
  Linear (spaCy's characters head).
* ``vectors`` objective: predict each token's static vector (``[initialize]
  vectors``), cosine or L2, averaged over the real tokens that have one.

On one device a step is autograd, then the optimizer the block names
(``Adam.v1``: the fused update, K5 on the card); the trunk's own dropout
acts, as in training. The corpus's raw-text lines are read with the
pipeline's tokenizer (``corpus.use_raw_text_tokenizer``).

Output, in the output directory: ``model-last.npz`` (and ``model-{step}.npz``
every ``n_save_every`` steps), the trunk's parameters and persistent buffers
alone (a static-vector trunk's ``frozen_table`` too) in the flat-npz layout
of ``training/checkpoint.py``, which ``[initialize] init_tok2vec`` of either
package loads; and ``log.jsonl``, one line a step (loss, metrics, words, the
step's host seconds and, on the card, its CUDA-event ms), written at each
console line and at the end, so that the steps between run without a sync.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..devices import DeviceLike, resolve_device
from ..models.core import Chain, Context, Model, call, param_paths
from ..models.layers import Linear, Maxout
from ..pipeline.doc import Example
from ..pipeline.language import Pipeline, resolve_config_path
from ..pipeline.vectors import Vectors, use_vectors
from ..registry import registry
from ..types import Padded, TokenBatch
from .checkpoint import save_params
from .corpus import Corpus, use_raw_text_tokenizer
from .loop import _resolve_corpus
from .optimizers import Optimizer

N_BYTE_CLASSES = 257  # 256 byte values + "absent" (a token shorter than the window)
LOG_EVERY = 50  # a console line (and the log's lines so far) every this many steps

LossFn = Callable[[TokenBatch, Dict[str, torch.Tensor], Context],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def char_targets(examples: List[Any], B: int, T: int, n: int) -> np.ndarray:
    """[B, T, 2n] int32: the first n and last n UTF-8 bytes of each token
    (byte value + 1; 0 = absent). Cached per Example, as corpora yield the
    same Examples every epoch."""
    out = np.zeros((B, T, 2 * n), dtype=np.int32)
    for i, eg in enumerate(examples[:B]):
        cached = getattr(eg, "_char_cache", None)
        if cached is None or cached.shape[1] != 2 * n:
            words = eg.reference.words
            cached = np.zeros((len(words), 2 * n), dtype=np.int32)
            for j, w in enumerate(words):
                bs = w.encode("utf8")
                head, tail = bs[:n], bs[-n:]
                cached[j, : len(head)] = np.frombuffer(head, np.uint8) + 1
                cached[j, n: n + len(tail)] = np.frombuffer(tail, np.uint8).astype(np.int32) + 1
            try:
                eg._char_cache = cached
            except AttributeError:  # an Example with __slots__: no cache
                pass
        L = min(len(cached), T)
        out[i, :L] = cached[:L]
    return out


def build_char_head(width: int, n_characters: int, hidden: int = 0) -> Model:
    """Trunk vector -> [..., 2n * 257] logits: a Maxout hidden layer and a
    Linear when ``hidden`` > 0, a Linear alone otherwise."""
    n_out = 2 * n_characters * N_BYTE_CLASSES
    if hidden:
        return Chain(Maxout(width, hidden), Linear(hidden, n_out), name="char_head")
    return Linear(width, n_out, name="char_head")


def make_char_loss(trunk: Model, head: Model, n_characters: int) -> LossFn:
    """``loss_fn(tokens, targets, ctx) -> (loss, {"char_acc"})``: the masked
    mean softmax cross-entropy over the 2n byte slots of each real token."""

    def loss_fn(tokens, targets, ctx):
        enc: Padded = trunk(tokens, ctx=ctx)
        logits = call(head, enc, ctx).X
        B, T, _ = logits.shape
        logits = logits.reshape(B, T, 2 * n_characters, N_BYTE_CLASSES)
        tgt = targets["chars"].long()
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, tgt[..., None])[..., 0]
        mask = enc.mask.float()[..., None]
        denom = torch.clamp(mask.sum() * 2 * n_characters, min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logp.argmax(-1) == tgt).float() * mask).sum() / denom
        return loss, {"char_acc": acc.detach()}

    return loss_fn


def make_vector_loss(trunk: Model, head: Model, loss_kind: str) -> LossFn:
    """``loss_fn(tokens, targets, ctx) -> (loss, {})``: cosine (``"cosine"``)
    or squared L2 distance to each token's static vector, averaged over the
    real tokens that have one (``targets["has_vec"]``)."""

    def loss_fn(tokens, targets, ctx):
        enc: Padded = trunk(tokens, ctx=ctx)
        pred = call(head, enc, ctx).X.float()
        tgt = targets["vectors"].float()
        mask = (enc.mask & targets["has_vec"]).float()
        if loss_kind == "cosine":
            pn = pred / torch.clamp(pred.norm(dim=-1, keepdim=True), min=1e-8)
            tn = tgt / torch.clamp(tgt.norm(dim=-1, keepdim=True), min=1e-8)
            per_tok = 1.0 - (pn * tn).sum(-1)
        else:  # L2
            per_tok = (pred - tgt).square().sum(-1)
        loss = (per_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {}

    return loss_fn


def _vector_targets(nlp: Pipeline, examples: List[Example], B: int, T: int
                    ) -> Dict[str, np.ndarray]:
    """[B, T, D] static vectors and [B, T] has-a-vector of the docs' tokens
    (the rows the collate looks up, cached per Example)."""
    table = nlp.vectors.table
    vecs = np.zeros((B, T, table.shape[1]), dtype=np.float32)
    has = np.zeros((B, T), dtype=bool)
    for i, eg in enumerate(examples[:B]):
        rows = nlp._vector_rows(eg)[:T]
        found = rows >= 0
        vecs[i, :len(rows)][found] = table[rows[found]]
        has[i, :len(rows)] = found
    return {"vectors": vecs, "has_vec": has}


def _batches(corpus: Corpus, size: int) -> Iterator[List[Any]]:
    buf: List[Any] = []
    for eg in corpus():
        buf.append(eg)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


class Pretraining:
    """What a ``[pretraining]`` block builds on a device: the pipeline (its
    tokenizer, vocab and vectors collate the batches), the trunk component's
    model and the objective's head with their parameters drawn from
    ``torch.Generator(seed)`` (trunk first), the loss, the corpus and the
    optimizer."""

    def __init__(self, config: Config, device: DeviceLike = None):
        config = config.interpolate()
        P = dict(config.get("pretraining") or {})
        if not P:
            raise ValueError("Config has no [pretraining] block")
        self.settings = P
        nlp = Pipeline.from_config(config, device=device)
        comp_name = P.get("component") or nlp.tok2vec_name
        if comp_name is None or comp_name not in nlp.components:
            raise ValueError(
                f"[pretraining] component {comp_name!r} not in pipeline "
                f"{nlp.pipe_names} (and no tok2vec/transformer trunk found)"
            )
        # [initialize] vectors first: the trunk may embed static vectors
        vec_path = (config.get("initialize", {}) or {}).get("vectors")
        if vec_path and nlp.vectors is None:
            nlp.vectors = Vectors.from_disk(resolve_config_path(config, vec_path))
        with use_vectors(nlp.vectors):
            trunk = nlp.components[comp_name].build_model()
        width = trunk.dims.get("nO")
        if not width:
            raise ValueError(f"trunk {comp_name!r} does not expose an output width")

        corpora = {name: registry.resolve(block)
                   for name, block in config.get("corpora", {}).items()}
        self.corpus = _resolve_corpus(config, corpora, P.get("corpus", "corpora.pretrain"))

        obj = dict(P.get("objective") or {})
        self.objective = obj.get("type", "characters")
        self.n_characters = int(obj.get("n_characters", 4))
        if self.objective == "characters":
            head = build_char_head(width, self.n_characters,
                                   hidden=int(obj.get("hidden_size", 0)))
            self.loss_fn = make_char_loss(trunk, head, self.n_characters)
        elif self.objective == "vectors":
            if nlp.vectors is None:
                raise ValueError("objective type 'vectors' needs [initialize] vectors")
            head = Linear(width, nlp.vectors.width, name="vec_head")
            self.loss_fn = make_vector_loss(trunk, head, obj.get("loss", "cosine"))
        else:
            raise ValueError(f"Unknown [pretraining.objective] type {self.objective!r}")

        generator = torch.Generator().manual_seed(int(P.get("seed", 0)))
        trunk.init_parameters(generator)
        head.init_parameters(generator)
        self.nlp, self.comp_name = nlp, comp_name
        self.trunk, self.head = trunk.to(nlp.device), head.to(nlp.device)
        opt_cfg = dict(P.get("optimizer") or {})
        opt_cfg.setdefault("@optimizers", "Adam.v1")
        self.optimizer = registry.resolve(opt_cfg)
        if not isinstance(self.optimizer, Optimizer):
            raise TypeError("[pretraining.optimizer] did not resolve to an optimizer")

    def params(self) -> Dict[str, torch.nn.Parameter]:
        """The trained leaves as ``trunk/<path>`` and ``head/<path>`` (the
        JAX package's ``{"trunk", "head"}`` tree); buffers are not leaves."""
        return {f"{part}/{k.replace('.', '/')}": p
                for part, model in (("trunk", self.trunk), ("head", self.head))
                for k, p in model.named_parameters()}

    def batch(self, examples: List[Example]
              ) -> Tuple[TokenBatch, Dict[str, torch.Tensor], int]:
        """(tokens, targets, words) of one batch, on the device, padded to
        the batch's own size and its length bucket."""
        b = self.nlp.collate(examples, pad_batch_to=len(examples))
        tokens = b["tokens"]
        B, T = tokens.mask.shape
        if self.objective == "characters":
            host = {"chars": char_targets(examples, B, T, self.n_characters).astype(np.int64)}
        else:
            host = _vector_targets(self.nlp, examples, B, T)
        targets = {k: torch.from_numpy(v).to(self.nlp.device) for k, v in host.items()}
        return tokens, targets, int(b["n_words"])

    def save(self, path: Path) -> None:
        save_params(path, param_paths(self.trunk))


def pretrain(config: Config, output_dir: Path, *, device: DeviceLike = None,
             n_workers: Optional[int] = None) -> Dict[str, Any]:
    """Run the config's ``[pretraining]`` block on one device (``cuda``
    unless the caller asks for ``cpu``) and write the trunk's weights to
    ``output_dir``. Returns steps, epochs, the last loss, words and the
    output file."""
    if n_workers is not None and int(n_workers) > 1:
        raise NotImplementedError(
            "pretrain --n-workers > 1 (data parallelism over several cards) is "
            "not ported yet: it comes with slice 7, multi-GPU (ROADMAP)"
        )
    dev = resolve_device(device)
    run = Pretraining(config, dev)
    P = run.settings
    max_steps = int(P.get("max_steps", 1000))
    max_epochs = int(P.get("max_epochs", 0))
    batch_size = int(P.get("batch_size", 64))
    n_save_every = int(P.get("n_save_every", 0))
    if float(P.get("dropout", 0.0)):
        print(
            "# [pretraining] dropout is taken from the component's own model "
            "config here (the trunk applies its configured dropout when "
            "training); the standalone key is ignored",
            flush=True,
        )
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    log_path = output_dir / "log.jsonl"
    log_path.write_text("")

    params = run.params()
    for p in params.values():
        p.requires_grad_(True)
    opt_state = run.optimizer.init(params)
    seeds = torch.Generator().manual_seed(int(P.get("seed", 0)))
    use_events = dev.type == "cuda"
    pending: List[Dict[str, Any]] = []

    def flush() -> float:
        """Write the pending steps to the log; the last one's loss."""
        with open(log_path, "a", encoding="utf8") as f:
            for rec in pending:
                row = {k: v for k, v in rec.items() if k not in ("loss", "metrics", "events")}
                row["loss"] = float(rec["loss"])
                row.update({k: float(v) for k, v in rec["metrics"].items()})
                if rec["events"] is not None:
                    row["step_ms_events"] = rec["events"][0].elapsed_time(rec["events"][1])
                f.write(json.dumps(row) + "\n")
        last = float(pending[-1]["loss"])
        pending.clear()
        return last

    n_step = epoch = total_words = 0
    loss_val = float("nan")
    t0 = time.perf_counter()
    done = False
    with use_raw_text_tokenizer(run.nlp.tokenizer):
        while not done:
            epoch += 1
            for examples in _batches(run.corpus, batch_size):
                t_host = time.perf_counter()
                ev = None
                if use_events:
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                tokens, targets, n_words = run.batch(examples)
                ctx = Context(train=True, seed=int(torch.randint(0, 2 ** 62, (1,),
                                                                 generator=seeds)))
                for p in params.values():
                    p.grad = None
                loss, metrics = run.loss_fn(tokens, targets, ctx)
                loss.backward()
                grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for k, p in params.items()}
                with torch.no_grad():
                    run.optimizer.update(params, grads, opt_state)
                if ev is not None:
                    ev[1].record()
                n_step += 1
                total_words += n_words
                pending.append({"step": n_step, "epoch": epoch, "words": n_words,
                                "loss": loss.detach(), "metrics": metrics, "events": ev,
                                "step_s_host": time.perf_counter() - t_host})
                if n_step % LOG_EVERY == 0 or n_step == 1:
                    extra = "".join(f"  {k}={float(v):.3f}" for k, v in metrics.items())
                    loss_val = flush()
                    wps = total_words / max(time.perf_counter() - t0, 1e-9)
                    print(f"pretrain step {n_step:>6}  loss={loss_val:.4f}{extra}  "
                          f"wps={wps:,.0f}", flush=True)
                if n_save_every and n_step % n_save_every == 0:
                    run.save(output_dir / f"model-{n_step}.npz")
                if n_step >= max_steps:
                    done = True
                    break
            if n_step == 0:
                raise ValueError(
                    "pretraining corpus yielded no batches (empty file, or "
                    "max_length filtered every text); nothing to train on"
                )
            if max_epochs and epoch >= max_epochs:
                done = True
    if pending:
        loss_val = flush()
    for p in params.values():
        p.requires_grad_(False)
    run.save(output_dir / "model-last.npz")
    return {"steps": n_step, "epochs": epoch, "loss": loss_val, "words": total_words,
            "seconds": time.perf_counter() - t0, "output": str(output_dir / "model-last.npz")}
