"""Pipeline: the ``nlp`` object, built from ``config.cfg`` (counterpart of
``spacy_ray_tpu/pipeline/language.py``).

It resolves the components, initializes or loads their parameters onto one
device, lowers examples to bucket-shaped padded batches (with the heads'
targets for training), runs the trunk once per batch and feeds every
listening head, sums the heads' losses, and decodes and scores the outputs.
``to_disk``/``from_disk`` use the JAX package's on-disk layout
(``config.cfg``, ``meta.json``, a flat ``params.npz`` keyed by parameter
path), so a model directory written by either package loads in both.
"""

from __future__ import annotations

import itertools
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import __version__
from ..config import Config
from ..devices import DeviceLike, resolve_device
from ..models.core import Context, fold_in, param_paths
from ..registry import registry
from ..training import checkpoint
from ..training.batcher import DEFAULT_LENGTH_BUCKETS, bucket_batch_size, bucket_length
from ..types import TokenBatch
from .components.base import Component
from .components.tok2vec import Tok2VecComponent
from .doc import Doc, Example
from .tokenizer import Tokenizer
from .vocab import ATTRS, Vocab

#: examples read from the train corpus to collect labels at initialize
LABEL_SAMPLE_LIMIT = 10000


class Pipeline:
    def __init__(self, lang: str, components: Dict[str, Component],
                 pipe_names: List[str], config: Config, device: torch.device):
        self.lang = lang
        self.vocab = Vocab()
        self.tokenizer = Tokenizer()
        self.components = components
        self.pipe_names = pipe_names
        self.config = config
        self.device = device
        self.length_buckets: Sequence[int] = DEFAULT_LENGTH_BUCKETS
        self.model: Optional[nn.ModuleDict] = None  # set by initialize/from_disk

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, config: Config, device: DeviceLike = None) -> "Pipeline":
        """Build the pipeline skeleton from an interpolated config. The
        device defaults to ``cuda`` and raises when no card is present."""
        dev = resolve_device(device)
        nlp_cfg = config.get("nlp", {})
        pipe_names = list(nlp_cfg.get("pipeline", []))
        comp_cfgs = config.get("components", {})
        components: Dict[str, Component] = {}
        for name in pipe_names:
            if name not in comp_cfgs:
                raise ValueError(f"Pipeline names component {name!r} but no [components.{name}]")
            block = dict(comp_cfgs[name])
            if "source" in block:
                raise NotImplementedError(
                    f"[components.{name}] source = ...: sourced components are not ported yet"
                )
            factory_name = block.pop("factory", None)
            if factory_name is None:
                raise ValueError(f"[components.{name}] missing 'factory'")
            model_cfg = block.pop("model", None)
            if model_cfg is None:
                raise ValueError(f"[components.{name}] missing model block")
            factory = registry.get("factories", factory_name)
            components[name] = factory(name=name, model=model_cfg, **block)
        return cls(nlp_cfg.get("lang", "en"), components, pipe_names, config, dev)

    @property
    def tok2vec_name(self) -> Optional[str]:
        for name in self.pipe_names:
            if isinstance(self.components[name], Tok2VecComponent):
                return name
        return None

    def head_names(self) -> List[str]:
        return [n for n in self.pipe_names if n != self.tok2vec_name]

    def _build_models(self) -> nn.ModuleDict:
        return nn.ModuleDict({n: self.components[n].build_model() for n in self.pipe_names})

    # ------------------------------------------------------------------
    # Initialization and parameters
    # ------------------------------------------------------------------
    def initialize(
        self,
        get_examples: Optional[Callable[[], Iterable[Example]]] = None,
        *,
        labels: Optional[Dict[str, List[str]]] = None,
        seed: int = 0,
    ) -> Dict[str, Any]:
        """Set labels, build the models and draw their parameters.

        ``labels`` maps a component to its label list, used as given (in
        final order); otherwise labels are collected from the first 10 000
        examples of ``get_examples``.
        Parameters are drawn on the CPU from ``torch.Generator(seed)``, in
        pipeline order, then moved to the device, so a seed gives the same
        weights on every device."""
        labels = labels or {}
        sample = (list(itertools.islice(get_examples(), LABEL_SAMPLE_LIMIT))
                  if get_examples is not None else [])
        for name in self.pipe_names:
            comp = self.components[name]
            if name in labels:
                comp.labels = list(labels[name])
            elif sample:
                comp.add_labels_from(sample)
                comp.finish_labels()
        generator = torch.Generator().manual_seed(seed)
        model = self._build_models()
        for name in self.pipe_names:
            model[name].init_parameters(generator)
        self.model = model.to(self.device).eval()
        return self.params

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested dict of leaves (the
        tensors themselves, not copies)."""
        assert self.model is not None, "Pipeline not initialized"
        return checkpoint.unflatten(param_paths(self.model))

    def load_params(self, flat: Dict[str, Any]) -> None:
        """Load a flat ``{path: array}`` tree in the JAX package's naming
        (``transformer/layer_3/qkv_W``) into the built models. Every path
        and shape must match."""
        assert self.model is not None, "build the models first"
        have = param_paths(self.model)
        missing = sorted(set(have) - set(flat))
        extra = sorted(set(flat) - set(have))
        bad = sorted(k for k in set(have) & set(flat)
                     if tuple(np.shape(flat[k])) != tuple(have[k].shape))
        if missing or extra or bad:
            raise ValueError(
                f"params do not match the pipeline's models (missing: {missing[:5]}, "
                f"unexpected: {extra[:5]}, shape-mismatched: {bad[:5]})"
            )
        with torch.no_grad():
            for k, t in have.items():
                t.copy_(torch.from_numpy(np.array(flat[k], dtype=np.float32)))

    # ------------------------------------------------------------------
    # Collation: docs -> bucket-shaped device batch
    # ------------------------------------------------------------------
    def collate(
        self,
        examples: List[Example],
        *,
        with_targets: bool = False,
        pad_batch_to: Optional[int] = None,
        pad_len_to: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Lower ragged Examples into a padded batch on the device; with
        ``with_targets`` also each head's targets from the gold docs, as
        ``{component: {name: tensor}}`` under ``"targets"``."""
        lengths = [len(eg) for eg in examples]
        T = pad_len_to or bucket_length(max(lengths, default=1), self.length_buckets)
        B = pad_batch_to or bucket_batch_size(len(examples))
        attr_keys = np.zeros((B, T, len(ATTRS), 2), dtype=np.uint32)
        mask = np.zeros((B, T), dtype=bool)
        words = [w for eg in examples for w in eg.reference.words]
        feats = self.vocab.featurize(words)
        offset = 0
        for i, eg in enumerate(examples):
            n = len(eg.reference.words)
            k = min(n, T)
            attr_keys[i, :k] = feats[offset:offset + k]
            mask[i, :k] = True
            offset += n
        tokens = TokenBatch(
            attr_keys=torch.from_numpy(attr_keys.astype(np.int64)).to(self.device),
            mask=torch.from_numpy(mask).to(self.device),
        )
        batch = {"tokens": tokens, "n_words": int(sum(min(l, T) for l in lengths)),
                 "lengths": lengths}
        if with_targets:
            targets: Dict[str, Dict[str, torch.Tensor]] = {}
            for name in self.head_names():
                t = self.components[name].make_targets(examples, B, T)
                if t:
                    targets[name] = {
                        k: torch.from_numpy(v).to(self.device) for k, v in t.items()
                    }
            batch["targets"] = targets
        return batch

    # ------------------------------------------------------------------
    # Forward and prediction
    # ------------------------------------------------------------------
    def loss(self, tokens: TokenBatch, targets: Dict[str, Any], *,
             dropout: Optional[float] = None, seed: Optional[int] = None):
        """(total loss, metrics) of one batch in training mode: the trunk once,
        then each trainable head with targets on its output, the losses
        summed. Metrics are named per component as the JAX loss names them
        (``loss_tagger``, ``tagger_tag_acc_batch``). ``dropout`` overrides
        every dropout site's rate (``[training] dropout``); ``seed`` (an int)
        seeds the masks, None for no dropout."""
        assert self.model is not None, "Pipeline not initialized"
        metrics: Dict[str, Any] = {}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        t2v_name = self.tok2vec_name
        t2v_out = None
        if t2v_name is not None:
            ctx = Context(train=True, dropout=dropout,
                          seed=None if seed is None else fold_in(seed, 0))
            t2v_out = self.components[t2v_name].forward(tokens, None, ctx)
        for i, name in enumerate(self.head_names()):
            comp = self.components[name]
            if not comp.trainable or name not in targets:
                continue
            ctx = Context(train=True, dropout=dropout,
                          seed=None if seed is None else fold_in(seed, i + 1))
            loss, comp_metrics = comp.loss(t2v_out if comp.listens else tokens,
                                           targets[name], ctx)
            metrics[f"loss_{name}"] = loss.detach()
            metrics.update({f"{name}_{k}": v for k, v in comp_metrics.items()})
            total = total + loss
        return total, metrics

    def forward(self, tokens: TokenBatch, overlay: Optional[Dict[str, Any]] = None):
        """{component: output}: the trunk once, then every head on its
        output. ``overlay`` is a serving precision overlay keyed by
        component name (serving/overlay.py)."""
        overlay = overlay or {}
        outputs: Dict[str, Any] = {}
        t2v_name = self.tok2vec_name
        t2v_out = None
        if t2v_name is not None:
            t2v_out = self.components[t2v_name].forward(tokens, overlay.get(t2v_name))
            outputs[t2v_name] = t2v_out
        for name in self.head_names():
            comp = self.components[name]
            outputs[name] = comp.forward(t2v_out if comp.listens else tokens,
                                         overlay.get(name))
        return outputs

    def predict_docs(
        self,
        docs: List[Doc],
        *,
        batch_size: int = 128,
        overlay: Optional[Dict[str, Any]] = None,
        pad_batch_to: Optional[int] = None,
        pad_len_to: Optional[int] = None,
    ) -> List[Doc]:
        """Batched prediction, annotating ``docs`` in place.
        ``pad_batch_to``/``pad_len_to`` pin the padded (B, T), as the serving
        engine does with its bucket."""
        assert self.model is not None, "Pipeline not initialized"
        with torch.inference_mode():
            for start in range(0, len(docs), batch_size):
                chunk = docs[start:start + batch_size]
                batch = self.collate(
                    [Example.from_gold(d) for d in chunk],
                    pad_batch_to=pad_batch_to, pad_len_to=pad_len_to,
                )
                outputs = self.forward(batch["tokens"], overlay)
                T = batch["tokens"].seq_len
                lengths = [min(len(d), T) for d in chunk]
                for name in self.head_names():
                    self.components[name].set_annotations(chunk, outputs[name], lengths)
        return docs

    def __call__(self, text: str) -> Doc:
        doc = self.tokenizer(text)
        self.predict_docs([doc])
        return doc

    def evaluate(self, examples: List[Example], batch_size: int = 128) -> Dict[str, Any]:
        """Predict over gold examples (into fresh shells set as each
        example's ``predicted``), then score: every head's scores plus
        ``speed``, the words per second of the prediction."""
        docs = [eg.reference.copy_shell() for eg in examples]
        t0 = time.perf_counter()
        self.predict_docs(docs, batch_size=batch_size)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        for eg, doc in zip(examples, docs):
            eg.predicted = doc
        scores: Dict[str, Any] = {}
        for name in self.head_names():
            scores.update(self.components[name].score(examples))
        n_words = sum(len(d) for d in docs)
        scores["speed"] = n_words / seconds if seconds > 0 else 0.0
        return scores

    # ------------------------------------------------------------------
    # Serialization (the JAX package's on-disk layout)
    # ------------------------------------------------------------------
    def meta(self) -> Dict[str, Any]:
        nlp_cfg = self.config.get("nlp", {})
        return {
            "lang": self.lang,
            "name": nlp_cfg.get("name", "pipeline"),
            "version": nlp_cfg.get("version", "0.0.0"),
            "spacy_ray_tpu_version": __version__,
            "pipeline": self.pipe_names,
            "labels": {name: self.components[name].labels for name in self.pipe_names},
        }

    def to_disk(self, path) -> None:
        assert self.model is not None, "Pipeline not initialized"
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.cfg").write_text(self.config.to_str(), encoding="utf8")
        (path / "meta.json").write_text(json.dumps(self.meta(), indent=2), encoding="utf8")
        checkpoint.save_params(path / "params.npz", param_paths(self.model))

    @classmethod
    def from_disk(cls, path, device: DeviceLike = None) -> "Pipeline":
        """Load a model directory written by either package."""
        path = Path(path)
        config = Config.from_disk(path / "config.cfg").interpolate()
        nlp = cls.from_config(config, device=device)
        meta = json.loads((path / "meta.json").read_text(encoding="utf8"))
        for name, labels in meta.get("labels", {}).items():
            if name in nlp.components:
                nlp.components[name].labels = labels
        nlp.model = nlp._build_models()
        nlp.load_params(checkpoint.load_params(path / "params.npz"))
        nlp.model = nlp.model.to(nlp.device).eval()
        return nlp
