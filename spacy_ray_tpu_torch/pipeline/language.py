"""Pipeline: the ``nlp`` object, built from ``config.cfg`` (counterpart of
``spacy_ray_tpu/pipeline/language.py``).

It resolves the components, initializes or loads their parameters onto one
device, lowers examples to bucket-shaped padded batches (with the heads'
targets for training), runs the trunk once per batch and feeds every
listening head, sums the heads' losses, and decodes and scores the outputs.
``to_disk``/``from_disk`` use the JAX package's on-disk layout
(``config.cfg``, ``meta.json``, a flat ``params.npz`` keyed by parameter
path, ``components.json`` with the rule components' tables and patterns
and the entity linker's settings, ``vectors.npz`` with the static vectors,
``{name}.kb.npz`` with a linker's knowledge base), so a model directory
written by either package loads in both. A component may be taken from a
saved pipeline (``source``); a frozen one (``[training]
frozen_components``) keeps its parameters out of autograd in training.

A head's output is what its ``set_annotations`` takes: the tagger's
``Padded`` logits, the parser's and the NER's decoded ids (dicts of
tensors); a rule component (``attribute_ruler``, ``lemmatizer``,
``entity_ruler``) has no model and annotates from the docs alone. On the
card, a prediction pinned to a (B, T) bucket (the serving engine's)
replays each decoding head's CUDA graph for that bucket
(``pipeline/decode_graph.py``); everything else decodes eagerly.
"""

from __future__ import annotations

import copy
import inspect
import itertools
import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import __version__
from ..config import Config
from ..devices import DeviceLike, resolve_device
from ..models.core import Context, fold_in, param_paths
from ..registry import registry
from .decode_graph import DecodeGraphs
from ..training import checkpoint
from ..training.batcher import DEFAULT_LENGTH_BUCKETS, bucket_batch_size, bucket_length
from ..types import TokenBatch
from .components.base import Component
from .components.tok2vec import Tok2VecComponent
from .doc import Doc, Example, Span
from .tokenizer import Tokenizer
from .vectors import Vectors, use_vectors
from .vocab import ATTRS, Vocab

#: examples read from the train corpus to collect labels at initialize
LABEL_SAMPLE_LIMIT = 10000


def resolve_config_path(config: Optional[Config], raw: Any) -> Path:
    """A path found inside a config: relative paths anchor to the config
    file's directory (``Config.origin_path``), falling back to the working
    directory when only that one exists (the JAX package's rule)."""
    p = Path(raw)
    if p.is_absolute():
        return p
    origin = getattr(config, "origin_path", None) if config is not None else None
    if origin is not None:
        anchored = Path(origin).parent / p
        if anchored.exists() or not p.exists():
            return anchored
    return p


def read_labels_file(name: str, raw: Any, config: Optional[Config]) -> List[str]:
    """``[initialize.components.<name>] labels``: a non-empty JSON list of
    distinct strings, kept in its order (it is already final: the
    component's ``finish_labels`` does not run on it)."""
    loaded = json.loads(resolve_config_path(config, raw).read_text(encoding="utf8"))
    if (not isinstance(loaded, list) or not loaded
            or not all(isinstance(l, str) for l in loaded)):
        raise ValueError(
            f"[initialize.components.{name}] labels file {raw!r} must hold a "
            "non-empty JSON list of strings (write it with the init-labels command)"
        )
    if len(set(loaded)) != len(loaded):
        dupes = sorted({l for l in loaded if loaded.count(l) > 1})
        raise ValueError(
            f"[initialize.components.{name}] labels file {raw!r} contains "
            f"duplicates {dupes}: the head would be sized by the padded count "
            "while classes silently collapse"
        )
    return list(loaded)


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
        #: the static vectors (``[initialize] vectors``, or a model
        #: directory's ``vectors.npz``), None without them
        self.vectors: Optional[Vectors] = None
        #: the heads' decode graphs by bucket, made at the first pinned
        #: prediction on the card (None until then, and after a rebuild)
        self.decode_graphs: Optional[DecodeGraphs] = None
        #: ``[training] frozen_components`` and ``annotating_components``
        self.frozen_components: List[str] = []
        self.annotating_components: List[str] = []
        #: component name -> the ``source`` it was taken from
        self.sourced_components: Dict[str, str] = {}

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_config(cls, config: Config, device: DeviceLike = None) -> "Pipeline":
        """Build the pipeline skeleton from an interpolated config. The
        device defaults to ``cuda`` and raises when no card is present.

        A block ``[components.X] source = "<model dir>"`` (and no other key)
        takes component X from that saved pipeline, with its labels,
        settings and parameters; each directory loads once, relative paths
        anchor to the config's directory, and either package may have
        written it. The first source with vectors gives the pipeline its
        vectors; another source with a different table is refused. The
        block is then rewritten in ``config`` to the source's own, so the
        saved pipeline reloads without the source directory."""
        dev = resolve_device(device)
        nlp_cfg = config.get("nlp", {})
        pipe_names = list(nlp_cfg.get("pipeline", []))
        comp_cfgs = config.get("components", {})
        components: Dict[str, Component] = {}
        sourced: Dict[str, str] = {}
        sourced_vectors: Optional[Vectors] = None
        sources: Dict[str, "Pipeline"] = {}
        for name in pipe_names:
            if name not in comp_cfgs:
                raise ValueError(f"Pipeline names component {name!r} but no [components.{name}]")
            block = dict(comp_cfgs[name])
            source = block.pop("source", None)
            if source is not None:
                if block:
                    raise ValueError(
                        f"[components.{name}] mixes source = {source!r} with other "
                        f"keys {sorted(block)} — a sourced component can't be "
                        "overridden; drop `source` or the extra keys"
                    )
                if source not in sources:
                    sources[source] = cls.from_disk(resolve_config_path(config, source),
                                                    device=dev)
                src = sources[source]
                if name not in src.components:
                    raise ValueError(
                        f"[components.{name}] source {source!r} has no component "
                        f"{name!r} (has: {src.pipe_names})"
                    )
                components[name] = src.components[name]
                sourced[name] = source
                if src.vectors is not None:
                    if sourced_vectors is None:
                        sourced_vectors = src.vectors
                    elif sourced_vectors is not src.vectors and (
                            sourced_vectors.table.shape != src.vectors.table.shape
                            or not np.array_equal(sourced_vectors.table, src.vectors.table)):
                        raise ValueError(
                            f"[components.{name}] source {source!r} carries a "
                            "different vectors table than an earlier source — "
                            "sourced components must share one vectors asset"
                        )
                config["components"][name] = copy.deepcopy(
                    src.config.get("components", {})[name])
                continue
            factory_name = block.pop("factory", None)
            if factory_name is None:
                raise ValueError(f"[components.{name}] missing 'factory'")
            factory = registry.get("factories", factory_name)
            model_cfg = block.pop("model", None)
            if model_cfg is not None:
                components[name] = factory(name=name, model=model_cfg, **block)
                continue
            model_param = inspect.signature(factory).parameters.get("model")
            if model_param is None or model_param.default is inspect.Parameter.empty:
                raise ValueError(f"[components.{name}] missing model block")
            components[name] = factory(name=name, **block)  # a rule component
        nlp = cls(nlp_cfg.get("lang", "en"), components, pipe_names, config, dev)
        nlp.sourced_components = sourced
        nlp.vectors = sourced_vectors
        training = config.get("training", {}) or {}
        nlp.frozen_components = list(training.get("frozen_components") or [])
        nlp.annotating_components = list(training.get("annotating_components") or [])
        return nlp

    @property
    def tok2vec_name(self) -> Optional[str]:
        for name in self.pipe_names:
            if isinstance(self.components[name], Tok2VecComponent):
                return name
        return None

    def head_names(self) -> List[str]:
        return [n for n in self.pipe_names if n != self.tok2vec_name]

    def _build_models(self) -> nn.ModuleDict:
        """Every component's model (a rule component has none), built with
        the pipeline's static vectors active; a sourced component keeps the
        model it came with."""
        self.decode_graphs = None  # they hold the old models' parameters
        with use_vectors(self.vectors):
            models = {n: (self.components[n].model if n in self.sourced_components
                          else self.components[n].build_model()) for n in self.pipe_names}
        return nn.ModuleDict({n: m for n, m in models.items() if m is not None})

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

        A component's labels are, in this order: ``labels[name]`` as given;
        the JSON file of ``[initialize.components.<name>] labels`` (the
        config's directory anchors a relative path), in its order; or those
        collected from the first 10 000 examples of ``get_examples``, sorted.
        A sourced component keeps its labels and parameters.
        ``[initialize] vectors`` loads the static vectors (the config's
        directory anchors a relative path; it wins over a source's).
        Parameters are drawn on the CPU from ``torch.Generator(seed)``, in
        pipeline order, then moved to the device, so a seed gives the same
        weights on every device. ``[initialize] init_tok2vec`` then loads the
        trunk from a flat npz (what ``pretrain`` writes, in either package;
        relative to the config's directory), its persistent buffers
        (``frozen_table``) too: its key set and every shape must be the
        trunk's. A listening head whose width is not the trunk's raises."""
        init_cfg = self.config.get("initialize", {}) or {}
        init_components = init_cfg.get("components", {}) or {}
        labels = labels or {}
        sample = (list(itertools.islice(get_examples(), LABEL_SAMPLE_LIMIT))
                  if get_examples is not None else [])
        for name in self.pipe_names:
            if name in self.sourced_components:
                continue
            comp = self.components[name]
            labels_path = (init_components.get(name) or {}).get("labels")
            if name in labels:
                comp.labels = list(labels[name])
            elif labels_path:
                comp.labels = read_labels_file(name, labels_path, self.config)
            elif sample:
                comp.add_labels_from(sample)
                comp.finish_labels()
        if init_cfg.get("vectors"):
            self.vectors = Vectors.from_disk(resolve_config_path(self.config,
                                                                 init_cfg["vectors"]))
        generator = torch.Generator().manual_seed(seed)
        model = self._build_models()
        for name in self.pipe_names:
            if name in model and name not in self.sourced_components:
                model[name].init_parameters(generator)
        if init_cfg.get("init_tok2vec"):
            self._init_tok2vec(model, init_cfg["init_tok2vec"])
        self._check_listener_widths()
        self.model = model.to(self.device).eval()
        return self.params

    def _init_tok2vec(self, model: nn.ModuleDict, raw: Any) -> None:
        """Copy the pretrained trunk at ``raw`` into the trunk's parameters
        and buffers, after the key sets and shapes are checked (the JAX
        package's check and message)."""
        t2v_name = self.tok2vec_name
        if t2v_name is None or t2v_name not in model:
            raise ValueError(
                "[initialize] init_tok2vec is set but the pipeline has "
                "no tok2vec/transformer trunk with parameters"
            )
        loaded = checkpoint.load_params(resolve_config_path(self.config, raw))
        have = param_paths(model[t2v_name])
        if {k: tuple(v.shape) for k, v in have.items()} != {
                k: tuple(v.shape) for k, v in loaded.items()}:
            missing = sorted(set(have) - set(loaded))[:5]
            extra = sorted(set(loaded) - set(have))[:5]
            mismatched = sorted(k for k in set(have) & set(loaded)
                                if tuple(have[k].shape) != tuple(loaded[k].shape))[:5]
            raise ValueError(
                f"init_tok2vec weights at {raw!r} do not match the "
                f"{t2v_name!r} trunk this config builds "
                f"(missing={missing}, unexpected={extra}, "
                f"shape-mismatched={mismatched}); pretrain with the same "
                "trunk architecture settings"
            )
        with torch.no_grad():
            for k, t in have.items():
                t.copy_(torch.from_numpy(np.array(loaded[k], dtype=np.float32)))

    def _check_listener_widths(self) -> None:
        """A listening head (sourced or not) must take the trunk's width."""
        t2v = self.tok2vec_name
        if t2v is None:
            return
        trunk_w = self.components[t2v].model.dims.get("nO")
        for name in self.head_names():
            comp = self.components[name]
            head_w = (comp.model.dims or {}).get("width") if comp.model is not None else None
            if comp.listens and trunk_w and head_w and head_w != trunk_w:
                src = self.sourced_components.get(name)
                hint = f" (sourced from {src!r})" if src else ""
                raise ValueError(
                    f"Component {name!r}{hint} expects tok2vec width "
                    f"{head_w} but the pipeline trunk {t2v!r} produces "
                    f"{trunk_w}"
                )

    def requires_grad_(self, on: bool = True) -> "Pipeline":
        """Turn autograd on for every parameter but a frozen component's,
        or off for all. A frozen component's parameters take no gradient
        (JAX's ``stop_gradient`` on them), while the gradient of its loss
        still flows through it into a trunk that is not frozen; a frozen
        trunk's tables then launch no table gradient."""
        assert self.model is not None, "Pipeline not initialized"
        self.model.requires_grad_(on)
        if on:
            for name in self.frozen_components:
                if name in self.model:
                    self.model[name].requires_grad_(False)
        return self

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
        ``{component: {name: tensor}}`` under ``"targets"``.

        Each Example's ``[len, 4, 2]`` keys are computed once and kept on it
        (corpora yield the same Example objects every epoch): the docs not
        yet featurized go through one flat vocab call, and a later epoch
        only copies slices into the padded batch. With static vectors, each
        token's vector row is cached on the Example beside its keys (for
        the vectors it was looked up in), where the JAX package looks the
        rows up again at every collate: the same rows."""
        lengths = [len(eg) for eg in examples]
        T = pad_len_to or bucket_length(max(lengths, default=1), self.length_buckets)
        B = pad_batch_to or bucket_batch_size(len(examples))
        attr_keys = np.zeros((B, T, len(ATTRS), 2), dtype=np.uint32)
        mask = np.zeros((B, T), dtype=bool)
        vec_rows = np.full((B, T), -1, dtype=np.int64) if self.vectors is not None else None
        doc_feats = [getattr(eg, "_feat_cache", None) for eg in examples]
        uncached = [i for i, f in enumerate(doc_feats) if f is None]
        if uncached:
            flat = self.vocab.featurize(
                [w for i in uncached for w in examples[i].reference.words])
            offset = 0
            for i in uncached:
                n = len(examples[i].reference.words)
                examples[i]._feat_cache = doc_feats[i] = flat[offset:offset + n]
                offset += n
        for i, feats in enumerate(doc_feats):
            k = min(len(feats), T)
            attr_keys[i, :k] = feats[:k]
            mask[i, :k] = True
            if vec_rows is not None:
                vec_rows[i, :k] = self._vector_rows(examples[i])[:k]
        tokens = TokenBatch(
            attr_keys=torch.from_numpy(attr_keys.astype(np.int64)).to(self.device),
            mask=torch.from_numpy(mask).to(self.device),
            vector_rows=(torch.from_numpy(vec_rows).to(self.device)
                         if vec_rows is not None else None),
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

    def _vector_rows(self, example: Example) -> np.ndarray:
        """The doc's static-vector rows, cached on the Example for the
        vectors they were looked up in."""
        cached = getattr(example, "_vec_rows_cache", None)
        if cached is None or cached[0] is not self.vectors:
            cached = (self.vectors, self.vectors.rows_of(example.reference.words))
            example._vec_rows_cache = cached
        return cached[1]

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
        seeds the masks, None for no dropout. A frozen component
        (``frozen_components``) runs, and a frozen head's loss counts, as
        in JAX; :meth:`requires_grad_` keeps its parameters from a
        gradient. The trunk and every head share one aux sink (a head's
        inline trunk may be an MoE trunk too); its terms, the MoE router's
        load-balancing losses, are summed into ``loss_aux`` and the total
        unless the shared trunk is frozen (JAX ``pipeline/language.py``
        ``make_loss_fn``)."""
        assert self.model is not None, "Pipeline not initialized"
        metrics: Dict[str, Any] = {}
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        t2v_name = self.tok2vec_name
        t2v_out = None
        aux_sink: List[Any] = []
        if t2v_name is not None:
            ctx = Context(train=True, dropout=dropout,
                          seed=None if seed is None else fold_in(seed, 0),
                          aux_losses=aux_sink)
            t2v_out = self.components[t2v_name].forward(tokens, None, ctx)
        for i, name in enumerate(self.head_names()):
            comp = self.components[name]
            if not comp.trainable or name not in targets:
                continue
            ctx = Context(train=True, dropout=dropout,
                          seed=None if seed is None else fold_in(seed, i + 1),
                          aux_losses=aux_sink)
            loss, comp_metrics = comp.loss(t2v_out if comp.listens else tokens,
                                           targets[name], ctx)
            metrics[f"loss_{name}"] = loss.detach()
            metrics.update({f"{name}_{k}": v for k, v in comp_metrics.items()})
            total = total + loss
        if aux_sink and (t2v_name is None or t2v_name not in self.frozen_components):
            aux_total = aux_sink[0]
            for a in aux_sink[1:]:
                aux_total = aux_total + a
            metrics["loss_aux"] = aux_total.detach()
            total = total + aux_total
        return total, metrics

    def forward(self, tokens: TokenBatch, overlay: Optional[Dict[str, Any]] = None,
                graphs: Optional[DecodeGraphs] = None, only: Optional[Sequence[str]] = None):
        """{component: output}: the trunk once, then every head on its
        output. ``overlay`` is a serving precision overlay keyed by
        component name (serving/overlay.py); with ``graphs``, a decoding
        head that can be captured replays its graph for this (B, T).
        ``only`` restricts the heads to those listed (the training loop's
        annotating pass); the trunk then runs only if one of them listens."""
        overlay = overlay or {}
        outputs: Dict[str, Any] = {}
        heads = [n for n in self.head_names() if self.components[n].model is not None
                 and (only is None or n in only)]
        t2v_name = self.tok2vec_name
        t2v_out = None
        if t2v_name is not None and (only is None
                                     or any(self.components[n].listens for n in heads)):
            t2v_out = self.components[t2v_name].forward(tokens, overlay.get(t2v_name))
            outputs[t2v_name] = t2v_out
        for name in heads:
            comp = self.components[name]
            inputs = t2v_out if comp.listens else tokens
            if graphs is not None and comp.graph_capturable:
                t2v = comp.trunk_output(inputs)
                outputs[name] = graphs.run(name, comp, t2v.X, t2v.mask.sum(1))
            else:
                outputs[name] = comp.forward(inputs, overlay.get(name))
        return outputs

    def predict_docs(
        self,
        docs: List[Doc],
        *,
        batch_size: int = 128,
        overlay: Optional[Dict[str, Any]] = None,
        pad_batch_to: Optional[int] = None,
        pad_len_to: Optional[int] = None,
        annotate: Optional[Sequence[str]] = None,
    ) -> List[Doc]:
        """Batched prediction, annotating ``docs`` in place.
        ``pad_batch_to``/``pad_len_to`` pin the padded (B, T), as the serving
        engine does with its bucket; on the card the heads' decodes then
        run as that bucket's CUDA graphs (captured at its first use).
        ``annotate`` restricts the forward and ``set_annotations`` to the
        listed components (``[training] annotating_components``)."""
        assert self.model is not None, "Pipeline not initialized"
        graphs = None
        if self.device.type == "cuda" and pad_batch_to and pad_len_to:
            if self.decode_graphs is None:
                self.decode_graphs = DecodeGraphs()
            graphs = self.decode_graphs
        with torch.inference_mode():
            for start in range(0, len(docs), batch_size):
                chunk = docs[start:start + batch_size]
                batch = self.collate(
                    [Example.from_gold(d) for d in chunk],
                    pad_batch_to=pad_batch_to, pad_len_to=pad_len_to,
                )
                outputs = self.forward(batch["tokens"], overlay, graphs, only=annotate)
                T = batch["tokens"].seq_len
                lengths = [min(len(d), T) for d in chunk]
                for name in self.head_names():
                    if annotate is None or name in annotate:
                        self.components[name].set_annotations(chunk, outputs.get(name),
                                                              lengths)
        return docs

    def __call__(self, text: str) -> Doc:
        doc = self.tokenizer(text)
        self.predict_docs([doc])
        return doc

    def evaluate(self, examples: List[Example], batch_size: int = 128) -> Dict[str, Any]:
        """Predict over gold examples (into fresh shells set as each
        example's ``predicted``), then score: every head's scores, the keys
        the JAX package's ``evaluate`` gives. When a component has
        ``use_gold_ents`` (an entity linker) and none writes ``doc.ents``,
        each shell starts with the gold entities' boundaries and labels
        (never their kb_ids), as in JAX."""
        return self.evaluate_timed(examples, batch_size)[0]

    def evaluate_timed(self, examples: List[Example],
                       batch_size: int = 128) -> Tuple[Dict[str, Any], float]:
        """``(scores, words_per_second)``: :meth:`evaluate`'s scores and the
        speed of the prediction, kept apart from them."""
        docs = [eg.reference.copy_shell() for eg in examples]
        if (any(getattr(self.components[n], "use_gold_ents", False) for n in self.pipe_names)
                and not any(self.components[n].sets_ents for n in self.pipe_names)):
            for eg, doc in zip(examples, docs):
                doc.ents = [Span(s.start, s.end, s.label) for s in eg.reference.ents]
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
        return scores, (n_words / seconds if seconds > 0 else 0.0)

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

    def component_data(self) -> Dict[str, Any]:
        """The host state of the components that have one (patterns, lemma
        tables, the entity linker's settings), saved as ``components.json``
        beside ``meta.json``."""
        return {name: comp.table_data() for name, comp in self.components.items()
                if hasattr(comp, "table_data")}

    def to_disk(self, path) -> None:
        assert self.model is not None, "Pipeline not initialized"
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        (path / "config.cfg").write_text(self.config.to_str(), encoding="utf8")
        (path / "meta.json").write_text(json.dumps(self.meta(), indent=2), encoding="utf8")
        extras = self.component_data()
        if extras:
            (path / "components.json").write_text(json.dumps(extras), encoding="utf8")
        for name, comp in self.components.items():
            if hasattr(comp, "save_binary"):  # the entity linker's KB
                comp.save_binary(path, name)
        if self.vectors is not None:
            self.vectors.to_disk(path / "vectors.npz")
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
        if (path / "components.json").exists():
            data = json.loads((path / "components.json").read_text(encoding="utf8"))
            for name, table in data.items():
                comp = nlp.components.get(name)
                if comp is not None and hasattr(comp, "load_table_data"):
                    comp.load_table_data(table)
        for name, comp in nlp.components.items():
            if hasattr(comp, "load_binary"):
                comp.load_binary(path, name)
        if (path / "vectors.npz").exists():
            nlp.vectors = Vectors.from_disk(path / "vectors.npz")
        nlp.model = nlp._build_models()
        nlp.load_params(checkpoint.load_params(path / "params.npz"))
        nlp.model = nlp.model.to(nlp.device).eval()
        return nlp
