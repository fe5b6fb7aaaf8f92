"""The port's switch-MoE trunk against the JAX package's, on the CPU, at the
JAX package's own MoE test size (``tests/test_moe.py``: width 32, depth 2,
4 heads, FFN 64, 4 experts), with ``compute_dtype`` float32 and carried
weights.

Tolerances and why:
* ``_moe_ffn``: the output within 1e-5 relative to its max |y|, aux within
  1e-6: the same f32 arithmetic, the one-hot products done by index (every
  output of JAX's contractions is a sum with one non-zero term); the
  routing equal on every token whose top-two probability gap exceeds 1e-6
  (the count inside that band is reported, and is 0 on these inputs);
* the trunk output within 1e-5; the loss, ``loss_aux`` and the total within
  1e-5 relative; every leaf's gradient within 1e-4 x its max |g| (the bound
  of every gradient test since the CNN slice); three Adam steps: the losses
  within 1e-5 relative and every parameter within 1e-5;
* tags, parses and entities, model directories and served answers equal.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
import spacy_ray_tpu as J
from spacy_ray_tpu.models import pretrained as jpretrained
from spacy_ray_tpu.models.transformer import _moe_ffn, transformer_layer_params
from spacy_ray_tpu.ops import int8_matmul as ji8
from spacy_ray_tpu.serving.engine import InferenceEngine as JEngine
from spacy_ray_tpu.serving.overlay import build_serving_overlay
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training import pretrain as jpt
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.util import synth_corpus as j_synth

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import Context
from spacy_ray_tpu_torch.models.transformer import (
    INT8_UNSUPPORTED_LEAF_NAMES,
    SHADOW_LEAF_NAMES,
    make_transformer_encoder,
    moe_ffn,
    shadow_coverage,
)
from spacy_ray_tpu_torch.serving.engine import InferenceEngine
from spacy_ray_tpu_torch.serving.overlay import build_params_overlay
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training import pretrain as ppt
from spacy_ray_tpu_torch.training.loop import train as p_train
from spacy_ray_tpu_torch.util import synth_corpus as p_synth
from spacy_ray_tpu_torch.util import write_synth_jsonl

REPO = Path(__file__).resolve().parent.parent
JAX_MOE = REPO / "tests" / "data" / "jax_moe"

MOE_CFG = """
[nlp]
lang = "en"
pipeline = ["transformer","tagger"]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 32
depth = 2
n_heads = 4
ffn_mult = 2
dropout = 0.0
max_len = 64
embed_size = 256
remat = false
n_experts = 4
compute_dtype = "float32"

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32
"""

# a tagger whose trunk is its own MoE transformer (no listener)
INLINE_CFG = """
[nlp]
lang = "en"
pipeline = ["tagger"]

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 32
depth = 2
n_heads = 4
ffn_mult = 2
dropout = 0.0
max_len = 64
embed_size = 256
remat = false
n_experts = 4
compute_dtype = "float32"
"""


def _np(tree):
    return {k: np.asarray(v) for k, v in _flatten(tree).items()}


def _layer_params(seed=0, width=16, ffn=32, experts=4):
    p = {k: np.asarray(v) for k, v in
         transformer_layer_params(jax.random.PRNGKey(seed), width, ffn, experts).items()}
    rng = np.random.default_rng(seed)
    for k in ("e_b1", "e_b2"):  # non-zero biases, so empty slots would show
        p[k] = rng.normal(0, 0.1, p[k].shape).astype(np.float32)
    return p


def _both_moe(p, h, mask, cf):
    jy, ja = _moe_ffn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h),
                      jnp.asarray(mask), capacity_factor=cf, compute_dtype=jnp.float32)
    t = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    py, pa = moe_ffn(t.__getitem__, torch.from_numpy(h), torch.from_numpy(mask),
                     capacity_factor=cf, compute_dtype=torch.float32)
    return np.asarray(jy), float(ja), py.numpy(), float(pa)


@pytest.mark.parametrize("cf", [1.25, 1.0, 0.5])
def test_moe_ffn_matches_jax_with_padding(cf):
    p = _layer_params()
    rng = np.random.default_rng(1)
    N = 48
    h = rng.normal(size=(N, 16)).astype(np.float32)
    mask = np.ones(N, bool)
    mask[[3, 17, 40, 41, 42, 43, 44, 45, 46, 47]] = False
    jy, ja, py, pa = _both_moe(p, h, mask, cf)
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    assert abs(pa - ja) <= 1e-6
    assert not np.any(py[~mask]) and not np.any(jy[~mask])  # padding rows exactly zero
    # routing: JAX's argmax against the port's, outside the near-tie band
    probs = np.asarray(jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(p["router_W"]), -1))
    top2 = np.sort(probs, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-6
    in_band = int((~clear).sum())
    print(f"capacity_factor {cf}: {in_band} token(s) within 1e-6 of a routing tie")
    assert in_band == 0
    t = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    pidx = torch.argmax(torch.softmax(torch.from_numpy(h) @ t["router_W"], -1), -1).numpy()
    assert np.array_equal(pidx[clear], probs.argmax(-1)[clear])
    served = np.abs(py).sum(1) > 0
    assert np.array_equal(served, np.abs(jy).sum(1) > 0)
    if cf == 0.5:  # capacity 6 a queue: some real tokens are dropped
        assert served.sum() < mask.sum()


def test_capacity_drops_overflow_rows_as_jax():
    # JAX tests/test_moe.py: every token routed to expert 0, capacity 2
    p = _layer_params(width=8, ffn=16, experts=2)
    p["router_W"] = np.zeros((8, 2), np.float32)
    p["router_W"][:, 0] = 100.0
    h = np.ones((8, 8), np.float32)
    jy, ja, py, pa = _both_moe(p, h, np.ones(8, bool), 0.5)
    assert np.count_nonzero(np.abs(py).sum(axis=1)) == 2
    assert np.array_equal(np.abs(py).sum(1) > 0, np.abs(jy).sum(1) > 0)
    np.testing.assert_allclose(py, jy, rtol=0, atol=1e-5 * np.abs(jy).max())
    assert abs(pa - ja) <= 1e-6


def test_context_child_keeps_the_sink():
    sink = []
    ctx = Context(train=True, seed=3, aux_losses=sink)
    grandchild = ctx.child(0).child(2)
    assert grandchild.aux_losses is sink
    grandchild.add_aux_loss(torch.tensor(1.5))
    assert len(sink) == 1
    Context(train=True).child(1).add_aux_loss(torch.tensor(2.0))  # no sink: dropped
    assert len(sink) == 1


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX pipeline, port pipeline, JAX examples, port examples) with the
    same weights and labels: JAX initializes and saves, the port loads."""
    jnlp = J.Pipeline.from_config(J.Config.from_str(MOE_CFG).interpolate())
    jegs = j_synth(64, "tagger", seed=0)
    jnlp.initialize(lambda: iter(jegs), seed=0)
    path = tmp_path_factory.mktemp("jax_moe_model")
    jnlp.to_disk(path)
    pnlp = P.Pipeline.from_disk(path, device="cpu")
    pegs = p_synth(64, "tagger", seed=0)
    assert [e.reference.words for e in pegs] == [e.reference.words for e in jegs]
    return jnlp, pnlp, jegs, pegs, path


def _port_loss_grads(pnlp, batch, **kw):
    pnlp.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp.model.named_parameters()}
    for p in params.values():
        p.grad = None
    loss, metrics = pnlp.loss(batch["tokens"], batch["targets"], dropout=0.0, **kw)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in params.items() if p.grad is not None}
    pnlp.model.requires_grad_(False)
    return float(loss.detach()), metrics, grads


def test_trunk_output_matches_jax_with_padding(models):
    jnlp, pnlp, jegs, pegs, _ = models
    jb = jnlp.collate(jegs[:6], with_targets=False, pad_batch_to=8, pad_len_to=32)
    pb = pnlp.collate(pegs[:6], pad_batch_to=8, pad_len_to=32)
    jX = np.asarray(jnlp.make_forward_fn()(jnlp.params, jb["tokens"])["transformer"].X)
    with torch.no_grad():
        pX = pnlp.forward(pb["tokens"])["transformer"].X.numpy()
    np.testing.assert_allclose(pX, jX, rtol=0, atol=1e-5)
    assert not pX[~pb["tokens"].mask.numpy()].any()


def test_loss_aux_total_and_every_gradient_match_jax(models):
    jnlp, pnlp, jegs, pegs, _ = models
    jb = jnlp.collate(jegs[:8], pad_batch_to=8, pad_len_to=16)
    pb = pnlp.collate(pegs[:8], with_targets=True, pad_batch_to=8, pad_len_to=16)
    vg = jax.value_and_grad(jnlp.make_loss_fn(dropout=0.0), has_aux=True)
    (jloss, jm), jg = vg(jnlp.params, jb["tokens"], jb["targets"], jax.random.PRNGKey(0))
    ploss, pm, pg = _port_loss_grads(pnlp, pb)
    assert set(pm) == set(jm) and "loss_aux" in pm
    assert float(pm["loss_aux"]) > 0
    for k in ("loss_aux", "loss_tagger"):
        assert abs(float(pm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    assert abs(ploss - float(jloss)) <= 1e-5 * abs(float(jloss))
    # the total is the heads' losses plus the aux term
    assert abs(ploss - float(pm["loss_tagger"]) - float(pm["loss_aux"])) <= 1e-6
    jflat = _np(jg)
    assert set(jflat) == set(pg)
    assert {"router_W", "e_W1", "e_b1", "e_W2", "e_b2"} <= {k.split("/")[-1] for k in pg}
    for k, g in jflat.items():
        np.testing.assert_allclose(pg[k], g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30), err_msg=k)
    # the router's gradient carries the aux term: zero it and the router moves less
    assert np.abs(pg["transformer/layer_0/router_W"]).max() > 0


def test_three_adam_steps_match_jax(models):
    jnlp, pnlp, jegs, pegs, path = models
    lr = 0.001
    jtx = jopt.Adam(learn_rate=lr, grad_clip=1.0).tx
    vg = jax.jit(jax.value_and_grad(jnlp.make_loss_fn(dropout=0.0), has_aux=True))
    jparams = jnlp.params
    jstate = jtx.init(jparams)
    pnlp2 = P.Pipeline.from_disk(path, device="cpu")
    pnlp2.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp2.model.named_parameters()}
    opt = popt.Adam(learn_rate=lr, grad_clip=1.0)
    state = opt.init(params)
    for i in range(3):
        sl = slice(8 * i, 8 * i + 8)
        jb = jnlp.collate(jegs[sl], pad_batch_to=8, pad_len_to=16)
        (jloss, _), jg = vg(jparams, jb["tokens"], jb["targets"], jax.random.PRNGKey(0))
        upd, jstate = jtx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        pb = pnlp2.collate(pegs[sl], with_targets=True, pad_batch_to=8, pad_len_to=16)
        for p in params.values():
            p.grad = None
        loss, _ = pnlp2.loss(pb["tokens"], pb["targets"], dropout=0.0)
        loss.backward()
        with torch.no_grad():
            opt.update(params, {k: p.grad for k, p in params.items()}, state)
        assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    diffs = np.concatenate([np.abs(params[k].detach().numpy() - v).ravel()
                            for k, v in _np(jparams).items()])
    assert diffs.max() <= 1e-5


def test_remat_and_dropout_give_the_same_gradients_as_without_remat(models):
    _, pnlp, _, pegs, _ = models
    trunk = pnlp.components["transformer"].model
    batch = pnlp.collate(pegs[:8], with_targets=True, pad_batch_to=8, pad_len_to=16)

    def run(remat):
        trunk.remat = remat
        pnlp.requires_grad_(True)
        try:
            for p in pnlp.model.parameters():
                p.grad = None
            loss, m = pnlp.loss(batch["tokens"], batch["targets"], dropout=0.1, seed=7)
            loss.backward()
            return float(loss.detach()), float(m["loss_aux"]), [p.grad.clone()
                                                       for p in pnlp.model.parameters()]
        finally:
            trunk.remat = False
            pnlp.model.requires_grad_(False)

    on, off = run(True), run(False)
    assert on[:2] == off[:2]
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))


def test_a_frozen_moe_trunk_adds_no_aux_as_jax(models):
    jnlp, pnlp, jegs, pegs, _ = models
    jb = jnlp.collate(jegs[:8], pad_batch_to=8, pad_len_to=16)
    pb = pnlp.collate(pegs[:8], with_targets=True, pad_batch_to=8, pad_len_to=16)
    jnlp.frozen_components = ["transformer"]
    pnlp.frozen_components = ["transformer"]
    try:
        jloss, jm = jnlp.make_loss_fn(dropout=0.0)(jnlp.params, jb["tokens"], jb["targets"],
                                                   jax.random.PRNGKey(0))
        ploss, pm = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    finally:
        jnlp.frozen_components = []
        pnlp.frozen_components = []
    assert "loss_aux" not in jm and "loss_aux" not in pm
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(ploss) - float(pm["loss_tagger"])) <= 1e-7


def test_a_heads_inline_moe_trunk_adds_its_aux_as_jax(tmp_path):
    jnlp = J.Pipeline.from_config(J.Config.from_str(INLINE_CFG).interpolate())
    jegs = j_synth(16, "tagger", seed=2)
    jnlp.initialize(lambda: iter(jegs), seed=0)
    jnlp.to_disk(tmp_path)
    pnlp = P.Pipeline.from_disk(tmp_path, device="cpu")
    pegs = p_synth(16, "tagger", seed=2)
    jb = jnlp.collate(jegs[:8], pad_batch_to=8, pad_len_to=16)
    pb = pnlp.collate(pegs[:8], with_targets=True, pad_batch_to=8, pad_len_to=16)
    jloss, jm = jnlp.make_loss_fn(dropout=0.0)(jnlp.params, jb["tokens"], jb["targets"],
                                               jax.random.PRNGKey(0))
    ploss, pm = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    assert "loss_aux" in jm and "loss_aux" in pm
    assert abs(float(pm["loss_aux"]) - float(jm["loss_aux"])) <= 1e-5 * float(jm["loss_aux"])
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))


def test_pretraining_an_moe_trunk_adds_no_router_loss_as_jax(tmp_path):
    raw = tmp_path / "raw.jsonl"
    raw.write_text("".join(json.dumps({"text": " ".join(eg.reference.words)}) + "\n"
                           for eg in p_synth(16, "tagger", seed=0)), encoding="utf8")
    text = MOE_CFG + f"""
[corpora.pretrain]
@readers = "spacy.JsonlCorpus.v1"
path = "{raw}"

[pretraining]
max_steps = 2
batch_size = 8
corpus = "corpora.pretrain"
component = "transformer"

[pretraining.objective]
type = "characters"
n_characters = 3
hidden_size = 0
"""
    cfg = J.Config.from_str(text).interpolate()
    jn = J.Pipeline.from_config(cfg)
    comp = jn.components["transformer"]
    comp.build_model()
    head = jpt.build_char_head(32, 3, hidden=0)
    jloss_fn = jpt.make_char_loss(comp.model, head, 3)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jparams = {"trunk": comp.init_params(k1), "head": head.init(k2)}
    run = ppt.Pretraining(P.Config.from_str(text), device="cpu")
    flat = _np(jparams)
    with torch.no_grad():
        for part, model in (("trunk", run.trunk), ("head", run.head)):
            for k, t in model.state_dict().items():
                t.copy_(torch.from_numpy(np.array(flat[f"{part}/{k.replace('.', '/')}"])))
    from spacy_ray_tpu_torch.training import corpus as pcorpus

    with pcorpus.use_raw_text_tokenizer(run.nlp.tokenizer):
        pegs = list(run.corpus())[:8]
    tokens, targets, _ = run.batch(pegs)
    jtok = jn.collate([J.Example.from_gold(J.Doc(words=e.reference.words)) for e in pegs],
                      with_targets=False, pad_batch_to=8)["tokens"]
    jloss, _ = jloss_fn(jparams, jtok, {"chars": jnp.asarray(targets["chars"].numpy())},
                        jax.random.PRNGKey(0))
    sink = []
    ploss, _ = run.loss_fn(tokens, targets, Context(train=True))
    with_sink, _ = run.loss_fn(tokens, targets, Context(train=True, aux_losses=sink))
    assert sink and float(sink[0]) > 0  # the trunk does make a router loss ...
    assert float(with_sink) == float(ploss)  # ... which the objective never adds
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))


def _tags_of(nlp, texts):
    return [nlp(t).tags for t in texts]


def test_moe_model_dirs_load_both_ways_with_jax_tags(models, tmp_path):
    jnlp, pnlp, jegs, _, path = models
    texts = [" ".join(eg.reference.words) for eg in jegs[40:50]]
    want = _tags_of(jnlp, texts)
    assert _tags_of(pnlp, texts) == want
    pnlp.to_disk(tmp_path / "port")
    again = J.Pipeline.from_disk(tmp_path / "port")
    assert _tags_of(again, texts) == want
    for k, v in _np(again.params).items():
        assert np.array_equal(v, _np(jnlp.params)[k]), k


def test_both_packages_engines_serve_alike_at_the_same_buckets(models):
    jnlp, pnlp, jegs, _, _ = models
    texts = [" ".join(eg.reference.words) for eg in jegs[:12]]
    kw = dict(max_batch_docs=4, max_doc_len=32)
    jeng, peng = JEngine(jnlp, **kw).start(), InferenceEngine(pnlp, **kw).start()
    try:
        for i in range(0, len(texts), 3):
            chunk = texts[i:i + 3]
            jreq, preq = jeng.submit_texts(chunk), peng.submit_texts(chunk)
            assert {k: preq.batch_info[k] for k in ("occupancy", "B", "T")} == {
                k: jreq.batch_info[k] for k in ("occupancy", "B", "T")}
            assert [d.tags for d in preq.docs] == [d.tags for d in jreq.docs]
    finally:
        jeng.stop()
        peng.stop()


def test_bf16_covers_every_expert_leaf_and_int8_refuses_as_jax(models, monkeypatch):
    jnlp, pnlp, _, _, _ = models
    monkeypatch.setenv("SRT_PALLAS_INT8", "1")  # JAX's int8 on the CPU, as the port's
    monkeypatch.setattr(ji8, "_PROBE_CACHE", {})
    eligible, unknown = shadow_coverage(pnlp.params)
    assert unknown == [] and eligible == 2 * 8  # qkv/o W, b and 4 expert leaves a layer
    bf16 = build_params_overlay(pnlp.params, "bf16", torch.device("cpu"))
    assert bf16.resolved == "bf16"
    for i in range(2):
        layer = bf16.overlay["transformer"][f"layer_{i}"]
        assert {"e_W1", "e_b1", "e_W2", "e_b2"} <= set(layer)
        assert "router_W" not in layer and all(v.dtype == torch.bfloat16 for v in layer.values())
    assert {"e_W1", "e_b1", "e_W2", "e_b2"} <= SHADOW_LEAF_NAMES
    p8 = build_params_overlay(pnlp.params, "int8", torch.device("cpu"))
    j8 = build_serving_overlay(jnlp, "int8")
    assert p8.resolved == j8.resolved == "f32"
    assert p8.label == j8.label and p8.overlay is None
    assert "2 MoE expert weight leaf(s)" not in p8.label  # 2 layers x 2 weights
    assert p8.label.startswith("f32 (overlay refused: 4 MoE expert weight leaf(s) "
                               "outside int8 coverage (transformer/layer_0/e_W1")
    assert INT8_UNSUPPORTED_LEAF_NAMES == {"e_W1", "e_W2"}


def test_init_weights_into_an_moe_trunk_reports_as_jax(tmp_path):
    # a RoBERTa-layout file: attention, layer norms and embeddings load, the
    # dense FFN tensors are unused and the experts stay at their init
    import chip_smoke

    ckpt = tmp_path / "roberta.safetensors"
    chip_smoke.write_roberta_checkpoint(ckpt, layers=2, width=32, ffn=64, pos_rows=66)
    trunk = make_transformer_encoder(width=32, depth=2, n_heads=4, ffn_mult=2, max_len=64,
                                     embed_size=256, n_experts=4, compute_dtype="float32")
    trunk.init_parameters(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in trunk.state_dict().items()}
    report = P.models.pretrained.load_trunk_weights(trunk, ckpt)
    jtrunk = J.registry.get("architectures", "spacy_ray_tpu.TransformerEncoder.v1")(
        width=32, depth=2, n_heads=4, ffn_mult=2, max_len=64, embed_size=256, n_experts=4,
        compute_dtype="float32")
    jflat = jpretrained.load_flat(ckpt)
    jflat = jpretrained.hf_encoder_to_native(jflat, native_pos_rows=64)
    _, jreport = jpretrained.merge_pretrained(jtrunk.init(jax.random.PRNGKey(0)), jflat)
    assert {k: sorted(v) for k, v in report.items()} == {k: sorted(v)
                                                        for k, v in jreport.items()}
    assert any(k.endswith("e_W1") for k in report["missing"])
    assert any(k.endswith("ffn_W1") for k in report["unused"])
    after = trunk.state_dict()
    for k in report["missing"]:
        assert torch.equal(after[k.replace("/", ".")], before[k.replace("/", ".")]), k


def test_the_moe_architecture_adds_one_leaf_a_layer_and_e_minus_1_ffns():
    kw = dict(width=48, depth=3, n_heads=4, ffn_mult=4, max_len=32, embed_size=100)
    moe = make_transformer_encoder(n_experts=8, **kw)
    dense = make_transformer_encoder(**kw)
    names = [k.split(".")[-1] for k, _ in moe.named_parameters() if k.startswith("layer_0.")]
    assert names == ["qkv_W", "qkv_b", "o_W", "o_b", "ln1_g", "ln1_b", "ln2_g", "ln2_b",
                     "router_W", "e_W1", "e_b1", "e_W2", "e_b2"]
    assert moe.layer_1.e_W1.shape == (8, 48, 192) and moe.layer_2.e_W2.shape == (8, 192, 48)
    # trf.cfg's 165 leaves become 177 with n_experts = 8: one more a layer,
    # and each layer's FFN parameters times 8 plus the router's
    n = {m: (len(list(t.parameters())), sum(p.numel() for p in t.parameters()))
         for m, t in (("moe", moe), ("dense", dense))}
    ffn = 48 * 192 + 192 + 192 * 48 + 48
    assert n["moe"][0] - n["dense"][0] == 3
    assert n["moe"][1] - n["dense"][1] == 3 * (7 * ffn + 48 * 8)


def test_loss_aux_reaches_the_train_loops_records(tmp_path):
    write_synth_jsonl(tmp_path / "train.jsonl", 40, kind="tagger", seed=0)
    write_synth_jsonl(tmp_path / "dev.jsonl", 10, kind="tagger", seed=1)
    cfg = P.Config.from_str(MOE_CFG + """
[paths]
train = null
dev = null

[corpora.train]
@readers = "spacy.Corpus.v1"
path = ${paths.train}

[corpora.dev]
@readers = "spacy.Corpus.v1"
path = ${paths.dev}

[training]
max_steps = 4
eval_frequency = 2

[training.batcher]
@batchers = "spacy.batch_by_words.v1"
size = 120
""")
    cfg["paths"] = {"train": str(tmp_path / "train.jsonl"), "dev": str(tmp_path / "dev.jsonl")}
    _, result = p_train(cfg, tmp_path / "out", device="cpu", stdout_log=False)
    assert all("aux" in step and step["aux"] > 0 for step in result.step_head_losses)
    assert all("aux" in h["losses"] for h in result.history)


def test_committed_jax_moe_dir_gives_its_answers_in_the_port():
    # tests/data/jax_moe: written by the JAX package (bin/make_jax_moe_fixture.py);
    # chip_smoke.py serves it on the card
    from spacy_ray_tpu_torch.pipeline.doc import Doc, Example

    answers = json.loads((JAX_MOE / "answers.json").read_text(encoding="utf8"))
    nlp = P.Pipeline.from_disk(JAX_MOE, device="cpu")
    assert nlp.components["transformer"].model.dims["n_experts"] == 4
    for i, (text, (B, T)) in enumerate(zip(answers["texts"], answers["buckets"])):
        doc = nlp.tokenizer(text)
        nlp.predict_docs([doc], batch_size=1, pad_batch_to=B, pad_len_to=T)
        assert list(doc.tags) == answers["tags"][i]
        assert [int(h) for h in doc.heads] == answers["heads"][i]
        assert list(doc.deps) == answers["deps"][i]
        assert [[e.start, e.end, e.label] for e in doc.ents] == answers["ents"][i]
        if i < len(answers["trunk"]):
            batch = nlp.collate([Example.from_gold(Doc(words=list(doc.words)))],
                                pad_batch_to=B, pad_len_to=T)
            with torch.no_grad():
                X = nlp.forward(batch["tokens"])["transformer"].X[0, :len(doc)].numpy()
            np.testing.assert_allclose(X, np.asarray(answers["trunk"][i]), rtol=0, atol=1e-5)
    assert sum(len(e) for e in answers["ents"]) > 0
