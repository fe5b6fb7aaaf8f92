"""The port's pretrained trunk weights (``models/pretrained.py``,
``init_weights``, ``spacy-transformers.TransformerModel.v3``) against the
JAX package, on the CPU, at a small size (width 64, depth 2, 4 heads).

Safetensors files written by either package read bit-equal in the other
(and the writers write the same bytes); the Hugging Face remap, the merge
and its report equal JAX's; a trunk started from a native checkpoint that
holds every key gives JAX's trunk output within 1e-4 (f32, the tolerance of
``test_torch_pipeline.py``), and the encoder leaves of a RoBERTa-layout file
load bit-equal to the remapped arrays; every error has JAX's message.
"""

import json
import struct

import numpy as np
import pytest
import torch

import spacy_ray_tpu as J
from spacy_ray_tpu.models import pretrained as JPT
from spacy_ray_tpu.training.checkpoint import _flatten

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models import pretrained as PPT
from spacy_ray_tpu_torch.models.core import param_paths

from test_torch_pipeline import TEXTS, TRF_TAGGER_CFG, _collate_both, _gold

W, FFN, DEPTH, MAX_LEN = 64, 256, 2, 512


def _hf_state(rng, prefix="", pos_rows=None, width=W, ffn=FFN, depth=DEPTH):
    """A Hugging Face BERT/RoBERTa encoder's keys and shapes ([out, in]
    weights), values from ``rng``."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    hf = {}
    for i in range(depth):
        pre = f"{prefix}encoder.layer.{i}."
        for part in ("query", "key", "value"):
            hf[pre + f"attention.self.{part}.weight"] = f(width, width)
            hf[pre + f"attention.self.{part}.bias"] = f(width)
        hf[pre + "attention.output.dense.weight"] = f(width, width)
        hf[pre + "attention.output.dense.bias"] = f(width)
        hf[pre + "attention.output.LayerNorm.weight"] = f(width)
        hf[pre + "attention.output.LayerNorm.bias"] = f(width)
        hf[pre + "intermediate.dense.weight"] = f(ffn, width)
        hf[pre + "intermediate.dense.bias"] = f(ffn)
        hf[pre + "output.dense.weight"] = f(width, ffn)
        hf[pre + "output.dense.bias"] = f(width)
        hf[pre + "output.LayerNorm.weight"] = f(width)
        hf[pre + "output.LayerNorm.bias"] = f(width)
    if pos_rows:
        emb = prefix + "embeddings."
        hf[emb + "position_embeddings.weight"] = f(pos_rows, width)
        hf[emb + "word_embeddings.weight"] = f(50, width)
        hf[emb + "LayerNorm.weight"] = f(width)
    return hf


def test_safetensors_read_bit_equal_across_packages_and_written_alike(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"a/f32": rng.normal(size=(3, 5)).astype(np.float32),
               "b.f64": rng.normal(size=(4,)), "c_f16": rng.normal(size=(2, 2)).astype(np.float16),
               "d": np.arange(7, dtype=np.int64), "e": np.arange(6, dtype=np.int32).reshape(2, 3),
               "f": np.array([1, 0, 1], dtype=np.uint8), "g": np.array([True, False]),
               "h": np.zeros((0, 3), np.float32)}
    PPT.write_safetensors(tmp_path / "p.safetensors", tensors)
    JPT.write_safetensors(tmp_path / "j.safetensors", tensors)
    assert (tmp_path / "p.safetensors").read_bytes() == (tmp_path / "j.safetensors").read_bytes()
    for path in ("p.safetensors", "j.safetensors"):
        got, want = PPT.read_safetensors(tmp_path / path), JPT.read_safetensors(tmp_path / path)
        assert set(got) == set(want) == set(tensors)
        for k in tensors:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="unsupported dtype"):
        PPT.write_safetensors(tmp_path / "x.safetensors", {"c": np.zeros(2, np.complex64)})
    # bf16 (what Hugging Face checkpoints often hold): both read it as f32
    vals = rng.normal(size=(3, 4)).astype(np.float32)
    bits = (vals.view(np.uint32) >> 16).astype("<u2")
    header = json.dumps({"w": {"dtype": "BF16", "shape": [3, 4],
                               "data_offsets": [0, bits.nbytes]}}).encode()
    (tmp_path / "bf16.safetensors").write_bytes(struct.pack("<Q", len(header)) + header
                                                + bits.tobytes())
    got = PPT.read_safetensors(tmp_path / "bf16.safetensors")["w"]
    want = JPT.read_safetensors(tmp_path / "bf16.safetensors")["w"]
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.abs(got - vals).max() <= 2 ** -7 * np.abs(vals).max()


@pytest.mark.parametrize("case", ["bert", "roberta_prefixed", "roberta_prefixless",
                                  "roberta_prefixed_no_target"])
def test_hf_remap_equals_jax(case):
    rng = np.random.default_rng(1)
    prefix = "roberta." if case.startswith("roberta_prefixed") else ""
    rows = {"bert": MAX_LEN, "roberta_prefixed": MAX_LEN + 2,
            "roberta_prefixless": MAX_LEN + 2, "roberta_prefixed_no_target": 40}[case]
    hf = _hf_state(rng, prefix, pos_rows=rows)
    target = None if case.endswith("no_target") else MAX_LEN
    assert PPT.looks_like_hf_encoder(hf) and JPT.looks_like_hf_encoder(hf)
    got = PPT.hf_encoder_to_native(hf, native_pos_rows=target)
    want = JPT.hf_encoder_to_native(hf, native_pos_rows=target)
    assert set(got) == set(want) and len(got) == 12 * DEPTH + 1
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    skipped = 0 if case == "bert" else 2
    assert np.array_equal(got["pos"], hf[f"{prefix}embeddings.position_embeddings.weight"][skipped:])
    assert got["layer_1/qkv_W"].shape == (W, 3 * W) and got["layer_0/ffn_W1"].shape == (W, FFN)
    with pytest.raises(ValueError, match="no encoder.layer.N"):
        PPT.hf_encoder_to_native({"x.attention.self.query.weight": np.zeros(2)})


def _params(rng):
    return {"pos": rng.normal(size=(8, 4)).astype(np.float32),
            "layer_0": {"qkv_W": rng.normal(size=(4, 12)).astype(np.float32),
                        "ln1_g": np.ones(4, np.float32)}}


@pytest.mark.parametrize("pos_rows", [8, 5, 11])
def test_merge_and_its_report_equal_jax(pos_rows):
    rng = np.random.default_rng(2)
    params = _params(rng)
    loaded = {"pos": rng.normal(size=(pos_rows, 4)).astype(np.float32),
              "layer_0/qkv_W": rng.normal(size=(4, 12)).astype(np.float32),
              "extra/thing": np.zeros(3, np.float32)}
    got, got_report = PPT.merge_pretrained(
        {"pos": torch.tensor(params["pos"]), "layer_0": {
            k: torch.tensor(v) for k, v in params["layer_0"].items()}}, loaded)
    want, want_report = JPT.merge_pretrained(params, loaded)
    assert got_report == want_report
    assert got_report["missing"] == ["layer_0/ln1_g"] and got_report["unused"] == ["extra/thing"]
    want = {k: np.asarray(v) for k, v in _flatten(want).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k
    bad = dict(loaded, **{"layer_0/qkv_W": np.zeros((4, 9), np.float32)})
    errors = []
    for merge in (PPT.merge_pretrained, JPT.merge_pretrained):
        with pytest.raises(ValueError, match="param expects") as e:
            merge(params, bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _pipelines(init_weights, seed=7, cfg_text=TRF_TAGGER_CFG):
    out = []
    for pkg in (P, J):
        cfg = pkg.Config.from_str(cfg_text)
        if init_weights is not None:
            cfg = cfg.apply_overrides(
                {"components.transformer.model.init_weights": str(init_weights)})
        kw = {"device": "cpu"} if pkg is P else {}
        nlp = pkg.Pipeline.from_config(cfg.interpolate(), **kw)
        egs = _gold() if pkg is J else [P.Example.from_gold(P.Doc(words=e.reference.words,
                                                                  tags=e.reference.tags))
                                        for e in _gold()]
        nlp.initialize(lambda: egs, seed=seed)
        out.append(nlp)
    return out


def test_native_checkpoint_with_every_key_gives_jax_trunk_output(tmp_path, capsys):
    source = J.Pipeline.from_config(J.Config.from_str(TRF_TAGGER_CFG).interpolate())
    source.initialize(lambda: _gold(), seed=0)
    JPT.save_trunk_params(tmp_path / "trunk.npz", source.params["transformer"])
    pnlp, jnlp = _pipelines(tmp_path / "trunk.npz")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[transformer]")]
    assert len(lines) == 2 and lines[0] == lines[1] and "(0 left at init, 0 unused" in lines[0]
    saved = dict(np.load(tmp_path / "trunk.npz"))
    for k, t in param_paths(pnlp.model["transformer"]).items():
        assert np.array_equal(t.numpy(), saved[k]), k
    jb, pb = _collate_both(jnlp, pnlp, TEXTS)
    jout = jnlp.make_forward_fn()(jnlp.params, jb["tokens"])
    with torch.inference_mode():
        pout = pnlp.forward(pb["tokens"])
    np.testing.assert_allclose(pout["transformer"].X.numpy(),
                               np.asarray(jout["transformer"].X), atol=1e-4)
    # the port's save_trunk_params writes what JAX's init_weights loads
    PPT.save_trunk_params(tmp_path / "port.npz", pnlp.model["transformer"])
    _, jnlp2 = _pipelines(tmp_path / "port.npz", seed=3)
    for k, v in _flatten(jnlp2.params["transformer"]).items():
        assert np.array_equal(np.asarray(v), saved[k]), k


def test_roberta_layout_safetensors_loads_bit_equal_to_the_remap(tmp_path, capsys):
    hf = _hf_state(np.random.default_rng(3), "roberta.", pos_rows=MAX_LEN + 2)
    PPT.write_safetensors(tmp_path / "roberta.safetensors", hf)
    want = PPT.hf_encoder_to_native(hf, native_pos_rows=MAX_LEN)
    pnlp, jnlp = _pipelines(tmp_path / "roberta.safetensors")
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[transformer]")]
    have = param_paths(pnlp.model["transformer"])
    assert lines[0] == lines[1]  # the embedding block is dropped by the remap, not unused
    assert (f"loaded {12 * DEPTH + 1} tensors" in lines[0]
            and f"({len(have) - 12 * DEPTH - 1} left at init, 0 unused in file)" in lines[0])
    jflat = _flatten(jnlp.params["transformer"])
    for k, v in want.items():
        assert np.array_equal(have[k].numpy(), v) and np.array_equal(np.asarray(jflat[k]), v), k
    # keys absent from the file keep the seeded draw of a run without it
    plain = _pipelines(None)[0]
    embed = [k for k in have if k.startswith("embed/")]
    assert embed and all(torch.equal(have[k], param_paths(plain.model["transformer"])[k])
                         for k in embed)


V3_CFG = TRF_TAGGER_CFG.replace(
    '''@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 64
depth = 2
n_heads = 4
ffn_mult = 4
dropout = 0.1
max_len = 512
embed_size = 500''', '''@architectures = "spacy-transformers.TransformerModel.v3"
name = "{name}"

[components.transformer.model.transformer_config]
width = 64
depth = 2
n_heads = 4''').replace("${components.transformer.model.width}", "64")


def test_transformer_model_v3_loads_a_local_path_and_refuses_a_hub_name(tmp_path):
    errors = []
    for pkg in (P, J):
        cfg = pkg.Config.from_str(V3_CFG.replace("{name}", "roberta-base")).interpolate()
        with pytest.raises(NotImplementedError, match="not a local file") as e:
            kw = {"device": "cpu"} if pkg is P else {}
            pkg.Pipeline.from_config(cfg, **kw).initialize(lambda: [], seed=0)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    hf = _hf_state(np.random.default_rng(4), "roberta.", pos_rows=MAX_LEN + 2)
    PPT.write_safetensors(tmp_path / "model.safetensors", hf)
    want = PPT.hf_encoder_to_native(hf, native_pos_rows=MAX_LEN)
    pnlp, jnlp = _pipelines(None, cfg_text=V3_CFG.replace("{name}", str(tmp_path)))
    have = param_paths(pnlp.model["transformer"])
    jflat = _flatten(jnlp.params["transformer"])
    assert set(have) == set(jflat)
    for k, v in want.items():
        assert np.array_equal(have[k].numpy(), v) and np.array_equal(np.asarray(jflat[k]), v), k


def test_a_file_that_matches_nothing_is_refused_as_in_jax(tmp_path):
    PPT.write_safetensors(tmp_path / "distil.safetensors",
                          {"transformer.layer.0.attention.q_lin.weight": np.zeros((4, 4),
                                                                                   np.float32)})
    errors = []
    for pkg in (P, J):
        with pytest.raises(ValueError, match="matched the trunk schema") as e:
            _pipelines_one(pkg, tmp_path / "distil.safetensors")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    with pytest.raises(ValueError, match="want .npz or .safetensors"):
        PPT.load_flat(tmp_path / "x.bin")
    with pytest.raises(ValueError, match="without model.safetensors"):
        PPT.load_flat(tmp_path)


def _pipelines_one(pkg, init_weights):
    cfg = pkg.Config.from_str(TRF_TAGGER_CFG).apply_overrides(
        {"components.transformer.model.init_weights": str(init_weights)})
    kw = {"device": "cpu"} if pkg is P else {}
    pkg.Pipeline.from_config(cfg.interpolate(), **kw).initialize(lambda: _gold(), seed=0)


@pytest.mark.parametrize("arch", ["bert", "roberta"])
def test_a_transformers_checkpoint_remaps_as_jax_and_its_attention_matches_torch(arch, tmp_path):
    # JAX tests/test_pretrained.py's check of a real save_pretrained
    # checkpoint, for both layouts: the port's remap bit-equal to JAX's, and
    # the remapped attention sublayer equal to transformers' within 1e-4
    tfm = pytest.importorskip("transformers")
    kw = dict(hidden_size=32, num_attention_heads=4, num_hidden_layers=2,
              intermediate_size=64, vocab_size=100)
    if arch == "bert":
        cfg, cls, rows = tfm.BertConfig(max_position_embeddings=16, **kw), tfm.BertModel, 16
    else:  # RoBERTa's two leading padding rows of its position table
        cfg, cls, rows = tfm.RobertaConfig(max_position_embeddings=18, **kw), tfm.RobertaModel, 16
    torch.manual_seed(0)
    model = cls(cfg).eval()
    model.save_pretrained(tmp_path / "hf", safe_serialization=True)
    pflat, jflat = PPT.load_flat(tmp_path / "hf"), JPT.load_flat(tmp_path / "hf")
    assert set(pflat) == set(jflat) and all(np.array_equal(pflat[k], jflat[k]) for k in jflat)
    assert PPT.looks_like_hf_encoder(pflat) and JPT.looks_like_hf_encoder(jflat)
    native = PPT.hf_encoder_to_native(pflat, native_pos_rows=rows)
    jnative = JPT.hf_encoder_to_native(jflat, native_pos_rows=rows)
    assert set(native) == set(jnative)
    for k, v in jnative.items():
        assert native[k].dtype == np.asarray(v).dtype and np.array_equal(native[k], v), k
    assert native["layer_0/qkv_W"].shape == (32, 96) and native["pos"].shape == (rows, 32)
    B, T, D, H = 1, 5, 32, 4
    x = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    layer = model.encoder.layer[0]
    with torch.no_grad():
        ctx = layer.attention.self(torch.from_numpy(x))[0]
        want = layer.attention.output.dense(ctx).numpy()
    q, k, v = np.split(x @ native["layer_0/qkv_W"] + native["layer_0/qkv_b"], 3, axis=-1)

    def heads(a):  # [B, T, D] -> [B, H, T, Dh]
        return a.reshape(B, T, H, D // H).transpose(0, 2, 1, 3)

    scores = heads(q) @ heads(k).transpose(0, 1, 3, 2) / np.sqrt(D // H)
    probs = np.exp(scores - scores.max(axis=-1, keepdims=True))
    probs /= probs.sum(axis=-1, keepdims=True)
    got = ((probs @ heads(v)).transpose(0, 2, 1, 3).reshape(B, T, D) @ native["layer_0/o_W"]
           + native["layer_0/o_b"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
