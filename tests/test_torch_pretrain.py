"""The port's pretraining (``training/pretrain.py``, the ``pretrain``
command), ``[initialize] init_tok2vec`` and ``--code`` against the JAX
package, on the CPU, at the JAX package's own test size (HashEmbedCNN width
64, depth 2, embed_size 300).

Tolerances, with JAX's weights carried across and no dropout (the trunk has
no dropout site): the character and vector losses and ``char_acc`` within
1e-5; every leaf's gradient, trunk and head, within 1e-4 x its max |g| with
the parameters in float64 in both packages (the losses' softmax and norms
run in float32 in both, as written); three ``Adam.v1`` steps over the
``{"trunk", "head"}`` tree with the same gradients within 1e-6 x each
leaf's max. Targets, pretraining files and loaded weights are held
bit-equal, and every error to JAX's message.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.pipeline.vectors import Vectors as JVectors
from spacy_ray_tpu.pipeline.vectors import use_vectors as j_use_vectors
from spacy_ray_tpu.registry import import_code as j_import_code
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training import pretrain as jpt
from spacy_ray_tpu.models.layers import Linear as JLinear
from spacy_ray_tpu.training.checkpoint import _flatten

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import main as cli
from spacy_ray_tpu_torch.models.core import Context, param_paths
from spacy_ray_tpu_torch.registry import import_code
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training import pretrain as ppt
from spacy_ray_tpu_torch.training.checkpoint import load_params
from spacy_ray_tpu_torch.util import write_synth_jsonl

from test_torch_cnn_train import one_torch_thread  # noqa: F401  (module fixture)

REPO = Path(__file__).resolve().parent.parent

CFG = """
[paths]
raw_text = "{raw}"

[nlp]
lang = "en"
pipeline = ["tok2vec","tagger"]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 64
depth = 2
embed_size = 300
window_size = 1
maxout_pieces = 2
subword_features = true
pretrained_vectors = {pretrained_vectors}

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64

[corpora.pretrain]
@readers = "spacy.JsonlCorpus.v1"
path = ${{paths.raw_text}}

[pretraining]
max_steps = 12
batch_size = 8
corpus = "corpora.pretrain"

[pretraining.objective]
type = "{objective}"
n_characters = 3
hidden_size = {hidden}
loss = "{loss}"

[pretraining.optimizer]
@optimizers = "Adam.v1"
learn_rate = 0.01
"""

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Pretraining predicts characters from context vectors.",
    "Naïve café owners sell crème brûlée for 5€ — 日本 too!",
    "A b c: short tokens (x, y) and well-known don't contractions.",
]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """Raw-text lines and a small vectors table that has most of their
    words (some only in lower case, some not at all)."""
    d = tmp_path_factory.mktemp("pretrain")
    with open(d / "raw.jsonl", "w", encoding="utf8") as f:
        for t in TEXTS * 8:
            f.write(json.dumps({"text": t}) + "\n")
    words = sorted({w.lower() for t in TEXTS for w in P.Pipeline.from_config(
        P.Config.from_str('[nlp]\npipeline = []\n'), device="cpu").tokenizer(t).words})
    words = [w for i, w in enumerate(words) if i % 5 != 4]
    table = np.random.default_rng(3).normal(size=(len(words), 16)).astype(np.float32)
    JVectors(words, table).to_disk(d / "vectors.npz")
    return d


def _cfg_text(assets, objective="characters", hidden=0, loss="cosine", static=False,
              vectors=None):
    text = CFG.format(raw=assets / "raw.jsonl", objective=objective, hidden=hidden,
                      loss=loss, pretrained_vectors="true" if static else "null")
    if vectors or static:
        text += f'\n[initialize]\nvectors = "{assets / "vectors.npz"}"\n'
    return text


def _jax_objective(text, seed=1):
    """The JAX package's trunk, head, params ({"trunk", "head"}), loss and
    collated batch of the first 8 raw lines, built as its ``pretrain``
    builds them."""
    cfg = J.Config.from_str(text).interpolate()
    nlp = J.Pipeline.from_config(cfg)
    vec = (cfg.get("initialize") or {}).get("vectors")
    if vec:
        nlp.vectors = JVectors.from_disk(vec)
    comp = nlp.components["tok2vec"]
    with j_use_vectors(nlp.vectors):
        comp.build_model()
    obj = cfg["pretraining"]["objective"]
    if obj["type"] == "characters":
        head = jpt.build_char_head(64, 3, hidden=obj["hidden_size"])
        loss_fn = jpt.make_char_loss(comp.model, head, 3)
    else:
        head = JLinear(64, nlp.vectors.width, name="vec_head")
        loss_fn = jpt.make_vector_loss(comp.model, head, obj["loss"])
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    with j_use_vectors(nlp.vectors):
        params = {"trunk": comp.init_params(k1), "head": head.init(k2)}
    corpus = J.registry.resolve(cfg["corpora"]["pretrain"])
    with jcorpus.use_raw_text_tokenizer(nlp.tokenizer):
        egs = list(corpus())[:8]
    tokens = nlp.collate(egs, with_targets=False, pad_batch_to=len(egs))["tokens"]
    B, T = tokens.attr_keys.shape[:2]
    if obj["type"] == "characters":
        targets = {"chars": jnp.asarray(jpt.char_targets(egs, B, T, 3))}
    else:
        targets = {k: jnp.asarray(v) for k, v in jpt._vector_targets(nlp, egs, B, T).items()}
    return params, loss_fn, tokens, targets, egs


def _port_objective(text, jparams):
    """The port's :class:`Pretraining` on the CPU with JAX's params carried
    across, and its batch of the same 8 lines."""
    run = ppt.Pretraining(P.Config.from_str(text), device="cpu")
    carry(run, jparams)
    with pcorpus.use_raw_text_tokenizer(run.nlp.tokenizer):
        egs = list(run.corpus())[:8]
    tokens, targets, _ = run.batch(egs)
    return run, tokens, targets, egs


def carry(run, jparams):
    """JAX's pretraining tree ``{"trunk", "head"}`` into the port's trunk
    and head, parameters and persistent buffers (``frozen_table``), every
    key and shape checked."""
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    have = {f"{part}/{k}": t for part, model in (("trunk", run.trunk), ("head", run.head))
            for k, t in param_paths(model).items()}
    assert set(have) == set(flat)
    with torch.no_grad():
        for k, t in have.items():
            assert tuple(t.shape) == flat[k].shape, k
            t.copy_(torch.from_numpy(np.array(flat[k])))


def _port_grads(run, tokens, targets):
    params = run.params()
    for p in params.values():
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = run.loss_fn(tokens, targets, Context(train=True))
    loss.backward()
    grads = {k: p.grad.detach().numpy() for k, p in params.items()}
    for p in params.values():
        p.requires_grad_(False)
    return loss.detach(), metrics, grads


def test_char_targets_equal_jax_with_multibyte_short_tokens_and_padding():
    words = ["abc", "hello", "x", "naïve", "日本", "5€", "", "—"]
    jeg = J.Example.from_gold(J.Doc(words=words))
    peg = P.Example.from_gold(P.Doc(words=words))
    for B, T, n in ((3, 10, 2), (2, 4, 3), (1, 8, 4)):
        want = jpt.char_targets([jeg], B, T, n)
        got = ppt.char_targets([peg], B, T, n)
        assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
        assert not got[1:].any()  # padding rows: every slot absent
    assert list(got[0, 3, :4]) == [b + 1 for b in "naïve".encode("utf8")[:4]]
    assert peg._char_cache.shape == (len(words), 8)  # cached per Example


@pytest.mark.parametrize("hidden", [0, 32])
def test_char_loss_acc_and_gradients_match_jax(assets, hidden):
    text = _cfg_text(assets, hidden=hidden)
    jparams, jloss_fn, jtokens, jtargets, jegs = _jax_objective(text)
    run, tokens, targets, pegs = _port_objective(text, jparams)
    assert [e.reference.words for e in pegs] == [e.reference.words for e in jegs]
    assert np.array_equal(tokens.attr_keys.numpy(), np.asarray(jtokens.attr_keys).astype(np.int64))
    assert np.array_equal(targets["chars"].numpy(), np.asarray(jtargets["chars"]))
    jloss, jm = jloss_fn(jparams, jtokens, jtargets, jax.random.PRNGKey(0))
    ploss, pm, _ = _port_grads(run, tokens, targets)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert abs(float(pm["char_acc"]) - float(jm["char_acc"])) <= 1e-5
    _assert_grads_match(run, tokens, targets, jparams, jloss_fn, jtokens, jtargets)


@pytest.mark.parametrize("loss", ["cosine", "L2"])
def test_vector_loss_and_gradients_match_jax_masked_to_rows_with_a_vector(assets, loss):
    text = _cfg_text(assets, objective="vectors", loss=loss, vectors=True)
    jparams, jloss_fn, jtokens, jtargets, _ = _jax_objective(text)
    run, tokens, targets, _ = _port_objective(text, jparams)
    for k in ("vectors", "has_vec"):
        assert np.array_equal(targets[k].numpy(), np.asarray(jtargets[k])), k
    real = tokens.mask.numpy()
    has = targets["has_vec"].numpy()
    assert has[real].any() and not has[real].all() and not has[~real].any()
    jloss, _ = jloss_fn(jparams, jtokens, jtargets, jax.random.PRNGKey(0))
    ploss, _, pgrads = _port_grads(run, tokens, targets)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(np.isfinite(g).all() for g in pgrads.values())
    if loss == "cosine":
        # a padding row predicts exactly 0 through the zero-initialised bias,
        # where the norm's gradient is 0/0: NaN in JAX (ROADMAP C28), 0 here
        jg = jax.grad(lambda p: jloss_fn(p, jtokens, jtargets, jax.random.PRNGKey(0))[0])(
            jparams)
        assert np.isnan(np.asarray(jg["head"]["b"])).any()
    # with a bias that is not zero, no row predicts 0: every gradient as JAX's
    bias = np.random.default_rng(4).normal(size=jparams["head"]["b"].shape) * 0.1
    jparams["head"]["b"] = jnp.asarray(bias, jnp.float32)
    carry(run, jparams)
    _assert_grads_match(run, tokens, targets, jparams, jloss_fn, jtokens, jtargets)


def _assert_grads_match(run, tokens, targets, jparams, jloss_fn, jtokens, jtargets):
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
        t64 = {k: (jnp.asarray(v, jnp.float64) if v.dtype == jnp.float32 else v)
               for k, v in jtargets.items()}
        jg = jax.grad(lambda p: jloss_fn(p, jtokens, t64, jax.random.PRNGKey(0))[0])(p64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jg).items()}
    run.trunk.double()
    run.head.double()
    t64 = {k: (v.double() if v.is_floating_point() else v) for k, v in targets.items()}
    _, _, pgrads = _port_grads(run, tokens, t64)
    run.trunk.float()
    run.head.float()
    assert set(pgrads) == set(jflat)
    assert any(k.startswith("head/") for k in pgrads)
    for k, g in jflat.items():
        assert pgrads[k].dtype == np.float64
        np.testing.assert_allclose(pgrads[k], g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30), err_msg=k)


def test_three_adam_steps_over_trunk_and_head_match_jax_chain(assets):
    text = _cfg_text(assets, hidden=32)
    jparams, jloss_fn, jtokens, jtargets, _ = _jax_objective(text)
    run, _, _, _ = _port_objective(text, jparams)
    params = run.params()
    state = run.optimizer.init(params)
    tx = J.registry.get("optimizers", "Adam.v1")(learn_rate=0.01)
    jstate = tx.init(jparams)
    grad_fn = jax.jit(jax.grad(lambda p: jloss_fn(p, jtokens, jtargets,
                                                  jax.random.PRNGKey(0))[0]))
    for _ in range(3):
        jg = grad_fn(jparams)
        flat_g = {k: np.asarray(v) for k, v in _flatten(jg).items()}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        with torch.no_grad():
            run.optimizer.update(params, {k: torch.from_numpy(np.array(flat_g[k])) for k in params},
                                 state)
    jflat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    assert set(jflat) == set(params)
    for k, p in params.items():
        scale = max(np.abs(jflat[k]).max(), 1e-30)
        assert np.abs(p.numpy() - jflat[k]).max() <= 1e-6 * scale, k


def _initialized(pkg, text, init_tok2vec):
    cfg = pkg.Config.from_str(text)
    cfg.setdefault("initialize", {})["init_tok2vec"] = str(init_tok2vec)
    kw = {"device": "cpu"} if pkg is P else {}
    nlp = pkg.Pipeline.from_config(cfg.interpolate(), **kw)
    egs = [pkg.Example.from_gold(pkg.Doc(words=["a", "b"], tags=["X", "Y"]))]
    nlp.initialize(lambda: iter(egs), seed=0)
    return nlp


def _trunk_flat(pkg, nlp):
    if pkg is P:
        return {k: v.numpy() for k, v in param_paths(nlp.model["tok2vec"]).items()}
    return {k: np.asarray(v) for k, v in _flatten(nlp.params["tok2vec"]).items()}


@pytest.mark.parametrize("static", [False, True], ids=["cnn", "static_vectors"])
def test_pretraining_files_load_bit_equal_in_both_packages(assets, tmp_path, static):
    text = _cfg_text(assets, static=static)
    pcfg = P.Config.from_str(text)
    pcfg["pretraining"]["max_steps"] = 3
    stats = ppt.pretrain(pcfg, tmp_path / "port", device="cpu")
    assert stats["steps"] == 3 and np.isfinite(stats["loss"])
    jcfg = J.Config.from_str(text)
    jcfg["pretraining"]["max_steps"] = 1
    jpt.pretrain(jcfg, tmp_path / "jax")
    port_file = load_params(tmp_path / "port" / "model-last.npz")
    jax_file = load_params(tmp_path / "jax" / "model-last.npz")
    assert set(port_file) == set(jax_file)
    assert all(port_file[k].shape == jax_file[k].shape for k in port_file)
    frozen = [k for k in port_file if k.endswith("frozen_table")]
    assert len(frozen) == int(static)
    for k in frozen:
        table = JVectors.from_disk(assets / "vectors.npz").table
        assert np.array_equal(port_file[k], table) and np.array_equal(jax_file[k], table)
    lines = (tmp_path / "port" / "log.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines] == [1, 2, 3]
    for path, saved in ((tmp_path / "port" / "model-last.npz", port_file),
                        (tmp_path / "jax" / "model-last.npz", jax_file)):
        for pkg in (P, J):
            got = _trunk_flat(pkg, _initialized(pkg, text, path))
            assert set(got) == set(saved)
            for k in saved:
                assert np.array_equal(got[k], saved[k]), (pkg.__name__, path, k)


def test_init_tok2vec_errors_match_jax(assets, tmp_path):
    text = _cfg_text(assets)
    pcfg = P.Config.from_str(text)
    pcfg["pretraining"]["max_steps"] = 1
    ppt.pretrain(pcfg, tmp_path, device="cpu")
    # another trunk width: every shape-mismatched key named, the same message
    wide = text.replace("width = 64", "width = 96")
    errors = []
    for pkg in (P, J):
        with pytest.raises(ValueError, match="init_tok2vec") as e:
            _initialized(pkg, wide, tmp_path / "model-last.npz")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "shape-mismatched=['0_multi_hash_embed" in errors[0]
    # a pipeline with no trunk: the tagger embeds inline
    inline = text.replace('pipeline = ["tok2vec","tagger"]', 'pipeline = ["tagger"]').replace(
        '@architectures = "spacy.Tok2VecListener.v1"\nwidth = 64',
        '@architectures = "spacy.HashEmbedCNN.v2"\nwidth = 64\ndepth = 1\nembed_size = 300\n'
        'window_size = 1\nmaxout_pieces = 2\nsubword_features = true\npretrained_vectors = null')
    errors = []
    for pkg in (P, J):
        with pytest.raises(ValueError, match="no tok2vec/transformer trunk") as e:
            _initialized(pkg, inline, tmp_path / "model-last.npz")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("case", ["no_block", "component", "objective", "no_vectors",
                                  "empty_corpus"])
def test_pretrain_errors_match_jax(assets, tmp_path, case):
    text = _cfg_text(assets)
    if case == "no_block":
        text = text.split("[pretraining]")[0]
    elif case == "component":
        text = text.replace('corpus = "corpora.pretrain"',
                            'corpus = "corpora.pretrain"\ncomponent = "tok2vecs"')
    elif case == "objective":
        text = text.replace('type = "characters"', 'type = "words"')
    elif case == "no_vectors":
        text = text.replace('type = "characters"', 'type = "vectors"')
    else:
        (tmp_path / "empty.jsonl").write_text("")
        text = text.replace(str(assets / "raw.jsonl"), str(tmp_path / "empty.jsonl"))
    errors = []
    for pkg, run in ((P, lambda c: ppt.pretrain(c, tmp_path / "p", device="cpu")),
                     (J, lambda c: jpt.pretrain(c, tmp_path / "j"))):
        with pytest.raises(ValueError) as e:
            run(pkg.Config.from_str(text))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_raw_text_lines_raise_outside_pretraining_as_in_jax(assets):
    errors = []
    for mod in (pcorpus, jcorpus):
        with pytest.raises(ValueError, match="raw 'text'") as e:
            list(mod.Corpus(assets / "raw.jsonl")())
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_pretrain_cli_runs_on_the_cpu_and_refuses_several_workers(assets, tmp_path, capsys):
    cfg = tmp_path / "pt.cfg"
    cfg.write_text(_cfg_text(assets))
    assert cli(["pretrain", str(cfg), str(tmp_path / "out"), "--device", "cpu",
                "--pretraining.max_steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "pretrain step      1" in out and "Pretraining done. steps=4 loss=" in out
    assert (tmp_path / "out" / "model-last.npz").exists()
    with pytest.raises(NotImplementedError, match="slice 7"):
        cli(["pretrain", str(cfg), str(tmp_path / "out2"), "--device", "cpu",
             "--n-workers", "2"])


CODE = '''
import json
from spacy_ray_tpu_torch.registry import registry


@registry.callbacks("test_code.record_steps.v1")
def make(path):
    def before_update(nlp, info):
        with open(path, "a") as f:
            f.write(json.dumps(info) + "\\n")
    return before_update


@registry.architectures("test_code.Tagger.v1")
def tagger(tok2vec, nO=None):
    return registry.get("architectures", "spacy.Tagger.v2")(tok2vec=tok2vec, nO=nO)
'''


def test_code_registers_a_callback_and_an_architecture_for_train_and_evaluate(tmp_path):
    code = tmp_path / "user_code.py"
    code.write_text(CODE)
    write_synth_jsonl(tmp_path / "train.jsonl", 40, kind="tagger", seed=0)
    write_synth_jsonl(tmp_path / "dev.jsonl", 10, kind="tagger", seed=1)
    (tmp_path / "cfg.cfg").write_text(_tagger_cfg(tmp_path))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    base = [sys.executable, "-m", "spacy_ray_tpu_torch"]
    train = base + ["train", str(tmp_path / "cfg.cfg"), "--output", str(tmp_path / "out"),
                    "--device", "cpu", "--training.max_steps", "4",
                    "--training.eval_frequency", "2"]
    out = subprocess.run(train, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and "test_code.Tagger.v1" in out.stderr
    out = subprocess.run(train + ["--code", str(code)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    calls = [json.loads(l) for l in (tmp_path / "steps.jsonl").read_text().splitlines()]
    assert [c["step"] for c in calls] == [0, 1, 2, 3]
    evaluate = base + ["evaluate", str(tmp_path / "out" / "best-model"),
                       str(tmp_path / "dev.jsonl"), "--device", "cpu"]
    out = subprocess.run(evaluate, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and "test_code.Tagger.v1" in out.stderr
    out = subprocess.run(evaluate + ["--code", str(code)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert "tag_acc" in json.loads(out.stdout.strip().splitlines()[-1])


def _tagger_cfg(tmp_path):
    return f"""
[paths]
train = "{tmp_path / 'train.jsonl'}"
dev = "{tmp_path / 'dev.jsonl'}"

[nlp]
lang = "en"
pipeline = ["tok2vec","tagger"]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 32
depth = 1
embed_size = 300
window_size = 1
maxout_pieces = 2
subword_features = true
pretrained_vectors = null

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "test_code.Tagger.v1"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32

[corpora.train]
@readers = "spacy.Corpus.v1"
path = ${{paths.train}}

[corpora.dev]
@readers = "spacy.Corpus.v1"
path = ${{paths.dev}}

[training.before_update]
@callbacks = "test_code.record_steps.v1"
path = "{tmp_path / 'steps.jsonl'}"
"""


def test_code_path_not_found_raises_as_in_jax(tmp_path):
    errors = []
    for fn in (import_code, j_import_code):
        with pytest.raises(FileNotFoundError) as e:
            fn(str(tmp_path / "missing.py"))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    import_code(None)  # no --code: nothing to import
    with pytest.raises(FileNotFoundError):
        cli(["evaluate", str(tmp_path), str(tmp_path / "d.jsonl"), "--device", "cpu",
             "--code", str(tmp_path / "missing.py")])
