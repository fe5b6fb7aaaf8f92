"""The port's CNN pipelines (configs/cnn.cfg and sm.cfg as written) in
training, on the CPU, against the JAX package: one batch's loss and every
leaf's gradient with carried weights, the ``train`` loop's dev ``tag_acc``
against the JAX loop's, and the commands a user runs (``train``,
``evaluate``, ``serve``) on ``.spacy`` corpora.

Tolerances: the loss (float32) within 1e-5 relative and each leaf's
gradient within 1e-4 of its max |g|, computed in float64 by both packages,
and in float32 once the batch's maxout near-ties are broken (near a tie
either package's float32 sums may pick either piece; see the tests);
dropout off, as its bits come from different generators. The loops'
dev ``tag_acc`` within 5 points (initial weights and dropout bits differ).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import spacy_ray_tpu as J
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.training.loop import train as j_train
from spacy_ray_tpu.udgen import write_ud_jsonl as j_write_ud

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.__main__ import build_server
from spacy_ray_tpu_torch.models.layers import Maxout
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.loop import train as p_train
from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread for the module's tests: the test
    workers share the cores, and torch's parallel regions stall when their
    threads outnumber the cores (a CPU train loop ran ~100 x slower so).
    Modules that import this fixture get it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A pseudo-UD corpus as .jsonl and as .spacy (the port's writer)."""
    d = tmp_path_factory.mktemp("cnn_data")
    j_write_ud(d / "train.jsonl", 160, seed=0, max_sents=2)
    j_write_ud(d / "dev.jsonl", 40, seed=1, max_sents=2)
    for split in ("train", "dev"):
        write_docbin(d / f"{split}.spacy", pcorpus.read_jsonl_docs(d / f"{split}.jsonl"))
    return d


def _config(pkg, name, data, suffix=".spacy", **training):
    cfg = pkg.Config.from_disk(REPO / "configs" / f"{name}.cfg")
    cfg["paths"] = {"train": str(data / f"train{suffix}"), "dev": str(data / f"dev{suffix}")}
    cfg["training"].update(training)
    return cfg


def _carried(name, data, model_dir):
    """A JAX pipeline initialized on the corpus, the port's pipeline loaded
    from its model directory, and the same 12 docs collated by both."""
    jcfg = _config(J, name, data, suffix=".jsonl").interpolate()
    jnlp = J.Pipeline.from_config(jcfg)
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(model_dir)
    pnlp = P.Pipeline.from_disk(model_dir, device="cpu")
    jb = jnlp.collate(egs[:12])
    pb = pnlp.collate(list(pcorpus.Corpus(data / "train.spacy")())[:12], with_targets=True)
    for head, t in jb["targets"].items():
        for key, v in t.items():
            assert np.array_equal(np.asarray(v), pb["targets"][head][key].numpy()), (head, key)
    return jnlp, pnlp, jb, pb


def _port_loss_and_grads(pnlp, pb):
    pnlp.model.requires_grad_(True)
    params = {k.replace(".", "/"): p for k, p in pnlp.model.named_parameters()}
    for p in params.values():
        p.grad = None
    loss, metrics = pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
    loss.backward()
    pnlp.model.requires_grad_(False)
    return loss.detach(), metrics, {k: p.grad.numpy() for k, p in params.items()}


def _jax_grads(jnlp, jb):
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                               jax.random.PRNGKey(0))[0]))(jnlp.params)
    return {k: np.asarray(v) for k, v in _flatten(grads).items()}


def _assert_grads_close(pgrads, jflat, n_leaves, dtype):
    assert set(jflat) == set(pgrads) and len(pgrads) == n_leaves
    for k, g in jflat.items():
        assert g.dtype == pgrads[k].dtype == dtype
        np.testing.assert_allclose(pgrads[k], g, rtol=0,
                                   atol=1e-4 * max(np.abs(g).max(), 1e-30), err_msg=k)


def _break_maxout_ties(pnlp, pb, gap=1e-4, nudge=1e-2):
    """Raise by ``nudge`` the bias of each maxout piece that wins a real
    token by less than ``gap`` (relative, in float64), until no maxout of the
    batch has such a near-tie; returns the number of pieces nudged. Near a
    tie the float32 sums of either package may pick either piece."""
    maxouts = [m for m in pnlp.model.modules() if isinstance(m, Maxout)]
    assert maxouts
    nudged = 0
    pnlp.model.double()
    for _ in range(8):
        seen = []
        hooks = [m.register_forward_hook(lambda m, inp, out: seen.append((m, inp[0])))
                 for m in maxouts]
        with torch.no_grad():
            pnlp.loss(pb["tokens"], pb["targets"], dropout=0.0)
        for h in hooks:
            h.remove()
        pieces = set()
        for m, x in seen:
            nO, nP = m.b.shape
            h = (x.X @ m.W).reshape(*x.X.shape[:-1], nO, nP) + m.b
            top2 = h[x.mask].topk(2, dim=-1)
            near = (top2.values[..., 0] - top2.values[..., 1]
                    < gap * (1 + top2.values[..., 0].abs()))
            pieces |= {(m, o, int(top2.indices[row, o, 0]))
                       for row, o in near.nonzero().tolist()}
        if not pieces:
            pnlp.model.float()
            return nudged
        with torch.no_grad():
            for m, o, piece in pieces:
                m.b[o, piece] += nudge
        nudged += len(pieces)
    raise AssertionError("maxout near-ties remain after 8 rounds of nudges")


@pytest.mark.parametrize("name", ["cnn", "sm"])
def test_loss_and_gradients_of_one_batch_match_jax(name, data, tmp_path):
    jnlp, pnlp, jb, pb = _carried(name, data, tmp_path)
    loss_fn = jnlp.make_loss_fn(dropout=0.0)
    # the loss in float32, the training dtype
    jloss, jmetrics = jax.jit(loss_fn)(jnlp.params, jb["tokens"], jb["targets"],
                                       jax.random.PRNGKey(0))
    ploss, pmetrics, _ = _port_loss_and_grads(pnlp, pb)
    assert set(pmetrics) == set(jmetrics)
    assert abs(float(ploss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for head in pnlp.head_names():
        jl = float(jmetrics[f"loss_{head}"])
        assert abs(float(pmetrics[f"loss_{head}"]) - jl) <= 1e-5 * abs(jl), head
    # the gradients with every parameter in float64 in both packages: in
    # float32 a maxout whose two top pieces lie within rounding of each other
    # can route a token's gradient to either piece (on this batch one
    # token of cnn.cfg's third encoder block, 1e-6 apart, moves that block's
    # W gradient by 3 % of its max in the port and not in JAX, whose float32
    # sums happen to round as the float64 ones do; and through the blocks
    # below it, every leaf under it by up to 0.6 %)
    with jax.enable_x64():
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype=jnp.float64),
                                          jnlp.params)
        jgrads = jax.jit(jax.grad(lambda p: loss_fn(p, jb["tokens"], jb["targets"],
                                                    jax.random.PRNGKey(0))[0]))(params64)
        jflat = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    pnlp.model.double()
    _assert_grads_close(_port_loss_and_grads(pnlp, pb)[2], jflat,
                        {"cnn": 26, "sm": 34}[name], np.float64)


@pytest.mark.parametrize("name", ["cnn", "sm"])
def test_float32_gradients_of_one_batch_match_jax(name, data, tmp_path):
    # the training dtype, every leaf: first each maxout near-tie of the batch
    # is broken by a bias nudge in the port, and the nudged weights go to JAX
    # through a model directory, so both packages route every token alike
    _, pnlp, _, pb = _carried(name, data, tmp_path / "jax")
    assert _break_maxout_ties(pnlp, pb) >= 1
    pnlp.to_disk(tmp_path / "nudged")
    jnlp = J.Pipeline.from_disk(tmp_path / "nudged")
    jb = jnlp.collate(list(jcorpus.Corpus(data / "train.jsonl")())[:12])
    _assert_grads_close(_port_loss_and_grads(pnlp, pb)[2], _jax_grads(jnlp, jb),
                        {"cnn": 26, "sm": 34}[name], np.float32)


def test_port_train_on_cnn_cfg_reaches_the_jax_loop_tag_acc(data, tmp_path):
    # configs/cnn.cfg as written but for the run's length and the batch
    # (400 words, so that 16 steps see the corpus twice)
    batcher = {"@batchers": "spacy.batch_by_words.v1", "size": 400, "tolerance": 0.2}
    _, presult = p_train(_config(P, "cnn", data, max_steps=16, eval_frequency=8,
                                 batcher=batcher), tmp_path / "port", device="cpu",
                         stdout_log=False)
    _, jresult = j_train(_config(J, "cnn", data, suffix=".jsonl", max_steps=16,
                                 eval_frequency=8, batcher=batcher),
                         tmp_path / "jax", n_workers=1, stdout_log=False)
    p_acc = presult.history[-1]["other_scores"]["tag_acc"]
    j_acc = jresult.history[-1]["other_scores"]["tag_acc"]
    assert [h["step"] for h in presult.history] == [h["step"] for h in jresult.history] == [8, 16]
    assert abs(p_acc - j_acc) <= 0.05, (p_acc, j_acc)
    assert p_acc > 0.8 and presult.step_losses[-1] < presult.step_losses[0] / 3
    assert (tmp_path / "port" / "best-model" / "params.npz").exists()
    # its best-model tags as the JAX package tags with the same directory
    jnlp = J.Pipeline.from_disk(tmp_path / "port" / "best-model")
    pnlp = P.Pipeline.from_disk(tmp_path / "port" / "best-model", device="cpu")
    for eg in list(pcorpus.Corpus(data / "dev.spacy")())[:10]:
        text = " ".join(eg.reference.words)
        assert pnlp(text).tags == jnlp(text).tags


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "spacy_ray_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, "PYTHONPATH": str(REPO)})


def test_sm_cfg_trains_evaluates_and_serves_from_spacy_corpora(data, tmp_path):
    out = tmp_path / "out"
    res = _run(["train", str(REPO / "configs" / "sm.cfg"), "--output", str(out), "--device",
                "cpu", "--paths.train", str(data / "train.spacy"), "--paths.dev",
                str(data / "dev.spacy"), "--training.max_steps", "8",
                "--training.eval_frequency", "4"])
    assert res.returncode == 0, res.stderr
    assert "Done. steps=8" in res.stdout and "doc-passes" in res.stdout
    res = _run(["evaluate", str(out / "best-model"), str(data / "dev.spacy"), "--device", "cpu"])
    assert res.returncode == 0, res.stderr
    scores = json.loads(res.stdout.strip().splitlines()[-1])
    assert {"tag_acc", "dep_las", "ents_f"} <= set(scores)
    # served: the answers carry tags, heads and deps; a CNN is served in f32
    # whatever the precision asked (the overlay needs a transformer trunk)
    import urllib.request

    for precision, label in (("auto", "f32 (auto resolves f32 on cpu)"),
                             ("bf16", "f32 (overlay refused: no transformer trunk")):
        server = build_server([str(out / "best-model"), "--device", "cpu", "--port", "0",
                               "--max-batch", "4", "--max-doc-len", "64",
                               "--precision", precision])
        assert server.engine.overlay.label.startswith(label)
        _, port = server.start()
        server.engine.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/parse",
                data=json.dumps({"texts": ["Paris is a city in France ."]}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                doc = json.loads(r.read())["docs"][0]
            assert len(doc["tags"]) == len(doc["heads"]) == len(doc["deps"]) == 7
        finally:
            server.request_shutdown()
            assert server.wait() == 0
