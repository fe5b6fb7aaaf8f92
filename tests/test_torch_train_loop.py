"""The port's ``train`` and ``evaluate`` entry points on the CPU, against the
JAX package's loop, at a small size (width 64, depth 2, 4 heads, embed 500).

Both packages train the same config on the same synthetic corpus (tags
follow from the words); the port's dev ``tag_acc`` must come within 5
points of the JAX loop's (dropout bits and initial weights differ: the
packages draw them from different generators). With the parser and NER
heads added (trf.cfg's pipeline and score weights), on the pseudo-UD
corpus, the port's dev ``dep_las`` and ``ents_f`` must come within 5 points
of the JAX loop's too. The port's ``best-model/``
loads in the JAX package and tags the same; training generations resume,
and fall back past a torn one; without ``--device cpu`` and without a card
the command fails.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import spacy_ray_tpu as J
from spacy_ray_tpu.training.checkpoint import load_params as j_load_params
from spacy_ray_tpu.training.loop import train as j_train
from spacy_ray_tpu.udgen import write_ud_jsonl as j_write_ud
from spacy_ray_tpu.util import write_synth_jsonl as j_write_synth

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.training.checkpoint import CheckpointCorrupt, TrainCheckpoint
from spacy_ray_tpu_torch.training.corpus import Corpus
from spacy_ray_tpu_torch.training.loop import train as p_train, validate_training

from test_torch_cnn_train import one_torch_thread  # noqa: F401 (an autouse fixture)

REPO = Path(__file__).resolve().parent.parent

CFG = """
[nlp]
lang = "en"
pipeline = ["transformer", "tagger"]

[components]

[components.transformer]
factory = "transformer"

[components.transformer.model]
@architectures = "spacy_ray_tpu.TransformerEncoder.v1"
width = 64
depth = 2
n_heads = 4
ffn_mult = 4
dropout = 0.1
max_len = 512
embed_size = 500
remat = true

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64

[paths]
train = null
dev = null

[corpora]

[corpora.train]
@readers = "spacy.Corpus.v1"
path = "${paths.train}"
shuffle = true

[corpora.dev]
@readers = "spacy.Corpus.v1"
path = "${paths.dev}"

[training]
seed = 0
dropout = 0.1
accumulate_gradient = 2
max_steps = 24
eval_frequency = 12

[training.optimizer]
@optimizers = "Adam.v1"
learn_rate = 0.002
grad_clip = 1.0

[training.batcher]
@batchers = "spacy.batch_by_words.v1"
size = 200
tolerance = 0.2
"""


PARSER_NER = """
[components.parser]
factory = "parser"

[components.parser.model]
@architectures = "spacy.TransitionBasedParser.v2"
state_type = "parser"
hidden_width = 32
maxout_pieces = 2

[components.parser.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64

[components.ner]
factory = "ner"

[components.ner.model]
@architectures = "spacy.TransitionBasedParser.v2"
state_type = "ner"
hidden_width = 32
maxout_pieces = 2

[components.ner.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 64
"""


def _full_config(pkg, data):
    """The tagger config with trf.cfg's parser and NER heads and score
    weights, on the pseudo-UD corpus: 24 steps of 400 words at lr 0.004."""
    cfg = pkg.Config.from_str(CFG + PARSER_NER)
    cfg["nlp"]["pipeline"] = ["transformer", "tagger", "parser", "ner"]
    cfg["paths"] = {"train": str(data / "ud_train.jsonl"), "dev": str(data / "ud_dev.jsonl")}
    cfg["training"]["batcher"]["size"] = 400
    cfg["training"]["optimizer"]["learn_rate"] = 0.004
    cfg["training"]["score_weights"] = {"tag_acc": 0.33, "dep_las": 0.33, "ents_f": 0.34}
    return cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    j_write_synth(d / "train.jsonl", 120, kind="tagger", seed=0)
    j_write_synth(d / "dev.jsonl", 30, kind="tagger", seed=1)
    j_write_ud(d / "ud_train.jsonl", 200, seed=0, max_sents=2)
    j_write_ud(d / "ud_dev.jsonl", 80, seed=1, max_sents=2)
    return d


def _config(pkg, data, **training):
    cfg = pkg.Config.from_str(CFG)
    cfg["paths"] = {"train": str(data / "train.jsonl"), "dev": str(data / "dev.jsonl")}
    cfg["training"].update(training)
    return cfg


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_out")
    nlp, result = p_train(_config(P, data), out, device="cpu", stdout_log=False)
    return nlp, result, out


def test_port_train_reaches_the_jax_loop_tag_acc(data, port_run, tmp_path):
    _, presult, _ = port_run
    _, jresult = j_train(_config(J, data), tmp_path / "jax_out", n_workers=1,
                         stdout_log=False)
    p_acc = presult.history[-1]["other_scores"]["tag_acc"]
    j_acc = jresult.history[-1]["other_scores"]["tag_acc"]
    assert [h["step"] for h in presult.history] == [h["step"] for h in jresult.history] == [12, 24]
    assert abs(p_acc - j_acc) <= 0.05, (p_acc, j_acc)
    assert presult.step_losses[-1] < presult.step_losses[0]
    assert len(presult.step_shapes) == 24 and presult.final_step == 24
    # tagger, parser and NER over one trunk
    _, pfull = p_train(_full_config(P, data), tmp_path / "port_full", device="cpu",
                       stdout_log=False)
    _, jfull = j_train(_full_config(J, data), tmp_path / "jax_full", n_workers=1,
                       stdout_log=False)
    pscores, jscores = pfull.history[-1]["other_scores"], jfull.history[-1]["other_scores"]
    assert set(pscores) == set(jscores)
    for key in ("tag_acc", "dep_las", "ents_f"):
        assert abs(pscores[key] - jscores[key]) <= 0.05, (key, pscores[key], jscores[key])
    assert pscores["dep_las"] > 0.5 and pscores["ents_f"] > 0.5
    assert pfull.history[-1]["eval_wps"] > 0


def test_port_best_model_loads_in_jax_and_tags_the_same(data, port_run):
    nlp, _, out = port_run
    jnlp = J.Pipeline.from_disk(out / "best-model")
    pnlp = P.Pipeline.from_disk(out / "best-model", device="cpu")
    docs = [eg.reference for eg in Corpus(data / "dev.jsonl")()][:10]
    for d in docs:
        text = " ".join(d.words)
        assert jnlp(text).tags == pnlp(text).tags
    # a training generation's params load in the JAX package too
    stamp = max(TrainCheckpoint.load(out / "last-model")["step"], 0)
    flat = j_load_params(out / "last-model" / f"params-{stamp}.npz")
    assert "transformer" in flat and "tagger" in flat


def test_resume_continues_the_step_count_and_falls_back_past_a_torn_generation(data, tmp_path):
    out = tmp_path / "run"
    cfg = _config(P, data, max_steps=8, eval_frequency=4)
    _, first = p_train(cfg, out, device="cpu", stdout_log=False)
    assert first.final_step == 8
    _, resumed = p_train(cfg, out, device="cpu", resume=True, max_steps_override=12,
                         stdout_log=False)
    assert [h["step"] for h in resumed.history] == [12] and resumed.final_step == 12
    assert len(resumed.step_shapes) == 4  # only the steps after the checkpoint ran
    last = out / "last-model"
    assert sorted(TrainCheckpoint.generation_stamps(last)) == [8, 12]  # keep = 2
    (last / "params-12.npz").write_bytes(b"torn")
    assert TrainCheckpoint.load(last)["step"] == 8
    (last / "opt_state-8.npz").unlink()
    with pytest.raises(CheckpointCorrupt, match="no intact"):
        TrainCheckpoint.load(last)


def test_use_averages_evaluates_and_saves_the_running_mean(data, tmp_path):
    cfg = _config(P, data, max_steps=4, eval_frequency=4)
    cfg["training"]["optimizer"]["use_averages"] = True
    nlp, result = p_train(cfg, tmp_path, device="cpu", stdout_log=False)
    raw = {k: v.numpy() for k, v in P.Pipeline.from_disk(
        tmp_path / "last-model", device="cpu").model.state_dict().items()}
    avg = {k: v.numpy() for k, v in P.Pipeline.from_disk(
        tmp_path / "best-model", device="cpu").model.state_dict().items()}
    gen = TrainCheckpoint.load(tmp_path / "last-model")["params"]
    k = "transformer.layer_0.qkv_W"
    assert not np.array_equal(raw[k], avg[k])  # best-model holds the averages
    assert np.array_equal(gen[k.replace(".", "/")], raw[k])  # generations hold raw params


def test_training_block_is_validated_like_the_jax_loop():
    with pytest.raises(ValueError, match="did you mean 'patience'"):
        validate_training({"patiance": 3})
    with pytest.raises(ValueError, match="accumulate_gradient must be"):
        validate_training({"accumulate_gradient": 0})
    validate_training({"update_sharding": "full", "prefetch_batches": 4, "steps_per_dispatch": 2})


def _run(args, env_extra, timeout=240):
    env = {**os.environ, "PYTHONPATH": str(REPO), **env_extra}
    return subprocess.run([sys.executable, "-m", "spacy_ray_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout, env=env)


def test_cli_train_needs_the_card_and_evaluate_runs_on_the_cpu(data, port_run, tmp_path):
    _, _, out = port_run
    cfg = tmp_path / "cfg.cfg"
    cfg.write_text(CFG)
    no_card = _run(["train", str(cfg), "--output", str(tmp_path / "o"),
                    "--paths.train", str(data / "train.jsonl"),
                    "--paths.dev", str(data / "dev.jsonl")], {"CUDA_VISIBLE_DEVICES": ""})
    assert no_card.returncode != 0
    assert "no CUDA device is available" in no_card.stderr
    assert not (tmp_path / "o").exists()
    ev = _run(["evaluate", str(out / "best-model"), str(data / "dev.jsonl"), "--device", "cpu"],
              {})
    assert ev.returncode == 0, ev.stderr
    lines = ev.stdout.strip().splitlines()
    scores = json.loads(lines[-1])
    assert 0.0 <= scores["tag_acc"] <= 1.0 and "speed" not in scores
    assert float(lines[-2].split()[-1]) > 0 and lines[-2].startswith("words/s")
