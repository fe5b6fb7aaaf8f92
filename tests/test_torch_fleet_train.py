"""The port's trainer fleet end to end on the CPU: two workers as threads of
this process with real loopback HTTP, against the JAX package's
``train_fleet_worker`` at its parity point (f32 wire, full pulls, no
membership), and the ``train --fleet-workers`` coordinator as processes.

Tolerances. Three applied rounds at S 0, quorum 2, dropout 0, from the same
parameters (one model directory both configs source): each leaf's change
from the start within 1e-4 x that leaf's max |change| in JAX, the float32
measure of ``test_float32_gradients_of_one_batch_match_jax``; versions and
counters equal. The run uses Adam.v1 with ``eps`` 1e-3: at the default
1e-8, Adam's ``m / (sqrt(v) + eps)`` turns the float32 summation-order
differences of gradient elements that cancel to near zero into update
differences of up to 5e-3 of the max change (10 to 18 of the 36,864
elements of each maxout ``W`` on this corpus, measured); with ``eps`` 1e-3
the update stays near linear in the gradient and the worst leaf measured
5e-6. No maxout near-tie moved a leaf past 1e-5 here, so none is nudged.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import spacy_ray_tpu as J
from spacy_ray_tpu.training import corpus as jcorpus
from spacy_ray_tpu.training.checkpoint import _flatten
from spacy_ray_tpu.training.fleet.worker import train_fleet_worker as j_worker
from spacy_ray_tpu.util import write_synth_jsonl

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.training import corpus as pcorpus
from spacy_ray_tpu_torch.training.fleet import worker as pworker
from spacy_ray_tpu_torch.training.fleet.membership import read_membership_ledger
from spacy_ray_tpu_torch.training.loop import train as p_train

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 240  # every join and quorum wait allows minutes: the test workers share the cores


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_train")
    write_synth_jsonl(d / "train.jsonl", 120, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 30, kind="tagger", seed=1)
    return d


def _config(pkg, text, data, **over):
    cfg = pkg.Config.from_str(text)
    return cfg.apply_overrides({"paths.train": str(data / "train.jsonl"),
                                "paths.dev": str(data / "dev.jsonl"), **over})


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def run_thread_fleet(worker_fn, cfg, out, n, *, quorum, staleness, overrides=None, **kw):
    """N fleet workers as threads with real HTTP peer servers on loopback;
    returns {worker id: (nlp, TrainResult)}. ``overrides`` gives one
    worker's own keyword arguments."""
    ports = _free_ports(n)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    results, errors = {}, {}

    def run(k):
        try:
            results[k] = worker_fn(cfg, out, worker_id=k, n_workers=n, quorum=quorum,
                                   max_staleness=staleness, port=ports[k], peer_urls=urls,
                                   stdout_log=False, quorum_wait_s=float(JOIN_S),
                                   **{**kw, **(overrides or {}).get(k, {})})
        except Exception as e:  # surfaced below
            errors[k] = e

    threads = [threading.Thread(target=run, args=(k,), name=f"fleet-{k}") for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t.name for t in threads if t.is_alive()], "fleet workers wedged"
    assert not errors, errors
    return results


JAX_PARITY = {"grad_compression": "f32", "param_delta_window": 0, "peer_lease_s": 0,
              "install_signal_handlers": False}


@pytest.fixture(scope="module")
def source(data, tagger_config_text, tmp_path_factory):
    """One initialized tagger pipeline both packages' fleets source."""
    d = tmp_path_factory.mktemp("fleet_source")
    jnlp = J.Pipeline.from_config(_config(J, tagger_config_text, data).interpolate())
    egs = list(jcorpus.Corpus(data / "train.jsonl")())
    jnlp.initialize(lambda: egs, seed=0)
    jnlp.to_disk(d)
    return d, {k: np.asarray(v) for k, v in _flatten(jnlp.params).items()}


def _sourced(pkg, text, data, src, steps):
    cfg = _config(pkg, text, data, **{"training.max_steps": steps,
                                      "training.eval_frequency": 100,
                                      "training.dropout": 0.0,
                                      "training.optimizer.eps": 1e-3})
    for name in ("tok2vec", "tagger"):
        cfg["components"][name] = {"source": str(src)}
    return cfg


def test_three_rounds_match_the_jax_thread_fleet(data, tagger_config_text, source):
    # 4 steps: a worker's model holds the slices pulled at its last step's
    # top, so after 3 applied rounds in both packages
    src, start = source
    port = run_thread_fleet(pworker.train_fleet_worker,
                            _sourced(P, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, device="cpu", peer_lease_s=0)
    jax_ = run_thread_fleet(j_worker, _sourced(J, tagger_config_text, data, src, 4), None, 2,
                            quorum=2, staleness=0, **JAX_PARITY)
    for k in (0, 1):
        pflat = {key: v.numpy() for key, v in param_paths(port[k][0].model).items()}
        jflat = {key: np.asarray(v) for key, v in _flatten(jax_[k][0].params).items()}
        assert set(pflat) == set(jflat) == set(start)
        for key, s0 in start.items():
            dj, dp = jflat[key] - s0, pflat[key] - s0
            scale = np.abs(dj).max()
            assert scale > 0, key
            assert np.abs(dp - dj).max() <= 1e-4 * scale, (k, key)
        pf, jf = port[k][1].fleet, jax_[k][1].fleet
        assert pf["version"] == jf["version"] == 4
        assert pf["quorum"] == jf["quorum"] == 2
        shared = set(pf["counters"]) & set(jf["counters"])
        assert {c: pf["counters"][c] for c in shared} == {c: jf["counters"][c] for c in shared}
        assert all(jf["counters"][c] == 0 or c.endswith("_uncompressed")
                   for c in set(jf["counters"]) - shared)
        assert pf["counters"]["grad_applied"] == 8 and pf["counters"]["grad_pushed"] == 4
        assert port[k][1].final_step == jax_[k][1].final_step == 4


@pytest.fixture(scope="module")
def fleet_run(data, tagger_config_text, tmp_path_factory):
    """One 2-worker port fleet of 12 steps at S 0, quorum 2 (JAX's
    ``fleet_run``), evaluated every 6."""
    out = tmp_path_factory.mktemp("fleet_out")
    cfg = _config(P, tagger_config_text, data,
                  **{"training.max_steps": 12, "training.eval_frequency": 6})
    return out, run_thread_fleet(pworker.train_fleet_worker, cfg, out, 2, quorum=2,
                                 staleness=0, device="cpu")


def test_fleet_trains_and_learns(fleet_run):
    # JAX's test_fleet_trains_and_learns checks, on the port
    out, results = fleet_run
    r0 = results[0][1]
    assert r0.final_step == 12
    assert r0.best_score > 0.8, r0.best_score
    assert [h["step"] for h in r0.history] == [6, 12]
    for k, (_, r) in results.items():
        fl = r.fleet
        assert fl["version"] == 12
        c = fl["counters"]
        assert c["grad_discarded"] == c["push_failed"] == c["apply_wait_timeouts"] == 0
        assert c["pull_failed"] == c["pull_wait_timeouts"] == 0
        assert c["grad_applied"] + c["grad_discarded"] == c["grad_received"] == 24
        assert fl["phases"]["grad"] > 0 and fl["phases"]["push"] >= 0
        assert all(len(v) == 12 for v in fl["phase_steps_s"].values())
        ledger = json.loads((out / f"fleet-worker-{k}.json").read_text("utf8"))
        assert ledger["counters"] == c and ledger["steps"] == 12
        assert len(ledger["step_losses"]) == 12 and "launches" in ledger
    assert results[0][1].step_losses[-1] < results[0][1].step_losses[0]


def test_fleet_models_load_in_jax_and_tag_the_same(fleet_run, data):
    out, _ = fleet_run
    for d in ("best-model", "last-model"):
        jnlp = J.Pipeline.from_disk(out / d)
        pnlp = P.Pipeline.from_disk(out / d, device="cpu")
        for eg in list(pcorpus.Corpus(data / "dev.jsonl")())[:10]:
            text = " ".join(eg.reference.words)
            assert pnlp(text).tags == jnlp(text).tags
    meta = json.loads((out / "last-model" / "train_meta.json").read_text("utf8"))
    assert meta["step"] == 12 and meta["extra"]["fleet"]["opt_state"] is None


def test_resume_refuses_a_fleet_generation(fleet_run, data, tagger_config_text):
    out, _ = fleet_run
    cfg = _config(P, tagger_config_text, data, **{"training.max_steps": 14})
    with pytest.raises(ValueError, match="trainer-fleet generation"):
        p_train(cfg, out, device="cpu", resume=True, stdout_log=False)
    with pytest.raises(ValueError, match="cannot be resumed"):
        p_train(cfg, out, device="cpu", resume=True, stdout_log=False,
                fleet={"worker_id": 0, "n_workers": 2})


def test_peers_follow_the_lead_and_the_peer_timeout_reaches_the_clients(
        data, tagger_config_text, tmp_path, monkeypatch):
    # the lead stops at 6 steps and finalizes; the other worker, at quorum 1
    # and S 1, stops soon after instead of training on to 400; both
    # workers' peer clients take [training] fleet_peer_timeout_s, and the
    # clients of their membership threads' liveness probes
    # fleet_probe_timeout_s
    timeouts = []

    class Recording(pworker._PeerClient):
        def __init__(self, url, timeout=10.0):
            timeouts.append(timeout)
            super().__init__(url, timeout)

    monkeypatch.setattr(pworker, "_PeerClient", Recording)
    cfg = _config(P, tagger_config_text, data, **{"training.max_steps": 400,
                                                  "training.eval_frequency": 4,
                                                  "training.fleet_peer_timeout_s": 37.5,
                                                  "training.fleet_probe_timeout_s": 2.5})
    results = run_thread_fleet(pworker.train_fleet_worker, cfg, tmp_path / "out", 2, quorum=1,
                               staleness=1, device="cpu",
                               overrides={0: {"max_steps_override": 6}})
    assert results[0][1].final_step == 6
    assert results[1][1].final_step < 100, results[1][1].final_step
    assert sorted(timeouts) == [2.5, 2.5, 37.5, 37.5]


def test_fleet_worker_without_a_card_raises(data, tagger_config_text, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(P, tagger_config_text, data)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device=device,
                                       port=0, peer_urls=["http://127.0.0.1:1"] * 2)


def test_a_config_the_fleet_cannot_train_is_refused(data, tagger_config_text):
    for over, match in (({"training.accumulate_gradient": 2}, "accumulate_gradient"),
                        ({"training.frozen_components": ["tagger"]}, "frozen_components"),
                        ({"training.optimizer.use_averages": True}, "use_averages")):
        cfg = _config(P, tagger_config_text, data, **over)
        with pytest.raises(ValueError, match=match):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device="cpu",
                                       port=0, peer_urls=["http://127.0.0.1:1"] * 2)
    with pytest.raises(ValueError, match="quorum"):
        pworker.train_fleet_worker(_config(P, tagger_config_text, data), None, worker_id=0,
                                   n_workers=2, quorum=3, device="cpu")


# ---------------------------------------------------------------- the coordinator


def _cli(cfg_path, data, out, port, *extra, steps=4):
    return [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(cfg_path), "--device",
            "cpu", "--output", str(out), "--paths.train", str(data / "train.jsonl"),
            "--paths.dev", str(data / "dev.jsonl"), "--training.max_steps", str(steps),
            "--training.eval_frequency", "2", "--fleet-workers", "2", "--quorum", "2",
            "--max-staleness", "0", "--fleet-base-port", str(port), *extra]


def _env():
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def _children(pid):
    out = subprocess.run(["ps", "-o", "pid=", "--ppid", str(pid)], capture_output=True,
                         text=True)
    return [int(x) for x in out.stdout.split()]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    with open(f"/proc/{pid}/stat") as f:  # a zombie is gone
        return f.read().split()[2] != "Z"


def _two_free_consecutive_ports():
    for _ in range(50):
        base = _free_ports(1)[0]
        try:
            with socket.socket() as s:
                s.bind(("127.0.0.1", base + 1))
            return base
        except OSError:
            continue
    raise RuntimeError("no two consecutive free ports")


@pytest.fixture(scope="module")
def cfg_path(tagger_config_text, tmp_path_factory):
    p = tmp_path_factory.mktemp("fleet_cli") / "tagger.cfg"
    p.write_text(tagger_config_text, encoding="utf8")
    return p


def test_cli_fleet_trains_as_two_processes(cfg_path, data, tmp_path):
    out = tmp_path / "out"
    res = subprocess.run(_cli(cfg_path, data, out, _two_free_consecutive_ports()), cwd=REPO,
                         capture_output=True, text=True, timeout=JOIN_S, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Done. steps=4" in res.stdout and "Done. fleet worker 1: steps=4" in res.stdout
    for k in (0, 1):
        ledger = json.loads((out / f"fleet-worker-{k}.json").read_text("utf8"))
        assert ledger["version"] == 4 and ledger["counters"]["grad_discarded"] == 0
    assert (out / "best-model" / "params.npz").exists()


def test_cli_coordinator_ends_when_a_worker_is_killed(cfg_path, data, tmp_path):
    # --peer-lease-s 1: worker 1 is SIGKILLed once training is under way; at
    # quorum 2 worker 0 cannot step on until it evicts it (lease 1 s, 3 missed
    # probes 2 s apart), re-shards over itself alone at quorum 1 and finishes;
    # the coordinator reports the degraded success
    out = tmp_path / "out"
    steps = 60
    proc = subprocess.Popen(_cli(cfg_path, data, out, _two_free_consecutive_ports(),
                                 "--peer-lease-s", "1", "--training.eval_frequency", "10",
                                 steps=steps), cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=_env())
    try:
        deadline = time.monotonic() + JOIN_S
        while len(_children(proc.pid)) < 2 and time.monotonic() < deadline:
            time.sleep(0.2)
        kids = _children(proc.pid)
        assert len(kids) == 2
        while not (out / "best-model").exists() and time.monotonic() < deadline:
            time.sleep(0.2)  # training is under way
        worker_1 = next(k for k in kids
                        if Path(f"/proc/{k}/cmdline").read_bytes().split(b"\0")[-2:-1] == [b"1"])
        os.kill(worker_1, signal.SIGKILL)
        # stated bound: the eviction within ~7 s, then 50 steps of one worker
        rc = proc.wait(timeout=150)
        err = proc.stderr.read()
        assert rc == 0, err[-3000:]
        assert "fleet-degraded-success" in err
        assert not [k for k in kids if _alive(k)]
    finally:
        if proc.poll() is None:
            proc.kill()
    rows = read_membership_ledger(out / "fleet-membership.jsonl")
    evicts = [r for r in rows if r["event"] == "evict"]
    assert evicts and evicts[0]["evicted"] == [1] and evicts[0]["active"] == [0], rows
    assert [r["worker"] for r in rows if r["event"] == "apply"] == [0]
    ledger = json.loads((out / "fleet-worker-0.json").read_text("utf8"))
    assert ledger["steps"] == steps and ledger["membership_epoch"] == 1
    assert ledger["active"] == [0] and ledger["quorum"] == 1
    assert ledger["counters"]["evictions"] == 1 and ledger["counters"]["shards_adopted"] > 0
    assert not (out / "fleet-worker-1.json").exists()


def test_cli_coordinator_relays_sigterm_and_returns_75(cfg_path, data, tmp_path):
    proc = subprocess.Popen(_cli(cfg_path, data, tmp_path / "out", _two_free_consecutive_ports(),
                                 steps=100000), cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env())
    try:
        deadline = time.monotonic() + JOIN_S
        while not (tmp_path / "out" / "best-model").exists() and time.monotonic() < deadline:
            time.sleep(0.2)
        kids = _children(proc.pid)
        assert len(kids) == 2
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=150)
        assert proc.returncode == 75, err[-3000:]
        assert "Interrupted at step" in out
        assert not [k for k in kids if _alive(k)]
    finally:
        if proc.poll() is None:
            proc.kill()


def test_a_taken_base_port_fails_with_its_number(data, tagger_config_text):
    # worker k binds base + k and raises with that port; no other is chosen
    cfg = _config(P, tagger_config_text, data)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        base = s.getsockname()[1]
        with pytest.raises(OSError, match=f"127.0.0.1:{base} .*--fleet-base-port"):
            pworker.train_fleet_worker(cfg, None, worker_id=0, n_workers=2, device="cpu",
                                       base_port=base)
