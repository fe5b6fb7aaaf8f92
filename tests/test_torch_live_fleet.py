"""The live rollout end to end on the CPU: a port fleet of two replica
processes watching a directory into which the port's trainer writes its
generations canaries and then promotes them under load with no failed
request; ``train-and-serve --device cpu`` bootstraps from the run's first
best-model, swaps a generation in, and drains the trainer and the fleet on
one SIGTERM with exit 0. Every wait is bounded, every process killed in
``finally``; the replicas and trainers run torch on one thread (the test
workers share the cores)."""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.serving.fleet import Fleet, FleetConfig
from spacy_ray_tpu_torch.serving.fleet import fleet as fleet_module
from spacy_ray_tpu_torch.training import resilience as PR
from spacy_ray_tpu_torch.util import synth_corpus, write_synth_jsonl

from test_torch_serving_fleet_cli import CFG, _gone, _until

REPO = Path(__file__).resolve().parent.parent


def _train_config(tmp_path, max_steps, eval_frequency):
    write_synth_jsonl(tmp_path / "train.jsonl", 200, kind="tagger", seed=0)
    write_synth_jsonl(tmp_path / "dev.jsonl", 40, kind="tagger", seed=1)
    text = CFG + f"""
[paths]
train = "{(tmp_path / 'train.jsonl').as_posix()}"
dev = "{(tmp_path / 'dev.jsonl').as_posix()}"

[corpora]

[corpora.train]
@readers = "spacy.JsonlCorpus.v1"
path = ${{paths.train}}

[corpora.dev]
@readers = "spacy.JsonlCorpus.v1"
path = ${{paths.dev}}

[training]
seed = 0
dropout = 0.1
max_steps = {max_steps}
eval_frequency = {eval_frequency}

[training.optimizer]
@optimizers = "Adam.v1"
learn_rate = 0.01

[training.batcher]
@batchers = "spacy.batch_by_words.v1"
size = 600
tolerance = 0.2

[training.score_weights]
tag_acc = 1.0
"""
    (tmp_path / "cfg.cfg").write_text(text, encoding="utf8")
    return text


def _post(port, texts, timeout=60.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/parse",
                                 data=json.dumps({"texts": texts}).encode())
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


def test_a_fleet_canaries_then_promotes_the_port_trainers_generations(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    text = _train_config(tmp_path, max_steps=20, eval_frequency=10)
    # the bootstrap: the same config and labels, untrained
    nlp = P.Pipeline.from_config(P.Config.from_str(text), device="cpu")
    nlp.initialize(lambda: synth_corpus(200, "tagger", seed=0), seed=0)
    nlp.to_disk(tmp_path / "model")
    texts = [" ".join(eg.reference.words) for eg in synth_corpus(40, "tagger", seed=1)]
    out = tmp_path / "out"
    # JAX's end-to-end test sets its streaks to 3 bad and 2 good
    monkeypatch.setattr(fleet_module, "GUARD_BAD_CONSECUTIVE", 3)
    monkeypatch.setattr(fleet_module, "GUARD_GOOD_CONSECUTIVE", 2)
    fleet = Fleet(FleetConfig(
        model_path=str(tmp_path / "model"), port=0, device="cpu", replicas=2, max_replicas=2,
        max_batch=4, max_doc_len=32, probe_interval_s=0.2, watch_dir=str(out / "last-model"),
        watch_interval_s=0.3, canary_fraction=0.5, guard_min_samples=8,
        guard_error_rate=0.2, guard_p99_frac=50.0, guard_verdict_timeout_s=60.0,
        drain_timeout_s=30.0))
    results, lock, stop = [], threading.Lock(), threading.Event()
    trainer, pids, rc = None, set(), None
    PR.drain_events()
    try:
        host, port = fleet.start()
        assert fleet.wait_ready(2, timeout_s=120.0), "the fleet never came up"
        pids = {h.proc.pid for h in fleet.supervisor.handles()}

        def load(c):
            i = c
            while not stop.is_set():
                status, body = _post(port, [texts[i % len(texts)]])
                with lock:
                    results.append((status, body["batch"].get("generation") if body else None))
                i += 2

        clients = [threading.Thread(target=load, args=(c,), daemon=True) for c in range(2)]
        for th in clients:
            th.start()
        trainer = subprocess.Popen(
            [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(tmp_path / "cfg.cfg"),
             "--output", str(out), "--device", "cpu"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO)})
        train_out, _ = trainer.communicate(timeout=180)
        assert trainer.returncode == 0, train_out
        ctl = fleet.controller
        assert _until(lambda: ctl.current == 20 and ctl.phase == "idle", 90), (
            ctl.current, ctl.phase, ctl.rejected)
        # answers of the promoted generation from both replicas' side
        assert _until(lambda: sum(1 for s, g in list(results) if s == 200 and g == 20) >= 10,
                      60)
        stop.set()
        for th in clients:
            th.join(timeout=90)
        served = {h.replica_id: h.generation for h in fleet.router.ready_handles()}
        counters = fleet.tel.snapshot()["counters"]
    finally:
        stop.set()
        if trainer is not None and trainer.poll() is None:
            trainer.kill()
            trainer.wait(timeout=10)
        fleet.request_shutdown()
        rc = fleet.wait()
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
    assert rc == 0
    statuses = [s for s, _ in results]
    assert statuses and all(s == 200 for s in statuses), sorted(set(statuses))
    assert {None, 20} <= {g for _, g in results}
    assert served == {0: 20, 1: 20}
    assert counters.get("routed_canary", 0) > 0
    events = [e["event"] for e in PR.drain_events()]
    assert events.count("live-canary-start") >= 1 and events.count("live-promote") >= 1
    assert "live-rollback" not in events and "cache-flush" in events
    assert ctl.rollouts == ctl.promotes >= 1 and not ctl.rejected
    assert all(_gone(p) for p in pids)


def test_train_and_serve_drains_both_on_one_sigterm_with_exit_0(tmp_path):
    _train_config(tmp_path, max_steps=5000, eval_frequency=10)
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train-and-serve", str(tmp_path / "cfg.cfg"),
         "--output", str(tmp_path / "out"), "--device", "cpu", "--replicas", "1",
         "--port", "0", "--max-batch", "4", "--max-doc-len", "16", "--watch-interval-s",
         "0.3", "--drain-timeout-s", "60"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"},
        start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(l.rstrip() for l in proc.stdout),
                              daemon=True)
    reader.start()
    try:
        assert _until(lambda: any(l.startswith("fleet ready: 1") for l in lines), 240), lines
        banner = [l for l in lines if l.startswith("train-and-serve fleet on http://")]
        port = int(banner[0].split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)[1])
        assert any(l.startswith("bootstrapped serving model from ") for l in lines)

        def swapped():  # a generation of the running trainer, swapped in under requests
            status, body = _post(port, ["the cat runs fast today"])
            assert status == 200
            return body["batch"].get("generation")

        gen = _until(swapped, 120)
        assert gen is not None and gen % 10 == 0
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
    assert rc == 0, lines[-30:]
    drained = [l for l in lines if l.startswith("train-and-serve drained")]
    assert drained == ["train-and-serve drained (fleet rc 0, trainer rc 75 = preempted-clean)"]
    assert "train-and-serve: exiting 0" in lines
    assert any("Interrupted at step" in l for l in lines if l.startswith("[train] "))
    assert (tmp_path / "out" / "serve-bootstrap" / "params.npz").exists()
