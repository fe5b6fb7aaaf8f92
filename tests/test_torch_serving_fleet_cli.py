"""``python -m spacy_ray_tpu_torch serve-fleet`` end to end on the CPU: two
replica processes of a small model made from a seed behind the router. The
answers through the router equal the port's pipeline in this process; a
SIGKILLed replica is restarted by the supervisor and serves again; SIGTERM
ends the fleet with exit 0 and no replica left. Every wait is bounded and
the whole process group is killed in ``finally``; nothing is asserted of a
request sent during the drain."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

import spacy_ray_tpu_torch as P
from spacy_ray_tpu_torch.pipeline.doc import doc_to_json
from spacy_ray_tpu_torch.util import synth_corpus

REPO = Path(__file__).resolve().parent.parent

CFG = """
[nlp]
lang = "en"
pipeline = ["tok2vec","tagger"]

[components]

[components.tok2vec]
factory = "tok2vec"

[components.tok2vec.model]
@architectures = "spacy.HashEmbedCNN.v2"
width = 32
depth = 2
embed_size = 256

[components.tagger]
factory = "tagger"

[components.tagger.model]
@architectures = "spacy.Tagger.v2"

[components.tagger.model.tok2vec]
@architectures = "spacy.Tok2VecListener.v1"
width = 32
"""
TEXTS = ["the cat runs fast today", "a dog sleeps near the door",
         "rain falls softly on the roof", "the old man came back"]


def _http(port, path, payload=None, timeout=20.0):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _until(cond, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    return None


def _gone(pid):
    """True when ``pid`` is no running process (absent, or a zombie)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_serve_fleet_answers_restarts_a_killed_replica_and_drains(tmp_path):
    nlp = P.Pipeline.from_config(P.Config.from_str(CFG), device="cpu")
    egs = synth_corpus(64, "tagger", seed=0)
    nlp.initialize(lambda: egs, seed=0)
    nlp.to_disk(tmp_path / "model")
    want = [doc_to_json(nlp(t)) for t in TEXTS]

    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve-fleet", str(tmp_path / "model"),
         "--replicas", "2", "--device", "cpu", "--port", "0", "--max-batch", "4",
         "--max-doc-len", "32", "--probe-interval-s", "0.1", "--drain-timeout-s", "20"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO)}, start_new_session=True)
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(l.rstrip() for l in proc.stdout),
                              daemon=True)
    reader.start()
    pids = set()
    try:
        banner = _until(lambda: [l for l in lines if l.startswith("fleet serving on http://")],
                        30)
        assert banner, lines
        port = int(banner[0].split("http://", 1)[1].split(" ", 1)[0].rsplit(":", 1)[1])
        assert _until(lambda: any(l.startswith("fleet ready: 2") for l in lines), 60), lines

        status, body = _http(port, "/v1/parse", {"texts": TEXTS})
        assert status == 200 and body["docs"] == want
        roster = {r["id"]: r for r in _http(port, "/metrics")[1]["replicas"]}
        assert sorted(roster) == [0, 1] and all(r["ready"] for r in roster.values())
        pids = {r["pid"] for r in roster.values()}

        os.kill(roster[0]["pid"], signal.SIGKILL)

        def back():
            r = {r["id"]: r for r in _http(port, "/metrics")[1]["replicas"]}[0]
            return r if r["ready"] and r["pid"] != roster[0]["pid"] else None

        again = _until(back, 60)
        assert again and again["restarts"] == 1
        pids.add(again["pid"])
        for _ in range(3):  # through the router again, the restarted replica in rotation
            status, body = _http(port, "/v1/parse", {"texts": TEXTS[:2]})
            assert status == 200 and body["docs"] == want[:2]
        status, body = _http(again["port"], "/v1/parse", {"texts": TEXTS})
        assert status == 200 and body["docs"] == want  # the restarted replica serves

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, lines
        reader.join(timeout=10)
        assert "fleet drained; exiting 0" in lines
        assert _until(lambda: all(_gone(p) for p in pids), 10), pids
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


@pytest.mark.parametrize("argv, says", [
    (["--watch", "d"], "unrecognized arguments: --watch"),
    (["--canary-fraction", "0.5"], "unrecognized arguments: --canary-fraction"),
    (["--incidents-dir", "d"], "unrecognized arguments: --incidents-dir"),
    (["--continuous"], "unrecognized arguments: --continuous"),
    (["--window-ms", "5"], "unrecognized arguments: --window-ms"),
    (["--autoscale", "--model-manifest", "m.json"], "placement"),
    (["--replicas", "5"], "must lie within --min-replicas 1 .. --max-replicas 4"),
    (["--replicas", "0"], "--replicas/--min-replicas must be >= 1"),
    # the later --device wins: core masks without the CPU are refused
    (["--cpu-cores", "0", "--device", "cuda"], "--cpu-cores pins CPU replicas"),
])
def test_serve_fleet_refuses_what_waits_and_bad_bounds_with_exit_2(argv, says, capsys):
    from spacy_ray_tpu_torch.__main__ import main

    try:
        rc = main(["serve-fleet", "m", "--device", "cpu", *argv])
    except SystemExit as e:  # argparse's refusal
        rc = e.code
    out = capsys.readouterr()
    assert rc == 2 and says in out.err
    assert "fleet serving on" not in out.out
