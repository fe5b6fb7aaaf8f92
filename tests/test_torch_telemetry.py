"""The trainer's telemetry of the port (``spacy_ray_tpu_torch/training/
telemetry.py``, ``telemetry_http.py`` and the loop's wiring) held against the
JAX package's on the CPU.

Parity scenarios run once with each package on the same inputs and must
agree: the anomaly detectors on one series and one fake clock, the facade's
``metrics.jsonl`` rows and trace through ``step_boundary`` and
``eval_boundary`` on one fake clock (the device sample, the peak and the
compile count faked alike in both; JAX's alerting off), ``summarize_metrics``
on a port run's file, its run directory and a port ``serve --metrics-dir``
run, and the ``telemetry summarize`` command's errors. The rest drives the
port's loop: telemetry changes no parameter, telemetry off constructs
nothing, ``--metrics-port`` answers during training, the NaN drill reaches
every surface, and the FLOP probe counts a tiny transformer's step as its
matmuls add up and leaves the run as it found it.
"""

import http.client
import json
import math
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import spacy_ray_tpu.training.resilience as j_res
import spacy_ray_tpu.training.telemetry as j_tel
import spacy_ray_tpu_torch.training.hoststats as p_host
import spacy_ray_tpu_torch.training.resilience as p_res
import spacy_ray_tpu_torch.training.telemetry as p_tel
import spacy_ray_tpu_torch.training.telemetry_http as p_http
from spacy_ray_tpu.cli import main as j_main
from spacy_ray_tpu.util import write_synth_jsonl
from spacy_ray_tpu_torch.__main__ import main as p_main
from spacy_ray_tpu_torch.config import Config
from spacy_ray_tpu_torch.models.core import param_paths
from spacy_ray_tpu_torch.ops import _cuda
from spacy_ray_tpu_torch.serving.tracecollect import collect_fleet_traces
from spacy_ray_tpu_torch.training.loop import train as p_train

REPO = Path(__file__).resolve().parent.parent
PKGS = {"jax": SimpleNamespace(tel=j_tel, res=j_res, main=j_main),
        "port": SimpleNamespace(tel=p_tel, res=p_res, main=p_main)}


def both(scenario, *args, **kwargs):
    """``scenario(pkg, ...)`` with each package; the results must be equal."""
    out = {name: scenario(pkg, *args, **kwargs) for name, pkg in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_state():
    for pkg in PKGS.values():
        pkg.res.set_fault_plan(None)
        pkg.res.drain_events()
    yield
    for pkg in PKGS.values():
        pkg.res.set_fault_plan(None)
        pkg.res.drain_events()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


# ----------------------------------------------------------------------
# The detectors
# ----------------------------------------------------------------------


def _run_detectors(pkg, calls, **kw):
    clk = FakeClock()
    emitted = []
    det = pkg.tel.AnomalyDetectors(lambda e, m, **f: emitted.append((e, m, f)), clock=clk, **kw)
    for method, *args in calls:
        clk.t += 0.5
        getattr(det, method)(*args)
    return dict(det.fired), emitted


SERIES = {
    "nan-loss": ([("check_loss", 1, 1.0), ("check_loss", 2, float("nan")),
                  ("check_loss", 3, float("inf")), ("check_loss", 4, 1.0)], {}),
    "loss-spike": ([("check_loss", s, v) for s, v in
                    enumerate([1.0, 1.1, 0.9, 1.0, 1.2, 40.0, 1.0, 0.0], start=1)],
                   {"spike_factor": 4.0, "spike_min_history": 3}),
    "step-time": ([("check_step_time", s, 10.0 if s == 1 else (0.5 if s == 10 else 0.1))
                   for s in range(1, 14)], {"step_factor": 2.5, "step_warmup": 5}),
    "recompile": ([("check_compiles", 10, 5), ("check_compiles", 40, 8),
                   ("check_compiles", 60, 8), ("check_compiles", 80, 10),
                   ("check_compiles", 90, 10)], {"recompile_warmup_steps": 50}),
}


@pytest.mark.parametrize("name", sorted(SERIES))
def test_detectors_fire_as_jax_on_one_series(name):
    calls, kw = SERIES[name]
    fired, emitted = both(lambda pkg: (lambda f, e: (f, [(ev, fl) for ev, _, fl in e]))(
        *_run_detectors(pkg, calls, **kw)))
    assert sum(fired.values()) == len(emitted) >= 1
    msgs = {n: [m for _, m, _ in _run_detectors(pkg, calls, **kw)[1]]
            for n, pkg in PKGS.items()}
    if name == "recompile":
        # the port counts its kernel builds and graph captures, not XLA compiles
        assert msgs["port"] == ["2 new kernel build(s) or graph capture(s) after step 80 "
                                "(cumulative 10) — check shape bucketing"]
        assert msgs["jax"] == ["2 new XLA compile(s) after step 80 (cumulative 10) — check "
                               "shape bucketing"]
    else:
        assert msgs["port"] == msgs["jax"]


# ----------------------------------------------------------------------
# The facade
# ----------------------------------------------------------------------


def _facade(pkg, tmp, monkeypatch):
    clk = FakeClock()
    compiles = {"n": 3}
    monkeypatch.setattr(pkg.tel, "compile_count", lambda: 0)
    monkeypatch.setattr(pkg.tel, "sample_device_telemetry", lambda *a: {
        "platform": "gpu", "hbm_bytes_in_use": 1 << 30, "hbm_peak_bytes": 3 << 30,
        "hbm_bytes_limit": 80 << 30, "live_buffers": 17, "compile_count": compiles["n"]})
    monkeypatch.setattr(pkg.tel, "device_peak_flops", lambda *a: (989e12, "datasheet"))
    if pkg is PKGS["jax"]:
        import jax

        monkeypatch.setattr(jax, "devices", lambda *a: [0])  # one chip, as the port's
        tel = pkg.tel.Telemetry(tmp, trace_steps=(2, 6), clock=clk, alerting=False)
    else:
        tel = pkg.tel.Telemetry(tmp, trace_steps=(2, 6), clock=clk)
    tel.loop_start()
    snaps = []
    for step in range(1, 61):
        clk.t += 0.5 if step == 45 else 0.1
        loss = {30: 2.5, 31: float("nan"), 32: 1.5}.get(step)  # a fleet caller's streamed loss
        tel.step_boundary(step=step, epoch=step // 25, n_words=100 + step, steps_run=step,
                          loss=loss)
        if step % 20 == 0:
            if step == 60:
                compiles["n"] = 6
            t0 = clk()
            clk.t += 2.0  # the evaluation
            tel.trace.add_span("eval", t0, 2.0, cat="loop", args={"step": step}, force=True)
            losses = {"tagger": float("nan")} if step == 40 else {"tagger": 1.0 * step}
            snaps.append(tel.eval_boundary(step=step, epoch=step // 25, steps_run=step,
                                           losses=losses, score=0.5, eval_seconds=2.0,
                                           flops_fn=lambda: 1e12, wps=1234.5))
            with tel.trace.span("checkpoint_save", cat="loop", kind="last", step=step):
                clk.t += 0.3
            tel.rearm_step_clock()
    tel.finalize()
    rows = [json.loads(line) for line in open(tmp / "metrics.jsonl", encoding="utf8")]
    trace = json.loads((tmp / "trace.json").read_text())["traceEvents"]
    for row in rows:
        row.pop("process", None)  # the host's own sample
    # the recompile message names what each package counts (ROADMAP C74)
    recompile = [r.pop("message") for r in rows if r.get("anomaly") == "recompile-after-warmup"]
    for e in trace:
        if e["name"] == "recompile-after-warmup":
            assert e["args"].pop("message") == recompile[0]
    snap = tel.registry.snapshot()
    streamed = (snap["counters"].get("loss_nonfinite"), snap["histograms"]["loss"]["count"])
    return rows, trace, snaps, [(e["event"], e.get("step")) for e in pkg.res.drain_events()], \
        streamed


def test_the_facade_writes_jax_s_rows_and_trace(tmp_path, monkeypatch):
    rows, trace, snaps, evs, streamed = both(
        lambda pkg: _facade(pkg, tmp_path / pkg.tel.__name__, monkeypatch))
    assert streamed == (1.0, 2)
    steps = [r for r in rows if r["kind"] == "step"]
    evals = [r for r in rows if r["kind"] == "eval"]
    assert [r["step"] for r in steps] == list(range(1, 61))
    # the step after each evaluation does not carry the evaluation's time
    assert all(r["step_seconds"] == pytest.approx(0.1) for r in steps if r["step"] != 45)
    assert [r["step"] for r in evals] == [20, 40, 60]
    assert evals[0]["mfu"] == round(1e12 / 0.1 / 989e12, 5)
    assert evals[1]["loss_total"] == "nan"
    assert evs == [("nan-loss", 40), ("step-time-regression", 45),
                   ("recompile-after-warmup", None)]
    spans = [e for e in trace if e["ph"] == "X" and e["name"] == "step"]
    assert [e["args"]["step"] for e in spans] == [3, 4, 5, 6]  # trace_steps [2, 6)
    assert {e["name"] for e in trace} >= {"eval", "checkpoint_save", "nan-loss"}
    assert snaps[0]["compile_count"] == 3 and snaps[2]["compile_count"] == 6
    assert [r.get("loss") for r in steps[29:33]] == [2.5, "nan", 1.5, None]


def _dispatches(pkg, tmp, monkeypatch):
    """Stamps that each close ``k`` steps (JAX's ``steps_per_dispatch``)."""
    clk = FakeClock()
    monkeypatch.setattr(pkg.tel, "compile_count", lambda: 0)
    if pkg is PKGS["jax"]:
        import jax

        monkeypatch.setattr(jax, "devices", lambda *a: [0])
        tel = pkg.tel.Telemetry(tmp, trace_steps=(0, 100), clock=clk, alerting=False)
    else:
        tel = pkg.tel.Telemetry(tmp, trace_steps=(0, 100), clock=clk)
    tel.loop_start()
    step = 0
    for k, seconds, loss in ((1, 0.1, None), (3, 0.3, 2.0), (4, 2.0, float("nan")),
                             (2, 0.2, 1.5)):
        clk.t += seconds
        step += k
        tel.step_boundary(step=step, epoch=0, n_words=100 * k + 1, steps_run=step,
                          inner_steps=k, loss=loss)
    tel.finalize()
    rows = [json.loads(line) for line in open(tmp / "metrics.jsonl", encoding="utf8")]
    trace = json.loads((tmp / "trace.json").read_text())["traceEvents"]
    snap = tel.registry.snapshot()
    return rows, trace, snap["counters"], [e["event"] for e in pkg.res.drain_events()]


def test_inner_steps_split_a_stamp_as_jax(tmp_path, monkeypatch):
    rows, trace, counters, _ = both(
        lambda pkg: _dispatches(pkg, tmp_path / pkg.tel.__name__, monkeypatch))
    steps = [r for r in rows if r["kind"] == "step"]
    assert [r["step"] for r in steps] == list(range(1, 11))
    assert [r.get("dispatch_k") for r in steps] == [None] + [3] * 3 + [4] * 4 + [2] * 2
    assert [r["words"] for r in steps] == [101] + [100] * 3 + [100] * 4 + [100] * 2
    assert steps[5]["step_seconds"] == pytest.approx(0.5)
    assert [r.get("loss") for r in steps] == [None, None, None, 2.0, None, None, None, "nan",
                                              None, 1.5]
    assert counters["loss_nonfinite"] == 1.0
    assert len([e for e in trace if e["name"] == "step"]) == 10


def test_device_sample_peak_and_compile_count_on_the_cpu(monkeypatch):
    sample = p_tel.sample_device_telemetry("cpu")
    assert sample["platform"] == "cpu"
    assert all(sample[k] is None for k in ("hbm_bytes_in_use", "hbm_peak_bytes",
                                           "hbm_bytes_limit", "live_buffers"))
    assert p_tel.device_peak_flops("cpu") == (None, "no datasheet peak for cpu")
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA H100 NVL", 835e12), ("NVIDIA GH200 480GB", 989e12)):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, n=name: n)
        assert p_tel.device_peak_flops("cuda") == (peak, f"datasheet bf16 ({name})")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert p_tel.device_peak_flops("cuda") == (None, "unknown GPU kind 'NVIDIA A100-SXM4-80GB'")
    assert p_tel.device_peak_flops(None) == (None, "no datasheet peak for an unknown device")
    before = p_tel.compile_count()
    _cuda.count_compile()
    assert p_tel.compile_count() == before + 1


def test_the_flop_tally_counts_only_inside_its_block():
    _cuda.tally_flops(5.0)
    with _cuda.kernel_flop_tally() as tally:
        _cuda.tally_flops(2.0)
        threading.Thread(target=_cuda.tally_flops, args=(3.0,)).start()
        time.sleep(0.1)
    _cuda.tally_flops(7.0)
    assert tally == [5.0]


# ----------------------------------------------------------------------
# The loop
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry_data")
    write_synth_jsonl(d / "train.jsonl", 80, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 20, kind="tagger", seed=1)
    return d


def _config(text, data, **over):
    cfg = Config.from_str(text)
    return cfg.apply_overrides({"paths.train": str(data / "train.jsonl"),
                                "paths.dev": str(data / "dev.jsonl"),
                                "training.max_steps": 8, "training.eval_frequency": 4, **over})


@pytest.fixture(scope="module")
def nan_run(tagger_config_text, data, tmp_path_factory):
    """A CPU run with telemetry, the JSONL logger and ``step:3:nan``; its
    output dir holds ``metrics/`` (the run directory ``summarize`` reads)."""
    out = tmp_path_factory.mktemp("nan_run")
    cfg = _config(tagger_config_text, data, **{
        "training.trace_steps": [0, 5],
        "training.logger": {"@loggers": "spacy_ray_tpu.JsonlLogger.v1",
                            "path": str(out / "train_log.jsonl")}})
    os.environ[p_res.FAULT_PLAN_ENV] = "step:3:nan"
    try:
        nlp, result = p_train(cfg, out / "run", device="cpu", stdout_log=False,
                              metrics_dir=out / "run" / "metrics")
    finally:
        del os.environ[p_res.FAULT_PLAN_ENV]
        p_res.set_fault_plan(None)
    return out, nlp, result


def _strict(line):
    def reject(c):
        raise AssertionError(f"bare {c} token in jsonl output")
    return json.loads(line, parse_constant=reject)


def test_the_nan_drill_reaches_every_surface(nan_run):
    out, _, result = nan_run
    assert result.final_step == 8
    rows = [_strict(line) for line in open(out / "run" / "metrics" / "metrics.jsonl")]
    steps = [r for r in rows if r["kind"] == "step"]
    evals = [r for r in rows if r["kind"] == "eval"]
    assert [r["step"] for r in steps] == list(range(1, 9))
    assert all(r["step_seconds"] > 0 for r in steps)
    assert [r["step"] for r in evals] == [4, 8]
    assert evals[0]["loss_total"] == "nan" and math.isfinite(evals[1]["loss_total"])
    for ev in evals:
        assert ev["platform"] == "cpu" and ev["hbm_peak_bytes"] is None
        assert ev["compile_count"] == 0 and ev["mfu"] is None
        assert ev["flops_per_step"] > 0 and ev["step_seconds_p50"] > 0
    assert [r["anomaly"] for r in rows if r["kind"] == "anomaly"] == ["nan-loss"]
    log = [_strict(line) for line in open(out / "train_log.jsonl")]
    logged = [e["event"] for r in log for e in r.get("events", [])]
    assert "fault-injected" in logged and "nan-loss" in logged
    assert log[0]["telemetry"]["trace_events"] > 0
    trace = json.loads((out / "run" / "metrics" / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in trace}
    assert {"step", "eval", "checkpoint_save", "nan-loss"} <= names
    assert [e["args"]["step"] for e in trace if e["name"] == "step"] == [1, 2, 3, 4, 5]
    assert p_main(["telemetry", "summarize", str(out / "run" / "metrics" / "metrics.jsonl")]) == 0


def test_summarize_prints_jax_s_text_on_a_port_run_and_its_run_dir(nan_run):
    out, _, _ = nan_run
    for target in (out / "run" / "metrics" / "metrics.jsonl", out / "run"):
        text = both(lambda pkg: pkg.tel.summarize_metrics(target))
        assert "nan-loss" in text and "step-time p50" in text


def test_telemetry_changes_no_parameter(tagger_config_text, data, tmp_path):
    cfg = _config(tagger_config_text, data)
    plain, r0 = p_train(cfg, tmp_path / "a", device="cpu", stdout_log=False)
    telem, r1 = p_train(cfg, tmp_path / "b", device="cpu", stdout_log=False,
                        metrics_dir=tmp_path / "tel")
    a, b = param_paths(plain.model), param_paths(telem.model)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert r0.step_losses == r1.step_losses
    assert "telemetry" in r1.history[0] and "telemetry" not in r0.history[0]
    assert (tmp_path / "tel" / "metrics.jsonl").exists()


def test_telemetry_off_constructs_nothing(tagger_config_text, data, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("telemetry constructed on the disabled path")

    monkeypatch.setattr(p_tel.Telemetry, "__init__", boom)
    monkeypatch.setattr(p_tel.MetricsRegistry, "__init__", boom)
    monkeypatch.setattr(p_host.ProcessSampler, "__init__", boom)
    monkeypatch.setattr(p_http.TelemetryHTTPServer, "__init__", boom)
    monkeypatch.setattr(p_tel, "program_flops", boom)
    _, result = p_train(_config(tagger_config_text, data, **{"training.max_steps": 2}),
                        device="cpu", stdout_log=False)
    assert result.final_step == 2
    # a port without a metrics dir starts nothing and says so
    _, result = p_train(_config(tagger_config_text, data, **{"training.max_steps": 2}),
                        device="cpu", stdout_log=False, metrics_port=9)
    assert [e["event"] for e in p_res.drain_events()] == ["telemetry-endpoint-skipped"]


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5.0)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_metrics_port_serves_during_training(tagger_config_text, data, tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cfg = _config(tagger_config_text, data, **{"training.max_steps": 40,
                                               "training.eval_frequency": 20})
    scraped, stop = {}, threading.Event()

    def poll():
        while not stop.is_set():
            try:
                health = json.loads(_get(port, "/healthz")[1])
                text = _get(port, "/metrics?format=prometheus")[1].decode()
                trace = json.loads(_get(port, "/trace")[1])
                if "srt_training_steps_total" in text and any(
                        e["name"] == "step" for e in trace["traceEvents"]):
                    scraped.update(health=health, prometheus=text,
                                   json=json.loads(_get(port, "/metrics")[1]), trace=trace,
                                   alerts=json.loads(_get(port, "/admin/alerts")[1]),
                                   merged=collect_fleet_traces([f"http://127.0.0.1:{port}"]))
                    return
            except OSError:
                pass
            stop.wait(0.02)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        _, result = p_train(cfg, device="cpu", stdout_log=False, metrics_dir=tmp_path / "tel",
                            metrics_port=port)
    finally:
        stop.set()
        poller.join(timeout=10.0)
    assert result.final_step == 40
    assert "prometheus" in scraped, "the endpoint never answered during training"
    assert scraped["health"]["role"] == "trainer" and scraped["health"]["status"] == "ok"
    assert {"origin", "clock_now", "unix_now"} <= set(scraped["health"]["anchor"])
    assert "# TYPE srt_training_steps_total counter" in scraped["prometheus"]
    assert "srt_process_" in scraped["prometheus"]
    assert "steps" in scraped["json"]["counters"] and "process" in scraped["json"]
    assert scraped["trace"]["role"] == "trainer" and "anchor" in scraped["trace"]
    assert scraped["alerts"] == {"alerts": "disabled"}
    # telemetry collect-trace takes the trainer's spans, on its own track
    merged = scraped["merged"]
    assert merged["otherData"]["merged_from"] and not merged["otherData"].get("skipped")
    tracks = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
              if e["name"] == "process_name"}
    assert list(tracks.values()) == [f"trainer http://127.0.0.1:{port}"]
    steps = [e for e in merged["traceEvents"] if e["name"] == "step"]
    assert steps and {e["pid"] for e in steps} == set(tracks)
    with pytest.raises(OSError):
        _get(port, "/healthz")  # the listener went with the run


# ----------------------------------------------------------------------
# ``telemetry summarize``
# ----------------------------------------------------------------------


def test_summarize_prints_jax_s_text_on_a_port_serve_run(nan_run, tmp_path):
    out, _, _ = nan_run
    tel = tmp_path / "stel"
    proc = subprocess.Popen(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "serve", str(out / "run" / "best-model"),
         "--device", "cpu", "--port", "0", "--max-batch", "4", "--max-doc-len", "32",
         "--metrics-dir", str(tel)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(l.rstrip() for l in proc.stdout),
                              daemon=True)
    reader.start()
    try:
        deadline = time.monotonic() + 90
        while not any("; ready" in l for l in lines) and time.monotonic() < deadline:
            assert proc.poll() is None, lines
            time.sleep(0.1)
        port = int([l for l in lines if "serving on http://" in l][0].rsplit(":", 1)[1]
                   .split()[0].strip("/"))
        for texts in (["the cat runs"], ["a b c", "dogs bark loudly"]):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/v1/parse", body=json.dumps({"texts": texts}))
            assert conn.getresponse().status == 200
            conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        reader.join(timeout=10)
    assert proc.returncode == 0, lines
    text = both(lambda pkg: pkg.tel.summarize_metrics(tel / "metrics.jsonl"))
    assert "serving: requests 2" in text and "rejects: none" in text


def test_summarize_usage_errors_exit_as_jax(tmp_path, capsys):
    other = tmp_path / "other.jsonl"
    other.write_text('{"foo": 1}\n', encoding="utf8")

    def run(pkg):
        got = [pkg.main(["telemetry"]),
               pkg.main(["telemetry", "summarize", str(tmp_path / "nope.jsonl")]),
               pkg.main(["telemetry", "summarize", str(other)]),
               pkg.main(["telemetry", "summarize", str(tmp_path)])]
        err = capsys.readouterr().err
        with pytest.raises(SystemExit) as e:
            pkg.main(["telemetry", "summarize"])
        capsys.readouterr()
        return got, e.value.code, "contains no telemetry rows" in err, \
            "not a run directory" in err

    assert both(run) == ([1, 1, 1, 1], 2, True, True)


# ----------------------------------------------------------------------
# The FLOP probe
# ----------------------------------------------------------------------


def test_program_flops_counts_a_tiny_transformer_step_and_moves_nothing(data):
    """trf.cfg's trunk (remat on) and tagger at width 64, depth 2: the counted
    FLOPs of a microbatch's forward and backward equal the matmuls' analytic
    sum within 1%, and the probe leaves parameters, gradients and the torch,
    numpy and Python generators as they were."""
    import spacy_ray_tpu_torch.training.loop  # noqa: F401  (registers the readers)
    from spacy_ray_tpu_torch.pipeline.language import Pipeline
    from spacy_ray_tpu_torch.registry import registry
    from spacy_ray_tpu_torch.training.batcher import bucket_batch_size, bucket_length

    w, depth, heads = 64, 2, 4
    cfg = Config.from_str((REPO / "configs" / "trf.cfg").read_text()).apply_overrides({
        "paths.train": str(data / "train.jsonl"), "paths.dev": str(data / "dev.jsonl"),
        "nlp.pipeline": ["transformer", "tagger"], "components.transformer.model.width": w,
        "components.transformer.model.depth": depth,
        "components.transformer.model.n_heads": heads,
        "components.tagger.model.tok2vec.width": w})
    for name in ("parser", "ner"):
        cfg["components"].pop(name)
    cfg = cfg.interpolate()
    corpus = registry.resolve(cfg["corpora"]["train"])
    nlp = Pipeline.from_config(cfg, device="cpu")
    nlp.initialize(corpus, seed=0)
    nlp.requires_grad_(True)
    egs = list(corpus())[:16]
    B, T = bucket_batch_size(len(egs)), bucket_length(max(len(e) for e in egs),
                                                      nlp.length_buckets)
    c = nlp.collate(egs, with_targets=True, pad_batch_to=B, pad_len_to=T)
    params = {k.replace(".", "/"): p for k, p in nlp.model.named_parameters()}
    g = torch.Generator().manual_seed(3)
    for p in params.values():
        p.grad = torch.randn(p.shape, generator=g)
    before = {k: (p.detach().clone(), p.grad, p.grad.clone()) for k, p in params.items()}
    torch.manual_seed(11)
    np.random.seed(12)
    random.seed(13)
    states = (torch.get_rng_state(), np.random.get_state()[1].copy(), random.getstate())

    flops = p_tel.program_flops(lambda: nlp.loss(c["tokens"], c["targets"], dropout=0.1,
                                                 seed=0)[0], params, n_micro=3)

    N, ffn, n_tags = B * T, 4 * w, nlp.components["tagger"].model.dims["nO"]
    mix = 2 * N * (4 * w) * (3 * w)  # the embeddings' Maxout, 3 pieces
    layer = 2 * N * (w * 3 * w + w * w + 2 * w * ffn)  # qkv, output, the FFN's two
    attention = 4 * B * T * T * w  # scores and p @ v, over every key
    # a forward, the remat's second forward and a backward twice the work;
    # attention's backward is five products to the forward's two
    analytic = 3 * (3 * mix + depth * (4 * layer + 2 * attention + 2.5 * attention)
                    + 3 * 2 * N * w * n_tags)
    assert flops == pytest.approx(analytic, rel=0.01)
    for k, p in params.items():
        value, grad, grad_value = before[k]
        assert torch.equal(p.detach(), value) and p.grad is grad
        assert torch.equal(p.grad, grad_value)
    assert torch.equal(torch.get_rng_state(), states[0])
    assert np.array_equal(np.random.get_state()[1], states[1])
    assert random.getstate() == states[2]
    with pytest.raises(ZeroDivisionError):
        p_tel.program_flops(lambda: 1 / 0, params)
    assert all(p.grad is before[k][1] for k, p in params.items())
    assert torch.equal(torch.get_rng_state(), states[0])


def test_a_failed_flop_probe_is_logged_and_leaves_mfu_null(tagger_config_text, data, tmp_path,
                                                           monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no counter here")

    monkeypatch.setattr(p_tel, "program_flops", broken)
    p_train(_config(tagger_config_text, data), tmp_path / "out", device="cpu",
            stdout_log=False, metrics_dir=tmp_path / "tel")
    failed = [e for e in p_res.drain_events() if e["event"] == "flops-probe-failed"]
    assert [(e["step"], e["message"]) for e in failed] == [
        (4, "the FLOP probe failed, so no mfu: RuntimeError: no counter here")]
    rows = [json.loads(line) for line in open(tmp_path / "tel" / "metrics.jsonl")]
    evals = [r for r in rows if r["kind"] == "eval"]
    assert len(evals) == 2 and all(r["flops_per_step"] is None and r["mfu"] is None
                                   for r in evals)


def test_the_knobs_this_slice_honours_left_the_ignored_list():
    from spacy_ray_tpu_torch.training.loop import IGNORED_KNOBS, validate_training

    honoured = ("watchdog_timeout_s", "io_retries", "io_retry_base_s", "metrics_dir",
                "trace_steps", "metrics_port", "metrics_host", "anomaly_detection")
    assert not set(honoured) & set(IGNORED_KNOBS)
    assert {"alerting", "incident_dir", "profile_window"} <= set(IGNORED_KNOBS)
    validate_training({"metrics_dir": "tel", "trace_steps": [0, 100], "metrics_port": 9100,
                       "metrics_host": "0.0.0.0", "anomaly_detection": False,
                       "watchdog_timeout_s": 30, "io_retries": 0, "io_retry_base_s": 0.1})
    for key, value in (("trace_steps", [5, 1]), ("metrics_port", 70000), ("metrics_dir", 5),
                       ("anomaly_detection", "yes"), ("io_retry_base_s", 0),
                       ("watchdog_timeout_s", -1)):
        with pytest.raises(ValueError, match=f"\\[training\\] {key}"):
            validate_training({key: value})
