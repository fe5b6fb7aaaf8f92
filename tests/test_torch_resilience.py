"""The port's resilience (``spacy_ray_tpu_torch/training/resilience.py`` and its
sites) held against the JAX package's on the same inputs, on the CPU.

Each parity scenario runs once with each package's module (fault plans
parsed from the same specs, the watchdog on one fake clock, retries on one
fake sleep and generator, the jsonl logger on the same info dicts and
events) and the two results must be equal. The end-to-end tests drive the
port's loops: the ``corpus-read`` and ``checkpoint-write`` sites through a
plan, the retry policy from the knobs, ``train --max-restarts 1`` over a
hung step (the watchdog's exit 79, then a resumed run that ends 0), the
``nan`` poison in the loop, a two-worker thread fleet taking a corrupted
gradient push, and a fleet worker refusing the telemetry it does not have.
"""

import io
import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import spacy_ray_tpu.training.corpus as j_corpus
import spacy_ray_tpu.training.loggers as j_loggers
import spacy_ray_tpu.training.resilience as j_res
import spacy_ray_tpu_torch.training.corpus as p_corpus
import spacy_ray_tpu_torch.training.loggers as p_loggers
import spacy_ray_tpu_torch.training.resilience as p_res
from spacy_ray_tpu.util import write_synth_jsonl
from spacy_ray_tpu_torch.config import Config
from spacy_ray_tpu_torch.registry import registry as p_registry
from spacy_ray_tpu_torch.training.checkpoint import TrainCheckpoint
from spacy_ray_tpu_torch.training.fleet import worker as p_worker
from spacy_ray_tpu_torch.training.loop import train as p_train

REPO = Path(__file__).resolve().parent.parent
PKGS = {
    "jax": SimpleNamespace(res=j_res, corpus=j_corpus, loggers=j_loggers),
    "port": SimpleNamespace(res=p_res, corpus=p_corpus, loggers=p_loggers),
}


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
    prev = {name: pkg.res.set_fault_plan(None) for name, pkg in PKGS.items()}
    for pkg in PKGS.values():
        pkg.res.drain_events()
    yield
    for name, pkg in PKGS.items():
        pkg.res.set_fault_plan(prev[name])
        pkg.res.drain_events()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class MaxJitter:
    def random(self):
        return 1.0


def events(pkg):
    return [{k: v for k, v in e.items()} for e in pkg.res.drain_events()]


# ----------------------------------------------------------------------
# FaultPlan
# ----------------------------------------------------------------------

GOOD_SPECS = [
    "collate:2:runtime, corpus-read:1:oserror",
    "step:3:runtime",
    "step:9:sigterm,checkpoint-write:1:oserror",
    "step:2:nan",
    "grad-push:1:corrupt,grad-push:2:dup,param-pull:1:delay:0.25",
    "param-pull:10:partition:1,param-pull:16:heal:1,checkpoint-wire:1:partition,"
    "checkpoint-wire:2:heal",
    " STEP:1:RUNTIME".replace("STEP", "step"),
    "corpus-read:1:OSError,,",
]
BAD_SPECS = [
    "nope:1:runtime",           # unknown site
    "step:1:explode",           # unknown kind
    "step:1",                   # too few fields
    "step:one:runtime",         # call not an int
    "step:0:runtime",           # call < 1
    "collate:1:nan",            # nan off the step site
    "corpus-read:2:nan",
    "step:1:corrupt",           # a wire kind off the wire sites
    "checkpoint-write:1:partition",
    "grad-push:1:corrupt:x",    # corrupt takes no arg
    "param-pull:1:delay:soon",  # delay arg not a number
    "grad-push:1:partition:w1",  # peer not an int
    "step:1:runtime:5",         # runtime takes no arg
    "grad-push:corrupt",
    "a:b:c:d:e",
]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_fault_plan_parses_the_specs_as_jax(spec):
    rules = both(lambda pkg: pkg.res.FaultPlan.parse(spec).rules)
    assert rules


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_refuses_bad_specs_with_jax_s_message(spec):
    def refusal(pkg):
        with pytest.raises(ValueError) as e:
            pkg.res.FaultPlan.parse(spec)
        return str(e.value)

    both(refusal)


def test_sites_kinds_env_and_exit_codes_equal_jax():
    both(lambda pkg: (pkg.res.FAULT_SITES, pkg.res.FAULT_PLAN_ENV, pkg.res.RC_WATCHDOG,
                      pkg.res.RC_PREEMPTED, pkg.res._FAULT_KINDS, pkg.res._WIRE_FAULT_KINDS,
                      pkg.res._WIRE_FAULT_SITES))


def test_a_plan_triggers_at_the_scheduled_calls_as_jax():
    def run(pkg):
        pkg.res.set_fault_plan(pkg.res.FaultPlan.parse(
            "collate:2:runtime, corpus-read:1:oserror, step:2:nan"))
        outcomes = []
        for site in ("collate", "collate", "collate", "corpus-read", "corpus-read", "step",
                     "step", "step"):
            try:
                pkg.res.maybe_fail(site)
                outcomes.append((site, "ok", pkg.res.consume_poison(site)))
            except pkg.res.FaultInjected as e:
                outcomes.append((site, "FaultInjected", str(e)))
            except OSError as e:
                outcomes.append((site, "OSError", str(e)))
        return outcomes, [(e["event"], e["message"], e["site"], e["call"], e["kind"])
                          for e in events(pkg)]

    outcomes, evs = both(run)
    assert [o[1] for o in outcomes[:3]] == ["ok", "FaultInjected", "ok"]
    assert outcomes[3][1] == "OSError"
    assert [o[2] for o in outcomes[5:]] == [False, True, False]  # the poison, once
    assert len(evs) == 3


def test_nan_is_consumed_once_and_refused_at_unwired_sites():
    def run(pkg):
        pkg.res.set_fault_plan(pkg.res.FaultPlan.parse("step:2:nan"))
        got = []
        for _ in range(2):
            pkg.res.maybe_fail("step")
            got.append(pkg.res.consume_poison("step"))
        got.append(pkg.res.consume_poison("step"))
        with pytest.raises(ValueError, match="only wired at the 'step' site") as e:
            pkg.res.FaultPlan.parse("collate:1:nan")
        return got, str(e.value)

    assert both(run)[0] == [False, True, False]


def test_wire_faults_queue_fifo_and_partitions_heal_as_jax():
    def run(pkg):
        r = pkg.res
        r.set_fault_plan(r.FaultPlan.parse(
            "grad-push:1:corrupt,grad-push:2:dup,grad-push:3:delay:0.5,"
            "param-pull:1:partition:1,param-pull:2:partition,param-pull:3:heal:1,"
            "param-pull:4:heal"))
        for _ in range(3):
            r.maybe_fail("grad-push")
        queued = [r.consume_wire_fault("grad-push") for _ in range(4)]
        parts = []
        for _ in range(4):
            r.maybe_fail("param-pull")
            parts.append([r.partitioned(p) for p in (0, 1, "x")])
        return queued, parts, r.corrupt_bytes(bytes(range(64))), r.corrupt_bytes(b"")

    queued, parts, corrupted, empty = both(run)
    assert queued == [("corrupt", None), ("dup", None), ("delay", "0.5"), None]
    assert parts == [[False, True, False], [True, True, True], [True, True, True],
                     [False, False, False]]
    assert [i for i in range(64) if corrupted[i] != i] == [32] and empty == b""


def test_without_a_plan_every_site_is_free_and_an_empty_env_keeps_the_plan(monkeypatch):
    def run(pkg):
        for site in pkg.res.FAULT_SITES:
            pkg.res.maybe_fail(site)
            assert not pkg.res.consume_poison(site)
            assert pkg.res.consume_wire_fault(site) is None
        monkeypatch.setenv(pkg.res.FAULT_PLAN_ENV, "step:3:runtime")
        plan = pkg.res.activate_env_fault_plan()
        monkeypatch.setenv(pkg.res.FAULT_PLAN_ENV, "")
        kept = pkg.res.activate_env_fault_plan() is plan
        return plan.rules, kept

    assert both(run) == ([("step", 3, "runtime", None)], True)


# ----------------------------------------------------------------------
# The watchdog
# ----------------------------------------------------------------------


def test_watchdog_fires_at_the_same_instant_with_jax_s_dump_head():
    def run(pkg):
        clk = FakeClock()
        fired, err = [], io.StringIO()
        wd = pkg.res.Watchdog(10.0, stats_fn=lambda: {"stage_seconds": {"read": 1.0}},
                              clock=clk, sleep=clk.sleep, exit_fn=fired.append, stream=err)
        polls = []
        for t in (0.0, 9.0, None, 18.0, 30.0, 31.0):
            if t is None:
                wd.beat()  # at 9.0: the window starts again
                continue
            clk.t = t
            polls.append((t, wd.check()))
        dump = err.getvalue()
        return (polls, fired, dump.splitlines()[0], "thread" in dump,
                "test_watchdog_fires_at_the_same_instant" in dump,
                dump.rstrip().splitlines()[-1])

    polls, fired, head, has_threads, names_test, tail = both(run)
    assert polls == [(0.0, False), (9.0, False), (18.0, False), (30.0, True), (31.0, True)]
    assert fired == [79] and has_threads and names_test
    assert head == ("[watchdog] no step heartbeat for 21.0s (timeout 10.0s) — dumping "
                    "threads and exiting 79")
    assert tail == "[watchdog] input pipeline: {'stage_seconds': {'read': 1.0}}"


def test_watchdog_thread_fires_on_a_fake_clock_and_rejects_no_timeout():
    def run(pkg):
        clk = FakeClock()
        fired = threading.Event()
        wd = pkg.res.Watchdog(5.0, clock=clk, sleep=clk.sleep,
                              exit_fn=lambda rc: fired.set(), stream=io.StringIO())
        wd.start()
        ok = fired.wait(timeout=10.0)
        wd.stop()
        with pytest.raises(ValueError) as e:
            pkg.res.Watchdog(0)
        return ok, str(e.value)

    assert both(run)[0] is True


def test_the_supervisor_restarts_a_watchdog_exit_with_resume():
    class Child:
        def __init__(self, rc):
            self.returncode, self.pid = rc, 1

        def wait(self):
            return self.returncode

        def poll(self):
            return self.returncode

    def run(pkg):
        rcs, cmds = [pkg.res.RC_WATCHDOG, 0], []

        def popen(cmd):
            cmds.append(cmd)
            return Child(rcs[len(cmds) - 1])

        cmd = ["python", "-m", "x", "train", "c.cfg"]
        # the CLIs append --resume from the first relaunch on
        rc = pkg.res.Supervisor(lambda a: cmd + ["--resume"] * (a > 0), 1, popen=popen,
                                sleep=lambda s: None).run()
        return rc, cmds, [(e["event"], e["rc"]) for e in events(pkg)]

    rc, cmds, evs = both(run)
    assert rc == 0 and cmds[1][-1] == "--resume" and evs == [("supervisor-restart", 79)]
    assert p_res.relaunch_argv(cmds[0], 1) == cmds[1]


# ----------------------------------------------------------------------
# Retries
# ----------------------------------------------------------------------


def test_corpus_read_retries_through_a_plan_as_jax(tmp_path):
    f = tmp_path / "c.jsonl"
    f.write_text('{"tokens": ["a", "b"], "tags": ["X", "Y"]}\n')

    def run(pkg):
        sleeps = []
        pkg.res.set_fault_plan(pkg.res.FaultPlan.parse(
            "corpus-read:1:oserror,corpus-read:2:oserror"))
        prev = pkg.res.set_default_retry_policy(pkg.res.RetryPolicy(
            max_retries=2, base_delay=0.25, sleep=sleeps.append, rng=MaxJitter()))
        try:
            docs = list(pkg.corpus.read_jsonl_docs(f))
        finally:
            pkg.res.set_default_retry_policy(prev)
        return [d.words for d in docs], sleeps, [(e["event"], e["message"]) for e in events(pkg)]

    words, sleeps, evs = both(run)
    assert words == [["a", "b"]] and sleeps == [0.375, 0.75]
    assert [e[0] for e in evs] == ["fault-injected", "io-retry"] * 2


@pytest.mark.parametrize("suffix", [".jsonl", ".spacy", ".msgdoc", ".conllu"])
def test_every_corpus_format_opens_through_the_site(suffix, tmp_path):
    from spacy_ray_tpu_torch.pipeline.doc import Doc
    from spacy_ray_tpu_torch.training.spacy_docbin import write_docbin

    path = tmp_path / f"c{suffix}"
    doc = Doc(words=["a", "b"], tags=["X", "Y"], heads=[1, 1], deps=["dep", "ROOT"])
    if suffix == ".jsonl":
        path.write_text('{"tokens": ["a", "b"], "tags": ["X", "Y"]}\n')
    elif suffix == ".spacy":
        write_docbin(path, [doc])
    elif suffix == ".msgdoc":
        p_corpus.DocBin([doc]).to_disk(path)
    else:
        path.write_text("1\ta\ta\tX\tX\t_\t2\tdep\t_\t_\n2\tb\tb\tY\tY\t_\t0\troot\t_\t_\n\n")
    p_res.set_fault_plan(p_res.FaultPlan.parse("corpus-read:1:oserror"))
    prev = p_res.set_default_retry_policy(p_res.RetryPolicy(max_retries=1,
                                                            sleep=lambda s: None))
    try:
        docs = list(p_corpus._iter_path(path))
    finally:
        p_res.set_default_retry_policy(prev)
    assert [d.words for d in docs] == [["a", "b"]]
    assert [e["event"] for e in events(PKGS["port"])] == ["fault-injected", "io-retry"]


def test_checkpoint_writes_retry_and_a_crash_keeps_the_last_generation(tmp_path):
    import torch

    params = {"w": torch.ones(3)}
    OPT = {"mu": {"w": torch.zeros(3)}, "nu": {"w": torch.zeros(3)}, "count": 2,
           "sched_count": 2}
    p_res.set_fault_plan(p_res.FaultPlan.parse(
        "checkpoint-write:1:oserror,checkpoint-write:3:runtime"))
    prev = p_res.set_default_retry_policy(p_res.RetryPolicy(max_retries=2,
                                                            sleep=lambda s: None))
    try:
        TrainCheckpoint.save(tmp_path, params=params, opt_state=OPT, step=4, epoch=0,
                             best_score=0.5, best_step=4)
        with pytest.raises(p_res.FaultInjected):
            TrainCheckpoint.save(tmp_path, params=params, opt_state=OPT, step=8,
                                 epoch=0, best_score=0.5, best_step=4)
    finally:
        p_res.set_default_retry_policy(prev)
    assert TrainCheckpoint.generation_stamps(tmp_path) == [4]
    assert TrainCheckpoint.load(tmp_path)["step"] == 4
    assert [e["event"] for e in events(PKGS["port"])] == [
        "fault-injected", "io-retry", "fault-injected"]


# ----------------------------------------------------------------------
# JsonlLogger.v1
# ----------------------------------------------------------------------


def test_jsonl_logger_rows_equal_jax_on_the_same_infos_and_events(tmp_path):
    infos = [
        {"epoch": 0, "step": 4, "words": 120, "wps": 1000.5, "eval_seconds": 0.25,
         "score": 0.5, "losses": {"tagger": float("nan")}, "other_scores": {"tag_acc": 0.5},
         "eval_wps": 9.0, "telemetry": {"step_seconds_p50": 0.1, "mfu": None}},
        None,
        {"epoch": 1, "step": 8, "words": 240, "wps": 900.0, "eval_seconds": 0.5,
         "score": float("inf"), "losses": {"tagger": 1.5}, "other_scores": {}},
    ]

    def run(pkg):
        out = tmp_path / f"{pkg.res.__name__.split('.')[0]}.jsonl"
        setup = pkg.loggers.jsonl_logger(str(out))
        log_step, finalize = setup(None, io.StringIO(), io.StringIO())
        pkg.res.log_event("resume", "resumed from checkpoint step 4", step=4)
        for i, info in enumerate(infos):
            if i == 2:
                pkg.res.log_event("io-retry", "checkpoint-write: retry 1/3", site="x",
                                  attempt=1)
            log_step(info)
        pkg.res.log_event("preempted", "shutdown signal at step 8", step=8)
        finalize()
        stdout = io.StringIO()
        log_to_stdout, _ = pkg.loggers.jsonl_logger()(None, stdout, io.StringIO())
        log_to_stdout(infos[2])
        rows = [json.loads(line) for line in out.read_text().splitlines()]
        rows.append(json.loads(stdout.getvalue()))
        if pkg is PKGS["jax"]:
            # the port has no input pipeline, so its rows carry no such key (ROADMAP C83)
            for row in rows:
                assert row.pop("input_pipeline", None) is None
        return rows

    rows = both(run)
    stdout = rows.pop()
    assert [r.get("step") for r in rows] == [4, 8, None]
    assert rows[0]["losses"] == {"tagger": "nan"} and rows[0]["telemetry"]["mfu"] is None
    assert [e["event"] for e in rows[0]["events"]] == ["resume"]
    assert rows[2] == {"events": [{"event": "preempted", "message": "shutdown signal at step 8",
                                   "step": 8}]}
    assert stdout["score"] == "inf" and "input_pipeline" not in stdout


def test_jsonl_logger_is_registered_under_jax_s_name():
    assert p_registry.get("loggers", "spacy_ray_tpu.JsonlLogger.v1") is p_loggers.jsonl_logger


# ----------------------------------------------------------------------
# The loops
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("resilience_data")
    write_synth_jsonl(d / "train.jsonl", 80, kind="tagger", seed=0)
    write_synth_jsonl(d / "dev.jsonl", 20, kind="tagger", seed=1)
    return d


def _config(text, data, **over):
    cfg = Config.from_str(text)
    return cfg.apply_overrides({"paths.train": str(data / "train.jsonl"),
                                "paths.dev": str(data / "dev.jsonl"),
                                "training.max_steps": 4, "training.eval_frequency": 2, **over})


def test_the_retry_policy_follows_the_knobs(tagger_config_text, data, monkeypatch):
    """Two failed opens of the train corpus: io_retries 1 gives up, 2 trains."""
    monkeypatch.setenv(p_res.FAULT_PLAN_ENV, "corpus-read:1:oserror,corpus-read:2:oserror")
    knobs = {"training.io_retries": 1, "training.io_retry_base_s": 0.001}
    with pytest.raises(OSError, match="injected fault: corpus-read call 2"):
        p_train(_config(tagger_config_text, data, **knobs), device="cpu", stdout_log=False)
    assert p_res._DEFAULT_RETRY.max_retries == 1
    assert p_res._DEFAULT_RETRY.base_delay == 0.001
    knobs["training.io_retries"] = 2
    _, result = p_train(_config(tagger_config_text, data, **knobs), device="cpu",
                        stdout_log=False)
    assert result.final_step == 4 and p_res._DEFAULT_RETRY.max_retries == 2


def test_a_nan_rule_poisons_the_reported_loss_only(tagger_config_text, data, monkeypatch):
    """``step:3:nan`` reports step 3's loss as NaN (and the step-4 evaluation's
    loss sum with it); the parameters are those of the run without the plan."""
    from spacy_ray_tpu_torch.models.core import param_paths

    nlp0, r0 = p_train(_config(tagger_config_text, data), device="cpu", stdout_log=False)
    monkeypatch.setenv(p_res.FAULT_PLAN_ENV, "step:3:nan")
    nlp1, r1 = p_train(_config(tagger_config_text, data), device="cpu", stdout_log=False)
    assert np.isnan(r1.step_losses[2]) and np.isnan(r1.step_head_losses[2]["tagger"])
    assert r1.step_losses[:2] == r0.step_losses[:2] and r1.step_losses[3] == r0.step_losses[3]
    assert np.isnan(r1.history[1]["losses"]["tagger"])
    a, b = param_paths(nlp0.model), param_paths(nlp1.model)
    assert all(np.array_equal(a[k].numpy(), b[k].numpy()) for k in a)


def test_a_step_rule_crashes_the_loop_with_the_injected_error(tagger_config_text, data,
                                                             monkeypatch):
    monkeypatch.setenv(p_res.FAULT_PLAN_ENV, "collate:2:runtime")
    with pytest.raises(p_res.FaultInjected, match="collate call 2"):
        p_train(_config(tagger_config_text, data), device="cpu", stdout_log=False)


SLEEPER = '''
import time
from pathlib import Path
from spacy_ray_tpu_torch.registry import registry

@registry.callbacks("test.hang_once.v1")
def hang_once(marker: str, at_step: int, seconds: float):
    def hang_in_before_update(nlp, info):
        if info["step"] == at_step and not Path(marker).exists():
            Path(marker).write_text("hung")
            time.sleep(seconds)
    return hang_in_before_update
'''


def test_train_max_restarts_resumes_after_the_watchdog_exit(tagger_config_text, data, tmp_path):
    """A callback hangs once, at step 6 after the step-4 generation: the
    watchdog dumps the threads (the callback among them) and exits 79, the
    supervisor starts the run again with --resume, and it ends 0."""
    code = tmp_path / "hang.py"
    code.write_text(SLEEPER)
    cfg = _config(tagger_config_text, data, **{"training.max_steps": 8,
                                               "training.eval_frequency": 4})
    cfg["training"]["before_update"] = {"@callbacks": "test.hang_once.v1",
                                        "marker": str(tmp_path / "marker"), "at_step": 6,
                                        "seconds": 60.0}
    cfg.to_disk(tmp_path / "c.cfg")
    out = subprocess.run(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train", str(tmp_path / "c.cfg"),
         "--device", "cpu", "--output", str(tmp_path / "out"), "--code", str(code),
         "--max-restarts", "1", "--training.watchdog_timeout_s", "15",
         "--metrics-dir", str(tmp_path / "tel")],
        cwd=REPO, capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[watchdog] no step heartbeat" in out.stderr
    assert "hang_in_before_update" in out.stderr
    assert out.stderr.count("[supervisor-restart] child exited rc=79") == 1
    assert "Done. steps=8" in out.stdout
    rows = [json.loads(line) for line in open(tmp_path / "tel" / "metrics.jsonl")]
    # the first attempt's rows were flushed before its hard exit
    assert [r["step"] for r in rows if r["kind"] == "eval"] == [4, 8]
    assert [r["step"] for r in rows if r["kind"] == "step"] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert TrainCheckpoint.generation_stamps(tmp_path / "out" / "last-model")[-1] == 8


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_a_fleet_takes_a_corrupted_push_as_jax_s_drill_counts(tagger_config_text, data,
                                                             tmp_path):
    """``grad-push:2:corrupt`` on a two-worker thread fleet (quorum 1, S 1):
    the receiver refuses the frame by its CRC-32 (a counted discard, each
    attempt), the sender counts the push failed after its retry, and both
    workers finish their 4 steps (JAX ``test_fleet_grad_push_fault_drill``'s
    counts)."""
    import torch

    cfg = _config(tagger_config_text, data, **{"training.eval_frequency": 4})
    ports = _free_ports(2)
    urls = [f"http://127.0.0.1:{p}" for p in ports]
    p_res.set_fault_plan(p_res.FaultPlan.parse("grad-push:2:corrupt"))
    results, errors = {}, {}
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def run(k):
        try:
            results[k] = p_worker.train_fleet_worker(
                cfg, tmp_path / "out", worker_id=k, n_workers=2, quorum=1, max_staleness=1,
                port=ports[k], peer_urls=urls, stdout_log=False, quorum_wait_s=120.0,
                device="cpu", peer_lease_s=0, grad_compression="f32", param_delta_window=0)[1]
        except Exception as e:
            errors[k] = e

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        torch.set_num_threads(n_threads)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    counters = [results[k].fleet["counters"] for k in (0, 1)]
    refused = [results[k].fleet["frames_crc_refused"] for k in (0, 1)]
    assert sum(c["push_failed"] for c in counters) == 1
    # the frame and its one retry, refused at the owner by their CRC-32 and
    # counted apart from the stale and structural discards
    assert sorted(refused) == [0, 1 + p_worker.PUSH_RETRIES]
    assert all(results[k].final_step == 4 for k in (0, 1))
    evs = events(PKGS["port"])
    assert [(e["site"], e["kind"]) for e in evs if e["event"] == "fault-injected"] == [
        ("grad-push", "corrupt")]
    retries = [e["message"] for e in evs if e["event"] == "io-retry"]
    assert len(retries) == p_worker.PUSH_RETRIES and "HTTP 400" in retries[0]
    # `telemetry summarize` digests the fleet's run directory as JAX's does
    from spacy_ray_tpu.training import telemetry as j_tel
    from spacy_ray_tpu_torch.training import telemetry as p_tel

    text = p_tel.summarize_metrics(tmp_path / "out")
    assert text == j_tel.summarize_metrics(tmp_path / "out")
    assert "workers: 2" in text and text.count("push-failed 1") == 1


def test_a_fleet_worker_refuses_telemetry_naming_item_4_3(tagger_config_text, data, tmp_path):
    cfg = _config(tagger_config_text, data)
    for kw in ({"metrics_dir": tmp_path / "tel"}, {"metrics_port": 9100}):
        with pytest.raises(ValueError, match="item 4.3"):
            p_train(cfg, device="cpu", fleet={"worker_id": 0, "n_workers": 2}, **kw)
    cfg["training"]["metrics_dir"] = str(tmp_path / "tel")
    with pytest.raises(ValueError, match="item 4.3"):
        p_worker.train_fleet_worker(cfg, worker_id=0, n_workers=2, device="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "spacy_ray_tpu_torch", "train", "configs/cnn.cfg", "--device",
         "cpu", "--fleet-workers", "2", "--metrics-dir", str(tmp_path / "tel")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 2 and "item 4.3" in out.stderr
    assert not (tmp_path / "tel").exists()


def test_a_corrupted_frame_decodes_but_its_crc_refuses_it():
    """A frame past a few hundred bytes has its middle byte among the arrays:
    both packages decode the corrupted frame into other numbers; the CRC-32
    beside it is what refuses it."""
    from spacy_ray_tpu.training.fleet import wire as j_wire
    from spacy_ray_tpu_torch.training.fleet import wire as p_wire

    arrays = {"w": np.arange(4096, dtype=np.float32)}
    frame = p_wire.encode_arrays({"worker": 0, "stamp": 3}, arrays)
    assert frame == j_wire.encode_arrays({"worker": 0, "stamp": 3}, arrays)
    bad = p_res.corrupt_bytes(frame)
    for decode in (p_wire.decode_arrays, j_wire.decode_arrays):
        meta, got = decode(bad)
        assert meta["stamp"] == 3 and not np.array_equal(got["w"], arrays["w"])
    headers = {p_wire.CRC_HEADER: p_wire.frame_crc(frame)}
    p_wire.check_frame_crc(frame, headers)
    p_wire.check_frame_crc(bad, {})  # no header: nothing to check
    with pytest.raises(p_wire.WireError, match="CRC-32 mismatch"):
        p_wire.check_frame_crc(bad, headers)
