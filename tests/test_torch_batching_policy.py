"""The port's batching policy against the JAX package's ``DynamicBatcher``:
the same scripted arrivals under a fake clock give the same batches of
request ids, the same ``expired``, ``rejected_*`` and
``served_docs_by_class`` counters and the same ``fail_all_queued`` count,
in window and continuous mode, with and without SLO-class weights
(hypothesis over the arrival sequences). Then the JAX package's own
batcher cases, run on both classes."""

import threading
import time

import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

from spacy_ray_tpu.serving import batcher as JB

from spacy_ray_tpu_torch.serving import batcher as PB

IMPLS = {"jax": JB, "port": PB}
WEIGHTS = {"gold": 4.0, "batch": 1.0}
TIGHT = {"gold": 1.5, "batch": 1.0}  # turns of 9 and 6 docs: credit left over, forfeited
CLASSES = ("gold", "batch", "stray")  # "stray": a class the batcher was not built with


class FakeClock:
    """Deterministic time; ``tick`` is added at every read, so a window's
    wait loop advances the same way under both implementations."""

    def __init__(self, t: float = 100.0, tick: float = 0.0):
        self.t, self.tick = t, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _script_ops():
    submit = st.tuples(st.just("submit"), st.integers(1, 5), st.sampled_from(CLASSES),
                       st.sampled_from([0.0005, 0.003, 10.0]))
    advance = st.tuples(st.just("advance"), st.sampled_from([0.0005, 0.002, 0.01]))
    nxt = st.tuples(st.just("next"))
    return st.lists(st.one_of(submit, submit, advance, nxt, nxt), min_size=1, max_size=60)


def _run(mod, ops, *, mode, weights, tick):
    clock = FakeClock(tick=tick)
    b = mod.DynamicBatcher(max_queue_docs=16, max_batch_docs=6, max_wait_s=0.004, mode=mode,
                           clock=clock, class_weights=dict(weights) if weights else None)
    reqs, log = [], []
    for op in ops:
        if op[0] == "submit":
            _, n, klass, ttl = op
            r = mod.ServeRequest(list(range(n)), deadline=clock.t + ttl, enqueued_at=clock.t,
                                 request_id=f"r{len(reqs)}", klass=klass)
            reqs.append(r)
            try:
                b.submit(r)
                log.append(("ok", r.request_id))
            except mod.ServingError as e:
                log.append((type(e).__name__, r.request_id))
        elif op[0] == "advance":
            clock.t += op[1]
        elif b.queue_depth() > 0:
            batch = b.next_batch(poll_s=1e-4)
            log.append(("batch", [r.request_id for r in batch]))
    log.append(("depth", b.queue_depth()))
    log.append(("failed", b.fail_all_queued(mod.Draining("stop"))))
    log.append(("errors", [(r.request_id, type(r.error).__name__ if r.error else None,
                            r.done) for r in reqs]))
    log.append(("counters", b.expired, b.rejected_full, b.rejected_draining,
                dict(b.served_docs_by_class),
                dict(b.class_weights) if b.class_weights is not None else None))
    return log


@pytest.mark.parametrize("weights", [None, WEIGHTS, TIGHT], ids=["fifo", "wfq", "wfq_tight"])
@pytest.mark.parametrize("mode", ["continuous", "window"])
@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(ops=_script_ops())
# a class whose queue empties as its turn fills the batch forfeits the
# credit it has left (under TIGHT: gold may not take a third 5-doc request)
@example(ops=[("submit", 1, "gold", 10.0), ("submit", 4, "batch", 10.0),
              ("submit", 5, "batch", 10.0), ("next",), ("submit", 5, "gold", 10.0),
              ("submit", 5, "gold", 10.0), ("next",), ("next",), ("submit", 5, "batch", 10.0)])
def test_scripted_arrivals_give_jax_batches(mode, weights, ops):
    tick = 0.001 if mode == "window" else 0.0
    want = _run(JB, ops, mode=mode, weights=weights, tick=tick)
    got = _run(PB, ops, mode=mode, weights=weights, tick=tick)
    assert got == want


@pytest.mark.parametrize("mode", ["continuous", "window"])
def test_draining_and_close_rejections_match(mode):
    logs = {}
    for name, mod in IMPLS.items():
        clock = FakeClock(tick=0.001)
        b = mod.DynamicBatcher(max_queue_docs=4, max_batch_docs=2, max_wait_s=0.002,
                               mode=mode, clock=clock)
        out = []
        for i in range(3):
            try:
                b.submit(mod.ServeRequest([0, 1], deadline=clock.t + 10, enqueued_at=clock.t,
                                          request_id=f"r{i}"))
                out.append("ok")
            except mod.ServingError as e:
                out.append(e.code)
        b.begin_drain()
        try:
            b.submit(mod.ServeRequest([0], deadline=clock.t + 10, enqueued_at=clock.t))
        except mod.ServingError as e:
            out.append(e.code)
        out.append([r.request_id for r in b.next_batch(poll_s=1e-4)])
        b.close()
        out.append([r.request_id for r in b.next_batch(poll_s=1e-4)])
        out.append(b.next_batch(poll_s=1e-4))
        out += [b.rejected_full, b.rejected_draining, b.fail_all_queued(mod.Draining("x"))]
        logs[name] = out
    assert logs["port"] == logs["jax"]
    assert logs["jax"][:4] == ["ok", "ok", "queue_full", "draining"]


def _mm_req(mod, klass, n=1, deadline_in=30.0):
    now = time.monotonic()
    return mod.ServeRequest(list(range(n)), deadline=now + deadline_in, enqueued_at=now,
                            klass=klass)


def _drain_docs(b, n_docs):
    """Pop batches straight through ``_pop_ready`` until ``n_docs`` docs are
    served (the JAX tests' helper)."""
    served = 0
    while served < n_docs:
        batch = []
        with b._lock:
            b._pop_ready(batch, time.monotonic())
        if not batch:
            break
        served += sum(len(r.docs) for r in batch)
    return served


@pytest.mark.parametrize("impl", IMPLS)
def test_wfq_weights_honored_under_saturation(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=1024, max_batch_docs=8, max_wait_s=0.0,
                           class_weights={"gold": 4.0, "batch": 1.0})
    for _ in range(320):
        b.submit(_mm_req(mod, "gold"))
        b.submit(_mm_req(mod, "batch"))
    assert _drain_docs(b, 320) == 320
    gold, batch = b.served_docs_by_class["gold"], b.served_docs_by_class["batch"]
    assert batch > 0
    assert gold / batch == pytest.approx(4.0, rel=0.15)


@pytest.mark.parametrize("impl", IMPLS)
def test_wfq_unknown_class_auto_registers_at_weight_one(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=64, max_batch_docs=4, max_wait_s=0.0,
                           class_weights={"gold": 4.0})
    b.submit(_mm_req(mod, "surprise"))
    assert _drain_docs(b, 1) == 1
    assert b.class_weights["surprise"] == 1.0
    assert b.served_docs_by_class["surprise"] == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_wfq_idle_class_has_no_penalty(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=64, max_batch_docs=4, max_wait_s=0.0,
                           class_weights={"gold": 4.0, "batch": 1.0})
    for _ in range(8):
        b.submit(_mm_req(mod, "batch"))
    batch = []
    with b._lock:
        b._pop_ready(batch, time.monotonic())
    assert sum(len(r.docs) for r in batch) == 4


@pytest.mark.parametrize("impl", IMPLS)
def test_wfq_expires_per_class_queues(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=64, max_batch_docs=4, max_wait_s=0.0,
                           class_weights={"gold": 4.0, "batch": 1.0})
    dead, live = _mm_req(mod, "gold", deadline_in=0.0), _mm_req(mod, "batch")
    b.submit(dead)
    b.submit(live)
    time.sleep(0.002)
    assert _drain_docs(b, 1) == 1
    assert dead.done and isinstance(dead.error, mod.DeadlineExceeded)
    assert live.error is None
    assert b.expired == 1


@pytest.mark.parametrize("impl", IMPLS)
def test_wfq_fail_all_queued_drains_class_queues(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=64, max_batch_docs=4, max_wait_s=0.0,
                           class_weights={"gold": 4.0, "batch": 1.0})
    reqs = [_mm_req(mod, "gold"), _mm_req(mod, "batch"), _mm_req(mod, "gold")]
    for r in reqs:
        b.submit(r)
    assert b.fail_all_queued(mod.Draining("going down")) == 3
    assert b.queue_depth() == 0
    assert all(r.done and isinstance(r.error, mod.Draining) for r in reqs)


@pytest.mark.parametrize("impl", IMPLS)
def test_legacy_no_weights_is_single_fifo(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=64, max_batch_docs=4, max_wait_s=0.0)
    reqs = [_mm_req(mod, k) for k in ("gold", "batch", "gold", "batch")]
    for r in reqs:
        b.submit(r)
    batch = []
    with b._lock:
        b._pop_ready(batch, time.monotonic())
    assert batch == reqs  # arrival order, classes ignored
    assert b.served_docs_by_class == {}
    assert b.class_weights is None


@pytest.mark.parametrize("impl", IMPLS)
def test_batcher_coalesces_within_window(impl):
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=32, max_batch_docs=8, max_wait_s=0.25,
                           mode="window")
    now = time.monotonic()
    for _ in range(3):
        b.submit(mod.ServeRequest([0, 1], deadline=now + 30, enqueued_at=now))
    t0 = time.monotonic()
    batch = b.next_batch()
    assert sum(len(r.docs) for r in batch) == 6
    assert time.monotonic() - t0 < 5.0


@pytest.mark.parametrize("impl", IMPLS)
def test_window_collects_a_request_arriving_inside_it(impl):
    # a second request submitted from another thread while the window is
    # open rides the same batch; continuous mode would have dispatched alone
    mod = IMPLS[impl]
    b = mod.DynamicBatcher(max_queue_docs=32, max_batch_docs=8, max_wait_s=2.0,
                           mode="window")
    now = time.monotonic()
    first = mod.ServeRequest([0], deadline=now + 30, enqueued_at=now)
    late = mod.ServeRequest([0] * 7, deadline=now + 30, enqueued_at=now)
    b.submit(first)
    timer = threading.Timer(0.05, b.submit, args=(late,))
    timer.start()
    batch = b.next_batch()
    timer.join()
    assert batch == [first, late]  # the full batch ends the window early


def test_etags_and_request_ids_are_jaxs():
    texts = [[], ["a"], ["ab"], ["a", "b"], ["é  ", "x"], ["\ud800"]]
    for ts in texts:
        for model in ("", "md", "trf"):
            assert PB.cache_key_for(ts, model) == JB.cache_key_for(ts, model)
            for gen in (None, 0, 40, 123456789):
                assert PB.etag_for(ts, model, gen) == JB.etag_for(ts, model, gen)
    tag = PB.etag_for(["a"], "md", 3)
    for header in (None, "", tag, f"W/{tag}", f'"x", {tag}', "*", '"nope"', f"W/ {tag}"):
        assert PB.if_none_match_hit(header, tag) == JB.if_none_match_hit(header, tag)
    for raw in (None, "abc", "a" * 128, "a" * 129, "id\n", "ok-1.2:3_x", "sp ace", 5):
        assert PB.clean_request_id(raw) == JB.clean_request_id(raw)
    assert len(PB.mint_request_id()) == len(JB.mint_request_id()) == 16
    assert PB.REQUEST_ID_HEADER == JB.REQUEST_ID_HEADER
    for name in ("QuotaExceeded", "UnknownModel", "QueueFull", "Draining", "NotReady",
                 "DeadlineExceeded", "RequestTooLarge", "SwapFailed"):
        p, j = getattr(PB, name), getattr(JB, name)
        assert (p.http_status, p.code) == (j.http_status, j.code)
