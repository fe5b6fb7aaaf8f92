"""The trainer fleet's optimizer parts, their route and the supervisor in the
port against the JAX package, on the CPU: ``index_for_shape`` by rank, the
owners' parts written, assembled and carved back, the carving against JAX's
``local_opt_from_canonical`` on the same moments, torn, missing and
mis-digested parts falling back a generation, the retention sweep, the
watcher's scan of format-2 generations, ``POST /checkpoint`` against a JAX
peer server, the owner's checkpoint cut, and, each script run through JAX's
and the port's on the same fakes, ``Supervisor`` with a fake ``popen``, the
CLI's ``--max-restarts`` plumbing and ``ShutdownCoordinator``.

Tolerances: every comparison here is exact (indices, records, bits, replies,
counters, argv).
"""

import json
import os
import re
import signal
import subprocess
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from spacy_ray_tpu.training import optimizers as jopt
from spacy_ray_tpu.training import resilience as jres
from spacy_ray_tpu.training.fleet import membership as jmem
from spacy_ray_tpu.training.fleet import ownership as jown
from spacy_ray_tpu.training.fleet import peer as jpeer
from spacy_ray_tpu.training.fleet import wire as jwire

from spacy_ray_tpu_torch.serving.live.watcher import scan_intact_generations
from spacy_ray_tpu_torch.training import checkpoint as pck
from spacy_ray_tpu_torch.training import optimizers as popt
from spacy_ray_tpu_torch.training import resilience as pres
from spacy_ray_tpu_torch.training.fleet import coordinator as pcoord
from spacy_ray_tpu_torch.training.fleet import membership as pmem
from spacy_ray_tpu_torch.training.fleet import ownership as pown
from spacy_ray_tpu_torch.training.fleet import peer as ppeer
from spacy_ray_tpu_torch.training.fleet import worker as pworker

RNG = np.random.default_rng(19)
TEMPLATE = {"m": {"W": RNG.random((8, 6), dtype=np.float32),
                  "b": RNG.random(3, dtype=np.float32)},
            "n": {"E": RNG.random((12, 4), dtype=np.float32)},
            "s": RNG.random(6, dtype=np.float32)}
SHAPES = [(), (1,), (3,), (4,), (6, 2), (2, 6), (8, 6), (5, 7), (12, 3, 4), (3, 8, 5),
          (0,), (4, 0)]
#: the layouts the parts are written under: N 2, N 3, and N 3 after worker 0
#: failed over (rank 0 is worker 1, the lowest survivor)
LAYOUTS = {"n2": (0, 1), "n3": (0, 1, 2), "failover": (1, 2)}


def _layouts(name):
    active = LAYOUTS[name]
    if name == "failover":
        return pmem.RankedLayout(TEMPLATE, active), jmem.RankedLayout(TEMPLATE, active)
    return (pown.OwnershipLayout(TEMPLATE, len(active)),
            jown.OwnershipLayout(TEMPLATE, len(active)))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_index_for_shape_equals_jax(n):
    p, j = pown.OwnershipLayout(TEMPLATE, n), jown.OwnershipLayout(TEMPLATE, n)
    for shape in SHAPES:
        for w in range(4):
            assert p.index_for_shape(shape, w) == j.index_for_shape(shape, w), (shape, w)


def test_ranked_index_for_shape_after_an_eviction_equals_jax():
    for active in ([0, 2, 3], [1, 2], [3]):
        p, j = pmem.RankedLayout(TEMPLATE, active), jmem.RankedLayout(TEMPLATE, active)
        for shape in SHAPES:
            for w in range(4):
                if w in active:
                    assert p.index_for_shape(shape, w) == j.index_for_shape(shape, w)
                else:
                    for layout in (p, j):
                        with pytest.raises(ValueError, match="not in the active set"):
                            layout.index_for_shape(shape, w)


def _owner_states(layout, active, steps=3):
    """Each owner's optimizer state over its slices after ``steps`` applies
    of distinct gradients (host copies), through the fleet's own apply."""
    opt, _ = pworker.owner_optimizer(popt.Adam(learn_rate=0.01))
    states = {}
    for w in active:
        sa = pworker.SliceApply(opt, torch.device("cpu"))
        params, state = sa.init(layout.flat_slices(TEMPLATE, w))
        for i in range(steps):
            g = {k: RNG.normal(size=v.shape).astype(np.float32) * (0.01 * (i + 1))
                 for k, v in params.items()}
            params, state = sa(params, state, g)
        states[w] = pck.flatten_opt_state(state)
    return opt, states


def _write_parts(path, stamp, layout, active, opt, states):
    digests, files = {}, []
    for rank, w in enumerate(active):
        n_leaves, records = pown.opt_part_records(opt, TEMPLATE, layout, states[w], w)
        digests[rank] = pck.write_fleet_opt_part(path, stamp=stamp, part=rank,
                                                 parts=len(active), n_leaves=n_leaves,
                                                 records=records)
        files.append(path / pck.opt_part_name(stamp, rank, len(active)))
    return digests, files


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_parts_round_trip_bit_for_bit(name, tmp_path):
    """Parts written one per owner assemble into the one-process state over
    the whole template with no hole, a one-process optimizer loads it, and
    carving each owner's state back out gives its bits; the counts come from
    the rank-0 owner alone (worker 1 after the failover)."""
    layout, _ = _layouts(name)
    active = LAYOUTS[name]
    opt, states = _owner_states(layout, active)
    for rank, w in enumerate(active):
        _, records = pown.opt_part_records(opt, TEMPLATE, layout, states[w], w)
        counts = [r[0] for r in records if r[0] in ("count", "sched_count")]
        assert counts == (["count", "sched_count"] if rank == 0 else []), (w, counts)
    _, files = _write_parts(tmp_path, 3, layout, active, opt, states)
    canonical = pck.assemble_opt_parts(files, 3)
    want = pown.canonical_opt_leaves(opt, TEMPLATE)
    assert list(canonical) == list(want)
    assert {k: (v.shape, str(v.dtype)) for k, v in canonical.items()} == want
    assert int(canonical["count"]) == int(canonical["sched_count"]) == 3
    one = popt.Adam().init({k: torch.zeros(v.shape) for k, v in pck.flatten(TEMPLATE).items()})
    popt.Adam().load_opt_state(one, canonical)
    assert one["count"] == 3
    for w in active:
        back = pown.local_opt_from_canonical(opt, layout, canonical, w,
                                             layout.flat_slices(TEMPLATE, w))
        mine = states[w]
        assert sorted(back) == sorted(mine)
        for k in mine:
            assert back[k].dtype == mine[k].dtype and back[k].tobytes() == mine[k].tobytes(), \
                (w, k)


def _jax_name(key):
    """A JAX Adam.v1 state leaf's keystr as the port's flat name."""
    m = re.fullmatch(r"\[(\d)\]\.count", key)
    if m:
        return {"1": "count", "2": "sched_count"}[m.group(1)]
    m = re.fullmatch(r"\[1\]\.(mu|nu)((?:\['[^']*'\])+)", key)
    assert m, key
    return m.group(1) + "/" + "/".join(re.findall(r"\['([^']*)'\]", m.group(2)))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_carving_equals_jax_on_the_same_moments(name):
    """The same moments and counts, as an optax Adam.v1 state into JAX's
    ``local_opt_from_canonical`` and by flat name into the port's: every
    worker's pieces come out bit-equal."""
    playout, jlayout = _layouts(name)
    jtx = jopt.Adam(learn_rate=0.001)
    opt = popt.Adam(learn_rate=0.001)
    canonical = {k: (np.asarray(RNG.integers(1, 1000), np.int64) if not shape
                     else RNG.normal(size=shape).astype(np.float32))
                 for k, (shape, _) in pown.canonical_opt_leaves(opt, TEMPLATE).items()}
    flat, treedef = jax.tree_util.tree_flatten_with_path(jax.eval_shape(jtx.init, TEMPLATE))
    assert sorted(_jax_name(jax.tree_util.keystr(p)) for p, _ in flat) == sorted(canonical)
    jcanon = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(canonical[_jax_name(jax.tree_util.keystr(p))], dtype=leaf.dtype)
        for p, leaf in flat])
    for w in LAYOUTS[name]:
        jlocal = jown.local_opt_from_canonical(jtx, jlayout, jcanon, w,
                                               jlayout.slice_tree(TEMPLATE, w))
        jflat = {_jax_name(jax.tree_util.keystr(p)): np.asarray(leaf)
                 for p, leaf in jax.tree_util.tree_flatten_with_path(jlocal)[0]}
        plocal = pown.local_opt_from_canonical(opt, playout, canonical, w,
                                               playout.flat_slices(TEMPLATE, w))
        assert sorted(plocal) == sorted(jflat), w
        for k, v in jflat.items():
            if k in ("count", "sched_count"):
                assert int(plocal[k]) == int(v)
            else:
                assert plocal[k].tobytes() == v.tobytes(), (w, k)


def test_a_piece_of_the_wrong_shape_raises_jax_s_message():
    layout = pown.OwnershipLayout(TEMPLATE, 2)
    opt, states = _owner_states(layout, (0, 1), steps=1)
    bad = {**states[1], "mu/m/W": np.zeros((3, 6), np.float32)}
    with pytest.raises(ValueError, match=r"optimizer leaf 'mu/m/W': local slice shape "
                                         r"\(3, 6\) != owner-shard shape \(4, 6\)"):
        pown.opt_part_records(opt, TEMPLATE, layout, bad, 1)
    with pytest.raises(ValueError, match="not in the layout's active set"):
        pown.opt_part_records(opt, TEMPLATE, pmem.RankedLayout(TEMPLATE, [1, 2]), states[0], 0)


def _generation(path, step, keep=2, name="n2"):
    layout, _ = _layouts(name)
    active = LAYOUTS[name]
    opt, states = _owner_states(layout, active, steps=1)
    digests, files = _write_parts(path, step, layout, active, opt, states)
    pck.commit_fleet_generation(path, params=TEMPLATE, step=step, epoch=0, rng="0a0b0c",
                                best_score=0.5, best_step=step, opt_shards=len(active),
                                opt_digests=digests, keep=keep,
                                extra={"fleet": {"epoch": 0, "active": list(active)}})
    return files


def _tear(f):
    f.write_bytes(f.read_bytes()[: f.stat().st_size // 2])


CORRUPTIONS = {
    "torn": lambda path, files: _tear(files[1]),
    "missing": lambda path, files: files[0].unlink(),
    # a whole, valid part, but not the one the meta's digest names
    "wrong-digest": lambda path, files: files[1].write_bytes(
        (path / "opt_state-4.part1of2.npz").read_bytes()),
}


@pytest.mark.parametrize("how", sorted(CORRUPTIONS))
def test_a_bad_part_falls_back_one_generation(how, tmp_path):
    _generation(tmp_path, 2)
    _generation(tmp_path, 4)
    files = _generation(tmp_path, 6)
    # the sweep kept generations 4 and 6 and took 2's parts with it
    names = sorted(p.name for p in tmp_path.iterdir())
    assert not [n for n in names if re.search(r"-2[.]", n)], names
    assert [n for n in names if n.startswith("opt_state-")] == [
        "opt_state-4.part0of2.npz", "opt_state-4.part1of2.npz",
        "opt_state-6.part0of2.npz", "opt_state-6.part1of2.npz"]
    assert pck.TrainCheckpoint.load(tmp_path)["step"] == 6
    assert scan_intact_generations(tmp_path) == [4, 6]
    CORRUPTIONS[how](tmp_path, files)
    state = pck.TrainCheckpoint.load(tmp_path)
    assert state["step"] == 4 and state["format"] == 2 and state["rng"] == "0a0b0c"
    assert scan_intact_generations(tmp_path) == [4]
    assert scan_intact_generations(tmp_path, params_only=True) == [4, 6]


def test_assembly_refuses_holes_and_misnumbered_parts(tmp_path):
    layout, _ = _layouts("n2")
    opt, states = _owner_states(layout, (0, 1), steps=1)
    _, files = _write_parts(tmp_path, 3, layout, (0, 1), opt, states)
    with pytest.raises(pck.CheckpointCorrupt, match="names part 1 of 2"):
        pck.assemble_opt_parts([files[1], files[0]], 3)
    with pytest.raises(pck.CheckpointCorrupt, match="stamp 3"):
        pck.assemble_opt_parts(files, 4)
    # a part that left out its piece of one leaf: a hole
    n_leaves, records = pown.opt_part_records(opt, TEMPLATE, layout, states[1], 1)
    pck.write_fleet_opt_part(tmp_path, stamp=3, part=1, parts=2, n_leaves=n_leaves,
                             records=[r for r in records if r[0] != "mu/m/W"])
    with pytest.raises(pck.CheckpointCorrupt, match="holes in \\['mu/m/W'\\]"):
        pck.assemble_opt_parts(files, 3)
    with pytest.raises(ValueError, match="digests for parts"):
        pck.commit_fleet_generation(tmp_path, params=TEMPLATE, step=3, epoch=0, rng="",
                                    best_score=0.0, best_step=0, opt_shards=2,
                                    opt_digests={0: "d"})


def test_opt_file_names_of_both_packages_generations(tmp_path):
    _generation(tmp_path, 5, name="n3")
    meta = json.loads((tmp_path / "train_meta-5.json").read_text())
    assert meta["format"] == 2 and meta["opt_shards"] == 3
    assert pck.opt_file_names(meta, 5) == [f"opt_state-5.part{k}of3.npz" for k in range(3)]
    assert set(meta["digests"]) == {"params-5.npz", *pck.opt_file_names(meta, 5)}
    jax_meta = {"format": 2, "opt_shards": 2, "digests": {"opt_state-5.part0of2.pkl": "x"}}
    assert pck.opt_file_names(jax_meta, 5) == ["opt_state-5.part0of2.pkl",
                                               "opt_state-5.part1of2.pkl"]
    assert pck.opt_file_names({"digests": {"opt_state-5.npz": "x"}}, 5) == ["opt_state-5.npz"]
    assert pck.opt_file_names({}, 5) == ["opt_state-5.pkl"]
    # a generation whose parts are the JAX package's pickles is not this package's to resume
    (tmp_path / "train_meta-5.json").write_text(json.dumps({**meta, **jax_meta, "stamp": 5}))
    (tmp_path / "train_meta.json").unlink()
    with pytest.raises(pck.CheckpointCorrupt, match="JAX package's optimizer state"):
        pck.TrainCheckpoint.load(tmp_path)


def test_generator_states_round_trip_as_hex_and_as_byte_lists():
    gen = torch.Generator().manual_seed(5)
    torch.randint(0, 2 ** 62, (3,), generator=gen)
    want = torch.randint(0, 2 ** 62, (4,), generator=gen.clone_state())
    for saved in (pck.generator_state_hex(gen), gen.get_state().tolist()):
        other = torch.Generator().manual_seed(9)
        assert pck.set_generator_state(other, saved)
        assert torch.equal(torch.randint(0, 2 ** 62, (4,), generator=other), want)
    assert len(pck.generator_state_hex(gen)) == 2 * gen.get_state().numel()
    assert not pck.set_generator_state(gen, "") and not pck.set_generator_state(gen, [])


# ---------------------------------------------------------------- the route


def test_a_worker_writes_parts_only_into_its_own_last_model(tmp_path):
    pworker.check_checkpoint_dir(tmp_path, str(tmp_path / "last-model"))
    pworker.check_checkpoint_dir(tmp_path, str(tmp_path / "x" / ".." / "last-model"))
    for out, where in ((tmp_path, tmp_path / "elsewhere"), (tmp_path, "/tmp"),
                       (None, tmp_path / "last-model")):
        with pytest.raises(ValueError, match="only into its own output's last-model"):
            pworker.check_checkpoint_dir(out, str(where))


def _cb(ckpt_dir, stamp):
    return {"meta": {"part": 1, "digest": "d", "version": 7, "step": stamp, "rng": [1, 2]},
            "params": {"x": np.arange(4, dtype=np.float32)}}


def _boom(ckpt_dir, stamp):
    raise OSError("disk full")


def _server(pkg, cb):
    counters = pkg.FleetCounters()
    owner = pkg.OwnerState(worker_id=1, n_workers=2, quorum=1, max_staleness=0,
                           apply_fn=lambda p, o, g: (p, o),
                           slice_params={"x": np.zeros(4, np.float32)}, opt_state={},
                           counters=counters)
    server = pkg.PeerServer(owner, worker_id=1, layout_signature="sig", counters=counters,
                            checkpoint_cb=cb)
    server.set_membership((jmem if pkg is jpeer else pmem).Membership([0, 1], 1), "sig-e")
    host, port = server.start()
    return server, counters, f"http://{host}:{port}"


def _post(url, body):
    req = urllib.request.Request(url + "/checkpoint", data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _answer(status, body):
    try:
        payload = json.loads(body)
        payload.pop("message", None)
    except ValueError:
        meta, arrays = jwire.decode_arrays(body)
        payload = {"meta": meta, **{k: v.tolist() for k, v in arrays.items()}}
    return status, payload


CHECKPOINT_REQUESTS = [
    (_cb, {"dir": "d", "stamp": 5, "epoch": 1}),
    (_cb, {"dir": "d", "stamp": 5, "epoch": 0}),
    (_cb, {"dir": "d", "stamp": 5}),
    (_cb, {"dir": "d", "stamp": "x", "epoch": 1}),
    (_cb, {"stamp": 5, "epoch": 1}),
    (_cb, {"dir": "d", "stamp": 5, "epoch": -1}),
    (_boom, {"dir": "d", "stamp": 5, "epoch": 1}),
    (None, {"dir": "d", "stamp": 5, "epoch": 1}),
]


def test_checkpoint_route_answers_as_jax():
    """200 with the part's meta and the slices, 409 (counted, JAX's body) at
    another epoch or none, 400 on a bad body, 500 when the write raises and
    503 without a callback, from a port and a JAX peer server alike."""
    seen = {}
    for pkg in (ppeer, jpeer):
        answers, fenced = [], []
        for cb, req in CHECKPOINT_REQUESTS:
            server, counters, url = _server(pkg, cb)
            try:
                answers.append(_answer(*_post(url, json.dumps(req).encode("utf8"))))
                answers.append(_answer(*_post(url, b"not json")))
                fenced.append(counters.snapshot()["epoch_fenced"])
            finally:
                server.stop()
        seen[pkg] = answers, fenced
    assert seen[ppeer] == seen[jpeer]
    answers, fenced = seen[ppeer]
    assert [a[0] for a in answers[::2]] == [200, 409, 409, 400, 400, 400, 500, 503]
    assert answers[0][1] == {"meta": {"part": 1, "digest": "d", "version": 7, "step": 5,
                                      "rng": [1, 2]}, "x": [0.0, 1.0, 2.0, 3.0]}
    assert answers[2][1] == {"error": "epoch_fenced", "epoch": 1}
    assert fenced == [0, 1, 1, 0, 0, 0, 0, 0]


def test_the_owner_writes_its_part_from_one_cut_and_a_retired_owner_refuses():
    layout = pown.OwnershipLayout(TEMPLATE, 2)
    opt, _ = pworker.owner_optimizer(popt.Adam(learn_rate=0.01))
    sa = pworker.SliceApply(opt, torch.device("cpu"))
    params, state = sa.init(layout.flat_slices(TEMPLATE, 0))
    owner = ppeer.OwnerState(worker_id=0, n_workers=2, quorum=1, max_staleness=0, apply_fn=sa,
                             slice_params=params, opt_state=state,
                             counters=ppeer.FleetCounters())
    g = {k: np.full(v.shape, 0.5, np.float32) for k, v in params.items()}
    owner.submit(0, 0, g)
    version, host_opt, host_flat = owner.checkpoint_parts(lambda v, o, host: (v, o, host))
    assert version == 1 and int(host_opt["count"]) == 1
    for k, t in state["mu"].items():
        assert isinstance(host_opt[f"mu/{k}"], np.ndarray)
        assert host_opt[f"mu/{k}"].tobytes() == t.numpy().tobytes()
    owner.submit(0, 1, g)  # the copy taken in the cut does not move with the owner
    assert not np.array_equal(host_opt["mu/m/W"], state["mu"]["m/W"].numpy())
    assert host_flat["m/W"].tobytes() != owner.current_flat()[1]["m/W"].tobytes()
    owner.retire()
    with pytest.raises(RuntimeError, match="retired"):
        owner.checkpoint_parts(lambda *a: a)


def test_checkpoint_cuts_stay_whole_under_concurrent_applies():
    """16 threads push to one owner (quorum 1: every push is an apply that
    adds its gradient of ones to the slice, its moment and the count) while
    another takes checkpoint cuts, with the interpreter switching threads
    every microsecond: in every cut the version, the count, the moment and
    the slice agree, and no push is lost."""
    import sys
    import threading

    def apply(params, opt, grads):
        opt["mu"]["x"] = opt["mu"]["x"] + grads["x"]
        opt["count"] += 1
        return {"x": params["x"] + grads["x"]}, opt

    owner = ppeer.OwnerState(
        worker_id=0, n_workers=16, quorum=1, max_staleness=10 ** 6, apply_fn=apply,
        slice_params={"x": np.zeros(64, np.float32)},
        opt_state={"count": 0, "sched_count": 0, "mu": {"x": np.zeros(64, np.float32)},
                   "nu": {}}, counters=ppeer.FleetCounters())
    cuts, done = [], threading.Event()

    def push(w):
        for _ in range(50):
            assert owner.submit(w, owner.version, {"x": np.ones(64, np.float32)})[0]

    def cut():
        while not done.is_set():
            cuts.append(owner.checkpoint_parts(lambda v, o, host: (v, o, host)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        taker = threading.Thread(target=cut)
        taker.start()
        pushers = [threading.Thread(target=push, args=(w,)) for w in range(16)]
        for t in pushers:
            t.start()
        for t in pushers:
            t.join(timeout=60)
        done.set()
        taker.join(timeout=60)
        assert not any(t.is_alive() for t in (*pushers, taker))
    finally:
        sys.setswitchinterval(interval)
    assert owner.version == 16 * 50 and len(cuts) > 1
    for version, opt, host in cuts:
        assert int(opt["count"]) == version
        assert np.all(opt["mu/x"] == version) and np.all(host["x"] == version)


# ---------------------------------------------------------------- the supervisor
#
# Each script runs through JAX's and the port's ``Supervisor`` (and CLI, and
# ``ShutdownCoordinator``) on the same fakes; what each did must be equal.


class FakeProc:
    """A child that exits ``rc`` when waited on, or, with ``rc`` None, runs
    until it is signalled (ignoring SIGTERM when ``ignores_term``)."""

    pid = 4242

    def __init__(self, rc=None, on_wait=None, ignores_term=False):
        self.returncode, self.on_wait, self.ignores_term = rc, on_wait, ignores_term
        self.signals = []
        self._ended = threading.Event()
        if rc is not None:
            self._ended.set()

    def _end(self, rc):
        if self.returncode is None:
            self.returncode = rc
        self._ended.set()

    def poll(self):
        return self.returncode

    def terminate(self):
        self.signals.append("SIGTERM")
        if not self.ignores_term:
            self._end(-signal.SIGTERM)

    def kill(self):
        self.signals.append("SIGKILL")
        self._end(-signal.SIGKILL)

    def wait(self, timeout=None):
        if timeout is None:  # the supervisor's own wait
            if self.on_wait is not None:
                self.on_wait()
            assert self._ended.wait(30), "the fake child was never stopped"
        elif not self._ended.wait(timeout):
            raise subprocess.TimeoutExpired("child", timeout)
        return self.returncode


#: name -> (the children's codes, None for one that runs until signalled;
#: max_restarts; what happens: "" nothing, "first" a shutdown before the
#: first launch, "popen" one that lands while the child starts, "wait" one
#: relayed while it runs, "ignored" the same to a child ignoring SIGTERM)
SUPERVISOR_SCRIPTS = {
    "success_after_restarts": ([1, 137, 0], 5, ""),
    "gives_up_past_its_cap": ([7, 7, 7], 1, ""),
    "no_restarts": ([3], 0, ""),
    "killed_child_restarts": ([-signal.SIGKILL, 0], 1, ""),
    "shutdown_first": ([1], 3, "first"),
    "shutdown_during_popen": ([None], 3, "popen"),
    "relayed_kill": ([None], 3, "wait"),
    "relayed_kill_ignored": ([None], 3, "ignored"),
}


def _run_supervisor(res, script):
    """``res``'s ``Supervisor`` through ``script``: its code, restarts,
    launches, sleeps, each child's signals and the events it logged."""
    rcs, max_restarts, shutdown = SUPERVISOR_SCRIPTS[script]
    launched, procs, sleeps = [], [], []
    res.drain_events()

    def popen(cmd):
        launched.append(list(cmd))
        on_wait = sup.request_shutdown if shutdown in ("wait", "ignored") else None
        proc = FakeProc(rcs[len(launched) - 1], on_wait=on_wait,
                        ignores_term=shutdown == "ignored")
        procs.append(proc)
        if shutdown == "popen":
            sup.request_shutdown()  # the relay sees no child yet
        return proc

    sup = res.Supervisor(lambda attempt: ["child", str(attempt)], max_restarts, grace_s=0.05,
                         popen=popen, restart_delay_s=0.25, sleep=sleeps.append)
    if shutdown == "first":
        sup.request_shutdown()
    rc = sup.run()
    for t in threading.enumerate():
        if t.name == "supervisor-escalate":
            t.join(30)
    return {"rc": rc, "restarts_used": sup.restarts_used, "launched": launched,
            "sleeps": sleeps, "signals": [p.signals for p in procs],
            "events": res.drain_events()}


@pytest.mark.parametrize("script", ["success_after_restarts", "gives_up_past_its_cap",
                                    "no_restarts", "killed_child_restarts"])
def test_supervisor_restarts_until_success_and_gives_up_past_its_cap(script):
    port, ref = _run_supervisor(pres, script), _run_supervisor(jres, script)
    assert port == ref
    rcs, cap, _ = SUPERVISOR_SCRIPTS[script]
    # the script ran as written: a restart for each failure within the cap
    assert port["restarts_used"] == min(len(rcs) - 1, cap)
    assert port["launched"] == [["child", str(a)] for a in range(port["restarts_used"] + 1)]


@pytest.mark.parametrize("script", ["shutdown_first", "shutdown_during_popen", "relayed_kill",
                                    "relayed_kill_ignored"])
def test_supervisor_shutdown_first_launches_nothing_and_a_relayed_kill_is_75(script):
    port, ref = _run_supervisor(pres, script), _run_supervisor(jres, script)
    assert port == ref
    assert port["rc"] == pres.RC_PREEMPTED == jres.RC_PREEMPTED and port["restarts_used"] == 0
    assert port["launched"] == ([] if script == "shutdown_first" else [["child", "0"]])


#: argv lists for the two CLIs, each with its strip of ``--max-restarts``
CLI_ARGVS = {
    "one_process": ["{cfg}", "--max-restarts", "3", "--output", "out", "--device", "cpu"],
    "one_process_equals_resume": ["{cfg}", "--max-restarts=2", "--resume", "--device", "cpu"],
    "fleet": ["{cfg}", "--fleet-workers", "2", "--max-restarts=2", "--device", "cpu"],
    "fleet_spaced": ["{cfg}", "--device", "cpu", "--max-restarts", "1", "--fleet-workers", "3",
                     "--output", "out"],
}


def _cli_supervisors(cli, res, coord, argv, monkeypatch):
    """What ``cli.train_command(argv)`` handed its supervisors: each one's
    cap and its children's argv after ``train`` for launches 0-2."""
    made = []

    class FakeSupervisor:
        def __init__(self, build_cmd, max_restarts, **kw):
            made.append((build_cmd, max_restarts))

        def run(self):
            return 0

        def request_shutdown(self):
            pass

    monkeypatch.setattr(res, "Supervisor", FakeSupervisor)
    monkeypatch.setattr(coord, "Supervisor", FakeSupervisor)
    assert cli.train_command(argv) == 0
    out = []
    for build, cap in made:
        cmds = [build(a) for a in range(3)]
        out.append((cap, [c[c.index("train") + 1:] for c in cmds]))
    return out


@pytest.mark.parametrize("case", sorted(CLI_ARGVS))
def test_cli_strips_max_restarts_and_relaunches_with_resume(case, monkeypatch, tmp_path):
    from spacy_ray_tpu import cli as jcli
    from spacy_ray_tpu.training.fleet import coordinator as jcoord
    from spacy_ray_tpu_torch import __main__ as pmain

    argv = [a.format(cfg=tmp_path / "c.cfg") for a in CLI_ARGVS[case]]
    port = _cli_supervisors(pmain, pres, pcoord, argv, monkeypatch)
    ref = _cli_supervisors(jcli, jres, jcoord, argv, monkeypatch)
    assert port == ref and port
    for cap, (first, relaunch, again) in port:
        assert cap == int(re.search(r"--max-restarts[= ](\d+)", " ".join(argv)).group(1))
        assert not any(a.startswith("--max-restarts") for a in first)
        assert relaunch == again == first + ([] if "--resume" in first else ["--resume"])
    for flags in (["--max-restarts"], ["--max-restarts", "--cpu-cores"]):
        assert pmain._strip_flags(argv, flags) == jcli._strip_flags(argv, flags)


def test_cli_refuses_a_negative_max_restarts(tmp_path):
    from spacy_ray_tpu_torch.__main__ import train_command

    with pytest.raises(SystemExit) as e:
        train_command([str(tmp_path / "c.cfg"), "--max-restarts", "-1"])
    assert e.value.code == 2


def _shutdown_trace(res):
    """``res``'s ``ShutdownCoordinator`` through SIGTERM, ``request`` and
    two SIGINTs, with and without a previous handler; what it did, step by
    step."""
    trace = []
    prev_seen = []
    old_int = signal.signal(signal.SIGINT, lambda s, f: prev_seen.append(s))
    try:
        sc = res.ShutdownCoordinator().install()
        trace.append(("installed", sc.requested, signal.getsignal(signal.SIGTERM) == sc._handle))
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):  # delivered at a bytecode boundary
            if sc.requested:
                break
        trace.append(("sigterm", sc.requested))
        sc._handle(signal.SIGINT, None)  # second signal: the previous handler
        trace.append(("second sigint", sc.requested, list(prev_seen)))
        sc.restore()
        sc.restore()  # a second restore changes nothing
        trace.append(("restored", signal.getsignal(signal.SIGTERM) == sc._handle))
    finally:
        signal.signal(signal.SIGINT, old_int)
    sc = res.ShutdownCoordinator()
    trace.append(("fresh", sc.requested))
    sc.request()
    trace.append(("request", sc.requested))
    sc = res.ShutdownCoordinator()
    sc._handle(signal.SIGINT, None)
    trace.append(("first sigint", sc.requested))
    try:
        sc._handle(signal.SIGINT, None)
        trace.append(("second sigint, no previous handler", "returned"))
    except KeyboardInterrupt:
        trace.append(("second sigint, no previous handler", "KeyboardInterrupt"))
    return trace


def test_shutdown_coordinator_flag_and_second_sigint_match_jax():
    port, ref = _shutdown_trace(pres), _shutdown_trace(jres)
    assert port == ref
    assert port == [("installed", False, True), ("sigterm", True),
                    ("second sigint", True, [signal.SIGINT]), ("restored", False),
                    ("fresh", False), ("request", True), ("first sigint", True),
                    ("second sigint, no previous handler", "KeyboardInterrupt")]
