"""The port's elastic serving fleet (deeprec_tpu_torch/serving/fleet.py,
online/supervisor.py and the frontend's dynamic membership), case for case
with tests/test_fleet.py: lease-file discovery edge cases, consistent-hash
remap bounds, the drain protocol, dead-member re-probe, the autoscaler's
hysteresis and cooldown, the Supervisor's runtime specs — and against the
JAX package: the same ring (every key to the same member), leases written
by either package read by the other's registry, the same autoscaler
decisions. Backends serve a JAX-trained checkpoint on the CPU."""
import json
import os
import threading
import time

import numpy as np
import pytest

import torch

from deeprec_tpu.online import faults
from deeprec_tpu.serving import fleet as jax_fleet
from deeprec_tpu_torch.online import ProcessSpec, Supervisor
from deeprec_tpu_torch.serving import fleet
from deeprec_tpu_torch.serving.fleet import (
    FleetAutoscaler,
    FleetLoad,
    FleetRegistry,
    HashRing,
    LeaseStamper,
)

torch.set_num_threads(1)

# --------------------------------------------------------------- registry


def test_registry_stamp_sweep_unregister(tmp_path):
    r = FleetRegistry(str(tmp_path), lease_secs=5.0)
    st = LeaseStamper(r, "127.0.0.1:7001", capacity=4,
                      version_fn=lambda: 3, name="b0")
    st.stamp()
    (m,) = r.members()
    assert (m.addr, m.status, m.capacity, m.model_version, m.name) == (
        "127.0.0.1:7001", "up", 4, 3, "b0")
    assert m.age < 5.0 and m.pid == os.getpid()
    st.stop()  # unregisters
    assert r.members() == []
    # leases cross packages both ways
    jr = jax_fleet.FleetRegistry(str(tmp_path), lease_secs=5.0)
    jst = jax_fleet.LeaseStamper(jr, "127.0.0.1:7009", capacity=2,
                                 version_fn=lambda: 5, name="j0")
    jst.stamp()
    (m,) = r.members()
    assert (m.addr, m.capacity, m.model_version, m.name) == ("127.0.0.1:7009", 2, 5, "j0")
    jst.stop()
    LeaseStamper(r, "127.0.0.1:7008", name="p0").stamp()
    (m,) = jr.members()
    assert (m.addr, m.name) == ("127.0.0.1:7008", "p0")


def test_registry_stale_lease_eviction_and_readmission_race(tmp_path):
    """The eviction race with a live-but-slow member: a stale lease
    drops the member from routing, but the FILE survives (eviction is a
    routing decision, not a tombstone) — the moment the slow member
    stamps again it is readmitted. gc() only reaps on a much longer
    clock, so the re-stamp never races an unlink."""
    r = FleetRegistry(str(tmp_path), lease_secs=5.0)
    st = LeaseStamper(r, "127.0.0.1:7002")
    st.stamp()
    now = time.time()
    assert len(r.members(now=now)) == 1
    late = now + 6.0
    assert r.members(now=late) == []          # stale -> evicted
    assert os.path.exists(st.registry.lease_path("127.0.0.1:7002"))
    # not even a 10x-stale sweep unlinked it yet
    assert r.gc(evict_secs=50.0) == 0
    st.stamp()                                 # the slow member catches up
    assert len(r.members()) == 1               # readmitted, same lease file
    # long-dead: gc reaps
    assert r.gc(evict_secs=-1.0) == 1
    assert r.members() == []


def test_registry_torn_lease_write_is_skipped_not_trusted(tmp_path):
    """A torn lease (non-atomic writer / FS corruption — planted by the
    fault injector, since the registry's own writes are atomic
    tmp+rename) reads as 'no lease': the sweep skips it without
    crashing, and a later GOOD stamp over the same path recovers."""
    r = FleetRegistry(str(tmp_path), lease_secs=5.0)
    good = LeaseStamper(r, "127.0.0.1:7003")
    good.stamp()
    path = faults.torn_lease_write(r, "127.0.0.1:7004")
    assert os.path.exists(path)
    ms = r.members()
    assert [m.addr for m in ms] == ["127.0.0.1:7003"]  # torn one invisible
    # schema garbage (valid JSON, wrong shape) is equally skipped
    with open(r.lease_path("127.0.0.1:7005"), "w") as f:
        json.dump({"time": "not-a-number", "addr": 9}, f)
    assert [m.addr for m in r.members()] == ["127.0.0.1:7003"]
    # the torn path recovers when its owner stamps properly
    LeaseStamper(r, "127.0.0.1:7004").stamp()
    assert [m.addr for m in r.members()] == ["127.0.0.1:7003",
                                             "127.0.0.1:7004"]


def test_registry_duplicate_addr_last_writer_wins_quarantine(tmp_path):
    """Two backend processes claiming ONE addr (a respawn racing the old
    generation, a copy-paste config): the newest stamp wins the addr,
    the older lease is quarantined (renamed, visible) — and membership
    never shows the addr twice."""
    r = FleetRegistry(str(tmp_path), lease_secs=30.0)
    old_path = r.lease_path("127.0.0.1:7010", pid=1111)
    new_path = r.lease_path("127.0.0.1:7010", pid=2222)
    t = time.time()
    for path, pid, stamp in ((old_path, 1111, t - 5), (new_path, 2222, t)):
        with open(path + ".tmp", "w") as f:
            json.dump({"pid": pid, "time": stamp, "step": None,
                       "status": "up", "addr": "127.0.0.1:7010",
                       "role": "backend", "capacity": 1,
                       "model_version": 0, "started_at": stamp,
                       "name": ""}, f)
        os.replace(path + ".tmp", path)
    ms = r.members()
    assert len(ms) == 1 and ms[0].pid == 2222    # last writer wins
    assert not os.path.exists(old_path)          # older claim quarantined
    assert os.path.exists(old_path + ".quarantined")
    assert os.path.exists(new_path)


def test_registry_drain_request_roundtrip(tmp_path):
    r = FleetRegistry(str(tmp_path))
    assert r.drain_requested("127.0.0.1:7020") is None
    r.request_drain("127.0.0.1:7020", respawn=True)
    req = r.drain_requested("127.0.0.1:7020")
    assert req and req["respawn"] is True
    r.clear_drain("127.0.0.1:7020")
    assert r.drain_requested("127.0.0.1:7020") is None


def test_lease_stamper_picks_up_drain_and_exit_codes(tmp_path):
    """The member side of the drain protocol: the stamper's loop sees
    the drain-request file, stamps ``draining`` (frontends stop new
    assignments off that), and the exit code follows the respawn flag —
    EXIT_RESCALE for rolling restarts, 0 for retirement."""
    from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE

    r = FleetRegistry(str(tmp_path), lease_secs=5.0)
    st = LeaseStamper(r, "127.0.0.1:7030", interval=0.05).start()
    try:
        assert r.members()[0].status == "up"
        r.request_drain("127.0.0.1:7030", respawn=True)
        assert st.draining.wait(timeout=5.0)
        (m,) = r.members()                      # still a member...
        assert m.status == "draining"           # ...but marked leaving
        assert r.members(include_draining=False) == []
        assert st.exit_code() == EXIT_RESCALE
    finally:
        st.stop()
    st2 = LeaseStamper(r, "127.0.0.1:7031")
    st2.begin_drain(respawn=False)
    assert st2.exit_code() == 0


# -------------------------------------------------------------- hash ring


def test_ring_remap_fraction_on_join_at_most_2_over_n():
    """The consistency pin: adding one member to an
    N-member ring remaps at most 2/N of sticky users (expected ~1/(N+1);
    modular routing would remap ~N/(N+1)). Pinned across fleet sizes on
    10k keys."""
    keys = list(range(10_000))
    for n in (2, 3, 4, 8):
        members = [f"10.0.0.{i}:8500" for i in range(n)]
        before = HashRing(members)
        after = HashRing(members + [f"10.0.0.{n}:8500"])
        moved = sum(1 for k in keys if before.lookup(k) != after.lookup(k))
        frac = moved / len(keys)
        assert frac <= 2.0 / n, (n, frac)
        # and the ring actually hands the new member SOME keys
        assert frac > 0.0, n


def test_ring_leave_falls_to_preference_successor():
    """When a member leaves, each of its keys lands exactly on that
    key's next preference — so sibling-retry failover and post-churn
    routing agree (a retried request warms the SAME backend the users
    are about to move to)."""
    members = [f"10.0.0.{i}:8500" for i in range(4)]
    ring = HashRing(members)
    gone = members[1]
    shrunk = HashRing([m for m in members if m != gone])
    for k in range(3000):
        pref = ring.preference(k)
        if pref[0] == gone:
            assert shrunk.lookup(k) == pref[1], k
        else:
            assert shrunk.lookup(k) == pref[0], k


def test_ring_spread_and_determinism():
    members = [f"10.0.0.{i}:8500" for i in range(4)]
    ring = HashRing(members)
    counts = {m: 0 for m in members}
    for k in range(8000):
        counts[ring.lookup(k)] += 1
    # virtual nodes keep the split sane (no member starved or doubled)
    for m, c in counts.items():
        assert 0.5 * 2000 < c < 2.0 * 2000, counts
    # identical across instances (unsalted hash — every frontend replica
    # and every restart builds the same ring)
    again = HashRing(list(reversed(members)))
    assert all(ring.lookup(k) == again.lookup(k) for k in range(500))
    with pytest.raises(RuntimeError, match="empty hash ring"):
        HashRing([]).lookup(1)
    # the JAX package's ring routes every key to the same member, in the
    # same preference order
    jring = jax_fleet.HashRing(members)
    assert all(ring.lookup(k) == jring.lookup(k) for k in range(2000))
    assert all(ring.preference(k) == jring.preference(k) for k in range(200))


# ------------------------------------------------------------- autoscaler


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scaler(n0=2, **kw):
    state = {"n": n0, "ups": 0, "downs": 0}

    def up():
        state["n"] += 1
        state["ups"] += 1

    def down(_n):
        state["n"] -= 1
        state["downs"] += 1

    clock = _Clock()
    kw.setdefault("min_members", 1)
    kw.setdefault("max_members", 4)
    kw.setdefault("p99_high_ms", 100.0)
    kw.setdefault("p99_low_ms", 20.0)
    kw.setdefault("queue_high", 64)
    kw.setdefault("queue_low", 4)
    kw.setdefault("sustain", 3)
    kw.setdefault("cooldown_secs", 30.0)
    a = FleetAutoscaler(members_fn=lambda: state["n"], scale_up=up,
                        scale_down=down, clock=clock, **kw)
    return a, state, clock


def _hot(p99=500.0, q=0):
    return FleetLoad(p99_ms=p99, queue_depth=q, members=0)


def _cold():
    return FleetLoad(p99_ms=1.0, queue_depth=0, members=0)


def test_autoscaler_hysteresis_requires_sustained_breach():
    a, state, clock = _scaler()
    assert a.observe(_hot()) is None      # 1st breach: no action
    assert a.observe(_cold()) is None     # breach streak broken
    assert a.observe(_hot()) is None
    assert a.observe(_hot()) is None
    assert a.observe(_hot()) == "up"      # 3rd consecutive: scale up
    assert state["n"] == 3


def test_autoscaler_cooldown_blocks_flapping():
    a, state, clock = _scaler()
    for _ in range(3):
        a.observe(_hot())
    assert state["n"] == 3
    for _ in range(10):                    # still hot, but cooling down
        assert a.observe(_hot()) is None
    clock.t += 31.0                        # cooldown expired: the breach
    # streak accumulated through the cooldown, so the FIRST eligible
    # tick acts (sustained hot shouldn't restart its hysteresis count)
    assert a.observe(_hot()) == "up" and state["n"] == 4


def test_autoscaler_bounds_and_scale_down():
    a, state, clock = _scaler(n0=4)
    for _ in range(6):                     # hot at max: never exceeds
        a.observe(_hot())
        clock.t += 100.0
    assert state["n"] == 4 and state["ups"] == 0
    for _ in range(3):
        a.observe(_cold())
    assert state["n"] == 3                 # calm sustained: retire one
    clock.t += 100.0
    for _ in range(10):
        a.observe(_cold())
        clock.t += 100.0
    assert state["n"] == 1 and state["downs"] == 3  # floor holds


def test_autoscaler_queue_depth_alone_breaches():
    a, state, clock = _scaler()
    for _ in range(3):
        a.observe(_hot(p99=1.0, q=1000))   # p99 fine, queue exploding
    assert state["n"] == 3


def test_autoscaler_no_signal_never_acts():
    a, state, clock = _scaler()
    for _ in range(10):
        assert a.observe(None) is None
        assert a.observe(FleetLoad(p99_ms=None, queue_depth=0,
                                   members=2)) is None
    assert state["n"] == 2


def test_autoscaler_manual_target_walks_2_4_2():
    """The bench's deterministic scale event: set_target overrides load,
    one member per tick, cooldown-paced, and hands control back to the
    load policy at the target."""
    a, state, clock = _scaler(cooldown_secs=5.0)
    a.set_target(4)
    assert a.observe(None) == "up" and state["n"] == 3
    assert a.observe(None) is None         # cooling
    clock.t += 6.0
    assert a.observe(None) == "up" and state["n"] == 4
    clock.t += 6.0
    assert a.observe(None) is None and a.at_target()
    a.set_target(2)
    assert a.observe(_hot()) == "down"     # manual target beats load
    clock.t += 6.0
    assert a.observe(_hot()) == "down" and state["n"] == 2
    assert a.actions[-1]["why"] == "target 2"


def test_autoscaler_decides_as_jax():
    """The JAX autoscaler decides alike on the same observations."""
    seq = [_hot(), _hot(), _cold(), _hot(), _hot(), _hot(), None, _cold(),
           _cold(), _cold(), _hot(p99=1.0, q=1000)] * 3
    a, _, clock = _scaler()
    ja, jclock = _jax_scaler()
    for i, obs in enumerate(seq):
        clock.t = jclock.t = 7.0 * i
        jobs = None if obs is None else jax_fleet.FleetLoad(obs.p99_ms, obs.queue_depth, obs.members)
        assert a.observe(obs) == ja.observe(jobs), i


def _jax_scaler(n0=2):
    state = {"n": n0}
    clock = _Clock()

    def up():
        state["n"] += 1

    def down(_n):
        state["n"] -= 1

    a = jax_fleet.FleetAutoscaler(
        members_fn=lambda: state["n"], scale_up=up, scale_down=down, clock=clock,
        min_members=1, max_members=4, p99_high_ms=100.0, p99_low_ms=20.0,
        queue_high=64, queue_low=4, sustain=3, cooldown_secs=30.0)
    return a, clock


def test_load_from_stats_decodes_fleet_load():
    assert fleet.load_from_stats({}) is None
    got = fleet.load_from_stats({"fleet_load": {
        "e2e_p99_ms": 12.5, "queue_depth": 3, "members": 2}})
    assert got == FleetLoad(p99_ms=12.5, queue_depth=3, members=2)


# ------------------------------------------------- supervisor dynamic specs


def test_supervisor_add_remove_specs_runtime(tmp_path):
    """The autoscaler's supervisor surface: add_spec spawns a NEW worker
    while the watch loop runs (keep_alive: the loop survives every
    current worker finishing), remove_spec releases one; clean exits
    mark done without respawn."""
    import sys

    sup = Supervisor([], poll_secs=0.05, keep_alive=True,
                     on_event=lambda line: None).start()
    try:
        sleeper = [sys.executable, "-c",
                   "import time; time.sleep(60)"]
        quick = [sys.executable, "-c", "pass"]
        sup.add_spec(ProcessSpec(name="w1", argv=sleeper, lease_secs=None))
        sup.add_spec(ProcessSpec(name="w2", argv=quick, lease_secs=None))
        assert sup.pid("w1") is not None
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not sup.state("w2").done:
            time.sleep(0.05)
        assert sup.state("w2").done           # clean exit: done, no respawn
        assert sup.stats()["w2"]["restarts"] == 0
        assert sup.remove_spec("w2", kill=False)
        assert sup.state("w2") is None
        assert sup.remove_spec("w1", kill=True)   # reaps the sleeper
        assert not sup.remove_spec("nope")
        sup.add_spec(ProcessSpec(name="w3", argv=quick))
        with pytest.raises(ValueError, match="duplicate"):
            sup.add_spec(ProcessSpec(name="w3", argv=quick))
    finally:
        sup.stop()


# ----------------------------------------------- frontend fleet integration

jnp = pytest.importorskip("jax.numpy")


def _make_tier_ckpt(tmp_path):
    import optax

    from deeprec_tpu.data import SyntheticCriteo
    from deeprec_tpu.models import WDL as JaxWDL
    from deeprec_tpu.optim import Adagrad
    from deeprec_tpu.training import Trainer
    from deeprec_tpu.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.models import WDL

    kw = dict(emb_dim=8, capacity=1 << 12, hidden=(32, 16), num_cat=4, num_dense=2)
    model = WDL(**kw)
    tr = Trainer(JaxWDL(**kw), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=4, num_dense=2,
                          vocab=2000, seed=13)
    for _ in range(3):
        st, _ = tr.train_step(
            st, {k: jnp.asarray(v) for k, v in gen.batch().items()})
    CheckpointManager(str(tmp_path), tr).save(st)
    req = {k: np.asarray(v) for k, v in gen.batch().items()
           if not k.startswith("label")}
    return model, req


def Predictor(model, ckpt):
    """The port's Predictor on the CPU."""
    from deeprec_tpu_torch.serving import Predictor as P

    return P(model, ckpt, device="cpu")


def _backend(model, ckpt, registry, **kw):
    from deeprec_tpu_torch.serving import BackendServer, ModelServer

    return BackendServer(
        ModelServer(Predictor(model, ckpt), max_batch=64, max_wait_ms=1.0),
        registry=registry, **kw).start()


@pytest.fixture(scope="module")
def fleet_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet-wdl")
    model, req = _make_tier_ckpt(tmp)
    return model, str(tmp), req


def test_frontend_discovers_admits_and_retires_by_lease(fleet_ckpt,
                                                        tmp_path):
    """Dynamic membership end to end, no frontend restart anywhere: a
    frontend born with an EMPTY registry admits a backend when its lease
    lands, admits a second joiner at runtime, spreads traffic over both,
    and retires a member whose lease unregisters — all through direct
    sweep calls (deterministic), traffic green throughout."""
    from deeprec_tpu_torch.serving import Frontend

    model, ckpt, req = fleet_ckpt
    reg = FleetRegistry(str(tmp_path), lease_secs=30.0)
    fe = Frontend(None, model, registry=reg, membership_secs=0.0,
                  reprobe_secs=0.0)
    try:
        with pytest.raises(RuntimeError, match="no fleet members"):
            fe.request(req)
        b0 = _backend(model, ckpt, reg, member_name="b0")
        try:
            # lazy admission: the next request forces one sweep
            out = fe.request(req)
            assert np.asarray(out).size > 0
            assert [m.addr for m in fe._members] == [b0.addr]
            b1 = _backend(model, ckpt, reg, member_name="b1")
            try:
                fe.refresh_membership()
                assert len(fe._members) == 2
                for _ in range(8):
                    fe.request(req)
                counts = [m.snapshot()["requests"] for m in fe._members]
                assert all(c > 0 for c in counts), counts
            finally:
                b1.stop()            # unregisters its lease
            admitted, retired = fe.refresh_membership()
            assert retired == [b1.addr]
            assert [m.addr for m in fe._members] == [b0.addr]
            fe.request(req)          # tier keeps serving
        finally:
            b0.stop()
    finally:
        fe.close()


def test_frontend_drain_excludes_new_assignments_zero_failures(fleet_ckpt,
                                                               tmp_path):
    """The drain protocol under live traffic: request_drain -> the
    member stamps ``draining`` -> the frontend's next sweep stops NEW
    assignments (ring excludes it; plain round-robin skips it) while
    in-flight work finishes -> backend.drain() returns the retirement
    exit code -> retirement. Zero failed requests throughout."""
    from deeprec_tpu_torch.serving import Frontend

    model, ckpt, req = fleet_ckpt
    # short leases -> fast stamper loops (lease_secs/3), so the drain
    # request lands within the test without sleeping multiples of 10 s
    reg = FleetRegistry(str(tmp_path), lease_secs=1.5)
    b0 = _backend(model, ckpt, reg, member_name="b0")
    b1 = _backend(model, ckpt, reg, member_name="b1")
    fe = Frontend(None, model, registry=reg, membership_secs=0.05,
                  reprobe_secs=0.0)
    errors, done = [], threading.Event()

    def driver():
        try:
            while not done.is_set():
                fe.request(req)
        except Exception as e:  # pragma: no cover - the assertion
            errors.append(e)

    th = threading.Thread(target=driver)
    try:
        fe.refresh_membership()
        assert len(fe._members) == 2
        assert fe.warmup(req) == 2        # compile both before load
        th.start()
        time.sleep(0.2)
        reg.request_drain(b1.addr, respawn=False)
        assert b1.stamper.draining.wait(timeout=5.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            m = fe._by_addr.get(b1.addr)
            if m is not None and m.draining:
                break
            time.sleep(0.02)
        m = fe._by_addr[b1.addr]
        assert m.draining                 # sweep saw the draining lease
        assert b1.addr not in fe._ring.members  # no NEW grouped routing
        # Requests ASSIGNED before the sweep flipped the flag may still
        # land (that's the protocol: in-flight finishes) — wait for the
        # counter to go quiet, THEN pin that no NEW assignments arrive.
        before = m.snapshot()["requests"]
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            time.sleep(0.2)
            cur = m.snapshot()["requests"]
            if cur == before:
                break
            before = cur
        time.sleep(0.4)                   # traffic continues on b0 only
        assert m.snapshot()["requests"] == before
        rc = b1.drain(timeout=10.0)       # in-flight quiet -> stop
        assert rc == 0                    # retirement, not respawn
        time.sleep(0.2)                   # frontend retires the lease
        assert b1.addr not in fe._by_addr
        done.set()
        th.join(timeout=30)
        assert not errors, errors         # zero failed requests
        assert fe._members and fe._members[0].addr == b0.addr
    finally:
        done.set()
        if th.is_alive():
            th.join(timeout=10)
        fe.close()
        b0.stop()
        b1.stop()


def test_frontend_reprobes_and_readmits_same_addr(fleet_ckpt):
    """A member that died and came back at the SAME addr
    (external restart — no membership churn, static list) is readmitted
    by the periodic re-probe WITHOUT any client traffic, health call, or
    frontend restart risking a request on it."""
    from deeprec_tpu_torch.serving import BackendServer, Frontend, ModelServer

    model, ckpt, req = fleet_ckpt
    b = BackendServer(ModelServer(Predictor(model, ckpt), max_batch=64,
                                  max_wait_ms=1.0)).start()
    port = b.port
    fe = Frontend([("127.0.0.1", port)], model, reprobe_secs=0.1)
    try:
        fe.request(req)
        b.stop()                          # death: sockets sever
        with pytest.raises(RuntimeError):
            fe.request(req)               # all members down
        m = fe._members[0]
        assert m.fails > 0
        b2 = BackendServer(ModelServer(Predictor(model, ckpt),
                                       max_batch=64, max_wait_ms=1.0),
                           port=port).start()
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and m.fails:
                time.sleep(0.05)          # NO traffic: re-probe only
            assert m.fails == 0 and m.available(time.monotonic())
            fe.request(req)               # traffic resumes
        finally:
            b2.stop()
    finally:
        fe.close()


def test_frontend_stats_carry_fleet_load_window(fleet_ckpt):
    """/v1/stats now carries the autoscaler's observation: a windowed
    e2e p99 and member queue depth under fleet_load, decodable by
    fleet.load_from_stats."""
    from deeprec_tpu_torch.serving import BackendServer, Frontend, ModelServer

    model, ckpt, req = fleet_ckpt
    b = BackendServer(ModelServer(Predictor(model, ckpt), max_batch=64,
                                  max_wait_ms=1.0)).start()
    fe = Frontend([("127.0.0.1", b.port)], model, reprobe_secs=0.0)
    try:
        for _ in range(5):
            fe.request(req)
        snap = fe.stats_snapshot()
        fl = snap["fleet_load"]
        assert fl["members"] == 1 and fl["draining"] == 0
        assert fl["queue_depth"] >= 0
        load = fleet.load_from_stats(snap)
        if fe.stats.registry is not None:   # obs plane on (default)
            assert load.p99_ms is not None and load.p99_ms > 0
        member = snap["members"][0]
        assert "window" in member["stats"]
        assert member["stats"]["window"]["window_seconds"] == 60
    finally:
        fe.close()
        b.stop()
