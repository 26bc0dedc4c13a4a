"""The port's skew-aware placement (`deeprec_tpu_torch/parallel/placement.py`,
`costmodel.py`, the plan path of `parallel/trainer.py`) held against the JAX
package on the CPU.

The host half (`build_plans` untrained and trained, `PlacementCostModel`,
`DriftDetector`, `plan_moved_rows`, `modeled_loads` and the amortization
models of `ops/traffic.py`) is numpy in both packages: the same inputs give
equal results exactly. The device route `plan_owner` equals the host
mirror `owner_np` per id.

The trainer runs as 4 gloo ranks (`tests/torch_sharded_rank.py`, one
process set for the whole file) on a small WDL (emb 8, 2^12 slots, 4
categorical and 2 dense features) over a drifting zipf stream that shares
one raw id space across its columns, the JAX `tests/test_placement_v2.py`
workload. A forced `update_placement` after 3 steps from the carried JAX
state reaches JAX's plan, report and moved counts exactly; the migrated
rows are the port's own pre-migration rows bit for bit, and within
tests/test_torch_sharded.py's tolerances of JAX's (the f32 wire). The
drift runs are held against the port's own uniform trainer, bit for bit,
not against the JAX drift test (which is flaky under load).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.ops import traffic as JT
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.parallel import ShardedTrainer as JaxSharded
from deeprec_tpu.parallel import make_mesh as jax_mesh
from deeprec_tpu.parallel import placement as JP
from deeprec_tpu.parallel.costmodel import PlacementCostModel as JaxCM
from deeprec_tpu_torch.ops import traffic as PT
from deeprec_tpu_torch.parallel import placement as PP
from deeprec_tpu_torch.parallel.costmodel import PlacementCostModel as PortCM
from test_torch_sharded import RTOL, ATOL, export_jax_state, port_rows, shared
from torch_sharded_rank import spawn

KW = dict(emb_dim=8, capacity=1 << 12, hidden=(16,), num_cat=4, num_dense=2)
LR, DENSE_LR, B, W = 0.1, 1e-2, 256, 4
SPEC = dict(model=KW, model_name="wdl", lr=LR, dense_lr=DENSE_LR)
DRIFT = dict(threshold=1.25, sustain=1, cooldown=0, horizon_steps=100_000)


def drifting_batches(n, rotate_every=4, seed=7):
    gen = SyntheticCriteo(batch_size=B, num_cat=4, num_dense=2, vocab=3000, seed=seed,
                          zipf_a=[1.6, 1.9, 2.2, 2.5], offset_ids=False,
                          zipf_rotate_every=rotate_every)
    return [gen.batch() for _ in range(n)]


# ---------------------------------------------------------- host functions


def _members(mod, seed, n_members=3, ties=False):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_members):
        keys = rng.choice(1 << 20, 300, replace=False).astype(np.int32)
        w = (np.ones(300) if ties else
             np.minimum(rng.zipf(1.6, 300).astype(np.float64) / 2.0, float(W)))
        out.append(mod.MemberTraffic(bundle=f"b{t % 2}", member=t, keys=keys, weight=w,
                                     row_bytes=64.0 * (t + 1), sentinel=-(1 << 31)))
    return out


def _plan_fields(plans):
    return {ref: (p.num_shards, p.sentinel, p.offset, tuple(p.hot_keys), tuple(p.hot_owners))
            for ref, p in plans.items()}


def _record(models, seed):
    rng = np.random.default_rng(seed)
    stats = {"row_bytes": 64.0, "mass": 10.0, "unique_fraction": 0.5, "hot_mass": 0.1}
    for _ in range(8):
        modeled = rng.random(W) * 1000
        measured = modeled.copy()
        measured[1] = modeled[1] * 3.0 + 500
        for m in models:
            m.record_window(stats, modeled, measured)
    return stats


@pytest.mark.parametrize("case", ["untrained", "trained", "ties_trained", "base_loads"])
def test_build_plans_equal_jax(case):
    ties = case == "ties_trained"
    jm, pm = _members(JP, 3, ties=ties), _members(PP, 3, ties=ties)
    kw = dict(hot_budget=16)
    if case == "base_loads":
        kw["base_loads"] = np.asarray([100.0, 0.0, 50.0, 25.0])
    jkw, pkw = dict(kw), dict(kw)
    if case != "base_loads":
        jcm, pcm = JaxCM(min_rows=16), PortCM(min_rows=16)
        if case != "untrained":
            _record([jcm, pcm], 0)
            assert jcm.trained and pcm.trained
        jkw["cost_model"], pkw["cost_model"] = jcm, pcm
    jplans, jrep = JP.build_plans(W, jm, **jkw)
    pplans, prep = PP.build_plans(W, pm, **pkw)
    assert _plan_fields(pplans) == _plan_fields(jplans)
    assert prep == jrep


def test_cost_model_equals_jax():
    jcm, pcm = JaxCM(min_rows=16), PortCM(min_rows=16)
    stats = _record([jcm, pcm], 1)
    for a in ("_coef", "_mean", "_scale"):
        np.testing.assert_array_equal(getattr(pcm, a), getattr(jcm, a))
    for x in (np.full(W, 100.0), np.arange(W, dtype=np.float64) * 37.0):
        np.testing.assert_array_equal(pcm.predict_loads(stats, x), jcm.predict_loads(stats, x))
    assert pcm.info() == jcm.info()
    m = _members(PP, 5)[0]
    assert PortCM.member_stats(m) == JaxCM.member_stats(_members(JP, 5)[0])
    for cm in (JaxCM(), PortCM()):
        with pytest.raises(ValueError):
            cm.record_window(stats, np.ones(W), np.ones(2))
        cm.record_window(stats, np.ones(W), np.zeros(W))  # an empty window: skipped
        assert cm.info()["rows"] == 0 and not cm.trained


def test_drift_detector_sequences_equal_jax():
    """Hysteresis, cooldown, the deferred re-arm and the slope projection:
    the same observations fire at the same calls with the same records."""
    seq = [("o", 1.0, None), ("o", 1.6, None), ("o", 1.0, None), ("o", 1.7, None),
           ("o", 1.7, None), ("adopted",), ("o", 1.8, None), ("o", 1.8, None),
           ("o", 1.8, None), ("deferred",), ("o", 1.8, None), ("o", 1.8, None),
           ("o", 1.3, 0.05), ("o", 1.4, -1.0), ("o", 1.2, 0.2)]
    runs = []
    for mod in (JP, PP):
        d = mod.DriftDetector(mod.ReplanConfig(threshold=1.5, sustain=2, cooldown=2,
                                               lead_secs=10.0))
        got = []
        for ev in seq:
            if ev[0] == "o":
                got.append((d.observe(ev[1], ev[2]), dict(d.last)))
            else:
                getattr(d, ev[0])()
        runs.append(got)
    assert runs[0] == runs[1]
    assert [f for f, _ in runs[1]].count(True) >= 3


def test_moved_rows_loads_and_amortization_models_equal_jax():
    jm, pm = _members(JP, 7), _members(PP, 7)
    jc, _ = JP.build_plans(W, jm, hot_budget=8)
    pc, _ = PP.build_plans(W, pm, hot_budget=8)
    jcur = {("b0", 0): JP.ShardPlan(num_shards=W, sentinel=-(1 << 31), offset=3)}
    pcur = {("b0", 0): PP.ShardPlan(num_shards=W, sentinel=-(1 << 31), offset=3)}
    for cur in (None, "offset"):
        a = JP.plan_moved_rows(jm, jcur if cur else None, jc)
        b = PP.plan_moved_rows(pm, pcur if cur else None, pc)
        assert a == b
    for jp, pp in ((None, None), (jc, pc), (jcur, pcur)):
        np.testing.assert_array_equal(PP.modeled_loads(W, pm, pp), JP.modeled_loads(W, jm, jp))
    cur, cand = JP.modeled_loads(W, jm, None), JP.modeled_loads(W, jm, jc)
    assert PT.replan_gain_bytes(cur, cand) == JT.replan_gain_bytes(cur, cand)
    assert PT.replan_gain_bytes([], cand) == JT.replan_gain_bytes([], cand) == 0.0
    for n, rb in ((0, 64.0), (123, 40.0), (7, 3.5)):
        assert PT.migration_bytes(n, row_bytes=rb) == JT.migration_bytes(n, row_bytes=rb)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_device_plan_owner_equals_owner_np(dtype):
    """`plan_owner` on a plan's leaves equals `owner_np` per id (stacked
    leaves too), and on int32 keys both equal the JAX `owner_np`."""
    import torch

    rng = np.random.default_rng(11)
    keys = rng.integers(-(1 << 30), 1 << 30, (2, 500)).astype(dtype)
    plans = [PP.ShardPlan(num_shards=W, sentinel=-(1 << 31), offset=o,
                          hot_keys=tuple(int(k) for k in keys[t, :h]),
                          hot_owners=tuple(int(x) for x in rng.integers(0, W, h)))
             for t, (o, h) in enumerate(((1, 12), (3, 5)))]
    bp = PP.BundlePlan(tuple(plans))
    stacked = PP.plan_owner(torch.from_numpy(keys), W, bp.leaves(np.dtype(dtype), True, "cpu"))
    for t, p in enumerate(plans):
        host = p.owner_np(keys[t])
        single = PP.plan_owner(torch.from_numpy(keys[t])[None], W,
                               p.leaves(np.dtype(dtype), "cpu"))[0]
        np.testing.assert_array_equal(stacked[t].numpy(), host)
        np.testing.assert_array_equal(single.numpy(), host)
        if dtype == "int32":
            jp = JP.ShardPlan(num_shards=W, sentinel=p.sentinel, offset=p.offset,
                              hot_keys=p.hot_keys, hot_owners=p.hot_owners)
            np.testing.assert_array_equal(host, jp.owner_np(keys[t]))
            np.testing.assert_array_equal(p.dest_hot_counts(), jp.dest_hot_counts())
    assert bp.hot_count_min() == 5
    np.testing.assert_array_equal(bp.dest_hot_counts(), np.maximum(
        plans[0].dest_hot_counts(), plans[1].dest_hot_counts()))


# ------------------------------------------------------------ 4 gloo ranks


def _jax_force(mesh, batches, state_path):
    """JAX's side of the forced placement: init(0) (exported for the port),
    3 steps, the shard gauges, update_placement(force=True), 3 more."""
    import dataclasses

    from deeprec_tpu.obs import metrics as OM
    from test_torch_sharded import jax_rows

    model = JaxWDL(**KW)
    model.features = [dataclasses.replace(f, table=dataclasses.replace(
        f.table, exchange_dtype="float32")) if getattr(f, "table", None) is not None else f
        for f in model.features]
    tr = JaxSharded(model, JaxAdagrad(lr=LR), optax.adam(DENSE_LR), mesh=mesh, comm="a2a",
                    placement="plan", placement_hot_budget=48)
    st = tr.init(0)
    export_jax_state(st, state_path)
    losses = []
    for b in batches[:3]:
        st, m = tr.train_step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    stats = tr.dedup_stats(st)
    snap = OM.default_registry().snapshot()["metrics"] if OM.metrics_enabled() else {}
    tables = {t for t in stats if t != "__placement__"}
    gauges = {}
    for name in ("deeprec_shard_imbalance", "deeprec_shard_exchange_bytes"):
        gauges[name] = {json.dumps(sorted(s["labels"].items())): s["value"]
                        for s in snap.get(name, {}).get("series", [])
                        if s["labels"].get("table") in tables
                        and int(s["labels"].get("shard", 0)) < W}
    st, rep = tr.update_placement(st, force=True)
    plans = {b: [[p.offset, list(p.hot_keys), list(p.hot_owners)] for p in bp.plans]
             for b, bp in tr._plans.items()}
    rows, _ = jax_rows(tr, st)
    last = dict(tr.last_placement)
    for b in batches[3:6]:
        st, m = tr.train_step(st, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    budgets = {b: np.asarray(sh.last_a2a_budgets).tolist() for b, sh in tr.sharded.items()}
    per_shard = {t: r.get("per_shard") for t, r in stats.items() if t != "__placement__"}
    return dict(losses=losses, gauges=gauges, report=rep, plans=plans, rows=rows, last=last,
                budgets=budgets, per_shard=per_shard, stats=dict(tr._replan_stats))


def _placement4(tmp):
    batches = drifting_batches(12)
    state = os.path.join(tmp, "jax_init.npz")
    jax_side = _jax_force(jax_mesh(W), batches, state)
    f32 = dict(exchange_dtype="float32")
    jobs = [dict(name="force", kind="placement", scenario="force", comm="a2a", hot_budget=48,
                 state=state, **f32),
            dict(name="overflow", kind="placement", scenario="overflow", comm="a2a",
                 model_kw=dict(capacity=1 << 7)),
            dict(name="drift_ag", kind="placement", scenario="drift", comm="allgather",
                 mode="off", hot_budget=32, replan=DRIFT, windows=4, per_window=2),
            dict(name="drift_a2a", kind="placement", scenario="drift", comm="a2a",
                 mode="lookahead", hot_budget=32, replan=DRIFT, windows=4, per_window=2),
            dict(name="amortize", kind="placement", scenario="amortize", hot_budget=16),
            dict(name="ckpt", kind="placement", scenario="ckpt", hot_budget=32,
                 replan=DRIFT, steps=6, save=os.path.join(tmp, "ck"),
                 cbf=dict(filter_freq=2, max_element_size=1 << 12))]
    port = spawn(tmp, W, jobs, "place4", batches=batches, timeout=400, **SPEC)
    return dict(jax=jax_side, port=port)


@pytest.fixture(scope="module")
def place4(tmp_path_factory):
    return shared(tmp_path_factory, "placement4", _placement4)


def _strip(outs, prefix):
    return [{k[len(prefix):]: v for k, v in o.items() if k.startswith(prefix)} for o in outs]


def _same_rows(a, b):
    """Two port row maps ({(bundle, member, key): (shard, value, accum,
    freq, version)}) with the same keys, values and accumulators bit for
    bit (the shard is free)."""
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][3:] == b[k][3:], k
        np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=str(k))
        np.testing.assert_array_equal(a[k][2], b[k][2], err_msg=str(k))


def test_forced_update_placement_matches_jax(place4):
    """The same plan (offsets, hot keys and owners), the same report and
    moved counts, and the same modeled numbers as JAX, on every rank."""
    j, outs = place4["jax"], place4["port"]["force"]
    for o in outs:
        assert json.loads(str(o["plans"])) == j["plans"]
        assert json.loads(str(o["report"])) == json.loads(json.dumps(j["report"]))
        assert json.loads(str(o["last"])) == json.loads(json.dumps(j["last"]))
        assert json.loads(str(o["stats"])) == json.loads(json.dumps(j["stats"]))
    assert any(r["adopted"] and r["moved"] > 0 for r in j["report"].values())


def test_forced_migration_keeps_rows_bit_for_bit(place4):
    """The migrated state per key is the port's own pre-migration state bit
    for bit (values, accumulators, freq, version), each key on the shard the
    new plan routes it to (JAX's), within the sharded test's tolerances of
    JAX's migrated rows."""
    outs = place4["port"]["force"]
    pre, _ = port_rows(_strip(outs, "pre."))
    post, post_c = port_rows(_strip(outs, "post."))
    _same_rows(pre, post)
    want = place4["jax"]["rows"]
    assert post.keys() == want.keys()
    for k, (ws, wv, wa, wf, wver) in want.items():
        gs, gv, ga, gf, gver = post[k]
        assert (gs, gf, gver) == (ws, wf, wver), k
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL, err_msg=str(k))
        np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL, err_msg=str(k))
    for (bname, t, s, name), v in post_c.items():
        if name.startswith("owner_"):
            assert v == 0, (bname, t, s, name)  # measured under the old plan
    for o in outs:
        for key in o:
            if key.startswith("owner_dev:"):
                np.testing.assert_array_equal(o[key], o["owner_host:" + key[10:]])


def test_plan_budgets_and_losses_match_jax(place4):
    """`last_a2a_budgets` under the hot-key plan equals JAX's vector; no id
    past the budget; the losses before and after the adoption within the
    sharded test's tolerance of JAX's."""
    j, outs = place4["jax"], place4["port"]["force"]
    for o in outs:
        assert json.loads(str(o["budgets"])) == j["budgets"]
        assert int(o["a2a_overflow_total"]) == 0
    np.testing.assert_allclose(outs[0]["losses"], j["losses"], rtol=RTOL)


def test_shard_gauges_equal_jax(place4):
    """`dedup_stats` publishes `deeprec_shard_imbalance{table}` and
    `deeprec_shard_exchange_bytes{table,shard}` from the same counters as
    JAX: equal values, and `per_shard` equal."""
    j, outs = place4["jax"], place4["port"]["force"]
    for o in outs:
        assert json.loads(str(o["per_shard"])) == json.loads(json.dumps(j["per_shard"]))
        g = json.loads(str(o["gauges"]))
        if j["gauges"]["deeprec_shard_imbalance"]:
            assert g == j["gauges"]
        assert len(g["deeprec_shard_exchange_bytes"]) == W * len(g["deeprec_shard_imbalance"])


def test_failed_migration_changes_nothing(place4):
    """A plan that routes every key to shard 0 overflows it: every rank
    keeps its state bit for bit and its (uniform) plan, and trains on."""
    outs = place4["port"]["overflow"]
    for o in outs:
        rep = json.loads(str(o["report"]))
        assert all("local capacity" in r["migrate_failed"] and not r["adopted"]
                   for r in rep.values()), rep
        assert json.loads(str(o["plans"])) == {} and int(o["leaves"]) == 0
        assert json.loads(str(o["stats"]))["replans"] == 0
        for k in o:
            if k.startswith("pre."):
                np.testing.assert_array_equal(o[k], o["post." + k[4:]], err_msg=k)
    assert len({float(o["after_loss"]) for o in outs}) == 1


@pytest.mark.parametrize("run", ["drift_ag", "drift_a2a"])
def test_drift_replan_keeps_losses_bit_for_bit(place4, run):
    """An automatic replan fires on the drifting stream (allgather "off",
    a2a "lookahead"), and the plan trainer's losses and per-key rows equal
    the uniform trainer's bit for bit, through the replans and a
    `train_steps` window after them."""
    outs = place4["port"][run]
    np.testing.assert_array_equal(outs[0]["losses_p"], outs[0]["losses_u"])
    stats = json.loads(str(outs[0]["stats"]))
    assert stats["replans"] >= 1 and stats["forced_replans"] == 0
    assert stats["migration_bytes"] > 0 and "cost_model" in stats and "drift" in stats
    assert int(outs[0]["a2a_overflow_total"]) == 0
    u, _ = port_rows(_strip(outs, "u."))
    p, _ = port_rows(_strip(outs, "p."))
    _same_rows(u, p)
    reps = json.loads(str(outs[0]["reports"]))
    assert any(r and r.get("adopted") for w in reps for r in w.values())


def test_amortization_defers_below_horizon_and_adopts_above(place4):
    for o in place4["port"]["amortize"]:
        rep0, rep1 = json.loads(str(o["reports"]))
        last0, _ = json.loads(str(o["last"]))
        s0, s1 = json.loads(str(o["stats"]))
        assert all(r.get("deferred") == "amortization" for r in rep0.values()), rep0
        assert s0["replans"] == 0 and s0["deferred"] == 1
        assert last0["migration_bytes"] > 0 and last0["gain_bytes_per_step"] > 0
        assert last0["amortize_steps"] >= 1
        assert any(r.get("adopted") for r in rep1.values()), rep1
        assert s1["replans"] == 1 and s1["forced_replans"] == 0


def test_checkpoint_under_a_plan_restores_into_uniform_and_another_plan(place4):
    """A part-file save under plan A restores per key bit for bit into a
    uniform trainer and into one on plan B (each key on its new owner); the
    CBF sketch is rebuilt from the restored rows where the routing
    fingerprint differs and reused exactly where it matches (plan A, whose
    next step then equals the uninterrupted trainer's bit for bit; a
    rebuilt sketch forgets the sub-threshold counts, as in the JAX
    package)."""
    outs = place4["port"]["ckpt"]
    saved, _ = port_rows(_strip(outs, "saved."))
    moved = {}
    fp = json.loads(str(outs[0]["saved.fp"]))
    assert fp and all(v != "uniform" for v in fp.values())
    for tag in ("uniform", "planB", "planA"):
        got, _ = port_rows(_strip(outs, f"{tag}."))
        assert got.keys() == saved.keys()
        moved[tag] = sum(got[k][0] != saved[k][0] for k in saved)
        for k in saved:  # the dirty bits are the save's business
            np.testing.assert_array_equal(got[k][1], saved[k][1], err_msg=str(k))
            np.testing.assert_array_equal(got[k][2], saved[k][2], err_msg=str(k))
            assert got[k][3:] == saved[k][3:], k
        for o in outs:
            for b in fp:
                want = o[f"saved.bloom:{b}"] if tag == "planA" else o[f"{tag}.rebuilt:{b}"]
                np.testing.assert_array_equal(o[f"{tag}.bloom:{b}"], want, err_msg=(tag, b))
    # plan A's rows sit where plan A put them; the other routings move them
    assert moved["planA"] == 0 and moved["uniform"] > 0 and moved["planB"] > 0
    assert float(outs[0]["planA.next_loss"]) == float(outs[0]["next_loss"])
