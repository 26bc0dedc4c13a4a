"""The port's multi-tier tables under the sharded trainer
(`deeprec_tpu_torch/parallel/trainer.py`), auto-tiering over the mesh and
async part-file saves, held against the JAX package's ShardedTrainer on the
CPU.

The JAX side runs in this process on 4 of the virtual CPU devices of
tests/conftest.py; the port runs as 4 gloo ranks (`tests/torch_sharded_rank.py`,
one spawn, several jobs). A small DLRM-DCN (emb 16, 4 categorical and 3
dense features, the f32 exchange wire) trains on the same global batches of
64, and every `maintain` starts from the JAX state carried slot for slot
(`convert.sharded_train_state_from_arrays`): tier demotion ranks by freq and
breaks ties by slot, and the two packages' claim races place keys apart.
The tier stores are each package's own, from the same maintains.

Compared exactly: the maintain reports (every rank's equal to the JAX
report, `demoted` and `promoted` summed over the mesh), the device rows per
key and shard (values, accumulators, freq, version), the integer counters
per shard, and each (table, shard) member's host-store export and disk log.
The losses of the steps between maintains, which each package takes from
its own state, within tests/test_torch_sharded.py's tolerance (1e-4
relative).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.parallel import ShardedTrainer as JaxSharded
from deeprec_tpu.parallel import make_mesh as jax_mesh
from deeprec_tpu.training.trainer import TrainState as JaxTrainState
from test_torch_sharded import (
    BASE, DENSE_LR, KW, LR, RTOL, _batches, export_jax_state, jax_rows, port_rows, shared)
from torch_sharded_rank import spawn

torch.set_num_threads(1)

W = 4
CAP = 64  # global: 16 slots a shard, which 3 batches of 64 overfill
F32 = "float32"
TIER_KW = dict(KW, capacity=CAP)
SPEC = dict(BASE, model=TIER_KW)


# ------------------------------------------------------------- JAX side


def _jax_model(storage=None, on=None):
    model = JaxDLRMDCN(**TIER_KW)
    ev = (jcfg.EmbeddingVariableOption(storage=jcfg.StorageOption(**storage))
          if storage else None)
    sparse = [f for f in model.features if getattr(f, "table", None) is not None]
    pick = {id(f) for i, f in enumerate(sparse) if on is None or i in on}
    model.features = [
        dataclasses.replace(f, table=dataclasses.replace(
            f.table, exchange_dtype=F32, **({"ev": ev} if ev and id(f) in pick else {})))
        if getattr(f, "table", None) is not None else f for f in model.features]
    return model


def _norm(rep):
    return json.loads(json.dumps(rep, sort_keys=True, default=float))


def _jax_tiers(jtr):
    """{(bundle, 'k_s'): (host export by key, disk contents by key, log name)}."""
    out = {}
    for (bname, idx), mt in jtr._tiers.items():
        tag = "_".join(str(int(i)) for i in idx)
        host = disk = name = None
        if mt.host is not None:
            host = _by_key(*mt.host.export())
        if mt.disk is not None:
            keys = np.sort(np.fromiter(mt.disk.index, np.int64, len(mt.disk.index)))
            v, f, ver, found = mt.disk.get(keys)
            assert found.all()
            disk, name = _by_key(keys, v, f, ver), os.path.basename(mt.disk.path)
        out[(bname, tag)] = (host, disk, name)
    return out


def _by_key(keys, rows, freqs, versions):
    return {int(k): (np.asarray(rows[i]), int(freqs[i]), int(versions[i]))
            for i, k in enumerate(np.asarray(keys))}


def _jax_drain(jtr, jst):
    """Drain every member tier into the state (the JAX member layout)."""
    from jax.sharding import NamedSharding

    tables, total = dict(jst.tables), {}
    for bname, b in jtr.bundles.items():
        lead = jtr._bundle_lead_dims(b)
        idxs = list(np.ndindex(*lead))
        ts = tables[bname]
        members = [jax.tree.map(lambda a, i=i: a[i], ts) for i in idxs]
        for j, i in enumerate(idxs):
            mt = jtr._tiers.get((bname, i))
            if mt is None:
                continue
            members[j], stats = mt.drain(members[j])
            for name, v in dataclasses.asdict(stats).items():
                total[name] = total.get(name, 0) + v
        tables[bname] = jax.device_put(jtr._restack(members, lead),
                                       NamedSharding(jtr.mesh, jtr._table_spec(bname)))
    return JaxTrainState(step=jst.step, tables=tables, dense=jst.dense,
                         opt_state=jst.opt_state), total


def _jax_record(jtr, jst, rep=None):
    rows, counters = jax_rows(jtr, jst)
    return dict(rows=rows, counters=counters, tiers=_jax_tiers(jtr),
                report=None if rep is None else _norm(rep))


def jax_scenario(tmp, name, ops, storage=None, on=None, placement="uniform"):
    """Run `ops` on the JAX ShardedTrainer; a `load` op exports the state
    the port loads at that point. Returns ({tag: record}, the port's ops)."""
    mesh = jax_mesh(W)
    jtr = JaxSharded(_jax_model(storage, on), JaxAdagrad(lr=LR), optax.adam(DENSE_LR),
                     mesh=mesh, comm="allgather", placement=placement)
    batches = _batches(12)
    jst = jtr.init(0)
    rec, port_ops = {}, []
    for i, op in enumerate(ops):
        kind, tag = op["op"], op.get("tag", "")
        op = dict(op)
        if kind == "load":
            op["state"] = os.path.join(tmp, f"{name}_state{i}.npz")
            export_jax_state(jst, op["state"])
        elif kind == "steps":
            losses = []
            for b in batches[op["first"]:op["first"] + op["n"]]:
                jst, m = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
                losses.append(float(m["loss"]))
            rec[f"{tag}losses"] = losses
        elif kind == "maintain":
            kw = dict(op.get("kw", {}))
            if kw.get("hbm_budget_bytes") == "global":
                kw["hbm_budget_bytes"] = sum(jtr._state_bytes(ts) for ts in jst.tables.values())
                op["kw"] = dict(op["kw"], hbm_budget_bytes=kw["hbm_budget_bytes"])
            jst, rep = jtr.maintain(jst, **kw)
            rec[tag] = _jax_record(jtr, jst, rep)
        elif kind == "drain":
            jst, total = _jax_drain(jtr, jst)
            rec[tag] = dict(_jax_record(jtr, jst), drain=total)
        elif kind == "place":
            jst, rep = jtr.update_placement(jst, force=True)
            rec["place"] = _norm(rep)
            rec["plans"] = len(jtr._plans)
            rec["fingerprints"] = {b: jtr.routing_fingerprint(b) for b in jtr.bundles}
        port_ops.append(op)
    rec["_batches"] = batches
    return rec, port_ops


# ------------------------------------------------------------ port side


def _pre(o, tag):
    return {k[len(tag):]: v for k, v in o.items() if k.startswith(tag)}


def _port_tiers(outs, tag):
    """The port's per-member tiers from every rank's outputs."""
    out = {}
    for o in outs:
        o = _pre(o, tag)
        for k in o:
            if k.startswith(("host:", "disk:")) and k.endswith(":keys"):
                kind, bname, idx, _ = k.split(":")
                meta = o[f"{kind}:{bname}:{idx}:meta"]
                entry = out.setdefault((bname, idx), [None, None, None])
                by = _by_key(o[k], o[f"{kind}:{bname}:{idx}:rows"], meta[:, 0], meta[:, 1])
                if kind == "host":
                    entry[0] = by
                else:
                    entry[1], entry[2] = by, str(o[f"disk:{bname}:{idx}:path"])
    return {k: tuple(v) for k, v in out.items()}


def _same_store(got, want, what):
    assert (got is None) == (want is None), what
    if got is None:
        return
    assert got.keys() == want.keys(), what
    for k, (v, f, ver) in want.items():
        np.testing.assert_array_equal(got[k][0], v, err_msg=f"{what} {k}")
        assert got[k][1:] == (f, ver), (what, k)


def assert_record(outs, want, tag):
    """Every rank's record under `tag` against the JAX record: the report
    (equal on every rank), rows per key and counters exactly, the tier
    stores member by member."""
    if want.get("report") is not None:
        for o in outs:
            assert _norm(json.loads(str(o[f"{tag}report"]))) == want["report"], tag
    got_rows, got_c = port_rows([_pre(o, tag) for o in outs])
    assert got_rows.keys() == want["rows"].keys(), tag
    for k, (ws, wv, wa, wf, wver) in want["rows"].items():
        gs, gv, ga, gf, gver = got_rows[k]
        assert (gs, gf, gver) == (ws, wf, wver), (tag, k)
        np.testing.assert_array_equal(gv, wv, err_msg=f"{tag} {k}")
        np.testing.assert_array_equal(ga, wa, err_msg=f"{tag} {k}")
    assert got_c == want["counters"], tag
    got_t = _port_tiers(outs, tag)
    assert got_t.keys() == want["tiers"].keys(), tag
    for key, (wh, wd, wn) in want["tiers"].items():
        gh, gd, gn = got_t[key]
        _same_store(gh, wh, f"{tag} host {key}")
        _same_store(gd, wd, f"{tag} disk {key}")
        assert gn == wn, (tag, key)


def _losses(outs, want, tag):
    for o in outs:
        np.testing.assert_array_equal(o[f"{tag}losses"], outs[0][f"{tag}losses"])
    np.testing.assert_allclose(outs[0][f"{tag}losses"], want[f"{tag}losses"], rtol=RTOL)


# ------------------------------------------------------------ scenarios

TIERED = dict(storage_type="hbm_dram")
TIER_OPS = [dict(op="load"), dict(op="steps", first=0, n=3, tag="s1."),
            dict(op="load"), dict(op="maintain", tag="m1."),
            dict(op="steps", first=3, n=3, tag="s2."),
            dict(op="load"), dict(op="maintain", tag="m2."),
            dict(op="steps", first=6, n=2, tag="s3."),
            dict(op="load"), dict(op="maintain", kw=dict(tier_async=True), tag="m3."),
            dict(op="drain", tag="d3."), dict(op="paging")]
SSD_OPS = [dict(op="load"), dict(op="steps", first=0, n=3, tag="s1."),
           dict(op="load"), dict(op="maintain", tag="m1."),
           dict(op="steps", first=3, n=3, tag="s2."),
           dict(op="load"), dict(op="maintain", tag="m2.")]
BUDGET_OPS = [dict(op="load"), dict(op="steps", first=0, n=3, tag="s1."),
              dict(op="load"), dict(op="maintain", kw=dict(hbm_budget_bytes="global"),
                                    tag="m1."),
              dict(op="maintain", kw=dict(hbm_budget_bytes="global"), tag="m1b."),
              dict(op="steps", first=3, n=3, tag="s2."),
              dict(op="load"), dict(op="maintain", kw=dict(hbm_budget_bytes=1 << 30),
                                    tag="m2.")]
PLACE_OPS = [dict(op="steps", first=0, n=2), dict(op="place")]


def _scenarios(tmp):
    jax_logs, port_logs = (os.path.join(tmp, d, "log") for d in ("jax", "port"))
    for d in (jax_logs, port_logs):
        os.makedirs(os.path.dirname(d), exist_ok=True)
    ssd = dict(storage_type="hbm_dram_ssd", host_capacity=6)
    runs = {
        "tiers": dict(storage=TIERED, ops=TIER_OPS),
        "ssd": dict(storage=ssd, on=[0], ops=SSD_OPS),
        "budget": dict(ops=BUDGET_OPS),
        "place": dict(storage=TIERED, ops=PLACE_OPS, placement="plan"),
    }
    want, jobs, batches = {}, [], None
    for name, r in runs.items():
        storage = r.get("storage")
        jst = dict(storage, storage_path=jax_logs) if storage is ssd else storage
        want[name], ops = jax_scenario(tmp, name, r["ops"], jst, r.get("on"),
                                       r.get("placement", "uniform"))
        batches = want[name].pop("_batches")
        job = dict(name=name, kind="tiers", ops=ops, exchange_dtype=F32,
                   placement=r.get("placement", "uniform"))
        if storage is not None:
            job["storage"] = dict(storage, storage_path=port_logs) if storage is ssd else storage
            if r.get("on") is not None:
                job["storage_on"] = r["on"]
        jobs.append(job)
    port = spawn(tmp, W, jobs, "tiers", batches=batches, **SPEC)
    return dict(jax=want, port=port)


@pytest.fixture(scope="module")
def tiers(tmp_path_factory):
    return shared(tmp_path_factory, "sharded_tiers", _scenarios)


# ------------------------------------------------------------------ tests


def test_demote_then_promote_match_jax(tiers):
    """A demoting maintain, then a promoting one: reports (summed over the
    4 positions), rows, counters and the 16 (table, shard) host stores."""
    want, outs = tiers["jax"]["tiers"], tiers["port"]["tiers"]
    assert want["m1."]["report"]["group0"]["demoted"] > 0
    assert want["m2."]["report"]["group0"]["promoted"] > 0
    assert len(want["m1."]["tiers"]) == 4 * W  # keyed (table, shard)
    for tag in ("m1.", "m2."):
        assert_record(outs, want[tag], tag)
    for tag in ("s1.", "s2.", "s3."):
        _losses(outs, want, tag)


def test_tier_async_after_drain_matches_jax(tiers):
    """maintain(tier_async=True): the report of the device half, then every
    member drained: rows, counters and stores as JAX."""
    want, outs = tiers["jax"]["tiers"], tiers["port"]["tiers"]
    assert want["m3."]["report"]["group0"]["demoted"] > 0
    assert_record(outs, want["m3."], "m3.")
    assert_record(outs, want["d3."], "d3.")
    # each rank drains its own members: their TierStats summed over ranks
    drains = [json.loads(str(o["d3.drain"])) for o in outs]
    assert {k: sum(d[k] for d in drains) for k in drains[0]} == want["d3."]["drain"]


def test_enable_tier_paging_raises_on_every_rank(tiers):
    for o in tiers["port"]["tiers"]:
        assert str(o["paging"]).startswith("NotImplementedError")


def test_hbm_dram_ssd_per_rank_logs_match_jax(tiers):
    """hbm_dram_ssd on one single-table bundle: each position's disk log is
    `<path>_m<s>.ssd`, as JAX names its (shard,) members; host and disk
    contents equal after a demote with spill and after the next maintain."""
    want, outs = tiers["jax"]["ssd"], tiers["port"]["ssd"]
    names = sorted(n for _, _, n in want["m1."]["tiers"].values())
    assert names == [f"log_m{s}.ssd" for s in range(W)]
    assert any(d for _, d, _ in want["m1."]["tiers"].values())  # rows spilled
    for tag in ("m1.", "m2."):
        assert_record(outs, want[tag], tag)
    for tag in ("s1.", "s2."):
        _losses(outs, want, tag)


def test_hbm_budget_auto_tiers_then_grows_like_jax(tiers):
    """hbm_budget_bytes at exactly the whole mesh's table bytes: both
    auto-tier (capacity kept, rows demoted); the next maintain at that
    budget does nothing; a budget above the growth: both grow."""
    want, outs = tiers["jax"]["budget"], tiers["port"]["budget"]
    rep = want["m1."]["report"]["group0"]
    assert rep["auto_tiered"] and rep["demoted"] > 0 and rep["capacity"] == CAP // W
    rep = want["m1b."]["report"]["group0"]
    assert not {"auto_tiered", "grew_to"} & set(rep), rep
    assert want["m2."]["report"]["group0"]["grew_to"] > CAP // W
    for tag in ("m1.", "m1b.", "m2."):
        assert_record(outs, want[tag], tag)
    for tag in ("s1.", "s2."):
        _losses(outs, want, tag)


def test_multi_tier_bundle_is_never_replanned(tiers):
    """The counterpart of tests/test_placement.py's: update_placement(force=
    True) skips the hbm_dram bundle as JAX does, no plan, uniform routing."""
    want, outs = tiers["jax"]["place"], tiers["port"]["place"]
    assert all(r == {"adopted": False, "skipped": "multi_tier"} for r in want["place"].values())
    for o in outs:
        assert _norm(json.loads(str(o["place"]))) == want["place"]
        assert int(o["plans"]) == want["plans"] == 0
        assert json.loads(str(o["fingerprints"])) == want["fingerprints"]


# ---------------------------------------------------------- async saves


def _rows_by_key(o, tag):
    """{(member, key): (value, accum, freq, version)} of one rank's rows."""
    o = _pre(o, tag)
    return {(int(m), int(k)): (o["r:group0:value"][i], o["r:group0:accum"][i],
                               tuple(o["r:group0:meta"][i][:2]))
            for i, (m, k) in enumerate(zip(o["r:group0:member"], o["r:group0:key"]))}


def _same_rows(a, b, what):
    assert a.keys() == b.keys(), what
    for k, (v, acc, meta) in b.items():
        np.testing.assert_array_equal(a[k][0], v, err_msg=f"{what} {k}")
        np.testing.assert_array_equal(a[k][1], acc, err_msg=f"{what} {k}")
        assert a[k][2] == meta, (what, k)


def test_async_part_saves_at_world_2_are_synchronous(tmp_path):
    """The counterpart of tests/test_async_ckpt.py's sharded part-file
    parity: at world 2 save_async / save_incremental_async run the
    synchronous save (`last_save["async"]` False, as the JAX manager of a
    multi-process run), and a full + delta chain saved that way restores
    the same rows per key as one saved with save / save_incremental, which
    are the live rows."""
    batches = _batches(5)
    job = dict(name="ck", kind="ckpt_async", steps=3, dir=str(tmp_path), exchange_dtype=F32)
    outs = spawn(tmp_path, 2, [job], "ckasync", batches=batches, **SPEC)["ck"]
    for o in outs:
        assert o["sync.flags"].tolist() == o["async.flags"].tolist() == [False, False]
        assert o["sync.kinds"].tolist() == o["async.kinds"].tolist() == ["full", "incr"]
        assert int(o["sync.step"]) == int(o["async.step"]) == 4
        live = _rows_by_key(o, "sync.live.")
        _same_rows(_rows_by_key(o, "async.live."), live, "the two runs")
        _same_rows(_rows_by_key(o, "sync.restored."), live, "sync restore")
        _same_rows(_rows_by_key(o, "async.restored."), live, "async restore")


def test_async_part_save_at_world_1_runs_on_the_writer(tmp_path):
    """One position with sharded_io=True: the part write runs on the writer
    thread (nothing to meet), and after wait() restores what the
    synchronous save restores."""
    import threading

    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.parallel import ShardedTrainer, make_mesh
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    def trainer():
        return ShardedTrainer(DLRMDCN(**TIER_KW), Adagrad(lr=LR), adam(DENSE_LR),
                              mesh=make_mesh(device="cpu"))

    tr = trainer()
    st = tr.init(0)
    for b in _batches(2):
        st, _ = tr.train_step(st, b)
    ck_s = CheckpointManager(str(tmp_path / "sync"), tr, sharded_io=True)
    ck_a = CheckpointManager(str(tmp_path / "async"), tr, sharded_io=True)
    ck_s.save(st)
    seen = []
    ck_a.on_write = lambda path: seen.append(threading.current_thread().name)
    st, path = ck_a.save_async(st)
    ck_a.wait()
    assert ck_a.last_save["async"] is True
    assert seen and seen[0].startswith("ckpt-writer-full")
    assert any(n.endswith(".part00000.npz") for n in os.listdir(path))
    r_s = CheckpointManager(str(tmp_path / "sync"), trainer()).restore()
    r_a = CheckpointManager(str(tmp_path / "async"), trainer()).restore()
    for bname, ts in r_s.tables.items():
        ta = r_a.tables[bname]
        for name in ("keys", "values", "meta"):
            assert torch.equal(getattr(ts, name), getattr(ta, name)), name
        assert torch.equal(ts.slots["accum"], ta.slots["accum"])
