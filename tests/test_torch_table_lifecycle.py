"""The PyTorch port's table life cycle held against the JAX package on the
CPU: `hash_to_bucket` and the counting-Bloom sketch (`cbf_add`,
`cbf_estimate`) bit for bit; CBF admission deferring the slot; the TTL and
L2 `evict_mask`; `evict`, `rebuild` and `grow` per key; `lookup_readonly`;
`Trainer.evict_tables` and `Trainer.maintain` growing an overfilled table
with the JAX report; the paths `maintain` leaves to later slices; and
checkpoints that carry the sketch and the grown capacity both ways.

A JAX state is carried into the port slot for slot (convert.py), so both
packages start each check from the same table. Integers (keys, metadata,
sketches, sizes, counters) must agree bit for bit. Rows are compared per
key (which slot a key wins in a claim race is free): moved rows exactly,
initializer rows within 65 f32 ulps of erfinv (`RTOL`)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.data import SyntheticCriteo as JaxSyntheticCriteo
from deeprec_tpu.embedding import filters as jfilters
from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu.utils import hashing as jhash
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import filters as tfilters
from deeprec_tpu_torch.embedding.table import EmbeddingTable
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer
from deeprec_tpu_torch.utils import hashing as thash

torch.set_num_threads(1)

SENTINEL = int(np.iinfo(np.int32).min)
# Initializer rows: torch.erfinv and XLA's erfinv differ by at most 65 f32
# ulps (embedding/table.py `_uniform_to_normal`); every other row moves
# unchanged.
RTOL = 1e-5


def _cfg(mod, **kw):
    base = dict(name="t", dim=8, capacity=256)
    base.update(kw)
    return mod.TableConfig(**base)


def _ev(mod, **kw):
    parts = {}
    for name, args in kw.items():
        cls = {"cbf": mod.CBFFilter, "ttl": mod.GlobalStepEvict,
               "l2": mod.L2WeightEvict, "counter": mod.CounterFilter}[name]
        key = {"cbf": "cbf_filter", "ttl": "global_step_evict",
               "l2": "l2_weight_evict", "counter": "counter_filter"}[name]
        parts[key] = cls(**args)
    return mod.EmbeddingVariableOption(**parts)


def _port_state(cfg, js, device="cpu"):
    """The port's [1, ...] state of an unstacked JAX table state."""
    arrays = {"keys": np.asarray(js.keys), "values": np.asarray(js.values),
              "meta": np.asarray(js.meta), "insert_fails": np.asarray(js.insert_fails),
              "slots": {k: np.asarray(v) for k, v in js.slots.items()}}
    if js.bloom is not None:
        arrays["bloom"] = np.asarray(js.bloom)
    return convert.table_state_from_arrays(cfg, arrays, 1, device)


def _by_key(keys, values, meta, slots=None):
    """{key: (row, (freq, version, dirty), {slot: row})} of live slots."""
    keys = np.asarray(keys)
    out = {}
    for i in np.nonzero(keys != SENTINEL)[0]:
        out[int(keys[i])] = (np.asarray(values, np.float32)[i], tuple(np.asarray(meta)[:, i]),
                             {k: np.asarray(v)[i] for k, v in (slots or {}).items()})
    return out


def _jax_rows(js):
    return _by_key(js.keys, js.values.astype(jnp.float32), js.meta, js.slots)


def _port_rows(ts, t=0):
    return _by_key(ts.keys[t], ts.values[t].float(), ts.meta[t],
                   {k: v[t] for k, v in ts.slots.items() if not k.startswith("scalar/")})


def _assert_rows_equal(got, want, rtol=0.0):
    """Per key: rows within rtol (exact by default), metadata and slot rows
    exact."""
    assert got.keys() == want.keys()
    for key, (wv, wm, ws) in want.items():
        gv, gm, gs = got[key]
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=0, err_msg=str(key))
        assert gm == wm, key
        for name in ws:
            np.testing.assert_array_equal(gs[name], ws[name], err_msg=f"{key} {name}")


# ------------------------------------------------------------ hashing, CBF


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("buckets,salt", [(1024, 0), (1 << 17, 0xB1000003), (8, 12345)])
def test_hash_to_bucket_bit_for_bit(dtype, buckets, salt):
    """int32 ids against the JAX function; int64 ids (which exist in JAX
    only with x64 on) against the package's numpy mirror of the hash."""
    rng = np.random.default_rng(1)
    info = np.iinfo(dtype)
    ids = rng.integers(info.min, info.max, size=4096, dtype=dtype)
    ids[:4] = [0, -1, info.min, info.max]
    if dtype == np.int32:
        want = np.asarray(jhash.hash_to_bucket(jnp.asarray(ids), buckets, salt=salt))
    else:
        want = (jhash.mix32_np(jhash.fold64_np(ids) ^ np.uint32(salt))
                & np.uint32(buckets - 1)).astype(np.int32)
    got = thash.hash_to_bucket(torch.from_numpy(ids), buckets, salt=salt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        thash.hash_to_bucket(torch.from_numpy(ids), 1000)


@pytest.mark.parametrize("bits", [16, 3])
def test_cbf_add_and_estimate_bit_for_bit(bits):
    """Three updates of a sketch (duplicate cells within and across ids;
    3 counter bits saturate) and the read-only estimate of seen and unseen
    ids."""
    kw = dict(filter_freq=2, max_element_size=1 << 10, counter_bits=bits)
    jc, tc = jcfg.CBFFilter(**kw), tcfg.CBFFilter(**kw)
    assert (tc.num_cells(), tc.num_hashes()) == (jc.num_cells(), jc.num_hashes())
    rng = np.random.default_rng(2)
    jb = jnp.zeros((jc.num_cells(),), jnp.int32)
    tb = torch.zeros((1, tc.num_cells()), dtype=torch.int32)
    for _ in range(3):
        uids = rng.integers(0, 5000, 700).astype(np.int32)
        counts = rng.integers(0, 4, 700).astype(np.int32)
        jb, jest = jfilters.cbf_add(jc, jb, jnp.asarray(uids), jnp.asarray(counts))
        test = tfilters.cbf_add(tc, tb, torch.from_numpy(uids)[None],
                                torch.from_numpy(counts)[None])
        np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(test[0].numpy(), np.asarray(jest))
    probe = rng.integers(0, 10000, 300).astype(np.int32)
    np.testing.assert_array_equal(
        tfilters.cbf_estimate(tc, tb, torch.from_numpy(probe)[None])[0].numpy(),
        np.asarray(jfilters.cbf_estimate(jc, jb, jnp.asarray(probe))))


def test_cbf_admission_defers_the_slot():
    """An id below the sketch threshold takes no slot and reads the blocked
    default; at the threshold it is created. The sketch, sizes, slots taken
    and admission equal the JAX table's at every step."""
    ev = dict(cbf=dict(filter_freq=3, max_element_size=1 << 12))
    jt = JaxTable(_cfg(jcfg, ev=_ev(jcfg, **ev)))
    tt = EmbeddingTable(_cfg(tcfg, ev=_ev(tcfg, **ev)))
    js, ts = jt.create(), tt.create(device="cpu")
    assert ts.bloom.shape == (1, js.bloom.shape[0])
    rng = np.random.default_rng(3)
    for step in range(4):
        ids = np.concatenate([[123, 123], rng.integers(0, 40, 30)]).astype(np.int32)
        js, jr = jt.lookup_unique(js, jnp.asarray(ids), step=step)
        tr = tt.lookup_unique(ts, torch.from_numpy(ids)[None], step=step)
        np.testing.assert_array_equal(ts.bloom[0].numpy(), np.asarray(js.bloom))
        assert int(tt.size(ts)[0]) == int(jt.size(js))
        np.testing.assert_array_equal(tr.uids[0].numpy(), np.asarray(jr.uids))
        np.testing.assert_array_equal(tr.admitted[0].numpy(), np.asarray(jr.admitted))
        np.testing.assert_array_equal((tr.slot_ix[0] >= 0).numpy(),
                                      np.asarray(jr.slot_ix) >= 0)
        i = list(tr.uids[0].numpy()).index(123)
        # 2 sightings a step: below 3 at step 0, created at step 1
        assert (int(tr.slot_ix[0, i]) >= 0) == (step >= 1)
        if step == 0:
            np.testing.assert_array_equal(tr.embeddings[0, i].numpy(), 0.0)
    _assert_rows_equal(_port_rows(ts), _jax_rows(js), rtol=RTOL)


# --------------------------------------------------------- evict & rebuild


def _trained_pair(ev_kw, capacity=256, n=120, steps=6, dim=8, slots=True):
    """A JAX table after `steps` train lookups of overlapping id sets (and,
    with slots, an Adagrad accumulator written at random), and the port's
    slot-for-slot copy."""
    jt = JaxTable(_cfg(jcfg, capacity=capacity, dim=dim, ev=_ev(jcfg, **ev_kw)))
    cfg = _cfg(tcfg, capacity=capacity, dim=dim, ev=_ev(tcfg, **ev_kw))
    js = jt.create()
    rng = np.random.default_rng(4)
    for step in range(steps):
        ids = rng.integers(0, n, n // 2).astype(np.int32) + 1000 * (step % 3)
        js, _ = jt.lookup_unique(js, jnp.asarray(ids), step=step * 10)
    if slots:
        acc = rng.uniform(0.1, 2.0, (capacity, dim)).astype(np.float32)
        js = js.replace(slots={"accum": jnp.asarray(acc)})
    return jt, js, EmbeddingTable(cfg), _port_state(cfg, js)


def test_evict_mask_ttl_and_l2_match_jax():
    """The dropped keys under TTL at three steps, under L2 at three
    thresholds (rows scaled so norms spread around them), and both."""
    ev = dict(ttl=dict(steps_to_live=20))
    jt, js, tt, ts = _trained_pair(ev)
    keys = np.asarray(js.keys)
    for step in (30, 45, 65):
        want = set(keys[np.asarray(jt.evict_mask(js, step))].tolist())
        got = set(ts.keys[0][tt.evict_mask(ts, step)[0]].tolist())
        assert got == want and 0 < len(want) < int(jt.size(js)), (step, len(want))
    scale = np.random.default_rng(5).uniform(0, 20, (256, 1)).astype(np.float32)
    for thr in (0.05, 0.2, 1.0):
        ev = dict(l2=dict(l2_weight_threshold=thr), ttl=dict(steps_to_live=30))
        jt2 = JaxTable(_cfg(jcfg, ev=_ev(jcfg, **ev)))
        tt2 = EmbeddingTable(_cfg(tcfg, ev=_ev(tcfg, **ev)))
        js2 = js.replace(values=js.values * jnp.asarray(scale))
        ts2 = _port_state(tt2.cfg, js2)
        want = set(keys[np.asarray(jt2.evict_mask(js2, 60))].tolist())
        got = set(ts2.keys[0][tt2.evict_mask(ts2, 60)[0]].tolist())
        assert got == want and want, thr


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_evict_rebuild_grow_per_key_match_jax(value_dtype):
    """evict (TTL) keeps every survivor's row, metadata and slot rows, and
    resets the counters; grow to 1024 does the same at the new capacity;
    a rebuild with a keep mask keeps exactly the kept keys. bf16 rows move
    without rounding again."""
    ev = dict(ttl=dict(steps_to_live=20))
    jt, js, _, _ = _trained_pair(ev)
    cfg_kw = dict(value_dtype=value_dtype, ev=_ev(tcfg, **ev))
    jt = JaxTable(_cfg(jcfg, value_dtype=value_dtype, ev=_ev(jcfg, **ev)))
    js = js.replace(values=js.values.astype(jt.cfg.value_dtype),
                    insert_fails=jnp.int32(7))
    tt = EmbeddingTable(_cfg(tcfg, **cfg_kw))
    ts = _port_state(tt.cfg, js)
    fills = (("accum", 0.1),)
    je, te = jt.evict(js, 45, slot_fills=fills), tt.evict(ts, 45, slot_fills=fills)
    assert int(tt.size(te)[0]) == int(jt.size(je)) < int(jt.size(js))
    assert int(te.insert_fails[0]) == int(je.insert_fails) == 0
    _assert_rows_equal(_port_rows(te), _jax_rows(je))
    assert ts.values.dtype == te.values.dtype == tt.create(device="cpu").values.dtype
    jg, tg = jt.grow(js, 1024, slot_fills=fills), tt.grow(ts, 1024, slot_fills=fills)
    assert tg.keys.shape == (1, 1024) and tg.values.shape == (1, 1024, 8)
    _assert_rows_equal(_port_rows(tg), _jax_rows(jg))
    free = (tg.keys[0] == SENTINEL).numpy()
    np.testing.assert_array_equal(tg.slots["accum"][0].numpy()[free], np.float32(0.1))
    np.testing.assert_array_equal(tg.meta[0].numpy()[:, free],
                                  np.asarray(jg.meta)[:, np.asarray(jg.keys) == SENTINEL])
    keep_keys = np.asarray(js.keys)[::3]
    jk = jt.rebuild(js, keep=jnp.asarray(np.isin(np.asarray(js.keys), keep_keys)))
    tk = tt.rebuild(ts, keep=torch.from_numpy(np.isin(ts.keys.numpy(), keep_keys)))
    _assert_rows_equal(_port_rows(tk), _jax_rows(jk))
    with pytest.raises(ValueError, match="power of two"):
        tt.rebuild(ts, new_capacity=1000)


def test_lookup_readonly_matches_jax():
    """Resident keys read their row exactly, missing keys their
    initializer row, pads zeros; nothing changes in the state."""
    jt, js, tt, ts = _trained_pair({}, slots=False)
    live = np.asarray(js.keys)[np.asarray(js.keys) != SENTINEL]
    ids = np.concatenate([live[:20], [77777, 88888, -1, -1]]).astype(np.int32)
    ids = ids.reshape(4, 6)
    want = np.asarray(jt.lookup_readonly(js, jnp.asarray(ids)))
    before = ts.keys.clone(), ts.meta.clone()
    got = tt.lookup_readonly(ts, torch.from_numpy(ids)[None])
    assert got.shape == (1, 4, 6, 8)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=1e-7)
    np.testing.assert_array_equal(got[0].numpy()[ids < 0], 0.0)
    np.testing.assert_array_equal(got[0].reshape(-1, 8)[:20].numpy(), want.reshape(-1, 8)[:20])
    assert torch.equal(ts.keys, before[0]) and torch.equal(ts.meta, before[1])


# ------------------------------------------------- Trainer: evict, maintain

NUM_CAT, NUM_DENSE = 2, 2


def _wdl(mod, capacity, ev):
    return mod(emb_dim=4, capacity=capacity, hidden=(16,), num_cat=NUM_CAT,
               num_dense=NUM_DENSE, ev=ev)


def _port_from_jax(trainer, jst):
    tables = {}
    for bname, ts in jst.tables.items():
        tables[bname] = {
            "keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
            "meta": np.asarray(ts.meta),
            "slots": {k: np.asarray(v) for k, v in ts.slots.items()},
            **{c: np.asarray(getattr(ts, c)) for c in
               ("insert_fails", "dedup_unique", "dedup_ids", "dedup_overflow")}}
        if ts.bloom is not None:
            tables[bname]["bloom"] = np.asarray(ts.bloom)
    import jax

    return convert.train_state_from_arrays(
        trainer, int(jst.step), tables,
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.dense)],
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.opt_state)])


def _member_rows(trainer, state):
    """{feature: rows by key} over every bundle member of a port state."""
    out = {}
    for bname, b in trainer.bundles.items():
        for k, f in enumerate(b.features):
            out[f.name] = _port_rows(state.tables[bname], k if b.stacked else 0)
    return out


def _jax_member_rows(trainer, jst):
    import jax

    out = {}
    for bname, b in trainer.bundles.items():
        ts = jst.tables[bname]
        for k, f in enumerate(b.features):
            m = jax.tree.map(lambda a: a[k], ts) if b.stacked else ts
            out[f.name] = _jax_rows(m)
    return out


def _jax_overfilled(ev_kw, capacity=64, steps=6, vocab=300):
    """A JAX WDL trained `steps` steps on more ids than its tables hold."""
    jtr = JaxTrainer(_wdl(JaxWDL, capacity, _ev(jcfg, **ev_kw)), JaxAdagrad(lr=0.1),
                     optax.adam(1e-3))
    jst = jtr.init(0)
    gen = JaxSyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                             vocab=vocab, seed=6)
    for _ in range(steps):
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in gen.batch().items()})
    return jtr, jst


def _port_trainer(capacity, ev_kw, **kw):
    return Trainer(_wdl(WDL, capacity, _ev(tcfg, **ev_kw)), Adagrad(lr=0.1), adam(1e-3),
                   device="cpu", **kw)


def test_evict_tables_matches_jax():
    ev_kw = dict(ttl=dict(steps_to_live=3))
    jtr, jst = _jax_overfilled(ev_kw, capacity=1 << 10)
    trainer = _port_trainer(1 << 10, ev_kw)
    st = _port_from_jax(trainer, jst)
    jst = jtr.evict_tables(jst)
    st = trainer.evict_tables(st)
    assert st.step == int(jst.step) == 6
    got, want = _member_rows(trainer, st), _jax_member_rows(jtr, jst)
    for name in want:
        assert 0 < len(want[name]) < 6 * 64
        _assert_rows_equal(got[name], want[name])


def test_maintain_grows_on_overfill_like_jax():
    """An overfilled table (failed inserts) grows: the same report as the
    JAX `maintain` (occupancy, insert_fails, capacity, grew_to, the dedup
    fields), every key kept with its rows at the new capacity, and the
    bundle pointed at it; training then goes on without failed inserts.
    max_capacity caps the growth."""
    jtr, jst = _jax_overfilled({})
    trainer = _port_trainer(64, {})
    st = _port_from_jax(trainer, jst)
    fails = sum(int(np.asarray(ts.insert_fails).sum()) for ts in jst.tables.values())
    assert fails > 0
    jst, jrep = jtr.maintain(jst)
    st, rep = trainer.maintain(st)
    assert rep == jrep and all("grew_to" in r for r in rep.values()), rep
    for bname, b in trainer.bundles.items():
        C = rep[bname]["grew_to"]
        assert b.table.cfg.capacity == C == jtr.bundles[bname].table.cfg.capacity
        assert st.tables[bname].keys.shape[-1] == C
    got, want = _member_rows(trainer, st), _jax_member_rows(jtr, jst)
    for name in want:
        _assert_rows_equal(got[name], want[name])
    gen = JaxSyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                             vocab=300, seed=7)
    for _ in range(3):
        st, m = trainer.train_step(st, gen.batch())
        assert np.isfinite(float(m["loss"]))
    assert sum(int(ts.insert_fails.sum()) for ts in st.tables.values()) == 0
    _, jst2 = _jax_overfilled({})
    capped = _port_trainer(64, {})
    _, rep2 = capped.maintain(_port_from_jax(capped, jst2), max_capacity=100)
    assert all("grew_to" not in r and r["capacity"] == 64 for r in rep2.values()), rep2


@pytest.mark.parametrize("case", ["hbm_budget_bytes", "tier_async", "storage",
                                  "placement", "sentinel"])
def test_maintain_unported_paths_raise(case):
    """Every path that once raised now runs. placement='plan' on the
    single-device Trainer runs the JAX no-op `maybe_replan` before the
    budgets (the sharded trainer's placer is held in
    tests/test_torch_placement.py) and adds no `placement` record. The
    multi-tier paths and the sentinel's row hygiene, ported since
    (tests/test_torch_multi_tier.py, tests/test_torch_tier_paging.py and
    tests/test_torch_guard.py hold them against the JAX package), now run: a
    tiered table's maintain reports `demoted` and `promoted` and makes one
    MultiTierTable per member (tier_async too), a budget the empty tables
    fit in changes nothing, and the anomaly eviction finds nothing to
    re-initialize in empty tables."""
    tiered = case in ("storage", "tier_async")
    ev = tcfg.EmbeddingVariableOption(storage=tcfg.StorageOption(
        storage_type="hbm_dram")) if tiered else tcfg.EmbeddingVariableOption()
    trainer = Trainer(_wdl(WDL, 64, ev), Adagrad(lr=0.1), device="cpu")
    st = trainer.init()
    kw = {"hbm_budget_bytes": dict(hbm_budget_bytes=1 << 20),
          "tier_async": dict(tier_async=True)}.get(case, {})
    if case == "placement":
        trainer.placement = "plan"
    if case == "sentinel":
        from deeprec_tpu_torch.guard import SentinelConfig

        trainer.sentinel = SentinelConfig(row_evict_quantile=0.9)
    if case == "placement":
        for out, rep in (trainer.maybe_replan(st), trainer.update_placement(st, force=True)):
            assert out is st and rep == {}
    st, rep = trainer.maintain(st, **kw)
    for bname, r in rep.items():
        assert r["capacity"] == 64 and "grew_to" not in r and "auto_tiered" not in r
        assert "placement" not in r
        assert "rows_reinit" not in r
        if tiered:
            assert (r["demoted"], r["promoted"]) == (0, 0)
    members = sum(b.num_tables for b in trainer.bundles.values())
    assert len(trainer._tiers) == (members if tiered else 0)
    st, _ = trainer.maintain(st)  # settles an overlapped round


# -------------------------------------------------------------- checkpoints


def _cbf_ev(mod):
    return _ev(mod, cbf=dict(filter_freq=2, max_element_size=1 << 12),
               ttl=dict(steps_to_live=100))


def test_port_checkpoint_carries_bloom_and_growth_to_jax(tmp_path):
    """The port trains a CBF WDL, grows it, saves; the JAX package restores
    the checkpoint at the grown capacity with the same sketch and rows."""
    trainer = Trainer(_wdl(WDL, 64, _cbf_ev(tcfg)), Adagrad(lr=0.1), adam(1e-3),
                      device="cpu")
    st = trainer.init()
    gen = JaxSyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                             vocab=200, seed=8)
    for _ in range(5):
        st, _ = trainer.train_step(st, gen.batch())
    st, rep = trainer.maintain(st, grow_threshold=0.1)
    C = {r["grew_to"] for r in rep.values()}
    assert len(C) == 1
    st, _ = CheckpointManager(str(tmp_path), trainer).save(st)
    (C,) = C
    jtr = JaxTrainer(_wdl(JaxWDL, C, _cbf_ev(jcfg)), JaxAdagrad(lr=0.1), optax.adam(1e-3))
    jst = JaxCkpt(str(tmp_path), jtr).restore()
    for bname, b in trainer.bundles.items():
        jts = jst.tables[bname]
        assert np.asarray(jts.keys).shape[-1] == C
        np.testing.assert_array_equal(np.asarray(jts.bloom).reshape(st.tables[bname].bloom.shape),
                                      st.tables[bname].bloom.numpy())
    got, want = _member_rows(trainer, st), _jax_member_rows(jtr, jst)
    for name in want:
        assert got[name].keys() == want[name].keys()
        for key, (wv, (wf, wver, _), ws) in want[name].items():
            gv, (gf, gver, _), gs = got[name][key]
            np.testing.assert_array_equal(gv, wv)
            assert (gf, gver) == (wf, wver)
            np.testing.assert_array_equal(gs["accum"], ws["accum"])


def test_jax_checkpoint_carries_bloom_and_growth_to_port(tmp_path):
    """The mirror: JAX trains and grows a CBF WDL and saves; a port trainer
    at the grown capacity restores the sketch and rows, then both take one
    more step with the same admission."""
    jtr = JaxTrainer(_wdl(JaxWDL, 64, _cbf_ev(jcfg)), JaxAdagrad(lr=0.1), optax.adam(1e-3))
    jst = jtr.init(0)
    gen = JaxSyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                             vocab=200, seed=9)
    for _ in range(5):
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in gen.batch().items()})
    jst, rep = jtr.maintain(jst, grow_threshold=0.1)
    (C,) = {r["grew_to"] for r in rep.values()}
    jst, _ = JaxCkpt(str(tmp_path), jtr).save(jst)
    trainer = Trainer(_wdl(WDL, C, _cbf_ev(tcfg)), Adagrad(lr=0.1), adam(1e-3),
                      device="cpu")
    st = CheckpointManager(str(tmp_path), trainer).restore()
    for bname in trainer.bundles:
        ts, jts = st.tables[bname], jst.tables[bname]
        assert ts.keys.shape[-1] == C
        np.testing.assert_array_equal(ts.bloom.numpy(),
                                      np.asarray(jts.bloom).reshape(ts.bloom.shape))
    got, want = _member_rows(trainer, st), _jax_member_rows(jtr, jst)
    for name in want:
        assert got[name].keys() == want[name].keys()
    b = gen.batch()
    jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    st, _ = trainer.train_step(st, b)
    for bname, bnd in trainer.bundles.items():
        ts, jts = st.tables[bname], jst.tables[bname]
        np.testing.assert_array_equal(ts.bloom.numpy(),
                                      np.asarray(jts.bloom).reshape(ts.bloom.shape))
        np.testing.assert_array_equal(bnd.table.size(ts).numpy(),
                                      np.atleast_1d(np.asarray(
                                          (np.asarray(jts.keys) != SENTINEL).sum(-1))))
