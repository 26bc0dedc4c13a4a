"""The port's multi-tier tables (`deeprec_tpu_torch/embedding/multi_tier.py`)
held against the JAX package's on the CPU, one case per test of
tests/test_multi_tier.py, plus the overlapped sync and bf16 tables.

Each case builds its table state in JAX, carries it into the port slot for
slot (convert.py) just before the first `sync`, and then drives the same
tier operations in both packages. Demote order follows the slots (numpy's
argsort over the occupied slots in slot order), so a carried state demotes
the same keys even where freqs tie. What is compared, per key: the
`TierStats`, the device rows (values within RTOL — initializer rows of keys
each package re-creates on its own differ by up to 65 f32 ulps of erfinv;
moved, promoted and demoted rows are exact), metadata and optimizer slots
exactly, the host store's export and the disk log's contents exactly, and
`lookup_with_fallback` rows."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.embedding.multi_tier import MultiTierTable as JaxMT
from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
from deeprec_tpu.ops.packed import scatter_rows_any
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.optim.apply import ensure_slots as jax_ensure_slots
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding import MultiTierTable, TierStats
from deeprec_tpu_torch.embedding.table import EmbeddingTable

torch.set_num_threads(1)

SENTINEL = int(np.iinfo(np.int32).min)
# Initializer rows: torch.erfinv and XLA's erfinv differ by at most 65 f32
# ulps; every other row moves unchanged.
RTOL = 1e-5
FILLS = (("accum", 0.1),)


def _cfgs(capacity=64, strategy="lfu", three=None, value_dtype="float32"):
    """(JAX config, port config) of test_multi_tier.py's tables: "mt" with
    HBM_DRAM, or "mt3" with HBM_DRAM_SSD at `three` = (path, host_capacity)."""
    out = []
    for mod in (jcfg, tcfg):
        if three is None:
            storage = mod.StorageOption(storage_type=mod.StorageType.HBM_DRAM,
                                        cache_strategy=strategy)
            name = "mt"
        else:
            storage = mod.StorageOption(storage_type=mod.StorageType.HBM_DRAM_SSD,
                                        storage_path=three[0] + ("_jax" if mod is jcfg else "_port"),
                                        host_capacity=three[1])
            name = "mt3"
        out.append(mod.TableConfig(name=name, dim=4, capacity=capacity, value_dtype=value_dtype,
                                   ev=mod.EmbeddingVariableOption(storage=storage)))
    return out


class Pair:
    """One table in both packages: JAX table and MultiTierTable, port table
    and MultiTierTable."""

    def __init__(self, fills=None, **kw):
        jc, tc = _cfgs(**kw)
        self.jt, self.tt = JaxTable(jc), EmbeddingTable(tc)
        self.jmt = JaxMT(self.jt, high_watermark=0.75, low_watermark=0.5, slot_fills=fills)
        self.pmt = MultiTierTable(self.tt, high_watermark=0.75, low_watermark=0.5,
                                  slot_fills=fills)

    def carry(self, js):
        arrays = {"keys": np.asarray(js.keys), "values": np.asarray(js.values.astype(jnp.float32)),
                  "meta": np.asarray(js.meta), "insert_fails": np.asarray(js.insert_fails),
                  "slots": {k: np.asarray(v) for k, v in js.slots.items()}}
        return convert.table_state_from_arrays(self.tt.cfg, arrays, 1, "cpu")

    def sync(self, js, ps, step, force=False):
        js, jst = self.jmt.sync(js, step, force=force)
        ps, pst = self.pmt.sync(ps, step, force=force)
        assert dataclasses.asdict(pst) == dataclasses.asdict(jst)
        return js, ps, pst

    def lookup(self, js, ps, ids, step):
        js, _ = self.jt.lookup_unique(js, jnp.asarray(ids, jnp.int32), step=step)
        self.tt.lookup_unique(ps, torch.as_tensor(np.asarray(ids, np.int32))[None], step=step)
        return js

    def check(self, js, ps):
        """Device rows, the host store and the disk log agree per key."""
        _assert_rows(_port_rows(ps), _jax_rows(js))
        _same_store(_store_by_key(self.pmt.host), _store_by_key(self.jmt.host))
        _same_store(_disk_by_key(self.pmt.disk), _disk_by_key(self.jmt.disk))

    def fallback(self, js, ps, ids):
        want = np.asarray(self.jmt.lookup_with_fallback(js, jnp.asarray(ids, jnp.int32)),
                          np.float32)
        got = self.pmt.lookup_with_fallback(ps, torch.as_tensor(np.asarray(ids, np.int32)))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=0)
        return got.float().numpy()


def _by_key(keys, values, meta, slots):
    keys = np.asarray(keys)
    return {int(keys[i]): (np.asarray(values, np.float32)[i], tuple(np.asarray(meta)[:, i]),
                           {k: np.asarray(v).reshape(len(keys), -1)[i] for k, v in slots.items()})
            for i in np.nonzero(keys != SENTINEL)[0]}


def _jax_rows(js):
    return _by_key(js.keys, js.values.astype(jnp.float32), js.meta, js.slots)


def _port_rows(ps):
    return _by_key(ps.keys[0], ps.values[0].float(), ps.meta[0],
                   {k: v[0] for k, v in ps.slots.items() if not k.startswith("scalar/")})


def _assert_rows(got, want):
    assert got.keys() == want.keys()
    for key, (wv, wm, ws) in want.items():
        gv, gm, gs = got[key]
        np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0, err_msg=str(key))
        assert gm == wm, key
        for name in ws:
            np.testing.assert_array_equal(gs[name], ws[name], err_msg=f"{key} {name}")


def _store_by_key(kv):
    if kv is None:
        return None
    k, v, f, ver = kv.export()
    return {int(k[i]): (v[i], int(f[i]), int(ver[i])) for i in range(len(k))}


def _disk_by_key(disk):
    if disk is None:
        return None
    keys = np.fromiter(disk.index, np.int64, len(disk.index))
    v, f, ver, found = disk.get(keys)
    assert found.all()
    return {int(keys[i]): (v[i], int(f[i]), int(ver[i])) for i in range(len(keys))}


def _same_store(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return True
    assert got.keys() == want.keys()
    for k, (v, f, ver) in want.items():
        np.testing.assert_array_equal(got[k][0], v, err_msg=str(k))
        assert got[k][1:] == (f, ver), k
    return True


def _marked(p, n=52, value=None, per_id=False):
    """JAX state with n keys inserted at step 0, optionally every row
    written to `value` (or id + 1 with per_id)."""
    js = p.jt.create()
    js, res = p.jt.lookup_unique(js, jnp.arange(n, dtype=jnp.int32), step=0)
    if per_id:
        vals = jnp.broadcast_to((jnp.asarray(res.uids, jnp.float32) + 1.0)[:, None],
                                res.embeddings.shape)
        js = p.jt.scatter_update(js, res.slot_ix, vals, mask=res.valid)
    elif value is not None:
        js = p.jt.scatter_update(js, res.slot_ix, jnp.full_like(res.embeddings, value),
                                 mask=res.valid)
    return js


def _with_adagrad(p):
    js = jax_ensure_slots(p.jt, p.jt.create(), JaxAdagrad(lr=0.1, initial_accumulator_value=0.1))
    js, _ = p.jt.lookup_unique(js, jnp.arange(52, dtype=jnp.int32), step=0)
    return js


# ------------------------------------------------ test_multi_tier.py, case by case


def test_demotion_on_pressure_and_fallback_serving():
    p = Pair()
    js = p.jt.create()
    for _ in range(5):
        js, _ = p.jt.lookup_unique(js, jnp.arange(10, dtype=jnp.int32), step=1)
    js, _ = p.jt.lookup_unique(js, jnp.arange(10, 52, dtype=jnp.int32), step=2)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 3)
    assert st.demoted > 0 and st.device_size <= 32 and st.host_size == st.demoted
    p.check(js, ps)
    on_dev = set(ps.keys[0].tolist())
    assert set(range(10)) <= on_dev  # hot keys stay (LFU)
    assert np.isfinite(p.fallback(js, ps, np.arange(52))).all()


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_row_cache_serves_the_same_fallback_rows(value_dtype):
    """A MultiTierTable with the serving row cache gives the same fallback
    rows, bit for bit, as one without: on its first read (misses, filled
    from the host store) and its second (hits), and against the JAX
    MultiTierTable with its row cache. A sync boundary bumps the tier
    revision, so no cached row survives it."""
    p = Pair(value_dtype=value_dtype)
    jmt_c = JaxMT(p.jt, high_watermark=0.75, low_watermark=0.5, row_cache_bytes=1 << 16)
    pmt_c = MultiTierTable(p.tt, high_watermark=0.75, low_watermark=0.5,
                           row_cache_bytes=1 << 16)
    js = _marked(p, per_id=True)
    ps = p.carry(js)
    ps_c = p.carry(js)
    js_c = js
    js, ps, st = p.sync(js, ps, 1)
    js_c, _ = jmt_c.sync(js_c, 1)
    ps_c, st_c = pmt_c.sync(ps_c, 1)
    assert st.demoted > 0 and dataclasses.asdict(st_c) == dataclasses.asdict(st)
    ids = torch.as_tensor(np.arange(60, dtype=np.int32))
    plain = p.pmt.lookup_with_fallback(ps, ids)
    want = np.asarray(jmt_c.lookup_with_fallback(js_c, jnp.asarray(ids.numpy())), np.float32)
    for rnd in range(2):
        got = pmt_c.lookup_with_fallback(ps_c, ids)
        assert torch.equal(got, plain), rnd
        np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL, atol=0)
    snap = pmt_c.row_cache.snapshot()
    # every distinct id asks the cache each round; only stored rows enter it
    assert snap["hits"] == st.demoted and snap["misses"] == 2 * 60 - st.demoted
    assert snap["entries"] == st.demoted
    rev = pmt_c._tier_rev
    ps_c, _ = pmt_c.sync(ps_c, 2, force=True)
    assert pmt_c._tier_rev > rev
    assert pmt_c.row_cache.get_current((0).to_bytes(8, "little", signed=True)) is None


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_promotion_restores_values(value_dtype):
    p = Pair(value_dtype=value_dtype)
    js = _marked(p, value=3.25)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0
    p.check(js, ps)
    demoted = sorted(set(range(52)) - set(ps.keys[0].tolist()))
    k = demoted[0]
    js = p.lookup(js, ps, [k], 2)
    js, ps, st2 = p.sync(js, ps, 3)
    assert st2.promoted >= 1 and st2.host_size < st.host_size
    p.check(js, ps)
    row = p.tt.lookup_readonly(ps, torch.tensor([[k]], dtype=torch.int32))[0, 0]
    assert torch.equal(row.float(), torch.full((4,), 3.25))


def test_demote_rebuild_restores_slot_init_values():
    p = Pair(fills=FILLS)
    js = _with_adagrad(p)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0
    p.check(js, ps)
    free = ps.keys[0] == SENTINEL
    assert free.any() and torch.all(ps.slots["accum"][0][free] == 0.1)


def test_grow_restores_slot_init_values():
    p = Pair(capacity=32)
    opt = JaxAdagrad(lr=0.1, initial_accumulator_value=0.1)
    js = jax_ensure_slots(p.jt, p.jt.create(), opt)
    js, _ = p.jt.lookup_unique(js, jnp.arange(20, dtype=jnp.int32), step=0)
    ps = p.carry(js)
    js2 = p.jt.grow(js, 128, slot_fills=FILLS)
    ps2 = p.tt.grow(ps, 128, slot_fills=FILLS)
    _assert_rows(_port_rows(ps2), _jax_rows(js2))
    free = ps2.keys[0] == SENTINEL
    assert torch.all(ps2.slots["accum"][0][free] == 0.1) and int(p.tt.size(ps2)) == 20


def test_three_tier_spills_host_overflow_to_disk(tmp_path):
    p = Pair(three=(str(tmp_path / "tier"), 16))
    js = _marked(p, per_id=True)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0 and st.spilled > 0 and st.host_size <= 16
    assert st.disk_size == st.spilled
    p.check(js, ps)
    emb = p.fallback(js, ps, np.arange(52))
    np.testing.assert_array_equal(emb[:, 0], np.arange(52) + 1.0)


def test_three_tier_promotes_from_disk(tmp_path):
    p = Pair(three=(str(tmp_path / "tier"), 16))
    js = _marked(p, value=7.5)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.spilled > 0
    disk_key = int(next(iter(p.pmt.disk.index)))
    assert disk_key in p.jmt.disk.index
    js = p.lookup(js, ps, [disk_key], 2)
    js, ps, st2 = p.sync(js, ps, 3)
    assert st2.promoted >= 1
    p.check(js, ps)
    row = p.tt.lookup_readonly(ps, torch.tensor([[disk_key]], dtype=torch.int32))[0, 0]
    assert torch.equal(row, torch.full((4,), 7.5))
    assert disk_key not in p.pmt.disk.index


def test_disk_kv_persistence(tmp_path):
    """test_disk_kv_persistence's sequence on the port's DiskKV: an update
    wins, a reopen by the sidecar and by a log scan, a tail appended after
    the last save survives a reopen."""
    from deeprec_tpu_torch.embedding.multi_tier import DiskKV

    p = str(tmp_path / "store.ssd")
    d = DiskKV(p, dim=3)
    d.put(np.asarray([1, 2, 3], np.int64), np.eye(3, dtype=np.float32),
          np.asarray([5, 6, 7], np.int32), np.asarray([1, 1, 1], np.int32))
    d.put(np.asarray([2], np.int64), np.full((1, 3), 9.0, np.float32))
    d.close()
    d2 = DiskKV(p, dim=3)
    vals, freqs, _, found = d2.get(np.asarray([1, 2, 3, 4], np.int64))
    assert found.tolist() == [True, True, True, False] and freqs[0] == 5
    np.testing.assert_array_equal(vals[1], 9.0)
    import os

    os.remove(p + ".idx")
    d3 = DiskKV(p, dim=3)
    vals3, _, _, found3 = d3.get(np.asarray([2], np.int64))
    assert found3[0] and vals3[0, 0] == 9.0
    d3.save()
    d3.put(np.asarray([2], np.int64), np.full((1, 3), 11.0, np.float32))
    d3.put(np.asarray([9], np.int64), np.full((1, 3), 4.0, np.float32))
    d3._f.flush()
    vals4, _, _, found4 = DiskKV(p, dim=3).get(np.asarray([2, 9], np.int64))
    assert found4.all()
    np.testing.assert_array_equal(vals4[:, 0], [11.0, 4.0])


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_spill_and_load(tmp_path, writer, reader):
    """A spill loads into a fresh instance of either package."""
    p = Pair()
    js = _marked(p)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.host_size > 0
    path = str(tmp_path / "tier.bin")
    {"port": p.pmt, "jax": p.jmt}[writer].spill(path)
    fresh = Pair()
    mt = {"port": fresh.pmt, "jax": fresh.jmt}[reader]
    mt.load(path)
    assert len(mt.host) == st.host_size
    _same_store(_store_by_key(mt.host), _store_by_key(p.jmt.host))


def test_demote_promote_preserves_optimizer_slots():
    p = Pair(fills=FILLS)
    js = _with_adagrad(p)
    keys = np.asarray(js.keys)
    slot7 = int(np.nonzero(keys == 7)[0][0])
    occ0 = np.asarray(p.jt.occupied(js))
    put = jnp.asarray([slot7], jnp.int32)
    js = js.replace(
        values=scatter_rows_any(js.values, put, jnp.full((1, 4), 2.5), js.capacity),
        slots={**js.slots, "accum": scatter_rows_any(js.slots["accum"], put,
                                                     jnp.full((1, 4), 7.75), js.capacity)},
    ).replace_meta(freq=jnp.where(jnp.asarray(occ0), 5, js.freq).at[slot7].set(1))
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0 and 7 not in set(ps.keys[0].tolist())
    p.check(js, ps)
    js = p.lookup(js, ps, [7], 2)
    js, ps, st2 = p.sync(js, ps, 3)
    assert st2.promoted >= 1
    p.check(js, ps)
    slot = int(torch.nonzero(ps.keys[0] == 7)[0, 0])
    assert torch.all(ps.values[0, slot] == 2.5) and torch.all(ps.slots["accum"][0, slot] == 7.75)


def test_fresh_instance_load_serves_all_tiers(tmp_path):
    p = Pair(three=(str(tmp_path / "tier"), 16))
    js = _marked(p, value=4.5)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0 and st.spilled > 0
    p.pmt.spill(str(tmp_path / "host.spill"))
    tc = _cfgs(three=(str(tmp_path / "tier"), 16))[1]
    mt2 = MultiTierTable(EmbeddingTable(tc), high_watermark=0.75, low_watermark=0.5)
    mt2.load(str(tmp_path / "host.spill"))
    assert mt2.disk is not None and len(mt2.disk) == st.spilled
    emb = mt2.lookup_with_fallback(ps, torch.arange(52, dtype=torch.int32))
    assert torch.all(emb[:, 0] == 4.5)
    mt3 = MultiTierTable(EmbeddingTable(_cfgs()[1]))
    mt3.load(str(tmp_path / "never_written.bin"))
    assert mt3.host is None


def test_reference_storage_type_names_resolve():
    """All 13 reference StorageType names and field numbers resolve as in
    the JAX package; the port's own values pass; unknown ones raise."""
    S = tcfg.StorageType
    names = ["DEFAULT", "HBM", "DRAM", "PMEM_MEMKIND", "PMEM_LIBPMEM", "SSDHASH", "LEVELDB",
             "DRAM_PMEM", "DRAM_SSDHASH", "HBM_DRAM", "DRAM_LEVELDB", "DRAM_PMEM_SSDHASH",
             "HBM_DRAM_SSDHASH", 0, 1, 2, 3, 4, 5, 6, 11, 12, 13, 14, 101, 102,
             "hbm_dram", "hbm_dram_ssd", "hbm", "dram"]
    for name in names:
        want = jcfg.StorageType.from_reference(name).value
        assert S.from_reference(name).value == want, name
        assert tcfg.StorageOption(storage_type=name).storage_type.value == want, name
    assert S.from_reference("DRAM_SSDHASH") is S.HBM_DRAM_SSD
    with pytest.raises(ValueError, match="field numbers"):
        S.from_reference(57)
    with pytest.raises(ValueError, match="unknown storage type"):
        S.from_reference("FLOPPY_DISK")


def test_diskkv_compaction_bounds_log(tmp_path):
    """test_diskkv_compaction_bounds_log through a three-tier table's own
    disk log: repeated spills of the same keys stay bounded."""
    from deeprec_tpu_torch.embedding.multi_tier import DiskKV

    kv = DiskKV(str(tmp_path / "log.ssd"), dim=4)
    keys = np.arange(256, dtype=np.int64)
    for r in range(16):
        kv.put(keys, np.full((256, 4), float(r), np.float32), np.full(256, r, np.int32),
               np.zeros(256, np.int32))
    assert kv._log_records() <= 3 * 256
    vals, _, _, found = kv.get(keys)
    assert found.all() and np.all(vals == 15.0)


def test_diskkv_batched_reads_coalesce(tmp_path):
    """A promote burst from a three-tier table's disk tier: a contiguous
    log reads in one run (tests/test_torch_host_kv.py holds the run counts
    against the JAX DiskKV)."""
    p = Pair(three=(str(tmp_path / "tier"), 8))
    js = _marked(p, value=2.0)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.spilled > 0
    keys = np.sort(np.fromiter(p.pmt.disk.index, np.int64))
    _, _, _, found = p.pmt.disk.get(keys)
    assert found.all() and p.pmt.disk.last_reads == 1


# ------------------------------------------------ beyond test_multi_tier.py


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_sync_async_and_drain_match_jax(value_dtype):
    """sync, then sync_async (the device half, the background round) and
    drain, then a promote through the next round's candidates: the
    reports, device rows, host store and fallback rows per key as JAX."""
    p = Pair(fills=FILLS, value_dtype=value_dtype)
    js = _with_adagrad(p)
    ps = p.carry(js)
    js, ps, _ = p.sync(js, ps, 1)
    js = p.lookup(js, ps, np.arange(52, 100), 2)
    ps = p.carry(js)  # one layout again: the rebuild's claim races differ
    js, jst = p.jmt.sync_async(js, 3)
    ps, pst = p.pmt.sync_async(ps, 3)
    assert dataclasses.asdict(pst) == dataclasses.asdict(jst) and pst.demoted > 0
    js, jst = p.jmt.drain(js)
    ps, pst = p.pmt.drain(ps)
    assert dataclasses.asdict(pst) == dataclasses.asdict(jst)
    p.check(js, ps)
    back = sorted(set(range(100)) - set(ps.keys[0].tolist()))[:3]
    js = p.lookup(js, ps, back, 4)
    js, jst = p.jmt.sync_async(js, 5)
    ps, pst = p.pmt.sync_async(ps, 5)
    js, jst = p.jmt.drain(js)
    ps, pst = p.pmt.drain(ps)
    assert pst.promoted == jst.promoted == 3
    p.check(js, ps)
    p.fallback(js, ps, np.arange(100))


def test_lookup_with_fallback_before_any_sync_and_member_check():
    """Nothing demoted: the device rows (and initializer rows) come back;
    a stacked [T > 1] state is refused."""
    p = Pair()
    js = _marked(p, value=1.5)
    ps = p.carry(js)
    p.fallback(js, ps, np.arange(60))
    stacked = p.tt.create(2, "cpu")
    with pytest.raises(ValueError, match="one table"):
        p.pmt.sync(stacked, 0)
    assert TierStats().demoted == 0
    cached = MultiTierTable(p.tt, row_cache_bytes=1 << 20)
    assert cached.row_cache is not None and cached.row_cache.capacity_bytes == 1 << 20


def test_promote_then_demote_ranks_the_pre_promote_freqs():
    """One sync that promotes and then demotes: the demote ranks the freqs
    read before the promote added the tier freq (as the JAX sync does), so
    the promoted keys, tied with the rest before the promote, are demoted
    in slot order like them; the same keys go to the host as in JAX."""
    p = Pair()
    js = _marked(p, value=1.0)
    ps = p.carry(js)
    js, ps, _ = p.sync(js, ps, 1)
    demoted = sorted(set(range(52)) - set(ps.keys[0].tolist()))
    js, _ = p.jt.lookup_unique(js, jnp.asarray(demoted[:10] + list(range(100, 110)),
                                               jnp.int32), step=2)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 3)
    assert st.promoted == 10 and st.demoted > 0
    p.check(js, ps)
