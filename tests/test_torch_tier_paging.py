"""Tier paging and the trainer's tier half in the port, held against the
JAX package on the CPU: one case per test of tests/test_tier_paging.py
(the probe and fold core, the promote-scan diet, deduplicated fallback
serving, the pump's races, the trainer's staged pipeline, lookahead and
async maintain), with these differences:
  * the two row-cache tests wait for `serving/reuse` (ROADMAP queue A item
    7) and the obs-counter test for `obs/` (item 8); the counters are plain
    attributes here and are checked in the fold tests;
  * the port has no sharded trainer, so the refusal test checks that
    `enable_tier_paging` without a tiered bundle raises ValueError;
  * the fixed-chunk compile test becomes a fixed-chunk fold with jittering
    candidate counts (the port compiles nothing): one row write per chunk;
  * the lookahead parity holds the port's "lookahead" against its own
    "off".
And beyond them: `fold_candidates` per key against JAX on carried state,
a demoted key in a staged batch folded before its lookup, and
`maintain(hbm_budget_bytes=)` / `tier_async` reports equal to the JAX
`Trainer`'s from one carried state (no train step in between: dense math
differs within tolerance and claim races move slots).

Every threaded test bounds its waits and closes its pager in `finally`."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.data import SyntheticCriteo as JaxSyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.ops.packed import scatter_rows_any
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.embedding.table import COUNTERS
from deeprec_tpu_torch.embedding.tier_prefetch import TierPrefetcher
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.trainer import Trainer, stack_batches
from test_torch_multi_tier import (  # noqa: E402  (shared helpers)
    FILLS, SENTINEL, Pair, _assert_rows, _by_key, _jax_rows, _marked, _same_store,
    _store_by_key, _with_adagrad,
)

torch.set_num_threads(1)

WAIT = 5.0  # seconds, every bounded wait on a pump


def demote_marked(p, n=52, value=3.25):
    """Both packages from one carried state: n keys written to `value`,
    demoted past the watermark. Returns (JAX state, port state, demoted
    keys)."""
    js = _marked(p, n=n, value=value)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 0
    return js, ps, sorted(set(range(n)) - set(ps.keys[0].tolist()))


def _fold(p, js, ps, jc, pc, chunk=16):
    js, jf, jd = p.jmt.fold_candidates(js, jc, chunk=chunk)
    ps, pf, pd = p.pmt.fold_candidates(ps, pc, chunk=chunk)
    assert (pf, pd) == (jf, jd)
    return js, ps, pf, pd


def _same_cand(pc, jc):
    assert (pc is None) == (jc is None)
    if pc is None:
        return
    for k in ("keys", "rows", "freqs", "vers", "from_disk"):
        np.testing.assert_array_equal(pc[k], np.asarray(jc[k]), err_msg=k)


def _prefetch_counts(p, since=(0, 0, 0, 0)):
    """The port table's deeprec_tier_prefetch_{probed,hits,stale_dropped,
    folds} counters (the obs plane's; the table keeps no attributes for
    them), less `since`."""
    reg, lab = obs_metrics.default_registry(), {"table": p.pmt.table.cfg.name}
    return tuple(reg.counter(f"deeprec_tier_prefetch_{n}", "", lab).value - s
                 for n, s in zip(("probed", "hits", "stale_dropped", "folds"), since))


def _probe(p, ids):
    jc, pc = p.jmt.probe_rows(np.asarray(ids, np.int64)), p.pmt.probe_rows(np.asarray(ids, np.int64))
    _same_cand(pc, jc)
    return jc, pc


# ------------------------------------------------------ probe / fold core


def test_probe_rows_dedups_and_stamps_revision():
    p = Pair()
    c0 = _prefetch_counts(p)
    js, ps, demoted = demote_marked(p)
    jc, pc = _probe(p, demoted[:5] * 3 + [9999, 10000])
    assert sorted(pc["keys"].tolist()) == sorted(demoted[:5])
    assert pc["rev"] == p.pmt._gather_gen and pc["rows"].shape[1] == 4
    assert _probe(p, [9999]) == (None, None)
    assert _prefetch_counts(p, c0)[:2] == (8, 5)


def test_fold_restores_values_and_optimizer_slots_bit_exact():
    p = Pair(fills=FILLS)
    c0 = _prefetch_counts(p)
    js = _with_adagrad(p)
    slot7 = int(np.nonzero(np.asarray(js.keys) == 7)[0][0])
    occ0 = np.asarray(p.jt.occupied(js))
    put = jnp.asarray([slot7], jnp.int32)
    js = js.replace(
        values=scatter_rows_any(js.values, put, jnp.full((1, 4), 2.5), js.capacity),
        slots={**js.slots, "accum": scatter_rows_any(js.slots["accum"], put,
                                                     jnp.full((1, 4), 7.75), js.capacity)},
    ).replace_meta(freq=jnp.where(jnp.asarray(occ0), 5, js.freq).at[slot7].set(1))
    ps = p.carry(js)
    js, ps, _ = p.sync(js, ps, 1)
    jc, pc = _probe(p, [7])
    js = p.lookup(js, ps, [7], 2)
    js, ps, folded, dropped = _fold(p, js, ps, jc, pc)
    assert (folded, dropped) == (1, 0)
    p.check(js, ps)
    slot = int(torch.nonzero(ps.keys[0] == 7)[0, 0])
    assert torch.all(ps.values[0, slot] == 2.5) and torch.all(ps.slots["accum"][0, slot] == 7.75)
    assert _probe(p, [7]) == (None, None)  # the tier copy is consumed
    assert _prefetch_counts(p, c0)[3] == 1 and p.pmt.folded_rows == 1 \
        and p.pmt.fold_bytes == 32


def test_fold_loses_to_newer_device_row_bit_exact():
    p = Pair()
    c0 = _prefetch_counts(p)
    js, ps, demoted = demote_marked(p)
    k = demoted[0]
    jc, pc = _probe(p, [k])
    host_freq = int(pc["freqs"][0])
    for step in range(2, 4 + host_freq):
        js = p.lookup(js, ps, [k], step)
    res = p.tt.lookup_unique(ps, torch.tensor([[k]], dtype=torch.int32), step=4 + host_freq)
    p.tt.scatter_update(ps, res.slot_ix, torch.full((1, 1, 4), -8.5), mask=res.valid)
    js, jres = p.jt.lookup_unique(js, jnp.asarray([k], jnp.int32), step=4 + host_freq)
    js = p.jt.scatter_update(js, jres.slot_ix, jnp.full_like(jres.embeddings, -8.5),
                             mask=jres.valid)
    before = p.tt.lookup_readonly(ps, torch.tensor([[k]], dtype=torch.int32)).clone()
    js, ps, folded, dropped = _fold(p, js, ps, jc, pc)
    assert (folded, dropped) == (0, 1) and _prefetch_counts(p, c0)[2] == 1
    assert torch.equal(p.tt.lookup_readonly(ps, torch.tensor([[k]], dtype=torch.int32)), before)
    assert p.pmt.probe_rows(np.array([k])) is not None and k in p.pmt._retry_keys
    p.check(js, ps)
    js, ps, _ = p.sync(js, ps, 50)
    assert k not in p.pmt._retry_keys and k not in p.jmt._retry_keys
    p.check(js, ps)


def test_fold_inserts_missing_keys_ahead_of_lookup():
    from deeprec_tpu_torch.embedding.table import META_DIRTY, META_FREQ, META_VERSION

    p = Pair()
    js, ps, demoted = demote_marked(p)
    jc, pc = _probe(p, demoted[:4])
    assert not set(demoted[:4]) & set(ps.keys[0].tolist())
    js, ps, folded, dropped = _fold(p, js, ps, jc, pc)
    assert (folded, dropped) == (4, 0)
    p.check(js, ps)
    for i, k in enumerate(pc["keys"].tolist()):
        slot = int(torch.nonzero(ps.keys[0] == k)[0, 0])
        assert torch.all(ps.values[0, slot] == 3.25)
        meta = ps.meta[0, :, slot].tolist()
        assert (meta[META_FREQ], meta[META_VERSION], meta[META_DIRTY]) == (
            int(pc["freqs"][i]), int(pc["vers"][i]), 1)
    assert _probe(p, demoted[:4]) == (None, None)


def test_fold_erase_keeps_other_packages_valid():
    p = Pair()
    js, ps, demoted = demote_marked(p)
    jb, pb = _probe(p, demoted[3:6])
    ja, pa = _probe(p, demoted[:3])
    js, ps, folded, _ = _fold(p, js, ps, ja, pa)
    assert folded == 3 and pb["rev"] == p.pmt._gather_gen
    js, ps, folded, dropped = _fold(p, js, ps, jb, pb)
    assert (folded, dropped) == (3, 0)
    p.check(js, ps)


def test_fold_drops_whole_package_on_revision_change():
    p = Pair()
    c0 = _prefetch_counts(p)
    js, ps, demoted = demote_marked(p)
    jc, pc = _probe(p, demoted[:3])
    js = p.lookup(js, ps, demoted[:3], 2)
    js, ps, _ = p.sync(js, ps, 3)
    assert pc["rev"] != p.pmt._gather_gen
    js, ps, folded, dropped = _fold(p, js, ps, jc, pc)
    assert (folded, dropped) == (0, 3) and _prefetch_counts(p, c0)[2] == 3
    p.check(js, ps)


def test_fold_fixed_chunk_with_jittering_counts():
    """Packages of 3, 2, 5 and 1 keys fold through chunks of 8 (the one
    package of 9 in two chunks): the JAX counts per fold, one row write
    (#5: values and each slot) per chunk that holds a passing row, the
    rows per key."""
    p = Pair(capacity=128)
    js = p.jt.create()
    js, res = p.jt.lookup_unique(js, jnp.arange(100, dtype=jnp.int32), step=0)
    js = p.jt.scatter_update(js, res.slot_ix, jnp.full_like(res.embeddings, 1.5), mask=res.valid)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 1)
    assert st.demoted > 8
    demoted = sorted(int(k) for k in p.pmt.host.export()[0])
    js = p.lookup(js, ps, demoted, 2)
    writes = p.pmt.fold_writes
    for g in (demoted[:3], demoted[3:5], demoted[5:10], demoted[10:11], demoted[11:20]):
        jc, pc = _probe(p, g)
        js, ps, folded, _ = _fold(p, js, ps, jc, pc, chunk=8)
        assert folded == len(g)
    assert p.pmt.fold_writes - writes == 6
    p.check(js, ps)


# ------------------------------------------------------ promote-scan diet


def _replay(scan_diet, steps=14, capacity=64, vocab=90, seed=3):
    """tests/test_tier_paging.py's rotated-id stream through sync
    boundaries, on the port alone from one empty state."""
    p = Pair(capacity=capacity)
    p.pmt.scan_diet = scan_diet
    ps = p.tt.create(1, "cpu")
    rng = np.random.default_rng(seed)
    promotes = []
    for i in range(steps):
        ids = rng.integers((i * 7) % 30, vocab, size=24)
        p.tt.lookup_unique(ps, torch.as_tensor(ids, dtype=torch.int32)[None], step=2 * i)
        if i % 3 == 2:
            ps, st = p.pmt.sync(ps, step=2 * i + 1)
            promotes.append((st.promoted, st.demoted))
    return ps, sorted(int(k) for k in p.pmt.host.export()[0]), promotes


def test_scan_diet_bit_identical_promote_outcomes():
    s_on, host_on, prom_on = _replay(scan_diet=True)
    s_off, host_off, prom_off = _replay(scan_diet=False)
    assert prom_on == prom_off and any(p > 0 for p, _ in prom_on)
    assert host_on == host_off
    for f in ("keys", "values", "meta", *COUNTERS):
        assert torch.equal(getattr(s_on, f), getattr(s_off, f)), f


def test_lookup_with_fallback_dedup_parity():
    """One store probe over the distinct ids; rows equal the JAX package's
    and a per-position reference."""
    p = Pair()
    js, ps, _ = demote_marked(p)
    ids = np.random.default_rng(0).choice(np.arange(52), size=400).astype(np.int32)
    calls, orig = [], p.pmt.host.get
    p.pmt.host.get = lambda keys: (calls.append(len(keys)), orig(keys))[1]
    emb = p.fallback(js, ps, ids)
    p.pmt.host.get = orig
    assert calls == [len(np.unique(ids))]
    ref = p.tt.lookup_readonly(ps, torch.as_tensor(ids)[None])[0].numpy().copy()
    vals, _, _, found = p.pmt.host.get(ids.astype(np.int64))
    ref[found] = vals[found][:, :4]
    np.testing.assert_array_equal(emb, ref)


# ------------------------------------------------- prefetcher pump races


def _pump_fixture():
    p = Pair()
    js, ps, demoted = demote_marked(p)
    tiers = {("b", ()): p.pmt}
    pager = TierPrefetcher(resolve=tiers.get, extract=lambda batch: {("b", ()): batch["ids"]},
                           depth=4)
    return p, js, ps, demoted, pager


def test_pump_gathers_and_training_thread_folds():
    p, js, ps, demoted, pager = _pump_fixture()
    try:
        pager.observe({"ids": np.asarray(demoted[:4], np.int64)})
        pager.observe({"ids": np.asarray(demoted[2:6], np.int64)})
        assert pager.drain(WAIT)
        assert pager.pending_keys() == [("b", ())]
        cand = pager.take(("b", ()))
        assert sorted(cand["keys"].tolist()) == sorted(demoted[:6])
        jc = p.jmt.probe_rows(cand["keys"])
        _same_cand(cand, jc)
        js = p.lookup(js, ps, demoted[:6], 2)
        js, ps, folded, dropped = _fold(p, js, ps, jc, cand)
        assert (folded, dropped) == (6, 0)
        assert pager.take(("b", ())) is None
        p.check(js, ps)
    finally:
        pager.close()


def test_pump_killed_mid_gather_leaves_stores_consistent():
    p, js, ps, demoted, pager = _pump_fixture()
    try:
        host_before = sorted(int(k) for k in p.pmt.host.export()[0])
        entered = threading.Event()

        def die_mid_gather(batch):
            entered.set()
            raise RuntimeError("killed mid-gather")

        pager.on_gather = die_mid_gather
        pager.observe({"ids": np.asarray(demoted, np.int64)})
        assert entered.wait(WAIT) and pager.drain(WAIT)
    finally:
        pager.close()
    assert pager.stats()["gather_errors"] == 1 and pager.pending_keys() == []
    assert sorted(int(k) for k in p.pmt.host.export()[0]) == host_before
    js = p.lookup(js, ps, demoted[:4], 2)
    js, ps, st = p.sync(js, ps, 3)
    assert st.promoted >= 4
    p.check(js, ps)


def test_pump_close_mid_gather_unblocks():
    p, js, ps, demoted, pager = _pump_fixture()
    hold, entered = threading.Event(), threading.Event()
    try:
        pager.on_gather = lambda batch: (entered.set(), hold.wait(WAIT))
        pager.observe({"ids": np.asarray(demoted, np.int64)})
        assert entered.wait(WAIT)
        closer = threading.Thread(target=pager.close)
        closer.start()
        time.sleep(0.05)
        hold.set()
        closer.join(timeout=WAIT)
        assert not closer.is_alive()
        pager.observe({"ids": np.asarray(demoted, np.int64)})  # a no-op
        assert pager.stats()["dropped_batches"] == 0
    finally:
        hold.set()
        pager.close()


# --------------------------------------------------- trainer integration


def _ev(mod, storage="hbm_dram", **kw):
    return mod.EmbeddingVariableOption(storage=mod.StorageOption(storage_type=storage, **kw))


def _port_trainer(pipeline_mode="off", capacity=256, seed=0, storage="hbm_dram"):
    model = WDL(emb_dim=4, capacity=capacity, hidden=(16,), num_cat=2, num_dense=2,
                ev=_ev(tcfg, storage))
    tr = Trainer(model, Adagrad(lr=0.2), adam(5e-3), device="cpu", pipeline_mode=pipeline_mode)
    return tr, tr.init(seed)


def _stream(n, vocab=280, seed=0, B=256):
    gen = SyntheticCriteo(batch_size=B, num_cat=2, num_dense=2, vocab=vocab, seed=seed)
    return [gen.batch() for _ in range(n)]


def test_trainer_paging_end_to_end_through_staged_pipeline():
    tr, st = _port_trainer()
    pager = tr.enable_tier_paging(depth=8, chunk=64)
    try:
        folds = 0
        for i, b in enumerate(tr.stage(iter(_stream(24)), depth=2)):
            st, mets = tr.train_step(st, b)
            if (i + 1) % 8 == 0:
                st, _ = tr.maintain(st)
            assert pager.drain(WAIT)
            st, frep = tr.fold_tier_prefetch(st)
            folds += sum(r["folded"] for r in frep.values())
        assert folds > 0, "stream never exercised a fold"
        assert np.isfinite(float(mets["loss"]))
        stats = tr.tier_paging_stats()
        assert stats["folded_rows"] == folds and stats["fold_bytes"] > 0
        assert stats["gather_errors"] == 0
    finally:
        tr.close_tier_paging()


def test_kstep_lookahead_parity_with_paging_on():
    """'lookahead' windows with paging on equal 'off' bit for bit: folds
    land at window boundaries only."""
    K = 4
    stream = _stream(16, seed=7)
    finals = {}
    for mode in ("off", "lookahead"):
        tr, st = _port_trainer(pipeline_mode=mode)
        pager = tr.enable_tier_paging(depth=16, chunk=64)
        try:
            losses = []
            for i in range(0, len(stream), K):
                chunk = stream[i:i + K]
                for b in chunk:
                    pager.observe(b)
                st, mets = tr.train_steps(st, stack_batches(chunk))
                losses.append(mets["loss"])
                if (i // K) % 2 == 1:
                    st, _ = tr.maintain(st)
                assert pager.drain(WAIT)
                st, _ = tr.fold_tier_prefetch(st)
            finals[mode] = (st, torch.cat(losses), tr.tier_paging_stats()["folded_rows"])
        finally:
            tr.close_tier_paging()
    (s_off, l_off, f_off), (s_la, l_la, f_la) = finals["off"], finals["lookahead"]
    assert f_off > 0 and f_off == f_la
    assert torch.equal(l_off, l_la)
    for bname, a in s_off.tables.items():
        b = s_la.tables[bname]
        for f in ("keys", "values", "meta"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert all(torch.equal(a.slots[k], b.slots[k]) for k in a.slots)


def test_async_maintain_with_paging_converges():
    """tier_async rounds, the pump and the folds interleave without a
    deadlock or a store left inconsistent (the store-lock protocol), with
    the interpreter switching threads every 10 us."""
    import sys

    tr, st = _port_trainer()
    pager = tr.enable_tier_paging(depth=8, chunk=64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for i, b in enumerate(tr.stage(iter(_stream(20)), depth=2)):
            st, mets = tr.train_step(st, b)
            if (i + 1) % 5 == 0:
                st, _ = tr.maintain(st, tier_async=True)
            st, _ = tr.fold_tier_prefetch(st)
        st, rep = tr.maintain(st)
        assert np.isfinite(float(mets["loss"])) and pager.stats()["gather_errors"] == 0
        assert tr.tier_stall_ms() > 0
        # every key in exactly one tier after the settling sync
        (bname, b), = tr.bundles.items()
        for k in range(b.num_tables):
            dev = set(st.tables[bname].keys[k].tolist()) - {SENTINEL}
            host = set(tr._tiers[(bname, (k,))].host.export()[0].tolist())
            assert not dev & host
    finally:
        sys.setswitchinterval(interval)
        tr.close_tier_paging()


def test_enable_tier_paging_without_a_tiered_bundle_raises():
    tr, _ = _port_trainer(storage="hbm")
    with pytest.raises(ValueError, match="nothing to page"):
        tr.enable_tier_paging()


def test_demoted_key_in_a_staged_batch_folds_before_its_lookup():
    """A key demoted by maintain and seen again in a batch that enters the
    staged pipeline is back on the device, with its tier row, before the
    train step that looks it up; the pump probes the ids as the table
    stores them (the raw int ids cast to the table's key dtype)."""
    tr, st = _port_trainer()
    for b in _stream(8):
        st, _ = tr.train_step(st, b)
    st, rep = tr.maintain(st)
    (bname, b), = tr.bundles.items()
    assert rep[bname]["demoted"] > 0
    mt = tr._tiers[(bname, (0,))]
    keys, rows, freqs, vers = mt.host.export()
    k = int(keys[0])
    batch = _stream(1, seed=9)[0]
    batch[b.features[0].name] = batch[b.features[0].name].astype(np.int64)
    batch[b.features[0].name][:] = k
    pager = tr.enable_tier_paging(depth=2, chunk=64)
    try:
        it = iter(tr.stage(iter([batch]), depth=1))
        deadline = time.monotonic() + WAIT
        while not pager.pending_keys() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert pager.drain(WAIT)
        st, frep = tr.fold_tier_prefetch(st)
        assert frep[bname]["folded"] >= 1
        ts = st.tables[bname]
        slot = int(torch.nonzero(ts.keys[0] == k)[0, 0])
        assert torch.equal(ts.values[0, slot], torch.as_tensor(rows[0, :4]))
        assert torch.equal(ts.slots["accum"][0, slot], torch.as_tensor(rows[0, 4:]))
        assert not mt.host.get(np.asarray([k]))[3][0]
        st, mets = tr.train_step(st, next(it))
        assert np.isfinite(float(mets["loss"]))
    finally:
        tr.close_tier_paging()


# --------------------------------------------------- reports against JAX


def _jax_trainer(storage, capacity):
    model = JaxWDL(emb_dim=4, capacity=capacity, hidden=(16,), num_cat=2, num_dense=2,
                   ev=_ev(jcfg, storage))
    return JaxTrainer(model, JaxAdagrad(lr=0.2), optax.adam(5e-3))


def _carry(tr, jst):
    tables = {}
    for bname, ts in jst.tables.items():
        arrays = {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
                  "meta": np.asarray(ts.meta),
                  "slots": {k: np.asarray(v) for k, v in ts.slots.items()}}
        arrays.update({n: np.asarray(getattr(ts, n)) for n in COUNTERS})
        tables[bname] = arrays
    return convert.train_state_from_arrays(
        tr, int(jst.step), tables, [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.dense)],
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.opt_state)])


def _jax_train(jtr, jst, batches):
    for b in batches:
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    return jst


def _jax_stream(n, vocab=280, seed=0, B=256):
    gen = JaxSyntheticCriteo(batch_size=B, num_cat=2, num_dense=2, vocab=vocab, seed=seed)
    return [{k: np.asarray(v) for k, v in gen.batch().items()} for _ in range(n)]


def _same_members(jtr, jst, ptr, pst):
    """Every member's device rows and host store per key."""
    for bname, b in ptr.bundles.items():
        jts, pts = jst.tables[bname], pst.tables[bname]
        for k in range(b.num_tables):
            jm = jax.tree.map(lambda a: a[k], jts) if b.stacked else jts
            _assert_rows(_by_key(pts.keys[k], pts.values[k].float(), pts.meta[k],
                                 {n: v[k] for n, v in pts.slots.items()
                                  if not n.startswith("scalar/")}), _jax_rows(jm))
            idx = (k,) if b.stacked else ()
            jmt, pmt = getattr(jtr, "_tiers", {}).get((bname, idx)), ptr._tiers.get((bname, idx))
            assert (jmt is None) == (pmt is None)
            if pmt is not None:
                _same_store(_store_by_key(pmt.host), _store_by_key(jmt.host))


def test_maintain_tier_reports_match_jax():
    """A tiered bundle: maintain() (sync), then after more JAX training
    maintain(tier_async=True) and maintain() again, each from the carried
    JAX state: reports, rows per key and every member's host store equal.
    The stacked bundle's members keep their own stores."""
    jtr = _jax_trainer("hbm_dram", 256)
    jst = _jax_train(jtr, jtr.init(0), _jax_stream(6))
    ptr, _ = _port_trainer()
    pst = _carry(ptr, jst)
    jst, jrep = jtr.maintain(jst)
    pst, prep = ptr.maintain(pst)
    assert prep == jrep and prep["group0"]["demoted"] > 0
    _same_members(jtr, jst, ptr, pst)
    jst = _jax_train(jtr, jst, _jax_stream(2, seed=1))
    pst = _carry(ptr, jst)
    promoted = 0
    for kw in (dict(tier_async=True), {}):
        jst, jrep = jtr.maintain(jst, **kw)
        pst, prep = ptr.maintain(pst, **kw)
        assert prep == jrep, kw
        promoted += prep["group0"]["promoted"]
    assert promoted > 0, prep
    _same_members(jtr, jst, ptr, pst)


@pytest.mark.parametrize("budget", ["grows", "auto_tiers"])
def test_maintain_hbm_budget_reports_match_jax(budget):
    """An HBM bundle over its growth threshold: a budget that admits the
    growth reports grew_to, one that does not auto-tiers (demoted > 0),
    as the JAX Trainer does from the same carried state; the port counts
    the JAX package's table bytes."""
    jtr = _jax_trainer("hbm", 64)
    jst = _jax_train(jtr, jtr.init(0), _jax_stream(2))
    ptr, _ = _port_trainer(capacity=64, storage="hbm")
    pst = _carry(ptr, jst)
    total = sum(JaxTrainer._state_bytes(ts) for ts in jst.tables.values())
    assert sum(ptr._state_bytes(ts) for ts in pst.tables.values()) == total
    B = 10 * total if budget == "grows" else total + 1
    jst, jrep = jtr.maintain(jst, hbm_budget_bytes=B)
    pst, prep = ptr.maintain(pst, hbm_budget_bytes=B)
    assert prep == jrep
    key = "grew_to" if budget == "grows" else "auto_tiered"
    assert key in prep["group0"]
    if budget == "auto_tiers":
        assert prep["group0"]["demoted"] > 0
    _same_members(jtr, jst, ptr, pst)


def test_fold_tier_prefetch_matches_jax_on_carried_state():
    """The trainer's fold over a stacked bundle's members: the same
    packages folded from one carried state give the JAX report and rows
    per key; the pump reads the same ids from the batch."""
    jtr = _jax_trainer("hbm_dram", 256)
    jst = _jax_train(jtr, jtr.init(0), _jax_stream(6))
    ptr, _ = _port_trainer()
    pst = _carry(ptr, jst)
    jst, _ = jtr.maintain(jst)
    pst, _ = ptr.maintain(pst)
    pst = _carry(ptr, jst)  # one slot layout again
    batches = _jax_stream(2, seed=5)
    reps = []
    for tr in (jtr, ptr):
        pager = tr.enable_tier_paging(depth=4, chunk=64)
        try:
            for b in batches:
                pager.observe(b)
            assert pager.drain(WAIT)
            if tr is jtr:
                jst, rep = tr.fold_tier_prefetch(jst)
            else:
                pst, rep = tr.fold_tier_prefetch(pst)
            reps.append(rep)
        finally:
            tr.close_tier_paging()
    assert reps[1] == reps[0] and reps[1]["group0"]["folded"] > 0
    _same_members(jtr, jst, ptr, pst)
