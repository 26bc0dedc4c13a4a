"""The PyTorch port's checkpoint chains held against the JAX package on the
CPU: `save` returns (state, path) with the dirty bits cleared, so a delta
one step after a full save holds that step's rows and no others, as in
JAX; chains of a full save and deltas written by one package and restored
by both, per key bit for bit (TTL eviction between the saves, so the
deltas' `live_keys` prune, `save_filtered_features=False`, a CBF sketch, a
scalar optimizer slot, bf16 values and a larger restore capacity);
`restore_into` leaving its input untouched; input positions behind the
staging ring (`CriteoStats` through `Trainer.stage`); retention (`keep`)
against the JAX listing; and a JAX ShardedTrainer's part-file chain
(`sharded_io=True`, 8-device CPU mesh) restored by the port's plain
trainer as the JAX plain trainer restores it.

Both packages restore the same files, so rows, slots, metadata, sketches,
dense leaves and the Adam state must agree bit for bit per key; which slot
a key wins in a claim race is free."""
import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu import models as jmodels
from deeprec_tpu import optim as joptim
from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import models as tmodels
from deeprec_tpu_torch import optim as toptim
from deeprec_tpu_torch.data import CriteoStats
from deeprec_tpu_torch.embedding.table import META_DIRTY
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

NUM_CAT, NUM_DENSE, DIM, CAP, B = 3, 2, 4, 256, 64
SENTINEL = int(np.iinfo(np.int32).min)


def _retable(model, **cfg):
    """Every table config of `model` with `cfg` replaced (both packages'
    features are dataclasses)."""
    model.features = [
        dataclasses.replace(f, table=dataclasses.replace(f.table, **cfg))
        if getattr(f, "table", None) is not None else f for f in model.features]
    return model


def _ev(mod, case):
    kw = {}
    if case in ("ttl", "bf16", "capacity"):
        kw["global_step_evict"] = mod.GlobalStepEvict(steps_to_live=2)
    if case == "filtered":
        kw["counter_filter"] = mod.CounterFilter(filter_freq=2)
        kw["ckpt"] = mod.CheckpointOption(save_filtered_features=False)
    if case == "cbf":
        kw["cbf_filter"] = mod.CBFFilter(filter_freq=2, max_element_size=1 << 12)
    return mod.EmbeddingVariableOption(**kw)


def _sparse_opt(mod, case):
    return mod.AdamAsync(lr=0.01) if case == "scalar" else mod.Adagrad(lr=0.1)


def _jax_trainer(case, capacity=CAP):
    m = jmodels.WDL(emb_dim=DIM, capacity=capacity, hidden=(16,), num_cat=NUM_CAT,
                    num_dense=NUM_DENSE, ev=_ev(jcfg, case))
    if case == "bf16":
        _retable(m, value_dtype="bfloat16")
    return JaxTrainer(m, _sparse_opt(joptim, case), optax.adam(1e-3))


def _port_trainer(case, capacity=CAP):
    m = tmodels.WDL(emb_dim=DIM, capacity=capacity, hidden=(16,), num_cat=NUM_CAT,
                    num_dense=NUM_DENSE, ev=_ev(tcfg, case))
    if case == "bf16":
        _retable(m, value_dtype="bfloat16")
    return Trainer(m, _sparse_opt(toptim, case), toptim.adam(1e-3), device="cpu")


def _batches(n, seed=3, vocab=300):
    g = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE, vocab=vocab,
                        seed=seed)
    return [g.batch() for _ in range(n)]


# ------------------------------------------------------------ per-key views


def _by_key(keys, values, meta, slots):
    keys = np.asarray(keys)
    values = np.asarray(values, np.float32)
    meta = np.asarray(meta)
    out = {}
    for i in np.nonzero(keys != SENTINEL)[0]:
        out[int(keys[i])] = (values[i], tuple(int(x) for x in meta[:, i]),
                             {k: np.asarray(v)[i] for k, v in slots.items()})
    return out


def port_view(trainer, st):
    """{feature: (rows by key, per-table entries)} of a port state."""
    out = {}
    for bname, b in trainer.bundles.items():
        ts = st.tables[bname]
        for k, f in enumerate(b.features if b.stacked else b.features[:1]):
            rows = _by_key(ts.keys[k].numpy(), ts.values[k].float().numpy(), ts.meta[k].numpy(),
                           {n: a[k].numpy() for n, a in ts.slots.items()
                            if not n.startswith("scalar/")})
            whole = {n: a[k].numpy().reshape(-1) for n, a in ts.slots.items()
                     if n.startswith("scalar/")}
            if ts.bloom is not None:
                whole["bloom"] = ts.bloom[k].numpy()
            out[f.name] = (rows, whole)
    return out


def jax_view(jtr, jst):
    out = {}
    for bname, b in jtr.bundles.items():
        ts = jst.tables[bname]
        for k, f in enumerate(b.features if b.stacked else b.features[:1]):
            m = jax.tree.map(lambda a: a[k], ts) if b.stacked else ts
            rows = _by_key(m.keys, np.asarray(m.values.astype(jnp.float32)), m.meta,
                           {n: np.asarray(a) for n, a in m.slots.items()
                            if not n.startswith("scalar/")})
            whole = {n: np.asarray(a).reshape(-1) for n, a in m.slots.items()
                     if n.startswith("scalar/")}
            if m.bloom is not None:
                whole["bloom"] = np.asarray(m.bloom)
            out[f.name] = (rows, whole)
    return out


def assert_views_equal(got, want):
    assert got.keys() == want.keys()
    for name, (wrows, wwhole) in want.items():
        grows, gwhole = got[name]
        assert grows.keys() == wrows.keys(), name
        for key, (wv, wm, ws) in wrows.items():
            gv, gm, gs = grows[key]
            np.testing.assert_array_equal(gv, wv, err_msg=f"{name} {key}")
            assert gm == wm, (name, key, gm, wm)
            assert gs.keys() == ws.keys()
            for s in ws:
                np.testing.assert_array_equal(gs[s], ws[s], err_msg=f"{name} {key} {s}")
        assert gwhole.keys() == wwhole.keys(), name
        for n in wwhole:
            np.testing.assert_array_equal(gwhole[n], wwhole[n], err_msg=f"{name} {n}")


def assert_dense_equal(trainer, st, jst):
    for name, leaf in zip(jax_leaf_names(trainer.model), jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_array_equal(st.dense[name].numpy(), np.asarray(leaf), err_msg=name)
    jopt = jax.tree_util.tree_leaves(jst.opt_state)
    o = st.opt_state
    names = jax_leaf_names(trainer.model)
    got = [o.count.numpy()] + [o.mu[n].numpy() for n in names] + [o.nu[n].numpy() for n in names]
    assert len(got) == len(jopt)
    for g, w in zip(got, jopt):
        np.testing.assert_array_equal(g, np.asarray(w))


# -------------------------------------------- save clears the dirty bits


def _delta_keys(path):
    out = {}
    for fname in sorted(os.listdir(path)):
        if fname.startswith("table_"):
            with np.load(os.path.join(path, fname)) as z:
                out[fname] = set(z["keys"].tolist())
    return out


def test_save_returns_state_and_clears_dirty_bits(tmp_path):
    trainer = _port_trainer("ttl")
    st = trainer.init()
    for b in _batches(2):
        st, _ = trainer.train_step(st, b)
    assert any(int(ts.meta[:, META_DIRTY].sum()) for ts in st.tables.values())
    out = CheckpointManager(str(tmp_path), trainer).save(st)
    assert isinstance(out, tuple) and len(out) == 2
    st2, path = out
    assert st2 is st and path == os.path.join(str(tmp_path), "full-2")
    for ts in st.tables.values():
        assert int(ts.meta[:, META_DIRTY].sum()) == 0


def test_delta_after_full_save_holds_only_that_steps_rows(tmp_path):
    """One step after a full save the delta holds exactly the rows that
    step touched, and the same keys as the JAX package's delta from the
    same carried state."""
    from test_torch_table_lifecycle import _port_from_jax

    jtr = _jax_trainer("ttl")
    jst = jtr.init(0)
    batches = _batches(3)
    for b in batches[:2]:
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    trainer = _port_trainer("ttl")
    st = _port_from_jax(trainer, jst)
    jck, ck = JaxCkpt(str(tmp_path / "jax"), jtr), CheckpointManager(str(tmp_path / "port"), trainer)
    jst, _ = jck.save(jst)
    st, _ = ck.save(st)
    jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in batches[2].items()})
    st, _ = trainer.train_step(st, batches[2])
    _, jpath = jck.save_incremental(jst)
    _, path = ck.save_incremental(st)
    got, want = _delta_keys(path), _delta_keys(jpath)
    assert got == want
    ids = {f"table_group0_t{k}.npz": set(batches[2][f"C{k + 1}"].tolist())
           for k in range(NUM_CAT)}
    assert got == ids


# ------------------------------------------------- chains across packages

CASES = ["ttl", "filtered", "cbf", "scalar", "bf16", "capacity"]


def _train_chain(train, save, save_incr, evict, init):
    """A full save after 3 steps, 3 steps and an eviction, a delta, a step,
    a delta. Returns the final state."""
    st = init
    bs = _batches(8, seed=5)
    for b in bs[:3]:
        st = train(st, b)
    st = save(st)
    for b in bs[3:6]:
        st = train(st, b)
    st = evict(st)
    st = save_incr(st)
    st = train(st, bs[6])
    return save_incr(st)


@pytest.mark.parametrize("case", CASES)
def test_port_chain_restores_in_jax_and_port(tmp_path, case):
    trainer = _port_trainer(case)
    ck = CheckpointManager(str(tmp_path), trainer)
    _train_chain(lambda s, b: trainer.train_step(s, b)[0], lambda s: ck.save(s)[0],
                 lambda s: ck.save_incremental(s)[0], trainer.evict_tables, trainer.init())
    assert sorted(os.listdir(tmp_path)) == ["full-3", "incr-6", "incr-7"]
    cap = 2 * CAP if case == "capacity" else CAP
    jtr = _jax_trainer(case, cap)
    jst = JaxCkpt(str(tmp_path), jtr).restore()
    tr2 = _port_trainer(case, cap)
    st = CheckpointManager(str(tmp_path), tr2).restore()
    assert st.step == int(jst.step) == 7
    assert_views_equal(port_view(tr2, st), jax_view(jtr, jst))
    assert_dense_equal(tr2, st, jst)


@pytest.mark.parametrize("case", [c for c in CASES if c != "bf16"])
def test_jax_chain_restores_in_port_and_jax(tmp_path, case):
    jtr = _jax_trainer(case)
    jck = JaxCkpt(str(tmp_path), jtr)
    _train_chain(lambda s, b: jtr.train_step(s, {k: jnp.asarray(v) for k, v in b.items()})[0],
                 lambda s: jck.save(s)[0], lambda s: jck.save_incremental(s)[0],
                 jtr.evict_tables, jtr.init(0))
    cap = 2 * CAP if case == "capacity" else CAP
    jtr2 = _jax_trainer(case, cap)
    jst = JaxCkpt(str(tmp_path), jtr2).restore()
    trainer = _port_trainer(case, cap)
    st = CheckpointManager(str(tmp_path), trainer).restore()
    assert st.step == int(jst.step) == 7
    assert_views_equal(port_view(trainer, st), jax_view(jtr2, jst))
    assert_dense_equal(trainer, st, jst)


def test_ttl_eviction_between_saves_prunes_on_restore(tmp_path):
    """The keys the eviction dropped between the full save and the delta
    are gone after the restore (they are in the full save, not in the
    delta's live_keys), and the restored chain equals the live state."""
    trainer = _port_trainer("ttl")
    ck = CheckpointManager(str(tmp_path), trainer)
    live = _train_chain(lambda s, b: trainer.train_step(s, b)[0], lambda s: ck.save(s)[0],
                        lambda s: ck.save_incremental(s)[0], trainer.evict_tables,
                        trainer.init())
    with np.load(os.path.join(str(tmp_path), "full-3", "table_group0_t0.npz")) as z:
        full_keys = set(z["keys"].tolist())
    with np.load(os.path.join(str(tmp_path), "incr-6", "table_group0_t0.npz")) as z:
        live_keys = set(z["live_keys"].tolist())
    assert full_keys - live_keys  # the eviction dropped keys of the full save
    st = CheckpointManager(str(tmp_path), _port_trainer("ttl")).restore()
    got, want = port_view(trainer, st), port_view(trainer, live)
    for name in want:  # the restore stamps no dirty bit: compare freq, version
        assert got[name][0].keys() == want[name][0].keys()
        for key, (wv, wm, ws) in want[name][0].items():
            gv, gm, gs = got[name][0][key]
            np.testing.assert_array_equal(gv, wv)
            assert gm[:2] == wm[:2]
            np.testing.assert_array_equal(gs["accum"], ws["accum"])


def test_jax_bf16_chain_is_quarantined_alike(tmp_path):
    """The JAX package writes bf16 rows whose recorded dtype ('<V2') its own
    digest check reads back as '|V2' (ROADMAP queue C): both packages
    quarantine the same directories and find no intact full save."""
    jtr = _jax_trainer("bf16")
    jck = JaxCkpt(str(tmp_path / "src"), jtr)
    _train_chain(lambda s, b: jtr.train_step(s, {k: jnp.asarray(v) for k, v in b.items()})[0],
                 lambda s: jck.save(s)[0], lambda s: jck.save_incremental(s)[0],
                 jtr.evict_tables, jtr.init(0))
    listings = {}
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        shutil.copytree(str(tmp_path / "src"), d)
        ck = (JaxCkpt(d, _jax_trainer("bf16")) if who == "jax"
              else CheckpointManager(d, _port_trainer("bf16")))
        with pytest.raises(FileNotFoundError):
            ck.restore()
        listings[who] = sorted(os.listdir(d))
    assert listings["port"] == listings["jax"] == ["full-3.quarantined", "incr-6", "incr-7"]


def test_restore_into_leaves_its_input_untouched(tmp_path):
    trainer = _port_trainer("ttl")
    ck = CheckpointManager(str(tmp_path), trainer)
    _train_chain(lambda s, b: trainer.train_step(s, b)[0], lambda s: ck.save(s)[0],
                 lambda s: ck.save_incremental(s)[0], trainer.evict_tables, trainer.init())
    ck2 = CheckpointManager(str(tmp_path), _port_trainer("ttl"))
    base = ck2.restore_into(_port_trainer("ttl").init(), os.path.join(str(tmp_path), "full-3"))
    before = _tensors(base)
    out = ck2.restore_into(base, os.path.join(str(tmp_path), "incr-6"))
    after = _tensors(base)
    assert before.keys() == after.keys()
    for name in before:
        assert torch.equal(before[name], after[name]), name
    assert base.step == 3 and out.step == 6
    # the result equals replaying the same two links in place
    ref = CheckpointManager(str(tmp_path), _port_trainer("ttl"))
    st = ref._apply_ckpt(_port_trainer("ttl").init(), os.path.join(str(tmp_path), "full-3"),
                         load_dense=True)
    st = ref._apply_ckpt(st, os.path.join(str(tmp_path), "incr-6"), load_dense=True)
    assert_views_equal(port_view(trainer, out), port_view(trainer, st))
    for n in st.dense:
        assert torch.equal(out.dense[n], st.dense[n])


def _tensors(st):
    out = {f"dense/{n}": t.clone() for n, t in st.dense.items()}
    for bname, ts in st.tables.items():
        for f in dataclasses.fields(ts):
            v = getattr(ts, f.name)
            if torch.is_tensor(v):
                out[f"{bname}/{f.name}"] = v.clone()
        for n, a in ts.slots.items():
            out[f"{bname}/slot/{n}"] = a.clone()
    o = st.opt_state
    out["opt/count"] = o.count.clone()
    out.update({f"opt/mu/{n}": t.clone() for n, t in o.mu.items()})
    out.update({f"opt/nu/{n}": t.clone() for n, t in o.nu.items()})
    return out


# ------------------------------------------------------ stream positions


def test_dataset_positions_ride_checkpoints_behind_the_staging_ring(tmp_path):
    """CriteoStats staged through Trainer.stage (a ring 2 batches deep that
    runs ahead): a save records the CONSUMED index, a restore into a fresh
    stream resumes there, deltas carry positions too and the newest wins,
    and a chain without positions leaves the stream alone."""
    kw = dict(batch_size=B, seed=4, num_cat=NUM_CAT, num_dense=NUM_DENSE,
              cardinality_cap=CAP // 2)
    trainer = _port_trainer("ttl")
    st = trainer.init()
    gen = CriteoStats(**kw)
    data = trainer.stage(gen, depth=2)
    it = iter(data)
    for _ in range(3):
        st, _ = trainer.train_step(st, next(it))
    deadline = time.monotonic() + 30
    while gen._index <= 3 and time.monotonic() < deadline:
        time.sleep(0.01)  # the ring's producer runs ahead
    assert gen._index > 3
    ck = CheckpointManager(str(tmp_path), trainer, datasets={"criteo_stats": gen})
    st, path = ck.save(st)
    with open(os.path.join(path, "datasets.part00000.json")) as f:
        assert f.read() == '{"criteo_stats": {"index": 3}}'
    st, _ = trainer.train_step(st, next(it))
    st, _ = trainer.train_step(st, next(it))
    st, _ = ck.save_incremental(st)
    data.close()

    gen2 = CriteoStats(**kw)
    st2 = CheckpointManager(str(tmp_path), _port_trainer("ttl"),
                            datasets={"criteo_stats": gen2}).restore()
    assert st2.step == 5 and gen2.save() == {"index": 5}
    nxt = gen2.batch()
    want = CriteoStats(**kw).batch_at(5)
    assert nxt.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(nxt[k], want[k])
    # the JAX package reads the same positions
    from deeprec_tpu.data import CriteoStats as JaxCriteoStats

    jgen = JaxCriteoStats(**kw)
    JaxCkpt(str(tmp_path), _jax_trainer("ttl"), datasets={"criteo_stats": jgen}).restore()
    assert jgen.save() == {"index": 5}
    for d in os.listdir(str(tmp_path)):
        os.remove(os.path.join(str(tmp_path), d, "datasets.part00000.json"))
    gen3 = CriteoStats(**kw)
    CheckpointManager(str(tmp_path), _port_trainer("ttl"),
                      datasets={"criteo_stats": gen3}).restore()
    assert gen3.save() == {"index": 0}


# -------------------------------------------------------------- retention


@pytest.mark.parametrize("keep", [2, 0])
def test_keep_and_gc_match_jax(tmp_path, keep):
    """The same save sequence in both packages (fulls and deltas, one
    quarantined delta, a keep of 2 and of 0 = keep everything) leaves the
    same listing."""
    from deeprec_tpu.online import faults

    listings = {}
    for who in ("jax", "port"):
        d = str(tmp_path / who)
        if who == "jax":
            tr = _jax_trainer("ttl")
            st = tr.init(0)
            train = lambda s, b: tr.train_step(s, {k: jnp.asarray(v) for k, v in b.items()})[0]  # noqa: E731
            ck = JaxCkpt(d, tr, keep=keep)
        else:
            tr = _port_trainer("ttl")
            st = tr.init()
            train = lambda s, b: tr.train_step(s, b)[0]  # noqa: E731
            ck = CheckpointManager(d, tr, keep=keep)
        bs = _batches(12, seed=6)
        for i in range(4):
            st = train(st, bs[3 * i])
            st, _ = ck.save(st)
            st = train(st, bs[3 * i + 1])
            st, p = ck.save_incremental(st)
            if i == 1:  # a quarantined link, aged out with its chain
                faults.flip_bit(os.path.join(p, "table_group0_t0.npz"))
                assert ck.chain_dirs() == [f"full-{3 * i + 1}"]
            st = train(st, bs[3 * i + 2])
            st, _ = ck.save_incremental(st)
        listings[who] = sorted(os.listdir(d))
    assert listings["port"] == listings["jax"]
    if keep == 2:
        assert listings["port"] == ["full-10", "full-7", "incr-11", "incr-12", "incr-8",
                                    "incr-9"]


def test_sharded_io_raises_naming_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6"):
        CheckpointManager(str(tmp_path), _port_trainer("ttl"), sharded_io=True)


# ----------------------------------------------------------- part files


def test_jax_part_file_chain_restores_in_the_port(tmp_path):
    """A JAX ShardedTrainer on the 8-device CPU mesh writes part files
    (sharded_io=True, a CBF table: each part carries `bloom_parts`); the
    port's plain trainer restores the chain as the JAX plain trainer does —
    rows per key, no sketch (a plain trainer imports none from parts)."""
    from deeprec_tpu.parallel import ShardedTrainer, make_mesh, shard_batch

    mesh = make_mesh(8)
    m = jmodels.WDL(emb_dim=DIM, capacity=CAP * 4, hidden=(16,), num_cat=NUM_CAT,
                    num_dense=NUM_DENSE, ev=_ev(jcfg, "cbf"))
    str_ = ShardedTrainer(m, joptim.Adagrad(lr=0.1), optax.adam(1e-3), mesh=mesh)
    st = str_.init(0)
    ck = JaxCkpt(str(tmp_path), str_, sharded_io=True)
    bs = _batches(5, seed=7)
    for b in bs[:3]:
        st, _ = str_.train_step(st, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
    st, _ = ck.save(st)
    for b in bs[3:]:
        st, _ = str_.train_step(st, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
    st, _ = ck.save_incremental(st)
    names = os.listdir(os.path.join(str(tmp_path), "incr-5"))
    assert any(".part00000.npz" in n for n in names)
    jtr = _jax_trainer("cbf", CAP * 4)
    jst = JaxCkpt(str(tmp_path), jtr).restore()
    trainer = _port_trainer("cbf", CAP * 4)
    pst = CheckpointManager(str(tmp_path), trainer).restore()
    assert pst.step == int(jst.step) == 5
    got, want = port_view(trainer, pst), jax_view(jtr, jst)
    for name in want:
        assert not want[name][1]["bloom"].any() and not got[name][1]["bloom"].any()
    assert_views_equal(got, want)
    assert_dense_equal(trainer, pst, jst)
    # a part count that differs from the manifest's is refused, as in JAX
    full = os.path.join(str(tmp_path), "full-3")
    os.remove(os.path.join(full, "table_group0_t0.part00000.npz"))
    for ck in (JaxCkpt(str(tmp_path), jtr), CheckpointManager(str(tmp_path), trainer)):
        with pytest.raises(ValueError, match="part files"):
            ck._load_rows(full, "group0", "t0")


# ------------------------------------------------- import_rows and replay


@pytest.mark.parametrize("mode", ["exact", "bucket", "chunk", "chunk_past_n"])
def test_import_rows_bucket_and_chunk_match_jax(mode):
    """The JAX `import_rows` options: power-of-two padding and fixed-size
    slices (pads hold the sentinel and place nowhere; the per-table scalar
    slot is applied with every slice) give the same rows per key as the
    JAX package."""
    from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
    from deeprec_tpu.optim.apply import ensure_slots as jax_ensure_slots
    from deeprec_tpu.training.checkpoint import import_rows as jax_import_rows
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.optim.apply import ensure_slots
    from deeprec_tpu_torch.training.checkpoint import import_rows

    rng = np.random.default_rng(3)
    n, D = 37, 8
    rows = {
        "keys": rng.choice(np.arange(1, 10_000), n, replace=False).astype(np.int32),
        "values": rng.standard_normal((n, D)).astype(np.float32),
        "freqs": rng.integers(1, 9, n).astype(np.int32),
        "versions": rng.integers(0, 50, n).astype(np.int32),
        "slot:m": rng.standard_normal((n, D)).astype(np.float32),
        "slot:v": rng.random((n, D)).astype(np.float32),
        "slot:scalar/beta1_power": np.full((1, 1), 0.5, np.float32),
        "slot:scalar/beta2_power": np.full((1, 1), 0.25, np.float32),
    }
    kw = {"exact": {}, "bucket": dict(bucket=True), "chunk": dict(chunk=16),
          "chunk_past_n": dict(chunk=64)}[mode]
    jt = JaxTable(jcfg.TableConfig(name="t", dim=D, capacity=256))
    js = jax_import_rows(jt, jax_ensure_slots(jt, jt.create(), joptim.AdamAsync(lr=0.1)),
                         rows, **kw)
    tt = EmbeddingTable(tcfg.TableConfig(name="t", dim=D, capacity=256))
    ts = tt.create(1, "cpu")
    ensure_slots(tt, ts, toptim.AdamAsync(lr=0.1))
    import_rows(tt, ts, 0, rows, **kw)
    got = _by_key(ts.keys[0].numpy(), ts.values[0].numpy(), ts.meta[0].numpy(),
                  {k: v[0].numpy() for k, v in ts.slots.items() if not k.startswith("scalar/")})
    want = _by_key(js.keys, js.values, js.meta,
                   {k: np.asarray(v) for k, v in js.slots.items() if not k.startswith("scalar/")})
    assert_views_equal({"t": (got, {})}, {"t": (want, {})})
    for name in ("scalar/beta1_power", "scalar/beta2_power"):
        np.testing.assert_array_equal(ts.slots[name][0].numpy(), np.asarray(js.slots[name]))


def test_import_rows_strict_and_lenient_on_a_full_table():
    """strict raises when keys find no slot; strict=False drops them."""
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.training.checkpoint import import_rows

    tt = EmbeddingTable(tcfg.TableConfig(name="t", dim=4, capacity=16, max_probes=4))
    rows = {"keys": np.arange(1, 41, dtype=np.int32), "values": np.ones((40, 4), np.float32),
            "freqs": np.ones(40, np.int32), "versions": np.zeros(40, np.int32)}
    with pytest.raises(RuntimeError, match="failed to insert"):
        import_rows(tt, tt.create(1, "cpu"), 0, rows)
    ts = tt.create(1, "cpu")
    import_rows(tt, ts, 0, rows, strict=False)
    placed = int(tt.size(ts)[0])
    assert 0 < placed <= 16
    held = ts.keys[0][ts.keys[0] != SENTINEL].numpy()
    assert np.all(ts.values[0][ts.keys[0] != SENTINEL].numpy() == 1.0) and len(held) == placed


def test_restore_with_template_chunk_and_warm_replay(tmp_path):
    """restore(template=) replays onto copies (the template is unchanged)
    and equals restore(); restore(chunk=) equals it too; warm_replay is
    inert on the state it warms."""
    trainer = _port_trainer("ttl")
    ck = CheckpointManager(str(tmp_path), trainer)
    _train_chain(lambda s, b: trainer.train_step(s, b)[0], lambda s: ck.save(s)[0],
                 lambda s: ck.save_incremental(s)[0], trainer.evict_tables, trainer.init())
    tr2 = _port_trainer("ttl")
    ck2 = CheckpointManager(str(tmp_path), tr2)
    plain = ck2.restore()
    template = tr2.init()
    before = _tensors(template)
    via_template = ck2.restore(template=template)
    chunked = ck2.restore(chunk=8)
    for name, t in _tensors(template).items():
        assert torch.equal(t, before[name]), name
    for st in (via_template, chunked):
        assert st.step == plain.step == 7
        assert_views_equal(port_view(tr2, st), port_view(tr2, plain))
    snap = _tensors(plain)
    ck2.warm_replay(plain, chunk=8)
    for name, t in _tensors(plain).items():
        assert torch.equal(t, snap[name]), name
