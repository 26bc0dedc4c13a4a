"""The port's fused sparse bag step (`fused_sparse_forward` /
`fused_sparse_backward`, kernels #6 and #7, their plain versions on the
CPU) held against the JAX package at the size of tests/test_fused_step.py
(B = L = 4, C = 32): the same numpy inputs through the JAX function (its
XLA fallback under jax.jit, and the Pallas kernel in interpret mode for
one forward and one backward case) and through the port. The port's state
carries a leading table axis [T]; here T = 1.

uids ORDER is path-dependent (claim races differ), so uids/counts compare
as multisets; `out` and the rows compare per row id. Overflowed batches
keep count parity only: WHICH ids make the budget is path-dependent."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
from deeprec_tpu.embedding.table import TableConfig as JaxTableConfig
from deeprec_tpu.ops import fused_lookup as jfl
from deeprec_tpu.optim.apply import apply_bag_gradients as japply_bag
from deeprec_tpu.optim.apply import ensure_slots as jensure_slots
from deeprec_tpu.optim.sparse import REGISTRY as JREG
from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.embedding.table import META_DIRTY, META_VERSION, EmbeddingTable
from deeprec_tpu_torch.ops import fused_lookup as tfl
from deeprec_tpu_torch.ops.dedup import resolve_size
from deeprec_tpu_torch.optim.apply import apply_bag_gradients, ensure_slots
from deeprec_tpu_torch.optim.sparse import REGISTRY as TREG

torch.set_num_threads(1)

B, L = 4, 4
N = B * L
U = resolve_size(8, N)
# out: both sum the same f32 rows in l order; 1e-6 leaves room for XLA
# fusing the combine differently.
OUT_RTOL = 1e-6
# updated f32 rows and slots: the same row function in the same operation
# order, but jitted XLA may contract a multiply-add into one FMA (FTRL's
# `accum + grad * grad`) and its pow may differ from PyTorch's in the last
# bit. FTRL then amplifies: sigma = (new_accum^p - accum^p) / lr, so one
# ulp of accum^p (~3e-8 at 0.3) divided by lr = 0.01 and times |value|
# moves `linear` and the value by up to ~1e-6 absolute. Only FTRL gets
# that absolute slack.
ROW_RTOL = 2e-6
ROW_ATOL = {"ftrl": 1e-6}


def _ids(rng, vocab, *, pads=True):
    ids = rng.integers(0, vocab, (B, L))
    if pads:
        ids[0, :] = -1            # empty bag
        ids[1, :] = ids[1, 0]     # all-duplicate bag
        ids[2, 2:] = -1           # pad inside a bag
    return ids.astype(np.int32)


def _table(rng, C, D):
    return rng.normal(0, 0.5, (C, D)).astype(np.float32)


def _jax_values(vals, dtype):
    return jnp.asarray(vals, jnp.dtype(dtype))


def _port_values(vals, dtype):
    return torch.tensor(vals).to(getattr(torch, dtype))[None].contiguous()


def _jfwd(vals, ids, combiner, U, *, interpret=False):
    return jax.jit(lambda v, i: jfl.fused_sparse_forward(
        v, i, combiner=combiner, unique_size=U,
        interpret=interpret, use_pallas=interpret))(vals, jnp.asarray(ids))


def _jstep(vals, slots, ids, opt, combiner, U, seed=7, interpret=False):
    def fn(v, s, i):
        res = jfl.fused_sparse_forward(v, i, combiner=combiner, unique_size=U,
                                       interpret=interpret, use_pallas=interpret)
        g = res.out * 0.25 + 1.0
        return jfl.fused_sparse_backward(
            v, s, g, i, res, opt, combiner=combiner, step=3, seed=seed,
            interpret=interpret, use_pallas=interpret)
    return jax.jit(fn)(vals, slots, jnp.asarray(ids))


def _tstep(vals, slots, ids, opt, combiner, U, seed=7):
    """The port's forward + backward on the CPU, IN PLACE on vals/slots."""
    i = torch.from_numpy(ids)[None]
    res = tfl.fused_sparse_forward(vals, i, combiner=combiner, unique_size=U)
    g = res.out * 0.25 + 1.0
    return tfl.fused_sparse_backward(vals, slots, g, i, res, opt,
                                     combiner=combiner, step=3, seed=seed)


def _slots_np(opt, C, D):
    return {name: np.full((C, D), init, np.float32)
            for name, (shape, init) in opt.slot_specs(D).items()}


def _assert_bags_contract(r, ids):
    """uids[0] sentinel, counts[0] 0, and uids[inverse] rebuilding every
    budgeted position."""
    uids, inv = np.asarray(r[0]), np.asarray(r[1])
    assert uids[0] == -1 and int(np.asarray(r[2])[0]) == 0
    np.testing.assert_array_equal(uids[inv][inv > 0], ids[inv > 0])


def _multiset(uids, counts):
    return sorted(zip(np.asarray(uids).tolist(), np.asarray(counts).tolist()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("dim", [128, 96, 1])
def test_forward_parity(dtype, combiner, dim):
    seed = sum(map(ord, dtype + combiner)) * 1000 + dim
    rng = np.random.default_rng(seed)
    vals = _table(rng, 32, dim)
    ids = _ids(rng, 8)  # vocab 8 < budget: no overflow
    want = _jfwd(_jax_values(vals, dtype), ids, combiner, U)
    got = tfl.fused_sparse_forward(_port_values(vals, dtype),
                                   torch.from_numpy(ids)[None],
                                   combiner=combiner, unique_size=U)
    assert int(want.overflow) == 0 and int(got.overflow[0]) == 0
    assert got.out.dtype == torch.float32 and got.out.shape == (1, B, dim)
    np.testing.assert_allclose(got.out[0].numpy(), np.asarray(want.out),
                               rtol=OUT_RTOL, atol=0)
    _assert_bags_contract((want.uids, want.inverse, want.counts), ids)
    _assert_bags_contract((got.uids[0], got.inverse[0], got.counts[0]), ids)
    assert _multiset(got.uids[0], got.counts[0]) == _multiset(want.uids, want.counts)


@pytest.mark.parametrize("combiner", ["sum", "sqrtn"])
def test_forward_matches_pallas_interpret(combiner):
    """Against the Pallas kernel itself, run in interpret mode."""
    rng = np.random.default_rng(11)
    vals = _table(rng, 32, 128)
    ids = _ids(rng, 8)
    want = _jfwd(_jax_values(vals, "float32"), ids, combiner, U, interpret=True)
    got = tfl.fused_sparse_forward(_port_values(vals, "float32"),
                                   torch.from_numpy(ids)[None],
                                   combiner=combiner, unique_size=U)
    np.testing.assert_allclose(got.out[0].numpy(), np.asarray(want.out),
                               rtol=OUT_RTOL, atol=0)
    assert _multiset(got.uids[0], got.counts[0]) == _multiset(want.uids, want.counts)
    assert int(got.overflow[0]) == int(want.overflow) == 0


def _backward_case(opt_name, combiner, *, interpret=False, seed=1):
    rng = np.random.default_rng(seed)
    C, D = 32, 128
    jopt, topt = JREG[opt_name](), TREG[opt_name]()
    vals, slots = _table(rng, C, D), _slots_np(jopt, C, D)
    ids = _ids(rng, 8)
    jv, js = _jstep(jnp.asarray(vals), {k: jnp.asarray(v) for k, v in slots.items()},
                    ids, jopt, combiner, U, interpret=interpret)
    tv = _port_values(vals, "float32")
    ts = {k: torch.from_numpy(v)[None].clone() for k, v in slots.items()}
    out_v, out_s = _tstep(tv, ts, ids, topt, combiner, U)
    assert out_v is tv and out_s is ts  # in place
    atol = ROW_ATOL.get(opt_name, 0.0)
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv), rtol=ROW_RTOL, atol=atol)
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k][0].numpy(), np.asarray(js[k]),
                                   rtol=ROW_RTOL, atol=atol)
    # the step trained: touched rows moved, untouched rows are bit-identical
    touched = set(np.unique(ids[ids >= 0]).tolist())
    moved = set(np.flatnonzero(np.any(tv[0].numpy() != vals, axis=1)).tolist())
    assert moved == touched
    untouched = sorted(set(range(C)) - touched)
    np.testing.assert_array_equal(tv[0].numpy()[untouched], vals[untouched])


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam", "adamw", "ftrl"])
def test_backward_parity_f32(opt_name):
    _backward_case(opt_name, "mean")


def test_backward_matches_pallas_interpret():
    """Against the Pallas backward itself, run in interpret mode."""
    _backward_case("adagrad", "sum", interpret=True, seed=12)


def _spelled_out_sum(contrib, inv, u):
    """The fixed order, written as loops: slot u's positions in ascending
    flat order, in chunks of 32 summed in order from 0; the chunk partials
    in runs of 8 summed in order from 0; the runs' sums in order from 0."""
    pos = np.flatnonzero(inv == u) if u else np.zeros(0, np.int64)
    parts = []
    for c0 in range(0, len(pos), 32):
        part = np.zeros(contrib.shape[1], np.float32)
        for n in pos[c0:c0 + 32]:
            part = part + contrib[n]
        parts.append(part)
    total = np.zeros(contrib.shape[1], np.float32)
    for r0 in range(0, len(parts), 8):
        run = np.zeros(contrib.shape[1], np.float32)
        for part in parts[r0:r0 + 8]:
            run = run + part
        total = total + run
    return pos, total


def test_backward_summation_order_is_two_level():
    """The fixed order both the kernel and the plain version follow, now in
    three levels: a slot's positions, in flat order, in chunks of 32 summed
    in order from 0, the chunks' partials in runs of 8 summed in order from
    0, then the runs' sums in order from 0 — bit for bit against loops that
    spell it out; within f32 rounding of the exact sum. One id holds about
    400 positions (13 chunks, two runs) in the first case and about 3,300
    (105 chunks, 14 runs: the split of a zipf head over CTAs) in the
    second."""
    for Bs, Ls, head, min_chunks in ((64, 8, 0.8, 13), (64, 64, 0.9, 105)):
        rng = np.random.default_rng(9)
        D = 16
        ids = np.where(rng.random((Bs, Ls)) < head, 0, rng.integers(1, 40, (Bs, Ls)))
        ids[rng.random((Bs, Ls)) < 0.1] = -1
        ids = ids.astype(np.int32)
        gs = rng.normal(0, 1, (Bs, D)).astype(np.float32)
        Ub = resolve_size(Bs * Ls, Bs * Ls)
        res = tfl.fused_sparse_forward(torch.zeros((1, 64, D)), torch.from_numpy(ids)[None],
                                       combiner="sum", unique_size=Ub)
        got = tfl._segment_sum_plain(torch.from_numpy(gs)[None],
                                     torch.from_numpy(ids >= 0)[None], res.inverse, Ub)[0]
        inv = res.inverse[0].numpy().reshape(-1)
        contrib = np.repeat(gs, Ls, axis=0) * (ids.reshape(-1) >= 0)[:, None]
        assert int(np.bincount(inv).max()) > (min_chunks - 1) * 32
        for u in range(Ub):
            pos, total = _spelled_out_sum(contrib, inv, u)
            np.testing.assert_array_equal(got[u].numpy(), total)
            np.testing.assert_allclose(got[u].numpy(),
                                       contrib[pos].astype(np.float64).sum(0),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,opt_name", [("float32", "adagrad"), ("float32", "adam"),
                                            ("bfloat16", "adagrad")])
def test_backward_ignores_the_slot_numbering(dtype, opt_name):
    """The backward's tables and slots are bit-identical when the forward's
    slot numbering is permuted (uids, counts and inverse relabelled
    together): the property that lets the kernel rank uids in claim order.
    A head id of about 2,100 positions spans 9 runs."""
    rng = np.random.default_rng(13)
    Bs, Ls, C, D = 64, 48, 64, 16
    ids = np.where(rng.random((Bs, Ls)) < 0.75, 3, rng.integers(0, C, (Bs, Ls)))
    ids[rng.random((Bs, Ls)) < 0.1] = -1
    tids = torch.from_numpy(ids.astype(np.int32))[None]
    vals = _table(rng, C, D)
    opt = TREG[opt_name]()
    Ub = resolve_size(Bs * Ls, Bs * Ls)
    v0 = _port_values(vals, dtype)
    res = tfl.fused_sparse_forward(v0, tids, combiner="sum", unique_size=Ub)
    perm = torch.cat([torch.zeros(1, dtype=torch.long),
                      1 + torch.from_numpy(rng.permutation(Ub - 1))])
    uids, counts = torch.empty_like(res.uids), torch.empty_like(res.counts)
    uids[0, perm], counts[0, perm] = res.uids[0], res.counts[0]
    permuted = res._replace(uids=uids, counts=counts,
                            inverse=perm[res.inverse.long()].to(torch.int32))
    assert not torch.equal(permuted.uids, res.uids)
    grad = torch.from_numpy(rng.normal(0, 1, (1, Bs, D)).astype(np.float32))
    outs = []
    for r in (res, permuted):
        v = v0.clone()
        s = {k: torch.full((1, C, D), init) for k, (_, init) in opt.slot_specs(D).items()}
        tfl.fused_sparse_backward(v, s, grad, tids, r, opt, combiner="sum", step=2,
                                  seed=5, grad_averaging=True)
        outs.append((v, s))
    (va, sa), (vb, sb) = outs
    assert torch.equal(va.view(torch.int16) if dtype == "bfloat16" else va.view(torch.int32),
                       vb.view(torch.int16) if dtype == "bfloat16" else vb.view(torch.int32))
    for k in sa:
        assert torch.equal(sa[k].view(torch.int32), sb[k].view(torch.int32)), k
    assert not torch.equal(va, v0)


def test_sr_bits_rows_match_jax():
    uids = np.array([-1, 0, 5, 31, 2 ** 30, 7], np.int32)
    for seed in (0, 3, 2 ** 31 - 5):
        want = np.asarray(jfl._sr_bits_rows(seed, jnp.asarray(uids), 96))
        got = tfl.sr_bits_rows(seed, torch.from_numpy(uids), 96).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want)


@pytest.mark.parametrize("combiner", ["sum", "sqrtn"])
def test_backward_parity_bf16_sr(combiner):
    """bf16 tables round with the JAX package's own row-keyed bits, so the
    written rows equal JAX's bit for bit wherever the f32 rows before the
    rounding agree bit for bit (an f32 step from the bf16 table upcast
    gives those rows), and within one bf16 ulp elsewhere."""
    rng = np.random.default_rng(2)
    C, D = 32, 128
    jopt, topt = JREG["adagrad"](), TREG["adagrad"]()
    vals = np.asarray(jnp.asarray(_table(rng, C, D), jnp.bfloat16).astype(jnp.float32))
    slots = _slots_np(jopt, C, D)
    ids = _ids(rng, 8)
    jslots = {k: jnp.asarray(v) for k, v in slots.items()}

    def port(dtype, seed=7):
        v = _port_values(vals, dtype)
        s = {k: torch.from_numpy(a)[None].clone() for k, a in slots.items()}
        _tstep(v, s, ids, topt, combiner, U, seed=seed)
        return v[0], s

    jv, js = _jstep(jnp.asarray(vals, jnp.bfloat16), jslots, ids, jopt, combiner, U)
    jv32, _ = _jstep(jnp.asarray(vals), jslots, ids, jopt, combiner, U)
    tv, ts = port("bfloat16")
    tv32, _ = port("float32")
    assert tv.dtype == torch.bfloat16
    got = tv.view(torch.int16).numpy().view(np.uint16).astype(np.int64)
    want = np.asarray(jv).view(np.uint16).astype(np.int64)
    same = tv32.numpy().view(np.uint32) == np.asarray(jv32).view(np.uint32)
    np.testing.assert_array_equal(got[same], want[same])
    assert np.all(np.abs(got - want) <= 1)
    for k in js:  # slots stay exact f32
        np.testing.assert_allclose(ts[k][0].numpy(), np.asarray(js[k]),
                                   rtol=ROW_RTOL, atol=0)
    # another seed, another rounding: the stochastic rounding is engaged
    tv2, _ = port("bfloat16", seed=8)
    assert not torch.equal(tv, tv2)


def test_forward_edge_bags():
    rng = np.random.default_rng(3)
    vals = _table(rng, 32, 128)
    ids = _ids(rng, 8)
    v = _port_values(vals, "float32")
    for combiner in ("sum", "mean", "sqrtn"):
        r = tfl.fused_sparse_forward(v, torch.from_numpy(ids)[None],
                                     combiner=combiner, unique_size=U)
        # an empty bag pools to zeros under every combiner
        np.testing.assert_array_equal(r.out[0, 0].numpy(), 0.0)
    # an all-duplicate bag under mean is the row itself
    r = tfl.fused_sparse_forward(v, torch.from_numpy(ids)[None],
                                 combiner="mean", unique_size=U)
    np.testing.assert_array_equal(r.out[0, 1].numpy(), vals[ids[1, 0]])


def test_overflow_count_parity():
    """Past the budget both packages count the same overflow, and a
    position out of the budget adds nothing to its bag."""
    rng = np.random.default_rng(4)
    vals = _table(rng, 64, 128)
    Ut = resolve_size(4, N)  # tiny budget, wide vocab: overflow
    ids = _ids(rng, 60, pads=False)
    want = _jfwd(_jax_values(vals, "float32"), ids, "sum", Ut)
    got = tfl.fused_sparse_forward(_port_values(vals, "float32"),
                                   torch.from_numpy(ids)[None],
                                   combiner="sum", unique_size=Ut)
    assert int(got.overflow[0]) == int(want.overflow) > 0
    inv = got.inverse[0].numpy()
    rows = np.where((inv > 0)[..., None], vals[ids], 0.0)
    np.testing.assert_allclose(got.out[0].numpy(), rows.sum(1), rtol=OUT_RTOL)
    assert int((got.counts[0] > 0).sum()) == Ut - 1


def test_non_fusable_optimizers_rejected():
    for name in ("adam_async", "adagrad_decay"):
        assert not tfl.fusable_optimizer(TREG[name](), 128)
        assert not jfl.fusable_optimizer(JREG[name](), 128)
    for name in ("sgd", "adagrad", "adam", "adamw", "ftrl"):
        assert tfl.fusable_optimizer(TREG[name](), 128)


def test_non_cd_slot_layout_rejected():
    rng = np.random.default_rng(5)
    v = _port_values(_table(rng, 32, 128), "float32")
    ids = torch.from_numpy(_ids(rng, 8))[None]
    res = tfl.fused_sparse_forward(v, ids, combiner="sum", unique_size=U)
    g = torch.ones((1, B, 128))
    with pytest.raises(ValueError, match="want"):
        tfl.fused_sparse_backward(v, {"accum": torch.zeros((1, 16, 256))}, g,
                                  ids, res, TREG["adagrad"](), combiner="sum")


def test_table_bag_forward_and_apply_wiring():
    """bag_forward + apply_bag_gradients in both packages: the same rows,
    accumulators and version/dirty stamps (on the touched rows only)."""
    rng = np.random.default_rng(7)
    C, D = 64, 128
    vals = _table(rng, C, D)
    ids = _ids(rng, 8)
    g = np.ones((B, D), np.float32)

    jtbl = JaxTable(JaxTableConfig(name="t", dim=D, capacity=C))
    jopt = JREG["adagrad"]()
    jst = jensure_slots(jtbl, jtbl.create(), jopt).replace(values=jnp.asarray(vals))
    jres = jtbl.bag_forward(jst, jnp.asarray(ids), combiner="mean", unique_size=U)
    jst = japply_bag(jtbl, jst, jopt, jres, jnp.asarray(g), jnp.asarray(ids),
                     combiner="mean", step=5)

    tbl = EmbeddingTable(TableConfig(name="t", dim=D, capacity=C))
    opt = TREG["adagrad"]()
    st = ensure_slots(tbl, tbl.create(1, "cpu"), opt)
    st.values.copy_(torch.from_numpy(vals)[None])
    tids = torch.from_numpy(ids)[None]
    res = tbl.bag_forward(st, tids, combiner="mean", unique_size=U)
    np.testing.assert_allclose(res.out[0].numpy(), np.asarray(jres.out),
                               rtol=OUT_RTOL, atol=0)
    out = apply_bag_gradients(tbl, st, opt, res, torch.from_numpy(g)[None], tids,
                              combiner="mean", step=5)
    assert out is st
    np.testing.assert_allclose(st.values[0].numpy(), np.asarray(jst.values),
                               rtol=ROW_RTOL, atol=0)
    np.testing.assert_allclose(st.slots["accum"][0].numpy(),
                               np.asarray(jst.slots["accum"]), rtol=ROW_RTOL, atol=0)
    np.testing.assert_array_equal(st.meta[0].numpy(), np.asarray(jst.meta))
    touched = np.unique(ids[ids >= 0])
    meta = st.meta[0].numpy()
    assert np.all(meta[META_VERSION, touched] == 5)
    assert np.all(meta[META_DIRTY, touched] == 1)
    untouched = sorted(set(range(C)) - set(touched.tolist()))
    assert np.all(meta[META_VERSION, untouched] != 5)
    with pytest.raises(NotImplementedError, match="scalar"):
        apply_bag_gradients(tbl, st, TREG["adam_async"](), res,
                            torch.from_numpy(g)[None], tids)
