"""The PyTorch port's training ops held against the JAX package on the CPU:
stochastic rounding and the row scatter (the plain version of kernel #5
against the Pallas kernel in interpret mode, given the same random bits),
the initializer hash and rows, the train-mode lookup, the seven sparse row
functions, `apply_gradients`, the dense Adam against `optax.adam`, the
metrics and `SyntheticCriteo`. Inputs are made with numpy from a seed and
handed to both packages; the JAX side is jitted."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu import optim as joptim
from deeprec_tpu.data import SyntheticCriteo as JaxSyntheticCriteo
from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
from deeprec_tpu.ops import fused_lookup as jfl
from deeprec_tpu.training import metrics as jmetrics
from deeprec_tpu.utils import hashing as jhash
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import optim as toptim
from deeprec_tpu_torch.convert import table_state_from_arrays
from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.embedding.table import EmbeddingTable
from deeprec_tpu_torch.ops.fused_lookup import (
    apply_rows_sr, apply_rows_sr_plain, gather_rows, sr_bits,
    stochastic_round_plain,
)
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.training import metrics as tmetrics
from deeprec_tpu_torch.utils import hashing as thash

torch.set_num_threads(1)

SENTINEL = int(np.iinfo(np.int32).min)
# Row functions and applies: the same f32 operations in the same order; XLA
# and PyTorch may differ in the last bit of rsqrt, pow and sqrt and in
# fusing a multiply-add.
ROW_RTOL, ROW_ATOL = 1e-6, 1e-7


def _as_i32(bits_u32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits_u32).view(np.int32).copy())


# ------------------------------------------------ stochastic rounding (#5)


def test_stochastic_round_plain_matches_jax_given_its_bits():
    """Bit for bit with the JAX bit-twiddle fed `jax.random.bits`,
    including signed zeros, huge, tiny and exactly representable values."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (64, 37)).astype(np.float32)
    x[0, :6] = [0.0, -0.0, 3e38, -1e-40, 1.0, -2.5]
    key = jax.random.PRNGKey(3)
    bits = jax.random.bits(key, x.shape, jnp.uint32)
    want = np.asarray(jfl.stochastic_round(jnp.asarray(x), key).astype(jnp.float32))
    got = stochastic_round_plain(torch.from_numpy(x), _as_i32(bits))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("U,D,skip", [(10, 16, (1, 6)), (1, 3, ()), (1, 16, (0,)),
                                      (13, 128, (2, 12)), (9, 3, (4,))])
def test_apply_rows_sr_plain_matches_pallas_interpret(dtype, U, D, skip):
    """f32 bit-exact; bf16 bit-exact given the JAX kernel's own bits
    (`_sr_bits(seed, (U padded to the block, D))[:U]`). Skipped rows leave
    their slot untouched."""
    rng = np.random.default_rng(U * 100 + D)
    C, seed = 64, 5
    vals = rng.normal(0, 1, (C, D)).astype(np.float32)
    slot = rng.permutation(C)[:U].astype(np.int32)
    slot[list(skip)] = -1
    rows = rng.normal(0, 1, (U, D)).astype(np.float32)
    jv = jnp.asarray(vals).astype(dtype)
    want = np.asarray(jfl.apply_rows_sr(jv, jnp.asarray(slot), jnp.asarray(rows),
                                        jnp.int32(seed), interpret=True)
                      .astype(jnp.float32))
    up = -(-U // 8) * 8  # the kernel pads rows to its block of 8
    bits = _as_i32(np.asarray(jfl._sr_bits(jnp.int32(seed), (up, D)))[:U])
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))[None].clone()
    for fn in (apply_rows_sr_plain, apply_rows_sr):  # the wrapper on a CPU tensor
        out = fn(tv.clone(), torch.from_numpy(slot)[None],
                 torch.from_numpy(rows)[None], bits=bits[None])
        np.testing.assert_array_equal(out[0].float().numpy(), want)


def test_apply_rows_sr_rejects_bad_input():
    v = torch.zeros((1, 4, 2))
    with pytest.raises(TypeError):
        apply_rows_sr(v.to(torch.float16), torch.zeros((1, 3), dtype=torch.int32),
                      torch.zeros((1, 3, 2)))
    with pytest.raises(ValueError):
        apply_rows_sr(v, torch.zeros((1, 3), dtype=torch.int32), torch.zeros((1, 3, 5)))
    with pytest.raises(ValueError):
        apply_rows_sr_plain(v.to(torch.bfloat16), torch.zeros((1, 3), dtype=torch.int32),
                            torch.zeros((1, 3, 2)))


def test_sr_bits_are_seeded_counter_hashes():
    """Same (seed, shape) gives the same bits, another seed other bits, and
    the low 16 bits the rounding adds are uniform."""
    a = sr_bits(11, (4, 500, 16), "cpu")
    assert a.dtype == torch.int32 and a.shape == (4, 500, 16)
    assert torch.equal(a, sr_bits(11, (4, 500, 16), "cpu"))
    assert (a != sr_bits(12, (4, 500, 16), "cpu")).float().mean() > 0.99
    low = (a.long() & 0xFFFF).double()
    assert abs(float(low.mean()) / 65535.0 - 0.5) < 0.01
    hist = torch.bincount((low // 4096).long().flatten(), minlength=16)
    assert int(hist.min()) > 1700  # 32000 draws in 16 bins of 2000


def test_stochastic_round_is_unbiased_and_exact_on_representable():
    """The port's own bits: representable values never move, others land
    on a bf16 neighbour with the right mean (JAX's own contract,
    tests/test_fused_lookup.py)."""
    x = torch.tensor([0.0, 1.0, -2.5, 0.15625])
    got = stochastic_round_plain(x, sr_bits(0, (4,), "cpu"))
    np.testing.assert_array_equal(got.float().numpy(), x.numpy())
    v = np.float32(1.0 + 2.0 ** -9)  # 1/4 of the way from 1.0 to 1+2^-7
    r = stochastic_round_plain(torch.full((200_000,), v), sr_bits(0, (200_000,), "cpu"))
    r = r.float().numpy()
    assert set(np.unique(r)) <= {np.float32(1.0), np.float32(1.0 + 2.0 ** -7)}
    np.testing.assert_allclose(r.mean(), v, rtol=3e-4)


def test_apply_rows_bf16_rounds_to_neighbors():
    """bf16 writes land on one of the two bf16 neighbours of the f32 value;
    the skipped row stays untouched."""
    vals = torch.zeros((1, 32, 8), dtype=torch.bfloat16)
    slot = torch.tensor([[0, 1, 2, 3, -1, 5, 6, 7]], dtype=torch.int32)
    rows = torch.full((1, 8, 8), 1.0 + 1e-3)
    out = apply_rows_sr(vals, slot, rows, seed=7)[0].float().numpy()
    written = out[[0, 1, 2, 3, 5, 6, 7]]
    assert np.isin(written, [1.0, 1.0 + 2.0 ** -7]).all(), np.unique(written)
    np.testing.assert_array_equal(out[4], 0.0)


# ------------------------- the bf16 pair-granule kernels (#1, #2) on #3/#5


def test_gather_rows_bf16_matches_pair_kernel():
    """The cases of the pair-granule gather (#1): odd indices, duplicates,
    clamping and a non-block-multiple n, bit for bit against the Pallas
    pair kernel in interpret mode, through the bf16 branch of #3."""
    rng = np.random.default_rng(3)
    vals = jnp.asarray(rng.normal(0, 1, (256, 128)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    ix = np.array([1, 1, 0, 255, 254, 7, -3, 300, 13, 13, 12, 200, 77], np.int32)
    want = np.asarray(jfl.gather_rows_pair(vals, jnp.asarray(ix), block=8,
                                           interpret=True).astype(jnp.float32))
    tv = torch.from_numpy(np.asarray(vals.astype(jnp.float32))).to(torch.bfloat16)
    got = gather_rows(tv[None], torch.from_numpy(ix)[None])[0]
    assert got.dtype == torch.bfloat16 and got.shape == (13, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_apply_rows_sr_bf16_matches_pair_kernel():
    """The cases of the pair-granule scatter (#2) through the bf16 branch
    of #5: rows 6 and 7 share a granule (consecutive updates to one
    granule both land), 11 and 20 are half-granules whose mates 10 and 21
    must not move, -1 skips; bit for bit against the Pallas pair kernel in
    interpret mode given its positional bits (`_sr_bits(seed, (U padded
    to the block of 8, D))[:U]`)."""
    rng = np.random.default_rng(4)
    vals = rng.normal(0, 1, (64, 128)).astype(np.float32)
    jv = jnp.asarray(vals).astype(jnp.bfloat16)
    slot = np.array([6, 7, 11, 20, -1], np.int32)
    new = rng.normal(0, 1, (5, 128)).astype(np.float32)
    want = np.asarray(jfl.apply_rows_sr_pair(jv, jnp.asarray(slot), jnp.asarray(new),
                                             jnp.int32(9), interpret=True)
                      .astype(jnp.float32))
    bits = _as_i32(np.asarray(jfl._sr_bits(jnp.int32(9), (8, 128)))[:5])
    tv = torch.from_numpy(np.asarray(jv.astype(jnp.float32))).to(torch.bfloat16)[None]
    before = tv.clone()
    apply_rows_sr(tv, torch.from_numpy(slot)[None], torch.from_numpy(new)[None],
                  bits=bits[None])
    np.testing.assert_array_equal(tv[0].float().numpy(), want)
    untouched = [i for i in range(64) if i not in (6, 7, 11, 20)]
    assert torch.equal(tv[0, untouched], before[0, untouched])


def test_bf16_table_sr_preserves_small_updates_in_expectation():
    """A bf16 table whose updates are far below ulp/2 still drifts: SR
    keeps E[stored] == target where round-to-nearest would freeze at 1.0
    (the JAX package's contract, on the port's bits and its apply)."""
    ev = tcfg.EmbeddingVariableOption(
        init=tcfg.InitializerOption(kind="constant", constant=1.0))
    t = EmbeddingTable(tcfg.TableConfig(name="sr", dim=128, capacity=1024,
                                        value_dtype="bfloat16", ev=ev))
    opt = toptim.GradientDescent(lr=1.0)
    s = toptim.ensure_slots(t, t.create(device="cpu"), opt)
    ids = torch.arange(256, dtype=torch.int32)[None]
    g = torch.full((1, 256, 128), 1e-4)
    for step in range(200):
        res = t.lookup_unique(s, ids, step=step)
        toptim.apply_gradients(t, s, opt, res, g, step=step)
    occ = s.keys[0] != SENTINEL
    mean = float(s.values[0][occ].float().mean())
    assert abs(mean - (1.0 - 200 * 1e-4)) < 4e-3, mean


# ------------------------------------------------- hashing and initializer


def test_stateless_uniform_from_ids_bit_exact_with_int32_wrap():
    """ids in [0, 2^31) times D = 128 plus the column: the int32 product
    wraps in JAX, and the port wraps it the same way."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 2**31 - 1, 300).astype(np.int32)
    ids[:3] = [0, 2**31 - 1, 26_000_000]
    D, salt = 128, 1234567

    def jax_u(ids):
        x = ids[:, None] * jnp.int32(D) + jax.lax.broadcasted_iota(jnp.int32, (1, D), 1)
        return jhash.stateless_uniform_from_ids(x, salt=salt)

    want = np.asarray(jax.jit(jax_u)(jnp.asarray(ids)))
    x = thash.wrap_int32(torch.from_numpy(ids)[:, None].long() * D + torch.arange(D))
    got = thash.stateless_uniform_from_ids(x, salt).numpy()
    np.testing.assert_array_equal(got, want)


def _init_cfg(mod, kind, dtype):
    init = mod.InitializerOption(kind=kind, stddev=0.05, mean=0.01, constant=0.3)
    return mod.TableConfig(name="t", dim=128, capacity=256, value_dtype=dtype,
                           ev=mod.EmbeddingVariableOption(init=init))


@pytest.mark.parametrize("kind", ["stateless_normal", "matrix_normal", "constant"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rows_match_jax(kind, dtype):
    """Rows for three stacked tables, each with its own salt. The uniforms
    are bit-exact (above); torch.erfinv is not XLA's erfinv: over every
    uniform the hash can give (all 2^24), they differ by at most 65 f32 ulps
    of erfinv's output (4 where |2u - 1| < 0.9, 13 up to 0.999, 65 in the
    tails). The row mean + stddev sqrt(2) erfinv adds a rounding at each
    step; bf16 rows may then round to the neighbouring bf16 value."""
    rng = np.random.default_rng(2)
    uids = rng.integers(0, 2**31 - 1, (3, 200)).astype(np.int32)
    uids[0, :2] = [0, 2**31 - 1]
    salts = [11, 22, 2**31 - 1]
    jt, tt = JaxTable(_init_cfg(jcfg, kind, dtype)), EmbeddingTable(_init_cfg(tcfg, kind, dtype))
    init = jax.jit(lambda u, s: jt._init_rows(u, s).astype(jnp.float32))
    want = np.stack([np.asarray(init(jnp.asarray(uids[t]), jnp.uint32(salts[t])))
                     for t in range(3)])
    got = tt._init_rows(torch.from_numpy(uids), torch.tensor(salts))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    z = np.abs(want - 0.01) / 0.05
    e = (z / np.sqrt(2.0)).astype(np.float32)
    tol = 0.05 * (np.sqrt(2.0) * 65 * np.spacing(e) + 2 * np.spacing(z.astype(np.float32))) \
        + 2 * np.spacing(np.abs(want))
    if dtype == "bfloat16":
        tol = np.maximum(tol, 2.0 ** -7 * np.abs(want))  # one bf16 ulp
    assert np.all(np.abs(got - want) <= tol)


# ----------------------------------------------------- train-mode lookup


def _jax_arrays(ts):
    """A JAX TableState's arrays for convert.table_state_from_arrays."""
    return {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values.astype(jnp.float32)),
            "meta": np.asarray(ts.meta),
            "slots": {k: np.asarray(v) for k, v in ts.slots.items()},
            "insert_fails": np.asarray(ts.insert_fails)}


def _by_key(keys, *arrays):
    """{key: tuple of its rows} over the live slots of one table; every
    array has the slot on its first axis (pass meta [3, C] transposed)."""
    keys = np.asarray(keys)
    arrays = [np.asarray(a) for a in arrays]
    return {int(keys[i]): tuple(a[i] for a in arrays)
            for i in np.nonzero(keys != SENTINEL)[0]}


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("filter_freq", [0, 3])
def test_train_lookup_matches_jax(value_dtype, filter_freq):
    """Four train lookups with repeats and pads on both sides from one
    empty table: the same keys, freq and version per key, the same admitted
    embeddings (initializer rows within the erfinv bound above; bf16 tables
    store the bf16-rounded initializer, which SR leaves as it is), and the
    counters. f32 rows within 2e-5 relative (the erfinv bound); bf16 rows
    may sit one bf16 ulp apart where the two initializers straddle a
    rounding boundary."""
    rtol = 2e-5 if value_dtype == "float32" else 2.0 ** -7

    def cfg(mod):
        cf = mod.CounterFilter(filter_freq) if filter_freq else None
        ev = mod.EmbeddingVariableOption(
            counter_filter=cf, init=mod.InitializerOption(default_value_no_permission=0.25))
        return mod.TableConfig(name="t", dim=8, capacity=256, ev=ev, value_dtype=value_dtype)

    rng = np.random.default_rng(3)
    jt, tt = JaxTable(cfg(jcfg)), EmbeddingTable(cfg(tcfg))
    js = jt.create()
    ts = tt.create(device="cpu")
    for step in range(4):
        ids = rng.integers(0, 60, 50).astype(np.int32)
        ids[rng.random(50) < 0.1] = -1
        js, jres = jt.lookup_unique(js, jnp.asarray(ids), step=step, train=True)
        res = tt.lookup_unique(ts, torch.from_numpy(ids)[None], step=step, train=True)
        want = np.asarray(jres.embeddings.astype(jnp.float32))[np.asarray(jres.inverse)]
        got = res.embeddings[0].float().numpy()[res.inverse[0].numpy()]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)
        np.testing.assert_array_equal(got == 0.25, want == 0.25)
    want = _by_key(js.keys, js.values.astype(jnp.float32), np.asarray(js.meta).T)
    got = _by_key(ts.keys[0], ts.values[0].float(), ts.meta[0].T)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k][1], want[k][1])
        np.testing.assert_allclose(got[k][0], want[k][0], rtol=rtol, atol=1e-7)
    assert int(ts.insert_fails[0]) == int(js.insert_fails) == 0
    assert int(ts.dedup_unique[0]) == int(js.dedup_unique)
    assert int(ts.dedup_ids[0]) == int(js.dedup_ids)


def test_train_lookup_insert_fails_match_jax_when_full():
    """100 distinct ids into 64 slots: both fill every slot and count 36
    failed inserts."""
    def cfg(mod):
        return mod.TableConfig(name="t", dim=4, capacity=64)

    jt, tt = JaxTable(cfg(jcfg)), EmbeddingTable(cfg(tcfg))
    ids = np.arange(100, dtype=np.int32)
    js, _ = jt.lookup_unique(jt.create(), jnp.asarray(ids), train=True)
    ts = tt.create(device="cpu")
    res = tt.lookup_unique(ts, torch.from_numpy(ids)[None], train=True)
    assert int(ts.insert_fails[0]) == int(js.insert_fails) == 36
    assert int(tt.size(ts)[0]) == 64 and int((res.slot_ix >= 0).sum()) == 64


def test_scatter_update_writes_and_marks_dirty():
    t = EmbeddingTable(tcfg.TableConfig(name="t", dim=4, capacity=16))
    s = t.create(device="cpu")
    slot = torch.tensor([[3, -1, 9]], dtype=torch.int32)
    rows = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4)
    t.scatter_update(s, slot, rows, mask=torch.tensor([[True, True, False]]))
    np.testing.assert_array_equal(s.values[0, 3].numpy(), [0, 1, 2, 3])
    assert float(s.values[0, 9].abs().sum()) == 0.0
    assert s.meta[0, 2].nonzero().flatten().tolist() == [3]


# ------------------------------------------------------------- optimizers

_OPTS = {
    "sgd": {},
    "adagrad": {"initial_accumulator_value": 0.2},
    "adagrad_decay": {"accumulator_decay_step": 3, "accumulator_decay_rate": 0.5,
                      "accumulator_baseline": 0.05},
    "adam": {},
    "adam_async": {},
    "adamw": {"weight_decay": 0.1},
    "ftrl": {"l1": 0.01, "l2": 0.02},
}


def _random_slots(rng, specs, U):
    out = {}
    for name, (shape, init) in specs.items():
        if name.startswith("scalar/"):
            out[name] = np.full((1, 1), init, np.float32)
        elif name == "decay_period":
            out[name] = rng.integers(0, 4, (U, 1)).astype(np.float32)
        else:
            out[name] = np.abs(rng.normal(init + 0.1, 0.05, (U,) + shape)).astype(np.float32)
    return out


@pytest.mark.parametrize("name", sorted(_OPTS))
def test_sparse_row_functions_match_jax(name):
    """Each of the seven row functions on random rows, step 7, lr 0.03;
    the port's rows carry a leading table axis of 1."""
    rng = np.random.default_rng(4)
    U, D = 40, 16
    jopt, topt = joptim.make(name, lr=0.03, **_OPTS[name]), toptim.make(name, lr=0.03, **_OPTS[name])
    assert topt.slot_specs(D) == jopt.slot_specs(D)
    value = rng.normal(0, 0.1, (U, D)).astype(np.float32)
    grad = rng.normal(0, 0.5, (U, D)).astype(np.float32)
    counts = rng.integers(1, 5, U).astype(np.int32)
    slots = _random_slots(rng, jopt.slot_specs(D), U)
    jfn = jax.jit(lambda v, s, g, c: jopt.update(v, s, g, c, jnp.int32(7), jnp.float32(0.03)))
    wv, ws = jfn(jnp.asarray(value), {k: jnp.asarray(v) for k, v in slots.items()},
                 jnp.asarray(grad), jnp.asarray(counts))
    gv, gs = topt.update(torch.from_numpy(value)[None],
                         {k: torch.from_numpy(v)[None] for k, v in slots.items()},
                         torch.from_numpy(grad)[None], torch.from_numpy(counts)[None], 7, 0.03)
    # FTRL's sigma is a difference of two powers divided by lr: a last-bit
    # difference in pow (PyTorch takes sqrt for the power 0.5) reaches
    # `linear` as an absolute error of a few ulps of accum / lr.
    atol = 1e-6 if name == "ftrl" else ROW_ATOL
    np.testing.assert_allclose(gv[0].numpy(), np.asarray(wv), rtol=ROW_RTOL, atol=atol)
    assert gs.keys() == ws.keys()
    for k in ws:
        np.testing.assert_allclose(gs[k][0].numpy(), np.asarray(ws[k]),
                                   rtol=ROW_RTOL, atol=atol)


@pytest.mark.parametrize("name,averaging", [("adagrad", False), ("adam", False),
                                            ("adagrad", True)])
def test_apply_gradients_matches_jax(name, averaging):
    """A JAX table after two train lookups and applies, carried across
    slot for slot with its slots; one more lookup and `apply_gradients` on
    both sides (once with the residual rows, once with the stamps and a
    re-gather; summed or count-averaged grads), compared per key: value and
    slot rows, freq, version, dirty."""
    rng = np.random.default_rng(5)

    def cfg(mod):
        return mod.TableConfig(name="t", dim=8, capacity=128)

    jt, tt = JaxTable(cfg(jcfg)), EmbeddingTable(cfg(tcfg))
    jopt, topt = joptim.make(name, lr=0.05), toptim.make(name, lr=0.05)
    js = joptim.ensure_slots(jt, jt.create(), jopt)
    batches = [rng.integers(0, 40, 30).astype(np.int32) for _ in range(4)]
    grads = [rng.normal(0, 1, (30, 8)).astype(np.float32) for _ in range(4)]
    for step in range(2):
        js, res = jt.lookup_unique(js, jnp.asarray(batches[step]), step=step)
        js = joptim.apply_gradients(jt, js, jopt, res, jnp.asarray(grads[step]), step=step)
    ts = table_state_from_arrays(tt.cfg, _jax_arrays(js), 1, "cpu")
    for step, reuse in ((2, True), (3, False)):
        js, jres = jt.lookup_unique(js, jnp.asarray(batches[step]), step=step)
        js = joptim.apply_gradients(jt, js, jopt, jres, jnp.asarray(grads[step]), step=step,
                                    reuse_rows=reuse, stamp_meta=not reuse,
                                    grad_averaging=averaging)
        res = tt.lookup_unique(ts, torch.from_numpy(batches[step])[None], step=step)
        # the JAX uids are sorted like the port's: the same grads line up
        np.testing.assert_array_equal(res.uids[0].numpy(), np.asarray(jres.uids))
        toptim.apply_gradients(tt, ts, topt, res, torch.from_numpy(grads[step])[None],
                               step=step, reuse_rows=reuse, stamp_meta=not reuse,
                               grad_averaging=averaging)
    names = sorted(js.slots)
    want = _by_key(js.keys, np.asarray(js.meta).T, js.values, *[js.slots[k] for k in names])
    got = _by_key(ts.keys[0], ts.meta[0].T, ts.values[0], *[ts.slots[k][0] for k in names])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        for g, w in zip(got[k][1:], want[k][1:]):
            np.testing.assert_allclose(g, w, rtol=ROW_RTOL, atol=ROW_ATOL)


def test_dense_adam_matches_optax():
    """Five steps of `optim.dense.adam` against `optax.adam` on the same
    parameters and gradients: every parameter and moment within f32
    rounding (the bias terms b^count are float32 pows on both sides), and
    the state flattens in optax's leaf order."""
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(0, 1, (5, 3)).astype(np.float32),
              "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    jopt, topt = optax.adam(1e-3), tdense.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    jstep = jax.jit(lambda g, s, p: jopt.update(g, s, p))
    for _ in range(5):
        g = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
        u, js = jstep({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tdense.apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    want = [np.asarray(l) for l in jax.tree_util.tree_leaves(js)]
    got = tdense.state_leaves(ts, ["a", "b"])
    assert [w.shape for w in want] == [g.shape for g in got] and int(got[0]) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9)
    back = tdense.state_from_leaves(want, ["a", "b"], tp)
    assert int(back.count) == 5 and torch.equal(back.nu["b"], torch.tensor(want[4]))


# --------------------------------------------------------- metrics, data


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, 500).astype(np.float32)
    labels = (rng.random(500) < 0.4).astype(np.float32)
    probs = 1.0 / (1.0 + np.exp(-logits))
    tl, tlab, tpr = (torch.from_numpy(a) for a in (logits, labels, probs.astype(np.float32)))
    np.testing.assert_allclose(float(tmetrics.bce_loss(tl, tlab)),
                               float(jmetrics.bce_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    np.testing.assert_allclose(  # the mean's f32 sum runs in another order
        float(tmetrics.accuracy(tpr, tlab)),
        float(jmetrics.accuracy(jnp.asarray(probs), jnp.asarray(labels))), rtol=1e-6)
    js, ts = jmetrics.AucState.create(), tmetrics.AucState.create()
    for half in (slice(0, 250), slice(250, 500)):
        js = jmetrics.auc_update(js, jnp.asarray(probs[half]), jnp.asarray(labels[half]))
        ts = tmetrics.auc_update(ts, tpr[half], tlab[half])
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_allclose(float(tmetrics.auc_compute(ts)),
                               float(jmetrics.auc_compute(js)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_criteo_identical(seed):
    kw = dict(batch_size=128, num_cat=5, num_dense=4, vocab=1000, seed=seed)
    a, b = JaxSyntheticCriteo(**kw), SyntheticCriteo(**kw)
    for _ in range(3):
        x, y = a.batch(), b.batch()
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
