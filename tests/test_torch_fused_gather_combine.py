"""Kernel #4 in the PyTorch port, `fused_gather_combine`, held against the
JAX package's Pallas kernel run in interpret mode on the CPU (where the
port's wrapper runs its plain version, which is also what the CUDA kernel is
held against on the card), and the read-only pooled combine built on it
(`combiners.combine_pooled`) against the JAX `combine`.

The cases follow tests/test_fused_lookup.py: f32 with B = 12, not a
multiple of block_b (`test_fused_gather_combine_matches_oracle`), and bf16
at D = 128 through the pair-granule kernel
(`test_fused_gather_combine_pair_bf16`); plus L = 1, a bag of pads only,
rows past the table (clipped to C - 1) and sqrtn weights. Both sides add
the positions of a bag in order, out = out + w * row. Under sum weights
(w = 1, an exact product) the results are bit for bit and asserted so;
under mean and sqrtn weights XLA contracts the interpret mode's
out + w * row into one fused multiply-add, which the port does not, so they
are held within rtol 1e-6, atol 1e-6 (measured: 4.8e-7 at most). The
read-only combine multiplies by 1/n and then sums where `combine` sums and
then divides: within 1e-6 relative (plus 1e-7 absolute, for sums that
cancel to near 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu.embedding.combiners import combine as jax_combine
from deeprec_tpu.ops.fused_lookup import fused_gather_combine as jax_fgc
from deeprec_tpu_torch.embedding.combiners import combine, combine_pooled
from deeprec_tpu_torch.ops import fused_gather_combine
from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine_plain

torch.set_num_threads(1)

RTOL = ATOL = 1e-6


def _weights(row_ix, combiner):
    """The combiner as per-position weights, 0 at pads (the JAX tests'
    convention; the kernels skip pads whatever their weight)."""
    n = np.maximum((row_ix >= 0).sum(1, keepdims=True), 1).astype(np.float32)
    w = {"sum": np.ones_like(n), "mean": np.float32(1) / n,
         "sqrtn": np.float32(1) / np.sqrt(n)}[combiner]
    return np.where(row_ix >= 0, w, np.float32(0)).astype(np.float32)


def _case(C, D, B, L, seed, dtype=np.float32, hi=None):
    """values [C, D] normal (rounded to bf16 when asked), row_ix [B, L] in
    [-1, hi) (-1 = pad)."""
    rng = np.random.default_rng(seed)
    values = rng.normal(0, 1, (C, D)).astype(np.float32)
    if dtype == "bfloat16":
        values = np.asarray(jnp.asarray(values, jnp.bfloat16).astype(jnp.float32))
    row_ix = rng.integers(-1, C if hi is None else hi, (B, L)).astype(np.int32)
    return values, row_ix


def _port(values, row_ix, w, bf16=False):
    v = torch.from_numpy(np.array(values))
    if bf16:
        v = v.to(torch.bfloat16)
    return fused_gather_combine(v, torch.from_numpy(row_ix), torch.from_numpy(w)).numpy()


def _jax(values, row_ix, w, block_b, bf16=False, pair=False):
    v = jnp.asarray(values, jnp.bfloat16 if bf16 else jnp.float32)
    return np.asarray(jax_fgc(v, jnp.asarray(row_ix), jnp.asarray(w), block_b=block_b,
                              interpret=True, pair_kernels=pair))


def _assert_same(got, want, combiner):
    """Bit for bit under sum weights, else within RTOL / ATOL (see the
    module docstring)."""
    assert got.dtype == np.float32 and got.shape == want.shape
    if combiner == "sum":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# (C, D, B, L, block_b, values dtype, pair kernels, row_ix upper bound)
CASES = {
    "f32_B12": (256, 16, 12, 5, 8, np.float32, False, None),
    "bf16_pair_D128": (128, 128, 6, 5, 4, "bfloat16", True, None),
    "bf16_D128": (128, 128, 6, 5, 4, "bfloat16", False, None),
    "L1": (64, 16, 10, 1, 8, np.float32, False, None),
    "rows_past_C": (50, 8, 9, 6, 8, np.float32, False, 80),
}


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_interpret(case, combiner):
    C, D, B, L, block_b, dtype, pair, hi = CASES[case]
    values, row_ix = _case(C, D, B, L, seed=len(case), dtype=dtype, hi=hi)
    if case == "f32_B12":
        row_ix[3] = -1  # a bag of pads only: out 0
    w = _weights(row_ix, combiner)
    bf16 = dtype == "bfloat16"
    got = _port(values, row_ix, w, bf16)
    _assert_same(got, _jax(values, row_ix, w, block_b, bf16, pair), combiner)
    if case == "f32_B12":
        assert np.all(got[3] == 0.0)
    if case == "rows_past_C":
        assert (row_ix >= C).any()
        clipped = np.where(row_ix >= C, C - 1, row_ix)
        np.testing.assert_array_equal(got, _port(values, clipped, w))


def test_plain_version_sums_in_position_order():
    """out = out + w * row, position by position, pads skipped: the same
    bits as a numpy loop in f32."""
    values, row_ix = _case(40, 12, 7, 9, seed=3)
    w = np.random.default_rng(4).uniform(0.1, 2, row_ix.shape).astype(np.float32)
    want = np.zeros((7, 12), np.float32)
    for pos in range(9):
        ix = row_ix[:, pos]
        add = want + w[:, pos, None] * values[np.clip(ix, 0, 39)]
        want = np.where((ix >= 0)[:, None], add, want)
    got = fused_gather_combine_plain(torch.from_numpy(values), torch.from_numpy(row_ix),
                                     torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_its_inputs():
    v = torch.zeros((8, 4))
    ix = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.ones((3, 2))
    with pytest.raises(ValueError, match="values"):
        fused_gather_combine(v[None], ix, w)
    with pytest.raises(ValueError, match="weights"):
        fused_gather_combine(v, ix, w[:, :1])
    with pytest.raises(TypeError, match="dtype"):
        fused_gather_combine(v.to(torch.float16), ix, w)
    assert fused_gather_combine(v, ix[:0], w[:0]).shape == (0, 4)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_pooled_matches_jax_combine(combiner, dtype):
    """The read-only pooled combine against the JAX `combine` on the same
    unique rows, inverse and mask (an all-pad bag included)."""
    rng = np.random.default_rng(7)
    U, D, B, L = 30, 16, 11, 6
    emb = rng.normal(0, 1, (U, D)).astype(np.float32)
    inverse = rng.integers(0, U, (B, L)).astype(np.int32)
    mask = rng.random((B, L)) < 0.7
    mask[2] = False
    emb_t = torch.from_numpy(emb)
    jemb = jnp.asarray(emb)
    if dtype == "bfloat16":  # the rows as a bf16 table serves them
        emb_t = emb_t.to(torch.bfloat16)
        jemb = jemb.astype(jnp.bfloat16).astype(jnp.float32)
    got = combine_pooled(emb_t, torch.from_numpy(inverse), torch.from_numpy(mask),
                         combiner)
    want = np.asarray(jax_combine(jemb, jnp.asarray(inverse), jnp.asarray(mask),
                                  combiner))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.all(got.numpy()[2] == 0.0)
    # and the port's own differentiable combine, in f32
    ref = combine(emb_t.float(), torch.from_numpy(inverse), torch.from_numpy(mask),
                  combiner)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)
