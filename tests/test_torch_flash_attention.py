"""The port's flash attention (`deeprec_tpu_torch/ops/flash_attention.py`)
held against the JAX package's Pallas kernels run in interpret mode on the
CPU: the forward (o, lse) against `_pallas_forward`, the backward (dq, dk,
dv) against `_pallas_backward` given the same o, lse and do, causal and not,
at blocks 64 and 128, at [2, 2, 256, 32] and at the BST head width 8, with
length-prefix masks and with masks whose real keys are not a prefix (BST's,
scattered, a late first key); dead rows (every visible key masked) with the
Pallas kernel's semantics; the
autograd gradient against `jax.grad`; bf16 q, k, v against the JAX function
on bf16 inputs; `attention_reference`; the shape and dtype checks. On the CPU the port's wrappers run their plain versions, which are
also what the CUDA kernels are held against on the card.

JAX runs at "highest" matmul precision: in interpret mode Pallas otherwise
emulates the TPU's bf16 multiplies (tests/test_attention.py). Tolerances
are the JAX suite's own: 2e-5 on the forward (test_attention.py
test_flash_matches_reference), 5e-4 on the gradients
(test_pallas_backward_matches_reference)."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the module, not the function `deeprec_tpu.ops` re-exports under its name
jfa = importlib.import_module("deeprec_tpu.ops.flash_attention")
from deeprec_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-4


@pytest.fixture(autouse=True)
def _f32_matmuls():
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(B=2, H=2, L=256, D=32, seed=0, pattern=None):
    """q, k, v, do normal; mask from lengths in [L/2, L]. pattern="all"
    masks every key of batch element 1; pattern="head" masks its first 64
    keys (so under causal its rows 0-63 see no real key). Masks whose real
    keys are not a prefix (the CUDA kernels list each batch row's real
    keys): pattern="bst" is BST's encoder mask at L = 256, a history prefix
    of 1-199 keys, the target key alone at 200, then pads;
    pattern="scattered" has about 40 % of the keys real at random, masked
    keys between real ones inside every 16-key chunk; pattern="late" gives
    batch element 1 its first real key at 150 (not a block edge), so under
    causal its rows 0-149 see none although it has real keys later."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, L, D)).astype(np.float32)
                   for _ in range(4))
    lengths = rng.integers(L // 2, L + 1, B)
    mask = np.arange(L)[None, :] < lengths[:, None]
    if pattern == "all":
        mask[1] = False
    elif pattern == "head":
        mask[1] = True
        mask[1, :64] = False
    elif pattern == "bst":
        mask = np.arange(L)[None, :] < rng.integers(1, 200, B)[:, None]
        mask[:, 200] = True
    elif pattern == "scattered":
        mask = rng.random((B, L)) < 0.4
    elif pattern == "late":
        mask[1] = False
        mask[1, 150:] = rng.random(L - 150) < 0.5
        mask[1, 150] = True
    return q, k, v, mask, do


@functools.lru_cache(maxsize=None)
def _jax_run(D, causal, block, pattern=None):
    """JAX Pallas forward and backward (interpret mode) on _inputs(D=D)."""
    q, k, v, mask, do = _inputs(D=D, pattern=pattern)
    scale = 1.0 / np.sqrt(D)
    with jax.default_matmul_precision("highest"):
        o, lse = jfa._pallas_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(mask), causal, scale, block, block,
                                     True)
        dq, dk, dv = jfa._pallas_backward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), causal,
            scale, block, block, o, lse, jnp.asarray(do), True)
    return tuple(np.asarray(x) for x in (o, lse, dq, dk, dv))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# (D, causal, block, mask pattern): length prefixes, then the masks whose
# real keys are not a prefix (see _inputs)
CASES = [pytest.param(D, causal, block, None, id=f"{D}-{causal}-{block}")
         for D in (32, 8) for causal in (False, True) for block in (64, 128)] + [
    pytest.param(8, False, 128, "bst", id="8-False-128-bst"),
    pytest.param(8, True, 64, "bst", id="8-True-64-bst"),
    pytest.param(8, False, 64, "scattered", id="8-False-64-scattered"),
    pytest.param(32, True, 128, "scattered", id="32-True-128-scattered"),
    pytest.param(16, True, 64, "late", id="16-True-64-late"),
    pytest.param(16, True, 128, "late", id="16-True-128-late"),
]


@pytest.mark.parametrize("D,causal,block,pattern", CASES)
def test_forward_matches_pallas_interpret(D, causal, block, pattern):
    q, k, v, mask, _ = _inputs(D=D, pattern=pattern)
    o, lse = tfa.flash_forward(*_t(q, k, v, mask), causal, 1.0 / np.sqrt(D),
                               block, block)
    want_o, want_lse = _jax_run(D, causal, block, pattern)[:2]
    assert o.dtype == torch.float32 and lse.shape == (2, 2, 256)
    np.testing.assert_allclose(o.numpy(), want_o, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_ATOL, rtol=1e-6)


@pytest.mark.parametrize("D,causal,block,pattern", CASES)
def test_backward_matches_pallas_interpret(D, causal, block, pattern):
    """The same o, lse and do into both backwards."""
    q, k, v, mask, do = _inputs(D=D, pattern=pattern)
    o, lse, *want = _jax_run(D, causal, block, pattern)
    got = tfa.flash_backward(*_t(q, k, v, mask), causal, 1.0 / np.sqrt(D), block,
                             block, *_t(o, lse, do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal,dead", [pytest.param(False, "all", id="False"),
                                          pytest.param(True, "head", id="True"),
                                          pytest.param(True, "late", id="True-late")])
def test_dead_rows_follow_the_pallas_kernel(causal, dead):
    """A row whose visible keys are all masked: the forward gives the Pallas
    kernel's output, the mean of v over the keys of the K blocks that run
    (all of them when not causal; under causal the blocks up to the
    diagonal), with lse -1e30; every gradient of that row is exactly 0, and
    so is every masked key's dk and dv. "late": batch element 1's first
    real key is 150, so its causal rows 0-149 are dead though it has real
    keys, and rows 128-149 average the keys of two K blocks."""
    D, block = 16, 64
    q, k, v, mask, do = _inputs(D=D, pattern=dead)
    o, lse, *want = _jax_run(D, causal, block, dead)
    got_o, got_lse = tfa.flash_forward(*_t(q, k, v, mask), causal, 1.0 / np.sqrt(D),
                                       block, block)
    np.testing.assert_allclose(got_o.numpy(), o, atol=FWD_ATOL)
    np.testing.assert_allclose(got_lse.numpy(), lse, atol=FWD_ATOL, rtol=1e-6)
    first = 150 if dead == "late" else 64
    dead_rows = slice(0, first) if causal else slice(None)
    if causal:  # row i runs the K blocks up to its own: keys [0, 64 (i // 64 + 1))
        expect = np.stack([v[1, :, :(i // block + 1) * block].mean(axis=1)
                           for i in range(first)], axis=1)
    else:
        expect = v[1].mean(axis=1, keepdims=True)
    np.testing.assert_allclose(got_o.numpy()[1, :, dead_rows],
                               np.broadcast_to(expect, got_o[1, :, dead_rows].shape),
                               atol=1e-6)
    assert np.all(got_lse.numpy()[1, :, dead_rows] == np.float32(-1e30))
    dq, dk, dv = tfa.flash_backward(*_t(q, k, v, mask), causal, 1.0 / np.sqrt(D),
                                    block, block, got_o, got_lse, *_t(do))
    assert np.all(dq.numpy()[1, :, dead_rows] == 0.0)
    assert np.all(dk.numpy()[1][:, ~mask[1]] == 0.0)
    assert np.all(dv.numpy()[1][:, ~mask[1]] == 0.0)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_jax_grad(causal):
    """torch.autograd.grad through FlashAttention against jax.grad through
    the custom_vjp (Pallas interpret) of sum(o ** 2)."""
    q, k, v, mask, _ = _inputs(L=128, D=16, seed=5)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, jnp.asarray(mask), causal, None,
                                           64, 64, True) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(mask), causal, None, 64, 64)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_reference_matches_jax(causal):
    q, k, v, mask, _ = _inputs(L=128, D=16, seed=2)
    want = jfa.attention_reference(*map(jnp.asarray, (q, k, v, mask)), causal=causal)
    got = tfa.attention_reference(*_t(q, k, v, mask), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL)
    # and the flash path agrees with it where rows are live
    flash = tfa.flash_attention(*_t(q, k, v, mask), causal, None, 64, 64)
    np.testing.assert_allclose(flash.numpy(), got.numpy(), atol=FWD_ATOL)


def test_shapes_that_are_not_block_multiples_raise():
    q, k, v, mask, _ = _t(*_inputs(L=128, D=16))
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_attention(q, k, v, mask, False, None, 96, 64)
    with pytest.raises(ValueError, match="multiples"):
        tfa.flash_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100],
                            mask[:, :100], False, None, 64, 64)
    wide = torch.zeros((1, 1, 64, 160))
    with pytest.raises(ValueError, match="head dimension"):
        tfa.flash_attention(wide, wide, wide, torch.ones((1, 64), dtype=torch.bool),
                            False, None, 64, 64)
    with pytest.raises(TypeError, match="one dtype"):  # neither f32 nor bf16
        tfa.flash_attention(q.to(torch.float16), k.to(torch.float16),
                            v.to(torch.float16), mask, False, None, 64, 64)
    with pytest.raises(TypeError, match="one dtype"):  # mixed
        tfa.flash_attention(q.to(torch.bfloat16), k, v, mask, False, None, 64, 64)


# bf16 q, k, v: both sides upcast every load, compute in f32 and round o,
# dq, dk and dv to bf16 (nearest even); lse stays f32. A difference of f32
# summation order before that rounding can move a result by one bf16 ulp,
# so each tolerance is the f32 one plus one bf16 ulp of the value: 2^-8
# relative at the top of a binade, 2^-7 at its foot.
def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits), 0 at 0."""
    a = np.abs(x.astype(np.float64))
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(np.where(a > 0, a, 1.0))) - 7), 0.0)


def _assert_bf16_close(got, want, atol, name):
    err = np.abs(got.astype(np.float64) - want)
    tol = atol + _bf16_ulp(want)
    assert np.all(err <= tol), (
        f"{name}: {int((err > tol).sum())} elements off, max err "
        f"{err.max():.3g}, max err over tolerance {(err / tol).max():.3g}")


@functools.lru_cache(maxsize=None)
def _jax_bf16_run(causal, block):
    """The JAX flash_attention (Pallas, interpret mode) on bf16 inputs:
    o, and (dq, dk, dv) through its custom_vjp for a bf16 cotangent do."""
    q, k, v, mask, do = (jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
                         else jnp.asarray(a) for a in _inputs())
    with jax.default_matmul_precision("highest"):
        o, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
            q, k, v, mask, causal, None, block, block, True), q, k, v)
        grads = vjp(do)
    return tuple(np.asarray(x.astype(jnp.float32)) for x in (o, *grads)), o.dtype


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_matches_jax(causal):
    """bf16 q, k, v at [2, 2, 256, 32]: the forward and the gradients of
    the port's flash_attention against the JAX function's, in bf16."""
    block = 64
    want, jdtype = _jax_bf16_run(causal, block)
    q, k, v, mask, do = _inputs()
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, torch.from_numpy(mask), causal, None, block, block)
    assert out.dtype == torch.bfloat16 and str(jdtype) == "bfloat16"
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(torch.bfloat16))
    _assert_bf16_close(out.detach().float().numpy(), want[0], FWD_ATOL, "o")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want[1:]):
        assert g.dtype == torch.bfloat16
        _assert_bf16_close(g.float().numpy(), w, GRAD_ATOL, name)
    # lse stays f32, and the backward's delta comes from the stored bf16 o
    o, lse = tfa.flash_forward(*(t.detach() for t in leaves), torch.from_numpy(mask),
                               causal, 1.0 / np.sqrt(32), block, block)
    assert lse.dtype == torch.float32 and torch.equal(o, out.detach())
