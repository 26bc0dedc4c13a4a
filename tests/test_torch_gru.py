"""The port's GRU and AUGRU (`deeprec_tpu_torch.nn.gru_apply`, DIEN's
recurrences) held against `deeprec_tpu.nn.gru_apply` on the CPU at B 8,
L 12, D 16, H 8, from the same weights and inputs: the final state and
every state within 1e-5, and the gradients of a random projection of both
(`torch.autograd` against `jax.grad`, with respect to the weights, the
inputs and the attention scores) within 1e-4. The mask puts pads at the
start, in the middle and at the end of rows, and one row is all pads (its
states stay h0 = 0). Both sides multiply in plain f32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import nn as jnn
from deeprec_tpu_torch import nn as tnn
from deeprec_tpu_torch.nn import jax_leaf_names

torch.set_num_threads(1)

B, L, D, H = 8, 12, 16, 8
OUT_ATOL, GRAD_ATOL = 1e-5, 1e-4


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in
              jnn.gru_init(jax.random.PRNGKey(seed), D, H).items()}
    params["bz"] = rng.normal(0, 0.1, H).astype(np.float32)  # nonzero biases
    params["bh"] = rng.normal(0, 0.1, H).astype(np.float32)
    xs = rng.normal(0, 1, (B, L, D)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, :3] = False  # pads at the start
    mask[2, 4:7] = False  # in the middle
    mask[3, 9:] = False  # at the end
    mask[4, ::2] = False  # scattered
    mask[5] = False  # all pads
    att = rng.random((B, L)).astype(np.float32) * mask
    cot = rng.normal(0, 1, (B, L, H)).astype(np.float32)
    cot_final = rng.normal(0, 1, (B, H)).astype(np.float32)
    return params, xs, mask, att, cot, cot_final


def _jax(params, xs, mask, att, cot, cot_final):
    def f(p, x, a):
        h, hs = jnn.gru_apply(p, x, jnp.asarray(mask), a)
        return jnp.sum(hs * cot) + jnp.sum(h * cot_final), (h, hs)

    p = {k: jnp.asarray(v) for k, v in params.items()}
    a = None if att is None else jnp.asarray(att)
    argnums = (0, 1) if att is None else (0, 1, 2)
    grads, (h, hs) = jax.grad(f, argnums=argnums, has_aux=True)(p, jnp.asarray(xs), a)
    return h, hs, grads


def _torch(params, xs, mask, att, cot, cot_final):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    x = torch.tensor(xs, requires_grad=True)
    a = None if att is None else torch.tensor(att, requires_grad=True)
    h, hs = tnn.gru_apply(p, x, torch.tensor(mask), a)
    loss = torch.sum(hs * torch.tensor(cot)) + torch.sum(h * torch.tensor(cot_final))
    g = torch.autograd.grad(loss, [*p.values(), x] + ([] if a is None else [a]))
    return h.detach(), hs.detach(), [dict(zip(p, g[:len(p)])), *g[len(p):]]


@pytest.fixture(scope="module", params=["gru", "augru"])
def both(request):
    params, xs, mask, att, cot, cot_final = _inputs()
    if request.param == "gru":
        att = None
    return (mask, _jax(params, xs, mask, att, cot, cot_final),
            _torch(params, xs, mask, att, cot, cot_final))


def test_states_match_jax(both):
    mask, (jh, jhs, _), (h, hs, _) = both
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs), rtol=0, atol=OUT_ATOL)
    # the all-pad row stays at h0 = 0; a masked step repeats the state
    assert not hs[5].any() and not h[5].any()
    np.testing.assert_array_equal(hs[2, 4:7].numpy(), np.repeat(hs[2, 3:4].numpy(), 3, 0))
    assert not hs[1, :3].any()


def test_gradients_match_jax(both):
    _, (_, _, jgrads), (_, _, grads) = both
    for k, g in grads[0].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[0][k]), rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
    for g, jg in zip(grads[1:], jgrads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=GRAD_ATOL)
    assert not grads[1][5].any()  # the all-pad row's inputs get no gradient


def test_gru_module_is_the_jax_tree():
    """`GRU` holds gru_init's tree (leaf order and shapes as the JAX
    `gru_init`'s) and its forward is gru_apply over those parameters."""
    m = tnn.GRU(D, H, torch.Generator().manual_seed(0))
    leaves = jax.tree_util.tree_leaves(jnn.gru_init(jax.random.PRNGKey(0), D, H))
    names = jax_leaf_names(m)
    assert names == ["bh", "br", "bz", "wh", "wr", "wz"]
    assert [tuple(m.get_parameter(n).shape) for n in names] == [
        np.shape(leaf) for leaf in leaves]
    _, xs, mask, att, _, _ = _inputs(1)
    x, mk, a = torch.tensor(xs), torch.tensor(mask), torch.tensor(att)
    with torch.no_grad():
        got = m(x, mk, a)
        want = tnn.gru_apply({n: m.get_parameter(n) for n in names}, x, mk, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
