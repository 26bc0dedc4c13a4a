"""The port's ring attention (`deeprec_tpu_torch/parallel/ring_attention.py`)
and `mesh.ppermute` held against the JAX package on the CPU.

JAX runs `ring_attention_sharded` on 4 virtual CPU devices (float32
products, as tests/test_attention.py runs it), the port on 4 gloo ranks
(`tests/torch_sharded_rank.py`, one process set), on the same global q, k,
v and key mask, causal and not: the gathered outputs within 2e-5 and the
gradients of sum(o^2) within 3e-4 of JAX's; at L = 2048 the output within
3e-5. `ppermute`'s backward is the reverse rotation.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprec_tpu.parallel import make_mesh as jax_mesh
from deeprec_tpu.parallel.ring_attention import ring_attention_sharded as jax_ring
from test_torch_sharded import shared
from torch_sharded_rank import spawn

P = 4


def _inputs(B, H, L, D, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    q, k, v = (jax.random.normal(ks[i], (B, H, L, D), jnp.float32) for i in range(3))
    lengths = jax.random.randint(ks[3], (B,), L // 2, L + 1)
    mask = jnp.arange(L)[None, :] < lengths[:, None]
    return q, k, v, mask


def _jax_side(mesh, q, k, v, mask, causal, grads=True):
    """The JAX ring's output and (grads) the gradients of sum(o^2), one
    jitted program."""
    def loss(q, k, v):
        o = jax_ring(mesh, q, k, v, mask, axis="sp", causal=causal)
        return jnp.sum(o ** 2), o

    with jax.default_matmul_precision("highest"):
        if not grads:
            return {"o": np.asarray(jax.jit(loss)(q, k, v)[1])}
        (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"o": np.asarray(o), "dq": np.asarray(g[0]), "dk": np.asarray(g[1]),
            "dv": np.asarray(g[2])}


def _ring4(tmp):
    mesh = jax_mesh(P, axis="sp")
    cases = {"small": dict(shape=(2, 2, 256, 16), seed=3, causal=(False, True)),
             "long": dict(shape=(1, 2, 2048, 16), seed=7, causal=(False,))}
    jax_res, jobs = {}, []
    for name, c in cases.items():
        q, k, v, mask = _inputs(*c["shape"], c["seed"])
        path = os.path.join(tmp, f"{name}.npz")
        np.savez(path, q=np.asarray(q), k=np.asarray(k), v=np.asarray(v),
                 mask=np.asarray(mask))
        for causal in c["causal"]:
            jax_res[(name, causal)] = _jax_side(mesh, q, k, v, mask, causal,
                                                grads=name == "small")
        jobs.append(dict(name=name, kind="ring", inputs=path, causal=list(c["causal"]),
                         grads=name == "small"))
    port = spawn(tmp, P, jobs, "ring4", timeout=300, model={}, lr=0.0, dense_lr=0.0)
    return dict(jax=jax_res, port=port)


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    return shared(tmp_path_factory, "ring4", _ring4)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(ring4, causal):
    want = ring4["jax"][("small", causal)]
    tag = "causal" if causal else "full"
    for o in ring4["port"]["small"]:  # every position holds the global output
        np.testing.assert_allclose(o[f"{tag}:o"], want["o"], atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match_jax(ring4, causal):
    want = ring4["jax"][("small", causal)]
    tag = "causal" if causal else "full"
    for o in ring4["port"]["small"]:
        for n in ("dq", "dk", "dv"):
            np.testing.assert_allclose(o[f"{tag}:{n}"], want[n], atol=3e-4, err_msg=n)


def test_ring_attention_long_context_matches_jax(ring4):
    want = ring4["jax"][("long", False)]
    for o in ring4["port"]["long"]:
        np.testing.assert_allclose(o["full:o"], want["o"], atol=3e-5)


def test_ppermute_backward_is_the_reverse_rotation(ring4):
    """Position i receives position i-1's tensor; the gradient of position
    j's loss (weights (j + 1) * [1, 2, 3]) reaches position j-1."""
    for i, o in enumerate(ring4["port"]["small"]):
        np.testing.assert_array_equal(o["pp:y"], np.full(3, (i - 1) % P, np.float32))
        np.testing.assert_array_equal(o["pp:grad"],
                                      ((i + 1) % P + 1) * np.arange(1.0, 4.0, dtype=np.float32))
