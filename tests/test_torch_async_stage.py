"""The port's async embedding stage (`deeprec_tpu_torch/parallel/
async_stage.py`) held against the JAX package's `AsyncShardedTrainer` on
the CPU.

JAX runs on 2 virtual CPU devices, the port on 2 gloo ranks
(`tests/torch_sharded_rank.py`, one process set for the file). Both start
from the JAX state of `init(0)` and run `bootstrap` and 5 async steps of
the JAX `tests/test_async_stage.py` model (WDL, emb 4, 2^10 slots, 3
categorical and 2 dense features, global batch 256) with the allgather and
the a2a exchange on the f32 wire: the losses within 1e-4 relative and the
rows per key within tests/test_torch_sharded.py's tolerances. Within the
port: with every learning rate 0 the async loss at step t is the sync
trainer's `eval_step` loss on batch t-1 within 1e-5 relative (stale by
exactly one step), and `train_steps_async` over K batches equals K single
async steps bit for bit.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.parallel import AsyncShardedTrainer as JaxAsync
from deeprec_tpu.parallel import make_mesh as jax_mesh
from test_torch_sharded import ATOL, RTOL, assert_rows_agree, export_jax_state, jax_rows
from test_torch_sharded import port_rows, shared
from torch_sharded_rank import spawn

KW = dict(emb_dim=4, capacity=1 << 10, hidden=(16,), num_cat=3, num_dense=2)
LR, DENSE_LR, B, N, STEPS = 0.2, 5e-3, 256, 2, 5
SPEC = dict(model=KW, model_name="wdl", lr=LR, dense_lr=DENSE_LR)
F32 = dict(exchange_dtype="float32")


def _batches(n=STEPS + 1):
    gen = SyntheticCriteo(batch_size=B, num_cat=3, num_dense=2, vocab=800, seed=0)
    return [gen.batch() for _ in range(n)]


def _jax_model():
    model = JaxWDL(**KW)
    model.features = [dataclasses.replace(f, table=dataclasses.replace(
        f.table, exchange_dtype="float32")) if getattr(f, "table", None) is not None else f
        for f in model.features]
    return model


def _jax_async(mesh, comm, batches, state_path=None):
    tr = JaxAsync(_jax_model(), JaxAdagrad(lr=LR), optax.adam(DENSE_LR), mesh=mesh, comm=comm)
    st = tr.init(0)
    if state_path:
        export_jax_state(st, state_path)
    J = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ast = tr.bootstrap(st, J[0])
    losses = []
    for t in range(1, STEPS + 1):
        ast, m = tr.train_step_async(ast, J[t])
        losses.append(float(m["loss"]))
    rows, counters = jax_rows(tr, ast.inner)
    return dict(losses=losses, rows=rows, counters=counters)


def _async2(tmp):
    batches = _batches()
    mesh = jax_mesh(N)
    state = os.path.join(tmp, "jax_init.npz")
    jax_side = {"allgather": _jax_async(mesh, "allgather", batches, state),
                "a2a": _jax_async(mesh, "a2a", batches)}
    jobs = [dict(name=comm, kind="async", comm=comm, state=state, steps=STEPS, window=True, **F32)
            for comm in ("allgather", "a2a")]
    jobs.append(dict(name="lr0", kind="async", comm="allgather", state=state, steps=3,
                     lr=0.0, dense_lr=0.0, sync_eval=True, **F32))
    port = spawn(tmp, N, jobs, "async2", batches=batches, timeout=300, **SPEC)
    return dict(jax=jax_side, port=port)


@pytest.fixture(scope="module")
def async2(tmp_path_factory):
    return shared(tmp_path_factory, "async2", _async2)


@pytest.mark.parametrize("comm", ["allgather", "a2a"])
def test_async_steps_match_jax(async2, comm):
    j, outs = async2["jax"][comm], async2["port"][comm]
    np.testing.assert_allclose(outs[0]["losses"], j["losses"], rtol=RTOL)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    rows, counters = port_rows(outs)
    assert_rows_agree(rows, j["rows"], rtol=RTOL, atol=ATOL)
    assert counters == j["counters"]


def test_async_step_is_stale_by_one(async2):
    """With lr 0 everywhere, async step t reports the loss of batch t-1:
    the sync trainer's eval_step on batch t-1 within 1e-5 relative."""
    o = async2["port"]["lr0"][0]
    np.testing.assert_allclose(o["losses"], o["sync_eval"], rtol=1e-5)
    assert len(set(np.round(o["losses"], 6))) == len(o["losses"])  # distinct batches


@pytest.mark.parametrize("comm", ["allgather", "a2a"])
def test_train_steps_async_equals_single_steps(async2, comm):
    for o in async2["port"][comm]:
        np.testing.assert_array_equal(o["window_losses"], o["losses"])
        for k in o:
            if k.startswith(("r:", "d:")):
                np.testing.assert_array_equal(o["w." + k], o[k], err_msg=k)
