"""The PyTorch port's serving slice held against the JAX package on the CPU:
checkpoint cross-restore (JAX save -> port restore and port save -> JAX
restore, exact per key), convert.py weights giving the same lookup
embeddings, and the port's Predictor answering the same batches as the JAX
Predictor on one checkpoint (live, missing and pad ids).

The model is a small DLRM-DCN trained for 3 JAX steps on SyntheticCriteo.
Slot positions are not compared: which slot a key wins in a claim race is
free, so tables are compared per key."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.embedding.table import META_FREQ, META_VERSION
from deeprec_tpu_torch.models import DLRMDCN
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.serving import Predictor
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

NUM_CAT, NUM_DENSE = 4, 3
KW = dict(emb_dim=16, capacity=1 << 10, bottom=(32, 16), top=(32, 1),
          num_cat=NUM_CAT, num_dense=NUM_DENSE, cross_depth=2)
SENTINEL = int(np.iinfo(np.int32).min)
# Probabilities: both sides round the dense operands to bf16 and accumulate
# in f32, but XLA and PyTorch sum in different orders, and a 1-ulp f32
# difference before a rounding can flip one bf16 operand (a 2^-8 relative
# step). Measured max |diff| over 20 batches of 256 rows: 2.0e-5.
PROB_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """3 JAX train steps, then a full checkpoint."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    model = JaxDLRMDCN(**KW)
    tr = JaxTrainer(model, Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=0)
    for _ in range(3):
        st, _ = tr.train_step(st, {k: jnp.asarray(v) for k, v in gen.batch().items()})
    st, _ = JaxCkpt(d, tr).save(st)
    return model, tr, st, d


def _rows_by_key(keys, values, meta):
    """{key: (row, freq, version)} of one table's live slots."""
    keys, values, meta = (np.asarray(a) for a in (keys, values, meta))
    live = np.nonzero(keys != SENTINEL)[0]
    return {
        int(keys[i]): (values[i].tolist(), int(meta[META_FREQ, i]),
                       int(meta[META_VERSION, i]))
        for i in live
    }


def _jax_tables(tr, st):
    """{feature: rows_by_key} of a JAX TrainState."""
    out = {}
    for bname, b in tr.bundles.items():
        ts = st.tables[bname]
        for k, f in enumerate(b.features):
            sub = jax.tree.map(lambda a: a[k], ts) if b.stacked else ts
            out[f.name] = _rows_by_key(sub.keys, sub.values.reshape(
                sub.keys.shape[0], -1), sub.meta)
    return out


def _port_tables(trainer, state):
    out = {}
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        for k, f in enumerate(b.features):
            m = k if b.stacked else 0
            out[f.name] = _rows_by_key(ts.keys[m], ts.values[m], ts.meta[m])
    return out


def _batch(st, tr, B, seed):
    """Ids 80% live (drawn from the table), 10% never seen, 10% pad."""
    rng = np.random.default_rng(seed)
    tables = _jax_tables(tr, st)
    batch = {}
    for c in range(NUM_CAT):
        name = f"C{c + 1}"
        live = np.asarray(sorted(tables[name]), np.int32)
        ids = rng.choice(live, B).astype(np.int32)
        u = rng.random(B)
        ids[u < 0.2] = (10_000_000 + rng.integers(0, 1000, B))[u < 0.2]
        ids[u < 0.1] = -1
        batch[name] = ids
    for i in range(NUM_DENSE):
        batch[f"I{i + 1}"] = rng.lognormal(0, 1, (B, 1)).astype(np.float32)
    return batch


def test_jax_save_port_restore_exact(jax_run):
    model, tr, st, d = jax_run
    trainer = Trainer(DLRMDCN(**KW), device="cpu")
    state = CheckpointManager(d, trainer).restore()
    assert state.step == int(st.step) == 3
    assert _port_tables(trainer, state) == _jax_tables(tr, st)
    want = jax.tree_util.tree_leaves(st.dense)
    for name, leaf in zip(jax_leaf_names(trainer.model), want):
        np.testing.assert_array_equal(state.dense[name].numpy(), np.asarray(leaf))


def test_port_save_jax_restore_exact(jax_run, tmp_path):
    model, tr, st, d = jax_run
    trainer = Trainer(DLRMDCN(**KW), device="cpu")
    state = CheckpointManager(d, trainer).restore()
    state, _ = CheckpointManager(str(tmp_path), trainer).save(state)
    jtr = JaxTrainer(JaxDLRMDCN(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
    back = JaxCkpt(str(tmp_path), jtr).restore()
    assert int(back.step) == 3
    assert _jax_tables(jtr, back) == _jax_tables(tr, st)
    for a, b in zip(jax.tree_util.tree_leaves(back.dense),
                    jax.tree_util.tree_leaves(st.dense)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _converted(tr, st):
    trainer = Trainer(DLRMDCN(**KW), device="cpu")
    tables = {
        bname: {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
                "meta": np.asarray(ts.meta)}
        for bname, ts in st.tables.items()
    }
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(st.dense)]
    return trainer, convert.train_state_from_arrays(trainer, int(st.step), tables, leaves)


def test_convert_forward_views_exact(jax_run):
    """Slot-for-slot converted state: every position's looked-up row is
    the JAX row, bit for bit (live, missing and pad positions)."""
    model, tr, st, d = jax_run
    trainer, state = _converted(tr, st)
    batch = _batch(st, tr, 64, seed=1)
    jviews, _ = jax.jit(tr.forward_views)(st, {k: jnp.asarray(v) for k, v in batch.items()})
    views, _ = trainer.forward_views(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name, (emb, inv, mask) in views.items():
        jemb, jinv, jmask = (np.asarray(a) for a in jviews[name])
        np.testing.assert_array_equal(emb.numpy()[inv.numpy()], jemb[jinv])
        np.testing.assert_array_equal(mask.numpy(), jmask)


@pytest.mark.parametrize("B", [64, 1, 37])
def test_predictor_matches_jax(jax_run, B):
    model, tr, st, d = jax_run
    batch = _batch(st, tr, B, seed=B)
    want = JaxPredictor(model, d).predict(batch)
    p = Predictor(DLRMDCN(**KW), d, device="cpu")
    got, version = p.predict_versioned(batch)
    assert version == 0 and p.step == 3
    assert got.shape == (B,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROB_ATOL)


MULTI_L = 8


@pytest.fixture(scope="module")
def multi_hot_run(tmp_path_factory):
    """A DLRM-DCN at capacity 2^12: 3 JAX train steps, then a full
    checkpoint (every feature of its stacked bundle pooled by mean)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt_multi_hot"))
    kw = dict(KW, capacity=1 << 12)
    tr = JaxTrainer(JaxDLRMDCN(**kw), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=2000, seed=3)
    for _ in range(3):
        st, _ = tr.train_step(st, {k: jnp.asarray(v) for k, v in gen.batch().items()})
    st, _ = JaxCkpt(d, tr).save(st)
    return kw, tr, st, d


def _multi_hot_batch(st, tr, B, seed):
    """[B, MULTI_L] ids per feature: each bag has its own real length in
    [1, MULTI_L] (some bags full), its real positions 80% live, 10% never
    seen, 10% pad, and -1 past its length."""
    rng = np.random.default_rng(seed)
    tables = _jax_tables(tr, st)
    batch = {}
    for c in range(NUM_CAT):
        name = f"C{c + 1}"
        live = np.asarray(sorted(tables[name]), np.int32)
        ids = rng.choice(live, (B, MULTI_L)).astype(np.int32)
        u = rng.random((B, MULTI_L))
        ids[u < 0.2] = (10_000_000 + rng.integers(0, 1000, (B, MULTI_L)))[u < 0.2]
        ids[u < 0.1] = -1
        lengths = rng.integers(1, MULTI_L + 1, B)
        lengths[::5] = MULTI_L
        batch[name] = np.where(np.arange(MULTI_L)[None, :] < lengths[:, None], ids, -1)
    for i in range(NUM_DENSE):
        batch[f"I{i + 1}"] = rng.lognormal(0, 1, (B, 1)).astype(np.float32)
    return batch


@pytest.mark.parametrize("B", [64, 37])
def test_multi_hot_predictor_matches_jax(multi_hot_run, B):
    """Multi-hot requests ([B, L] bags of mixed real lengths, -1 pads): the
    port pools each bag through kernel #4's path (its plain version here),
    the JAX Predictor through `combine`; probabilities within PROB_ATOL."""
    kw, tr, st, d = multi_hot_run
    batch = _multi_hot_batch(st, tr, B, seed=100 + B)
    want = JaxPredictor(JaxDLRMDCN(**kw), d).predict(batch)
    got = Predictor(DLRMDCN(**kw), d, device="cpu").predict(batch)
    assert got.shape == (B,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROB_ATOL)
