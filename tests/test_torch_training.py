"""The PyTorch port's training slice held against the JAX package on the
CPU: a small DLRM-DCN (emb 16, 4 categorical and 3 dense features, batch
64) trained 3 steps by the JAX `Trainer` (Adagrad(0.05) + optax.adam(1e-3))
and by the port's `Trainer` from the same initial state (carried across
with convert.py), on the same `SyntheticCriteo` batches; checkpoints that
carry training state across in both directions; and the bf16 restore that
rounds stochastically. Tables are compared per key (which slot a key wins
in a claim race is free)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.models import DLRMDCN
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

NUM_CAT, NUM_DENSE, B = 4, 3, 64
KW = dict(emb_dim=16, capacity=1 << 10, bottom=(16, 16), top=(16, 1),
          num_cat=NUM_CAT, num_dense=NUM_DENSE, cross_depth=2)
LR, DENSE_LR = 0.05, 1e-3
SENTINEL = int(np.iinfo(np.int32).min)
# Loss, table rows and Adagrad accumulators: the same f32 math in another
# summation order (XLA vs PyTorch), bf16 operand rounding in the MLPs, and
# initializer rows within 65 ulps of erfinv; Adagrad's step is bounded by its
# accumulator, so differences stay at rounding size.
RTOL, ATOL = 1e-4, 1e-5


def _dense_atol(steps):
    """Adam normalises each dense step to about lr: a gradient element near
    zero whose sign flips under another f32 summation order moves by up to
    2 lr per step, so dense parameters are held within 2 lr per step taken
    (plus f32 rounding)."""
    return 2 * DENSE_LR * steps + 1e-6


def _jax_trainer():
    return JaxTrainer(JaxDLRMDCN(**KW), JaxAdagrad(lr=LR), optax.adam(DENSE_LR))


def _port_trainer():
    return Trainer(DLRMDCN(**KW), Adagrad(lr=LR), adam(DENSE_LR), device="cpu")


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_from_jax(trainer, jst):
    """The port's TrainState from a JAX TrainState (tables with slots and
    counters, dense params, Adam state)."""
    tables = {
        bname: {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
                "meta": np.asarray(ts.meta),
                "slots": {k: np.asarray(v) for k, v in ts.slots.items()},
                "insert_fails": np.asarray(ts.insert_fails),
                "dedup_unique": np.asarray(ts.dedup_unique),
                "dedup_ids": np.asarray(ts.dedup_ids)}
        for bname, ts in jst.tables.items()
    }
    return convert.train_state_from_arrays(
        trainer, int(jst.step), tables,
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.dense)],
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.opt_state)])


def _rows_by_key(keys, values, accum, meta):
    keys = np.asarray(keys)
    return {int(keys[i]): (np.asarray(values)[i], np.asarray(accum)[i],
                           np.asarray(meta)[:, i])
            for i in np.nonzero(keys != SENTINEL)[0]}


def _jax_tables(jtr, jst):
    out = {}
    for bname, b in jtr.bundles.items():
        ts = jst.tables[bname]
        for k, f in enumerate(b.features):
            out[f.name] = _rows_by_key(ts.keys[k], ts.values[k], ts.slots["accum"][k],
                                       ts.meta[k])
    return out


def _port_tables(trainer, st):
    out = {}
    for bname, b in trainer.bundles.items():
        ts = st.tables[bname]
        for k, f in enumerate(b.features):
            out[f.name] = _rows_by_key(ts.keys[k], ts.values[k], ts.slots["accum"][k],
                                       ts.meta[k])
    return out


def _assert_tables_agree(got, want):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for key, (wv, wa, wm) in want[name].items():
            gv, ga, gm = got[name][key]
            np.testing.assert_array_equal(gm, wm)  # freq, version, dirty
            np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL)


def _assert_dense_agree(trainer, st, jst, steps):
    for name, leaf in zip(jax_leaf_names(trainer.model), jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_allclose(st.dense[name].numpy(), np.asarray(leaf),
                                   rtol=0, atol=_dense_atol(steps), err_msg=name)


@pytest.fixture(scope="module")
def slice_run():
    """3 JAX steps and 3 port steps from the JAX initial state on the same
    batches; 2 more batches for evaluation."""
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=0)
    batches = [gen.batch() for _ in range(5)]
    jtr, trainer = _jax_trainer(), _port_trainer()
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    losses = []
    for b in batches[:3]:
        jst, jm = jtr.train_step(jst, _jbatch(b))
        st, m = trainer.train_step(st, b)
        losses.append((float(m["loss"]), float(jm["loss"]),
                       float(m["accuracy"]), float(jm["accuracy"])))
    return dict(jtr=jtr, jst=jst, trainer=trainer, st=st, batches=batches,
                losses=losses)


def test_train_losses_match_jax(slice_run):
    for loss, jloss, acc, jacc in slice_run["losses"]:
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
        assert acc == jacc
    assert slice_run["st"].step == int(slice_run["jst"].step) == 3


def test_train_tables_match_jax(slice_run):
    """Every inserted key: its value and accumulator rows, freq, version
    and dirty flag; and the insert-failure counters."""
    r = slice_run
    _assert_tables_agree(_port_tables(r["trainer"], r["st"]), _jax_tables(r["jtr"], r["jst"]))
    for bname, ts in r["st"].tables.items():
        jts = r["jst"].tables[bname]
        np.testing.assert_array_equal(ts.insert_fails.numpy(), np.asarray(jts.insert_fails))
        np.testing.assert_array_equal(ts.dedup_unique.numpy(), np.asarray(jts.dedup_unique))
        np.testing.assert_array_equal(ts.dedup_ids.numpy(), np.asarray(jts.dedup_ids))


def test_train_dense_params_match_jax(slice_run):
    r = slice_run
    _assert_dense_agree(r["trainer"], r["st"], r["jst"], 3)
    assert int(r["st"].opt_state.count) == int(r["jst"].opt_state[0].count) == 3


def test_evaluate_auc_matches_jax(slice_run):
    """Streamed loss and AUC over 2 held-out batches. The AUC histograms
    bin the probabilities into 512 bins: only a probability within rounding
    of a bin edge can land in another bin."""
    r = slice_run
    want = r["jtr"].evaluate(r["jst"], [_jbatch(b) for b in r["batches"][3:]])
    got = r["trainer"].evaluate(r["st"], r["batches"][3:])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["auc"], want["auc"], atol=1e-3)


def test_jax_save_port_restore_then_step_agrees(tmp_path):
    """2 JAX train steps, a JAX checkpoint, the port restores it (rows,
    `slot:accum`, opt.npz); then one more step on each side agrees."""
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=1)
    batches = [gen.batch() for _ in range(3)]
    jtr = _jax_trainer()
    jst = jtr.init(0)
    for b in batches[:2]:
        jst, _ = jtr.train_step(jst, _jbatch(b))
    jst, _ = JaxCkpt(str(tmp_path), jtr).save(jst)
    trainer = _port_trainer()
    st = CheckpointManager(str(tmp_path), trainer).restore()
    assert st.step == 2 and int(st.opt_state.count) == 2
    _assert_tables_agree(_port_tables(trainer, st), _jax_tables(jtr, jst))
    jst, jm = jtr.train_step(jst, _jbatch(batches[2]))
    st, m = trainer.train_step(st, batches[2])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
    _assert_tables_agree(_port_tables(trainer, st), _jax_tables(jtr, jst))
    _assert_dense_agree(trainer, st, jst, 1)


def test_port_save_jax_restore_then_step_agrees(tmp_path):
    """2 port train steps from the JAX initial state, a port checkpoint,
    the JAX package restores it; then one more step on each side agrees
    (the port continuing from its own restore)."""
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=2)
    batches = [gen.batch() for _ in range(3)]
    jtr, trainer = _jax_trainer(), _port_trainer()
    st = _port_from_jax(trainer, jtr.init(0))
    for b in batches[:2]:
        st, _ = trainer.train_step(st, b)
    st, _ = CheckpointManager(str(tmp_path), trainer).save(st)
    jst = JaxCkpt(str(tmp_path), jtr).restore()
    assert int(jst.step) == 2 and int(jst.opt_state[0].count) == 2
    st = CheckpointManager(str(tmp_path), trainer).restore()
    _assert_tables_agree(_port_tables(trainer, st), _jax_tables(jtr, jst))
    jst, jm = jtr.train_step(jst, _jbatch(batches[2]))
    st, m = trainer.train_step(st, batches[2])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
    _assert_tables_agree(_port_tables(trainer, st), _jax_tables(jtr, jst))
    _assert_dense_agree(trainer, st, jst, 1)


@pytest.mark.parametrize("origin", ["float32", "bfloat16"])
def test_bf16_restore_rounds_stochastically(origin):
    """Checkpointed rows restored into a bf16 table (`import_rows`). From
    f32 rows whose values are all 1 + 2^-9 (a quarter of the way from 1 to
    the next bf16 value) the JAX package rounds stochastically, and its
    mean stays near 1 + 2^-9 where round-to-nearest gives exactly 1.0; the
    port does the same with its own bits. Rows that came from a bf16 table
    are representable and restore bit for bit on both sides."""
    from deeprec_tpu import config as jcfg
    from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
    from deeprec_tpu.training.checkpoint import import_rows as jax_import_rows
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.training.checkpoint import import_rows

    n, D = 2000, 16
    rng = np.random.default_rng(8)
    v = np.float32(1.0 + 2.0 ** -9)
    rows = {"keys": rng.permutation(1 << 20)[:n].astype(np.int32),
            "values": np.full((n, D), v, np.float32),
            "freqs": np.ones(n, np.int32), "versions": np.zeros(n, np.int32)}
    if origin == "bfloat16":
        rows["values"] = np.asarray(jnp.asarray(rng.normal(0, 1, (n, D)), jnp.bfloat16)
                                    .astype(jnp.float32))

    def cfg(mod):
        return mod.TableConfig(name="t", dim=D, capacity=1 << 12, value_dtype="bfloat16")

    jt, tt = JaxTable(cfg(jcfg)), EmbeddingTable(cfg(tcfg))
    js = jax_import_rows(jt, jt.create(), rows)
    ts = tt.create(device="cpu")
    import_rows(tt, ts, 0, rows)
    order = {int(k): i for i, k in enumerate(rows["keys"])}

    def restored(keys, values):
        by_key = _rows_by_key(keys, values, np.zeros(len(keys)), np.zeros((3, len(keys))))
        assert by_key.keys() == order.keys()
        return np.stack([by_key[int(k)][0] for k in rows["keys"]])

    got = restored(ts.keys[0], ts.values[0].float())
    want = restored(js.keys, js.values.astype(jnp.float32))
    if origin == "bfloat16":
        np.testing.assert_array_equal(got, rows["values"])
        np.testing.assert_array_equal(want, rows["values"])
        return
    # 2000 x 16 Bernoulli(1/4) draws of the 2^-7 step: the mean's standard
    # deviation is 2^-7 sqrt(3/16 / 32000) = 1.9e-5; 8e-5 is four of them
    for out in (got, want):
        assert set(np.unique(out)) <= {np.float32(1.0), np.float32(1.0 + 2.0 ** -7)}
        assert abs(out.mean() - v) < 8e-5, out.mean()


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (2^-133 at zero, bf16's
    smallest subnormal)."""
    a = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, np.exp2(e - 7), 2.0 ** -133)


def test_bf16_train_step_matches_jax_within_one_ulp():
    """bf16 tables through `Trainer.train_step` against the JAX Trainer:
    a JAX state after 2 steps is carried across, one more step is taken on
    each side, and every key's row agrees within one bf16 ulp (the
    stochastic-rounding bits are the port's `sr_bits`, not threefry);
    accumulators, freq / version / dirty and the dense leaves within the
    f32 tolerances."""
    import dataclasses

    def bf16(model):
        model.features = [
            dataclasses.replace(f, table=dataclasses.replace(f.table, value_dtype="bfloat16"))
            if getattr(f, "table", None) is not None else f for f in model.features]
        return model

    jtr = JaxTrainer(bf16(JaxDLRMDCN(**KW)), JaxAdagrad(lr=LR), optax.adam(DENSE_LR))
    trainer = Trainer(bf16(DLRMDCN(**KW)), Adagrad(lr=LR), adam(DENSE_LR), device="cpu")
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=4)
    batches = [gen.batch() for _ in range(3)]
    jst = jtr.init(0)
    for b in batches[:2]:
        jst, _ = jtr.train_step(jst, _jbatch(b))
    st = _port_from_jax(trainer, jst)
    for ts in st.tables.values():
        assert ts.values.dtype == torch.bfloat16
    jst, jm = jtr.train_step(jst, _jbatch(batches[2]))
    st, m = trainer.train_step(st, batches[2])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
    got = {}
    for bname, b in trainer.bundles.items():
        ts = st.tables[bname]
        for k, f in enumerate(b.features):
            got[f.name] = _rows_by_key(ts.keys[k], ts.values[k].float(), ts.slots["accum"][k],
                                       ts.meta[k])
    want = {}
    for bname, b in jtr.bundles.items():
        ts = jst.tables[bname]
        for k, f in enumerate(b.features):
            want[f.name] = _rows_by_key(ts.keys[k], np.asarray(ts.values[k].astype(jnp.float32)),
                                        ts.slots["accum"][k], ts.meta[k])
    assert got.keys() == want.keys()
    moved = 0
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for key, (wv, wa, wm) in want[name].items():
            gv, ga, gm = got[name][key]
            np.testing.assert_array_equal(gm, wm)
            assert np.all(np.abs(gv - wv) <= _bf16_ulp(wv)), (name, key, gv, wv)
            np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ATOL)
            moved += int(np.any(gv != wv))
    _assert_dense_agree(trainer, st, jst, 3)
    print(f"bf16 rows that differ by one ulp: {moved}")
