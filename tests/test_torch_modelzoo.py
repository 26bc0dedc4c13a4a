"""WDL, DeepFM, DCN, DCNv2, MaskNet and DIN in the PyTorch port, held
against the JAX package on the CPU, one parametrised test per check with
each model as a case, at a small size (emb 8, capacity 2^10, hidden
(32, 16), 6 categorical and 4 numeric Criteo features, batch 64; DIN over
histories of 20 with the shared item and category tables):

- the parameter trees: the JAX `init` carried across by convert.py, leaf
  for leaf (WDL's and DeepFM's 0-d leaves, MaskNet's list of dicts, DCN's
  vector weights);
- `eval_step` on the carried initial state against the JAX
  `Trainer.eval_step` (the port serves and evaluates every pooled feature
  through kernel #4, the JAX package through `combine`);
- 3 train steps from that state on the same batches: losses, tables per
  key and dense leaves within tests/test_torch_training.py's tolerances;
- a checkpoint written by the port and restored by the JAX package (tables
  per key, shared ones included, and dense leaves exact), then served by
  both Predictors.

Probabilities are held within tests/test_torch_serving.py's PROB_ATOL:
both sides round the dense operands to bf16, and XLA and PyTorch sum in
other orders."""
import jax
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu import models as jmodels
from deeprec_tpu.data import SyntheticBehaviorSequence as JaxBehavior
from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch import models as tmodels
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.ops import fused_gather_combine
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.serving import Predictor
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

from test_torch_serving import PROB_ATOL  # noqa: E402  (shared tolerances)
from test_torch_training import (  # noqa: E402
    ATOL, DENSE_LR, LR, RTOL, _dense_atol, _jbatch, _port_from_jax, _rows_by_key,
)

torch.set_num_threads(1)

B, VOCAB, SEQ = 64, 300, 20
CRITEO = dict(emb_dim=8, capacity=1 << 10, num_cat=6, num_dense=4)
MODELS = {
    "WDL": dict(CRITEO, hidden=(32, 16)),
    "DeepFM": dict(CRITEO, hidden=(32, 16)),
    "DCN": dict(CRITEO, hidden=(32, 16), cross_depth=2),
    "DCNv2": dict(CRITEO, hidden=(32, 16), cross_depth=2),
    "MaskNet": dict(CRITEO, num_blocks=2, block_dim=16, mask_hidden=16, hidden=(16,)),
    "DIN": dict(emb_dim=8, capacity=1 << 10, att_hidden=(8,), hidden=(32, 16)),
}
# leaves of each JAX tree that the module layout has to reproduce
SPECIAL_LEAVES = {
    "WDL": {"wide_b": (), "wide_w": (10,)},
    "DeepFM": {"bias": (), "linear_w": (10,)},
    "DCN": {"cross.layers.0.w": (52,), "cross.layers.1.b": (52,)},
    "DCNv2": {"cross.layers.0.w": (52, 52)},
    "MaskNet": {"blocks.0.mask2.w": (16, 52), "blocks.1.mask2.w": (16, 16),
                "blocks.0.proj.w": (52, 16), "blocks.1.ln.g": (16,)},
    "DIN": {"att.mlp.layers.0.w": (64, 8), "mlp.layers.0.w": (40, 32)},
}


def _gen(name, seed):
    if name == "DIN":
        return JaxBehavior(batch_size=B, vocab=VOCAB, seq_len=SEQ, seed=seed)
    return SyntheticCriteo(batch_size=B, num_cat=CRITEO["num_cat"],
                           num_dense=CRITEO["num_dense"], vocab=VOCAB, seed=seed)


def _jax_trainer(name):
    return JaxTrainer(getattr(jmodels, name)(**MODELS[name]), JaxAdagrad(lr=LR),
                      optax.adam(DENSE_LR))


def _port_trainer(name):
    return Trainer(getattr(tmodels, name)(**MODELS[name]), Adagrad(lr=LR),
                   adam(DENSE_LR), device="cpu")


def _tables(tr, st, port):
    """{table: {key: (value row, accum row, meta)}} per member of a stacked
    bundle and once per shared table (the port's unstacked states carry a
    table axis of 1, the JAX package's none)."""
    out = {}
    for bname, b in tr.bundles.items():
        ts = st.tables[bname]
        members = ([(k, f.name) for k, f in enumerate(b.features)] if b.stacked
                   else [(0 if port else None, bname)])

        def pick(a, k):
            return a if k is None else a[k]

        for k, name in members:
            out[name] = _rows_by_key(pick(ts.keys, k), pick(ts.values, k),
                                     pick(ts.slots["accum"], k), pick(ts.meta, k))
    return out


def _assert_tables_agree(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for key, (wv, wa, wm) in want[name].items():
            gv, ga, gm = got[name][key]
            np.testing.assert_array_equal(gm, wm)  # freq, version, dirty
            np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)
            np.testing.assert_allclose(ga, wa, rtol=rtol, atol=atol)


@pytest.fixture(scope="module", params=sorted(MODELS))
def zoo_run(request):
    """One model: the JAX initial state carried into the port, both sides'
    eval_step on it, then 3 train steps on each side on the same batches."""
    name = request.param
    gen = _gen(name, 0)
    batches = [gen.batch() for _ in range(4)]
    jtr, trainer = _jax_trainer(name), _port_trainer(name)
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    fused_gather_combine.launches = 0
    evals = (jtr.eval_step(jst, _jbatch(batches[3])), trainer.eval_step(st, batches[3]))
    losses = []
    for b in batches[:3]:
        jst, jm = jtr.train_step(jst, _jbatch(b))
        st, m = trainer.train_step(st, b)
        losses.append((float(m["loss"]), float(jm["loss"])))
    return dict(name=name, jtr=jtr, jst=jst, trainer=trainer, st=st, evals=evals,
                losses=losses)


def test_param_tree_is_the_jax_tree(zoo_run):
    r = zoo_run
    names = jax_leaf_names(r["trainer"].model)
    leaves = jax.tree_util.tree_leaves(r["jtr"].init(0).dense)
    assert [tuple(r["trainer"].model.get_parameter(n).shape) for n in names] == [
        np.shape(leaf) for leaf in leaves]
    shapes = dict(zip(names, (np.shape(leaf) for leaf in leaves)))
    for leaf, shape in SPECIAL_LEAVES[r["name"]].items():
        assert shapes[leaf] == shape, leaf
    assert {n: [f.name for f in b.features] for n, b in r["trainer"].bundles.items()} == {
        n: [f.name for f in b.features] for n, b in r["jtr"].bundles.items()}


def test_eval_matches_jax(zoo_run):
    """The carried initial state: loss and probabilities against the JAX
    eval_step; the CPU path runs #4's plain version and counts no launch."""
    (jloss, jprobs), (loss, probs) = zoo_run["evals"]
    assert probs.shape == (B,)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=PROB_ATOL)
    assert fused_gather_combine.launches == 0


def test_train_losses_match_jax(zoo_run):
    for loss, jloss in zoo_run["losses"]:
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    assert zoo_run["st"].step == int(zoo_run["jst"].step) == 3


def test_train_tables_match_jax(zoo_run):
    """Every inserted key of every table (stacked members, shared tables):
    value and accumulator rows, freq, version and dirty flag."""
    r = zoo_run
    _assert_tables_agree(_tables(r["trainer"], r["st"], True),
                         _tables(r["jtr"], r["jst"], False))


def test_train_dense_params_match_jax(zoo_run):
    r = zoo_run
    for name, leaf in zip(jax_leaf_names(r["trainer"].model),
                          jax.tree_util.tree_leaves(r["jst"].dense)):
        np.testing.assert_allclose(r["st"].dense[name].numpy(), np.asarray(leaf),
                                   rtol=0, atol=_dense_atol(3), err_msg=name)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_checkpoint_restored_and_served_by_jax(name, tmp_path):
    """2 port train steps from the JAX initial state, a port checkpoint; the
    JAX package restores it as the port does, exactly (tables per key,
    shared ones included, dense leaves, Adam's count), and the JAX and the
    port Predictors answer one batch alike from it."""
    gen = _gen(name, 5)
    batches = [gen.batch() for _ in range(3)]
    jtr, trainer = _jax_trainer(name), _port_trainer(name)
    st = _port_from_jax(trainer, jtr.init(0))
    for b in batches[:2]:
        st, _ = trainer.train_step(st, b)
    CheckpointManager(str(tmp_path), trainer).save(st)
    jst = JaxCkpt(str(tmp_path), jtr).restore()
    assert int(jst.step) == st.step == 2 and int(jst.opt_state[0].count) == 2
    # a restore clears the dirty flags: the port's own restore is the twin
    back = CheckpointManager(str(tmp_path), trainer).restore()
    _assert_tables_agree(_tables(trainer, back, True), _tables(jtr, jst, False), 0, 0)
    for pname, leaf in zip(jax_leaf_names(trainer.model),
                           jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_array_equal(st.dense[pname].numpy(), np.asarray(leaf))
    want = JaxPredictor(getattr(jmodels, name)(**MODELS[name]), str(tmp_path)).predict(
        batches[2])
    got = Predictor(getattr(tmodels, name)(**MODELS[name]), str(tmp_path),
                    device="cpu").predict(batches[2])
    assert got.shape == (B,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=PROB_ATOL)
