"""The modelzoo in the PyTorch port — WDL, DeepFM, DCN, DCNv2, MaskNet, DIN,
DIEN, DSSM and the multi-task SimpleMultiTask, ESMM, MMoE, PLE and DBMTL —
held against the JAX package on the CPU, one parametrised test per check
with each model as a case, at a small size (emb 8, capacity 2^10, hidden
(32, 16), 6 categorical and 4 numeric Criteo features, batch 64; DIN and
DIEN over histories of 20 with the shared item and category tables; DSSM
over 4 user and 4 item features with an asymmetric user tower):

- the parameter trees: the JAX `init` carried across by convert.py, leaf
  for leaf (WDL's, DeepFM's and DSSM's 0-d leaves, MaskNet's list of dicts,
  DCN's vector weights, DIEN's GRUs, MMoE's list of experts, PLE's dict of
  expert lists, the per-task gate and tower dicts);
- `eval_step` on the carried initial state against the JAX
  `Trainer.eval_step`, task by task (the port serves and evaluates every
  pooled feature through kernel #4, the JAX package through `combine`);
- 3 train steps from that state on the same batches: losses (one BCE per
  task summed for the multi-task models), tables per key and dense leaves
  within tests/test_torch_training.py's tolerances;
- a checkpoint written by the port and restored by the JAX package (tables
  per key, shared ones included, and dense leaves exact), then served by
  both Predictors, task by task; and a JAX checkpoint restored by the port.

Also: DIEN with histories that are all padding, DSSM's tower methods, the
synthetic multi-task and two-tower batches bit for bit, and the registry.

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
from deeprec_tpu.data.synthetic import SyntheticMultiTask as JaxMultiTask
from deeprec_tpu.data.synthetic import SyntheticTwoTower as JaxTwoTower
from deeprec_tpu.models import registry as jregistry
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch import data as tdata
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
    "DIEN": dict(emb_dim=8, capacity=1 << 10, gru_hidden=8, hidden=(32, 16)),
    "DSSM": dict(emb_dim=8, capacity=1 << 10, hidden=(32, 16), user_hidden=(48, 16)),
    "SimpleMultiTask": dict(CRITEO, bottom=(32,), tower=(16,)),
    "ESMM": dict(CRITEO, tower=(32, 16)),
    "MMoE": dict(CRITEO, num_experts=3, expert=(16,), tower=(16,)),
    "PLE": dict(CRITEO, shared_experts=2, task_experts=1, expert=(16,), tower=(16,)),
    "DBMTL": dict(CRITEO, bottom=(32,), tower=(16,)),
}
MULTI_TASK = ("SimpleMultiTask", "ESMM", "MMoE", "PLE", "DBMTL")
# leaves of each JAX tree that the module layout has to reproduce
SPECIAL_LEAVES = {
    "WDL": {"wide_b": (), "wide_w": (10,)},
    "DeepFM": {"bias": (), "linear_w": (10,)},
    "DCN": {"cross.layers.0.w": (52,), "cross.layers.1.b": (52,)},
    "DCNv2": {"cross.layers.0.w": (52, 52)},
    "MaskNet": {"blocks.0.mask2.w": (16, 52), "blocks.1.mask2.w": (16, 16),
                "blocks.0.proj.w": (52, 16), "blocks.1.ln.g": (16,)},
    "DIN": {"att.mlp.layers.0.w": (64, 8), "mlp.layers.0.w": (40, 32)},
    "DIEN": {"gru1.wz": (24, 8), "augru.wh": (16, 8), "augru.bz": (8,),
             "att_w.w": (8, 16), "mlp.layers.0.w": (32, 32)},
    "DSSM": {"temp": (), "user.layers.0.w": (32, 48), "user.layers.1.w": (48, 16),
             "item.layers.1.w": (32, 16)},
    "SimpleMultiTask": {"bottom.layers.0.w": (52, 32), "towers.cvr.layers.1.w": (16, 1)},
    "ESMM": {"ctr.layers.0.w": (52, 32), "cvr.layers.2.w": (16, 1)},
    "MMoE": {"experts.2.layers.0.w": (52, 16), "gates.ctr.w": (52, 3),
             "towers.cvr.layers.0.w": (16, 16)},
    "PLE": {"experts.shared.1.layers.0.w": (52, 16), "experts.cvr.0.layers.0.w": (52, 16),
            "gates.cvr.w": (52, 3)},
    "DBMTL": {"cvr.layers.0.w": (48, 16), "link.layers.0.w": (32, 16)},
}


def _gen(name, seed):
    if name in ("DIN", "DIEN"):
        return JaxBehavior(batch_size=B, vocab=VOCAB, seq_len=SEQ, seed=seed)
    if name == "DSSM":
        return JaxTwoTower(batch_size=B, vocab=VOCAB, seed=seed)
    cls = JaxMultiTask if name in MULTI_TASK else SyntheticCriteo
    return cls(batch_size=B, num_cat=CRITEO["num_cat"], num_dense=CRITEO["num_dense"],
               vocab=VOCAB, seed=seed)


def _tasks(probs):
    """{task: array}: a single-task model's answer under the task ""."""
    if not isinstance(probs, dict):
        probs = {"": probs}
    return {t: np.asarray(p) for t, p in probs.items()}


def _assert_probs_agree(got, want):
    got, want = _tasks(got), _tasks(want)
    assert got.keys() == want.keys()
    for t in want:
        assert got[t].shape == (B,) and np.all(np.isfinite(got[t])), t
        np.testing.assert_allclose(got[t], want[t], rtol=0, atol=PROB_ATOL, err_msg=t)


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
    assert isinstance(probs, dict) == (zoo_run["name"] in MULTI_TASK)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    _assert_probs_agree(probs, jprobs)
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
    st, _ = CheckpointManager(str(tmp_path), trainer).save(st)
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
    _assert_probs_agree(got, want)


def test_jax_checkpoint_restored_by_port(zoo_run, tmp_path):
    """The JAX state after the 3 train steps, saved by the JAX package and
    restored by the port exactly: tables per key, dense leaves (0-d ones,
    dicts of lists), the step and Adam's count; the restored state
    evaluates as the JAX one does."""
    r = zoo_run
    jst, _ = JaxCkpt(str(tmp_path), r["jtr"]).save(r["jst"])
    trainer = _port_trainer(r["name"])
    st = CheckpointManager(str(tmp_path), trainer).restore()
    assert st.step == 3 and int(st.opt_state.count) == 3
    _assert_tables_agree(_tables(trainer, st, True), _tables(r["jtr"], jst, False), 0, 0)
    for pname, leaf in zip(jax_leaf_names(trainer.model),
                           jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_array_equal(st.dense[pname].numpy(), np.asarray(leaf))
    batch = _gen(r["name"], 9).batch()
    _assert_probs_agree(trainer.eval_step(st, batch)[1],
                        r["jtr"].eval_step(jst, _jbatch(batch))[1])


def test_dien_history_all_padding():
    """Rows whose histories are all pads (the generator draws none): the
    attention is zeroed after its softmax and both GRUs carry h0 = 0, on
    both sides alike."""
    gen = _gen("DIEN", 11)
    batch = gen.batch()
    for k in (0, 5, B - 1):
        batch["hist_items"][k] = -1
        batch["hist_cats"][k] = -1
    jtr, trainer = _jax_trainer("DIEN"), _port_trainer("DIEN")
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    for b in (gen.batch(), batch):  # rows in the tables first
        jst, _ = jtr.train_step(jst, _jbatch(b))
        st, _ = trainer.train_step(st, b)
    _assert_probs_agree(trainer.eval_step(st, batch)[1],
                        jtr.eval_step(jst, _jbatch(batch))[1])


def test_dssm_tower_methods_match_jax():
    """DSSM's serving hooks against the JAX package's on the same weights
    and pooled embeddings: the user and item towers, apply_with_user (row
    for row equal to the forward), score_items over [N, H] and [B, N, H],
    and the item tower's parameters."""
    from types import SimpleNamespace

    jmodel, model = jmodels.DSSM(**MODELS["DSSM"]), tmodels.DSSM(**MODELS["DSSM"])
    params = jmodel.init(jax.random.PRNGKey(3))
    leaves = jax.tree_util.tree_leaves(params)
    model.load_state_dict({n: torch.tensor(np.asarray(leaf)) for n, leaf in
                           zip(jax_leaf_names(model), leaves)})
    rng = np.random.default_rng(3)
    pooled = {f.name: rng.normal(0, 1, (B, 8)).astype(np.float32) for f in model.features}
    jin = SimpleNamespace(pooled={k: jax.numpy.asarray(v) for k, v in pooled.items()})
    tin = SimpleNamespace(pooled={k: torch.tensor(v) for k, v in pooled.items()})
    with torch.no_grad():
        u, v = model.towers(tin)
        ju, jv = jmodel.towers(params, jin)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(model.apply_with_user(u, tin).numpy(),
                                      model(tin).numpy())
        np.testing.assert_allclose(model(tin).numpy(),
                                   np.asarray(jmodel.apply(params, jin, False)),
                                   rtol=0, atol=1e-4)
        items = v[:5]
        np.testing.assert_allclose(
            model.score_items(u, items).numpy(),
            np.asarray(jmodel.score_items(params, ju, jv[:5])), rtol=0, atol=1e-4)
        per_user = torch.stack([v[:5]] * B)
        np.testing.assert_allclose(
            model.score_items(u, per_user).numpy(),
            np.asarray(jmodel.score_items(params, ju, jax.numpy.stack([jv[:5]] * B))),
            rtol=0, atol=1e-4)
    item = model.item_tower_params(dict(model.named_parameters()))
    jitem = jax.tree_util.tree_leaves(jmodel.item_tower_params(params))
    assert sorted(item) == [n for n in jax_leaf_names(model) if n.startswith("item.")]
    for n, leaf in zip(sorted(item), jitem):
        np.testing.assert_array_equal(item[n].detach().numpy(), np.asarray(leaf))
    with pytest.raises(ValueError, match="user_hidden"):
        tmodels.DSSM(hidden=(32, 16), user_hidden=(32, 8))


@pytest.mark.parametrize("kind", ["multitask", "twotower"])
def test_synthetic_batches_identical(kind):
    """SyntheticMultiTask and SyntheticTwoTower batches bit for bit against
    the JAX package's for one seed."""
    if kind == "multitask":
        kw = dict(batch_size=128, num_cat=5, num_dense=4, vocab=1000, seed=3)
        a, b = JaxMultiTask(**kw), tdata.SyntheticMultiTask(**kw)
    else:
        kw = dict(batch_size=128, num_user=3, num_item=2, vocab=1000, seed=3)
        a, b = JaxTwoTower(**kw), tdata.SyntheticTwoTower(**kw)
    for _ in range(3):
        x, y = a.batch(), b.batch()
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_registry_names_the_jax_registry():
    """Every name of the JAX registry resolves to the port's class of the
    same name, and build_model passes the keywords through."""
    assert tmodels.REGISTRY.keys() == jregistry.REGISTRY.keys()
    for key, cls in jregistry.REGISTRY.items():
        assert tmodels.REGISTRY[key].__name__ == cls.__name__, key
        assert tmodels.REGISTRY[key] is getattr(tmodels, cls.__name__), key
    m = tmodels.build_model("DIEN", emb_dim=8, gru_hidden=4)
    assert isinstance(m, tmodels.DIEN) and tuple(m.gru1.bz.shape) == (4,)
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.build_model("nope")
