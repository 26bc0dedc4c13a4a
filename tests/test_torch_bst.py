"""BST with flash attention in the PyTorch port, held against the JAX
package on the CPU: `SyntheticBehaviorSequence` bit for bit; `layernorm_apply`
and `transformer_block_apply` (flash on and off) from the same weights; the
BST forward from carried JAX weights; 3 `train_step`s of `BST(use_flash=True)`
(the size of tests/test_attention.py test_bst_flash_parity: emb 8, capacity
2^12, heads 2, ff 32, max_len 48, batch 64) with the shared item and
category tables compared per key; and checkpoints crossing both ways.

The JAX side runs BST's flash path off the TPU through its blockwise
fallback, the port's through its plain version of the Pallas kernel: the two
differ only for rows that see no real key, which BST never makes (its target
position is always real and it is not causal).

Each model-level test runs under two numerics:
- "f32": `dense_apply` keeps its operands in f32 on BOTH sides (the JAX
  functions' compute dtype default and the port's `_bf16` patched for the
  test). Only the summation order differs, so the tolerances are
  tests/test_torch_training.py's RTOL/ATOL and tests/test_torch_serving.py's
  PROB_ATOL 1e-4 (measured: rows within 6e-7, probabilities within 1e-7);
- "bf16": the models' own numerics. A 1-ulp f32 difference before a bf16
  operand rounding flips that operand by 2^-8 relative: nudging every
  weight by 1 ulp moves one of 64 BST logits by 5.5e-4. This is the card
  vs CPU situation of chip_smoke.py, so its bounds hold: PROB_ATOL 1e-3
  (logits here too) and ROW_ATOL 1e-4 on table rows (measured: 8.6e-4 and
  5.1e-5)."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.func import functional_call

from deeprec_tpu import nn as jnn
from deeprec_tpu.data import SyntheticBehaviorSequence as JaxBehavior
from deeprec_tpu.models import BST as JaxBST
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu.training.trainer import ModelInputs as JaxInputs
from deeprec_tpu_torch import nn as tnn
from deeprec_tpu_torch.convert import dense_from_leaves
from deeprec_tpu_torch.data import SyntheticBehaviorSequence
from deeprec_tpu_torch.models import BST
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.serving import Predictor
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import ModelInputs, Trainer

from test_torch_training import (  # noqa: E402  (shared helpers)
    ATOL, RTOL, _jbatch, _port_from_jax, _rows_by_key,
)

torch.set_num_threads(1)

KW = dict(emb_dim=8, capacity=1 << 12, heads=2, ff=32, max_len=48, hidden=(32,))
B, SEQ, VOCAB = 64, 48, 1500
LR, DENSE_LR = 0.1, 1e-3
FWD_ATOL = 2e-5  # a block's output, one f32 summation order against another
# (probability / logit atol, table-row atol, table-row rtol) per numerics
TOL = {"f32": (1e-4, ATOL, RTOL), "bf16": (1e-3, 1e-4, 0.0)}
NUMERICS = ["f32", "bf16"]


@contextlib.contextmanager
def _numerics(mode):
    """"bf16": as the models are. "f32": dense_apply's operands stay f32 in
    both packages for the duration."""
    if mode == "bf16":
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnn.dense_apply, "__defaults__", (jnp.float32,))
        mp.setattr(jnn.mlp_apply, "__defaults__", (jax.nn.relu, None, jnp.float32))
        mp.setattr(tnn, "_bf16", lambda x: x)
        yield


def _assert_tables_close(got, want, mode):
    """Per key: value and accumulator rows within the mode's bounds, and
    freq, version and dirty flag equal."""
    _, atol, rtol = TOL[mode]
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for key, (wv, wa, wm) in want[name].items():
            gv, ga, gm = got[name][key]
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)
            np.testing.assert_allclose(ga, wa, rtol=rtol, atol=atol)


def _dense_atol(steps):
    """Adam moves each dense element by about lr per step: an element whose
    gradient is near 0 can flip sign under another summation order, so dense
    parameters are held within 2 lr per step (tests/test_torch_training.py)."""
    return 2 * DENSE_LR * steps + 1e-6


def _gen(seed):
    return SyntheticBehaviorSequence(batch_size=B, vocab=VOCAB, seq_len=SEQ, seed=seed)


def _jax_trainer():
    return JaxTrainer(JaxBST(use_flash=True, **KW), JaxAdagrad(lr=LR),
                      optax.adam(DENSE_LR))


def _port_trainer():
    return Trainer(BST(use_flash=True, **KW), Adagrad(lr=LR), adam(DENSE_LR),
                   device="cpu")


def _jax_tables(jtr, jst):
    """{table: {key: rows}} of a JAX state whose bundles are all unstacked
    (one table each, [C] arrays)."""
    return {bname: _rows_by_key(ts.keys, ts.values, ts.slots["accum"], ts.meta)
            for bname, ts in jst.tables.items()}


def _port_tables(trainer, st):
    """The same of a port state (the table axis T = 1 of an unstacked
    bundle dropped)."""
    return {bname: _rows_by_key(ts.keys[0], ts.values[0], ts.slots["accum"][0],
                                ts.meta[0])
            for bname, ts in st.tables.items()}


def test_behavior_sequence_bit_identical():
    ours, ref = SyntheticBehaviorSequence(batch_size=32, vocab=900, seq_len=20, seed=4), \
        JaxBehavior(batch_size=32, vocab=900, seq_len=20, seed=4)
    for _ in range(3):
        a, b = ours.batch(), ref.batch()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _block_params(D, ff, seed):
    """A JAX transformer block's params (with non-trivial layer norms) and
    the port's TransformerBlock holding the same values."""
    p = jnn.transformer_block_init(jax.random.PRNGKey(seed), D, 2, ff)
    rng = np.random.default_rng(seed)
    for ln in ("ln1", "ln2"):
        p[ln] = {"g": jnp.asarray(rng.uniform(0.5, 1.5, D).astype(np.float32)),
                 "b": jnp.asarray(rng.normal(0, 0.1, D).astype(np.float32))}
    blk = tnn.TransformerBlock(D, ff, torch.Generator().manual_seed(0))
    weights = dense_from_leaves(blk, [np.asarray(l) for l in jax.tree_util.tree_leaves(p)],
                                "cpu")
    return p, blk, weights


def test_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (5, 7, 16)).astype(np.float32)
    p = {"g": rng.uniform(0.5, 1.5, 16).astype(np.float32),
         "b": rng.normal(0, 0.1, 16).astype(np.float32)}
    want = jnn.layernorm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tnn.layernorm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    ln = tnn.LayerNorm(16)
    assert tnn.jax_leaf_names(ln) == ["b", "g"]
    assert torch.equal(ln.g, torch.ones(16)) and torch.equal(ln.b, torch.zeros(16))


@pytest.mark.parametrize("flash", [False, True])
def test_transformer_block_matches_jax(flash):
    """x [4, 49, 16] (the BST sequence of max_len 48 plus the target), two
    heads; flash pads 49 to 128. Masked positions come out 0."""
    D, L = 16, 49
    p, blk, weights = _block_params(D, 32, 3)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, L, D)).astype(np.float32)
    mask = np.arange(L)[None, :] < rng.integers(1, L + 1, 4)[:, None]
    mask[:, -1] = True
    want = jax.jit(lambda p, x, m: jnn.transformer_block_apply(p, x, m, 2, flash=flash))(
        p, jnp.asarray(x), jnp.asarray(mask))
    got = functional_call(blk, weights, (torch.from_numpy(x), torch.from_numpy(mask), 2),
                          {"flash": flash})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FWD_ATOL)
    assert np.all(got.detach().numpy()[~mask] == 0.0)
    assert tnn.jax_leaf_names(blk) == [
        "ff1.b", "ff1.w", "ff2.b", "ff2.w", "ln1.b", "ln1.g", "ln2.b", "ln2.g",
        "proj", "qkv"]


@pytest.mark.parametrize("mode", NUMERICS)
@pytest.mark.parametrize("flash", [False, True])
def test_bst_forward_from_jax_weights(flash, mode):
    """The BST logits on the same ModelInputs and carried JAX weights (two
    blocks, so the second block reads the first's masked output)."""
    kw = dict(KW, blocks=2)
    jm, tm = JaxBST(use_flash=flash, **kw), BST(use_flash=flash, **kw)
    params = jm.init(jax.random.PRNGKey(1))
    names = tnn.jax_leaf_names(tm)
    assert names[-1] == "pos" and names[0] == "blocks.0.ff1.b"
    rng = np.random.default_rng(5)
    D = KW["emb_dim"]
    pooled = {n: rng.normal(0, 0.3, (B, D)).astype(np.float32)
              for n in ("user", "target_item", "target_cat")}
    mask = np.arange(SEQ)[None, :] < rng.integers(1, SEQ + 1, B)[:, None]
    seq = {n: (np.where(mask[..., None], rng.normal(0, 0.3, (B, SEQ, D)), 0.0)
               .astype(np.float32), mask) for n in ("hist_items", "hist_cats")}
    weights = dense_from_leaves(
        tm, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)], "cpu")
    with _numerics(mode):
        want = jax.jit(lambda p, x: jm.apply(p, x, False))(params, JaxInputs(
            pooled={k: jnp.asarray(v) for k, v in pooled.items()},
            seq={k: (jnp.asarray(e), jnp.asarray(m)) for k, (e, m) in seq.items()},
            dense={}))
        got = functional_call(tm, weights, (ModelInputs(
            pooled={k: torch.from_numpy(v) for k, v in pooled.items()}, dense={},
            seq={k: (torch.from_numpy(e), torch.from_numpy(m))
                 for k, (e, m) in seq.items()}),))
    atol = FWD_ATOL if mode == "f32" else TOL[mode][0]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


@pytest.fixture(scope="module", params=NUMERICS)
def bst_run(request):
    """3 JAX steps and 3 port steps of BST(use_flash=True) from the JAX
    initial state on the same batches, then an eval batch, under one
    numerics."""
    mode = request.param
    gen = _gen(3)
    batches = [gen.batch() for _ in range(4)]
    jtr, trainer = _jax_trainer(), _port_trainer()
    losses = []
    with _numerics(mode):
        jst = jtr.init(0)
        st = _port_from_jax(trainer, jst)
        for b in batches[:3]:
            jst, jm = jtr.train_step(jst, _jbatch(b))
            st, m = trainer.train_step(st, b)
            losses.append((float(m["loss"]), float(jm["loss"])))
        evals = (jtr.eval_step(jst, _jbatch(batches[3])),
                 trainer.eval_step(st, batches[3]))
    return dict(jtr=jtr, jst=jst, trainer=trainer, st=st, losses=losses,
                evals=evals, mode=mode)


def test_bst_bundles_are_the_shared_tables(bst_run):
    """user alone; target_item shared by hist_items; target_cat by
    hist_cats — unstacked bundles that look up and apply one feature after
    another, with the JAX package's names."""
    tr = bst_run["trainer"]
    assert {n: [f.name for f in b.features] for n, b in tr.bundles.items()} == {
        n: [f.name for f in b.features] for n, b in bst_run["jtr"].bundles.items()}
    assert {n: b.stacked for n, b in tr.bundles.items()} == {
        "user": False, "target_item": False, "target_cat": False}


def test_bst_train_losses_match_jax(bst_run):
    for loss, jloss in bst_run["losses"]:
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    assert bst_run["st"].step == int(bst_run["jst"].step) == 3


def test_bst_train_tables_match_jax(bst_run):
    """Every key of the three tables, shared or not: value and accumulator
    rows, freq, version and dirty flag."""
    r = bst_run
    _assert_tables_close(_port_tables(r["trainer"], r["st"]),
                         _jax_tables(r["jtr"], r["jst"]), r["mode"])


def test_bst_train_dense_params_match_jax(bst_run):
    r = bst_run
    for name, leaf in zip(tnn.jax_leaf_names(r["trainer"].model),
                          jax.tree_util.tree_leaves(r["jst"].dense)):
        np.testing.assert_allclose(r["st"].dense[name].numpy(), np.asarray(leaf),
                                   rtol=0, atol=_dense_atol(3), err_msg=name)


def test_bst_eval_matches_jax(bst_run):
    (jloss, jprobs), (loss, probs) = bst_run["evals"]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0,
                               atol=TOL[bst_run["mode"]][0])


@pytest.mark.parametrize("mode", NUMERICS)
def test_jax_checkpoint_served_by_port_predictor(tmp_path, mode):
    """2 JAX train steps, a JAX checkpoint; the port's Predictor restores it
    (shared bundles, pos, blocks) and answers as the JAX Predictor does."""
    gen = _gen(6)
    batches = [gen.batch() for _ in range(3)]
    jtr = _jax_trainer()
    with _numerics(mode):
        jst = jtr.init(0)
        for b in batches[:2]:
            jst, _ = jtr.train_step(jst, _jbatch(b))
        JaxCkpt(str(tmp_path), jtr).save(jst)
        want = JaxPredictor(JaxBST(use_flash=True, **KW), str(tmp_path)).predict(batches[2])
        got = Predictor(BST(use_flash=True, **KW), str(tmp_path),
                        device="cpu").predict(batches[2])
    assert got.shape == (B,)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL[mode][0])


@pytest.mark.parametrize("mode", NUMERICS)
def test_port_checkpoint_restored_by_jax(tmp_path, mode):
    """2 port train steps from the JAX initial state, a port checkpoint; the
    JAX package restores it (shared bundles, pos, blocks, Adam state), and
    the probabilities and the next step of both restores agree."""
    gen = _gen(7)
    batches = [gen.batch() for _ in range(3)]
    jtr, trainer = _jax_trainer(), _port_trainer()
    with _numerics(mode):
        st = _port_from_jax(trainer, jtr.init(0))
        for b in batches[:2]:
            st, _ = trainer.train_step(st, b)
        st, _ = CheckpointManager(str(tmp_path), trainer).save(st)
        jst = JaxCkpt(str(tmp_path), jtr).restore()
        st = CheckpointManager(str(tmp_path), trainer).restore()
        assert int(jst.step) == st.step == 2
        assert int(jst.opt_state[0].count) == int(st.opt_state.count) == 2
        _assert_tables_close(_port_tables(trainer, st), _jax_tables(jtr, jst), "f32")
        _, want = jtr.eval_step(jst, _jbatch(batches[2]))
        _, got = trainer.eval_step(st, batches[2])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL[mode][0])
        jst, jm = jtr.train_step(jst, _jbatch(batches[2]))
        st, m = trainer.train_step(st, batches[2])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
