"""Kernel #4 in the PyTorch port, `fused_gather_combine`, held against the
JAX package's Pallas kernel run in interpret mode on the CPU (where the
port's wrapper runs its plain version, which is also what the CUDA kernel is
held against on the card), and the read-only pooled combine built on it
(`combiners.combine_pooled_group`) against the JAX `combine`.

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
cancel to near 0).

The grouped launch (`fused_gather_combine_grouped`, one #4 launch for
features of mixed L and C) is held feature by feature against the Pallas
kernel under the same rule, and bit for bit against the single-feature
entry; the read-only forward that groups the pooled features by row dtype
and width (`Trainer.eval_step`, `Predictor.predict`) is held against the
JAX `Trainer.eval_step` within 1e-4 on probabilities, on f32 and on bf16
tables."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu.embedding.combiners import combine as jax_combine
from deeprec_tpu.ops.fused_lookup import fused_gather_combine as jax_fgc
from deeprec_tpu_torch.embedding import combiners
from deeprec_tpu_torch.embedding.combiners import combine, combine_pooled_group
from deeprec_tpu_torch.ops import fused_gather_combine
from deeprec_tpu_torch.ops.fused_lookup import (
    fused_gather_combine_grouped, fused_gather_combine_plain)

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
    inv_t, mask_t = torch.from_numpy(inverse), torch.from_numpy(mask)
    got = combine_pooled_group([emb_t], [inv_t], [mask_t], [combiner])[0]
    want = np.asarray(jax_combine(jemb, jnp.asarray(inverse), jnp.asarray(mask),
                                  combiner))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert np.all(got.numpy()[2] == 0.0)
    # in a group: beside a bag of another L (operands per feature) and
    # beside one of the same L and combiner (operands over the stack)
    for other in (inv_t[:, :2], inv_t.flip(0)):
        out = combine_pooled_group([emb_t, emb_t], [inv_t, other],
                                   [mask_t, mask_t[:, :other.shape[1]]],
                                   [combiner, combiner])
        assert torch.equal(out[0], got)
    # and the port's own differentiable combine, in f32
    ref = combine(emb_t.float(), torch.from_numpy(inverse), torch.from_numpy(mask),
                  combiner)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


# A group of mixed L and C at one D: (C, L, row_ix upper bound); the last
# feature has rows past its table and a bag of pads only.
GROUP = [(256, 5, None), (64, 1, None), (50, 9, 80), (128, 100, None)]


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_matches_pallas_interpret(dtype, combiner):
    """Each feature of one grouped call against the Pallas kernel in
    interpret mode (bit for bit under sum weights, else within RTOL / ATOL:
    the module docstring's FMA contraction) and bit for bit against the
    single-feature entry."""
    D, B, bf16 = (16, 10, False) if dtype == "float32" else (128, 6, True)
    cases = []
    for k, (C, L, hi) in enumerate(GROUP):
        values, row_ix = _case(C, D, B, L, seed=20 + k,
                               dtype=np.float32 if not bf16 else "bfloat16", hi=hi)
        if hi is not None:
            row_ix[2] = -1
        cases.append((values, row_ix, _weights(row_ix, combiner)))

    def t(values):
        v = torch.from_numpy(np.array(values))
        return v.to(torch.bfloat16) if bf16 else v

    got = fused_gather_combine_grouped(
        [t(v) for v, _, _ in cases], [torch.from_numpy(ix) for _, ix, _ in cases],
        [torch.from_numpy(w) for _, _, w in cases])
    assert len(got) == len(GROUP)
    for (values, row_ix, w), out in zip(cases, got):
        out = out.numpy()
        np.testing.assert_array_equal(out, _port(values, row_ix, w, bf16))
        _assert_same(out, _jax(values, row_ix, w, 4, bf16), combiner)
    assert np.all(got[2].numpy()[2] == 0.0)


def test_grouped_wrapper_checks_its_inputs():
    """A group shares device, row dtype, D and B; its three lists have one
    length; each feature passes the single entry's checks."""
    v = torch.zeros((8, 4))
    ix = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.ones((3, 2))
    with pytest.raises(ValueError, match="D 5"):
        fused_gather_combine_grouped([v, torch.zeros((8, 5))], [ix, ix], [w, w])
    with pytest.raises(ValueError, match="bfloat16"):
        fused_gather_combine_grouped([v, v.to(torch.bfloat16)], [ix, ix], [w, w])
    with pytest.raises(ValueError, match="B 4"):
        fused_gather_combine_grouped([v, v], [ix, ix.new_zeros((4, 2))],
                                     [w, w.new_ones((4, 2))])
    with pytest.raises(ValueError, match="meta"):
        fused_gather_combine_grouped([v, v.to("meta")], [ix, ix.to("meta")],
                                     [w, w.to("meta")])
    with pytest.raises(ValueError, match="row_ix on meta"):
        fused_gather_combine_grouped([v], [ix.to("meta")], [w])
    with pytest.raises(ValueError, match="2 values, 1 row_ix"):
        fused_gather_combine_grouped([v, v], [ix], [w, w])
    with pytest.raises(ValueError, match="weights"):
        fused_gather_combine_grouped([v], [ix], [w[:, :1]])
    with pytest.raises(TypeError, match="dtype"):
        fused_gather_combine_grouped([v.to(torch.float16)], [ix], [w])
    assert fused_gather_combine_grouped([], [], []) == []
    out = fused_gather_combine_grouped([v, v[:3]], [ix, ix[:, :1]], [w, w[:, :1]])
    assert [o.shape for o in out] == [(3, 4), (3, 4)]


def _group_calls(monkeypatch):
    """Record the features of each `combine_pooled_group` call."""
    calls, real = [], combiners.combine_pooled_group

    def spy(embs, inverses, masks, combs):
        embs = list(embs)
        calls.append((len(embs), embs[0].dtype, embs[0].shape[-1]))
        return real(embs, inverses, masks, combs)

    monkeypatch.setattr(combiners, "combine_pooled_group", spy)
    return calls


def _bf16_tables(model):
    """The model's tables as bf16 tables, in place."""
    import dataclasses

    for i, f in enumerate(model.features):
        if getattr(f, "table", None) is not None:
            model.features[i] = dataclasses.replace(
                f, table=dataclasses.replace(f.table, value_dtype="bfloat16"))
    return model


def _dlrm_pair(bf16):
    """A small DLRM-DCN (test_torch_training's widths) in both packages,
    f32 or bf16 tables, and its batches."""
    import optax
    from test_torch_training import B, KW, LR, NUM_CAT, NUM_DENSE

    from deeprec_tpu.data import SyntheticCriteo
    from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
    from deeprec_tpu.optim import Adagrad as JaxAdagrad
    from deeprec_tpu.training import Trainer as JaxTrainer
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    jm, tm = JaxDLRMDCN(**KW), DLRMDCN(**KW)
    if bf16:
        jm, tm = _bf16_tables(jm), _bf16_tables(tm)
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=11)
    return (JaxTrainer(jm, JaxAdagrad(lr=LR), optax.adam(1e-3)),
            Trainer(tm, Adagrad(lr=LR), adam(1e-3), device="cpu"),
            [gen.batch() for _ in range(2)])


def _bst_pair():
    """A small BST(use_flash=True) (test_torch_bst's widths) in both
    packages, and its batches."""
    from test_torch_bst import _gen, _jax_trainer, _port_trainer

    gen = _gen(12)
    return _jax_trainer(), _port_trainer(), [gen.batch() for _ in range(2)]


PROB_ATOL = 1e-4  # dense layers in another f32 summation order (ROADMAP C)


@pytest.mark.parametrize("model", ["dlrm_dcn", "bst"])
def test_grouped_read_only_forward_matches_jax(model, monkeypatch):
    """One JAX train step, the state carried across with convert.py, then
    eval_step in both packages on another batch: probabilities within
    PROB_ATOL and the loss within 1e-4 relative. Every pooled feature of
    either model has f32 rows of one width, so the port pools them in one
    group (one #4 launch on the card): DLRM-DCN's 4 categorical features,
    BST's user, target_item and target_cat. BST runs under its "f32"
    numerics (dense_apply's bf16 operand rounding off on both sides)."""
    from test_torch_bst import _numerics
    from test_torch_training import _jbatch, _port_from_jax

    jtr, trainer, batches = _dlrm_pair(False) if model == "dlrm_dcn" else _bst_pair()
    calls = _group_calls(monkeypatch)
    with _numerics("f32" if model == "bst" else "bf16"):
        jst, _ = jtr.train_step(jtr.init(0), _jbatch(batches[0]))
        st = _port_from_jax(trainer, jst)
        jloss, jprobs = jtr.eval_step(jst, _jbatch(batches[1]))
        loss, probs = trainer.eval_step(st, batches[1])
    pooled = [f for f in trainer.sparse_specs if f.pooling != "none"]
    assert len(pooled) == (4 if model == "dlrm_dcn" else 3)
    assert calls == [(len(pooled), torch.float32, trainer.model.emb_dim)]
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)


def test_bf16_tables_read_only_forward_matches_jax(tmp_path, monkeypatch):
    """bf16-valued tables through the grouped read-only forward (#4's bf16
    branch): one JAX train step (its stochastically rounded bf16 rows carry
    across exactly), then the port's eval_step, and its Predictor serving
    the port's checkpoint of that state, both against the JAX eval_step,
    probabilities within PROB_ATOL. The rows are the same bf16 values on
    both sides and both upcast them to f32 before any arithmetic, so the
    bound is the f32 one. (A JAX checkpoint of bf16 tables fails its own
    digest check on restore, in the JAX package as in the port: ROADMAP C.)"""
    from test_torch_training import _jbatch, _port_from_jax

    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    jtr, trainer, batches = _dlrm_pair(True)
    calls = _group_calls(monkeypatch)
    jst, _ = jtr.train_step(jtr.init(0), _jbatch(batches[0]))
    st = _port_from_jax(trainer, jst)
    assert all(ts.values.dtype == torch.bfloat16 for ts in st.tables.values())
    jloss, jprobs = jtr.eval_step(jst, _jbatch(batches[1]))
    loss, probs = trainer.eval_step(st, batches[1])
    assert calls == [(4, torch.bfloat16, 16)]
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    st, _ = CheckpointManager(str(tmp_path), trainer).save(st)
    got = Predictor(trainer.model, str(tmp_path), device="cpu").predict(batches[1])
    np.testing.assert_allclose(got, np.asarray(jprobs), rtol=0, atol=PROB_ATOL)
