"""The port's unique-budget engine held against the JAX package on the CPU:
the sizing policy and `rank_compact` exactly, `hash_dedup` per table
(uids/counts as multisets, overflow counts equal), and the budgeted
`Trainer`: 3 train steps of the small DLRM-DCN of test_torch_training.py
under an int budget, the "auto" budget's `update_budgets`, and the overflow
counter that the port used to leave at zero."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.ops import compact as jcompact
from deeprec_tpu.ops import dedup as jdedup
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu_torch.models import DLRMDCN
from deeprec_tpu_torch.ops import compact as tcompact
from deeprec_tpu_torch.ops import dedup as tdedup
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.trainer import Trainer
from test_torch_training import (
    B, DENSE_LR, KW, LR, NUM_CAT, NUM_DENSE, RTOL, _assert_dense_agree,
    _assert_tables_agree, _jax_tables, _jbatch, _port_from_jax, _port_tables,
)

torch.set_num_threads(1)

INT32_MIN = int(np.iinfo(np.int32).min)


@pytest.mark.parametrize("n", [1, 7, 8, 64, 1000, 204800])
def test_sizing_policy_matches_jax(n):
    for budget in (1, 3, 7, 8, 9, n // 2, n, n + 5, 10 ** 6):
        assert tdedup.resolve_size(budget, n) == jdedup.resolve_size(budget, n)
    assert tdedup.scratch_size(n) == jdedup.scratch_size(n)
    assert tcompact.next_pow2(n) == jcompact.next_pow2(n)
    for cap in (0, 64, 1 << 20):
        assert tcompact.quantize_rows(n, cap) == jcompact.quantize_rows(n, cap)


def test_auto_budget_fraction_matches_jax():
    for ema in np.linspace(-0.1, 1.2, 53):
        for slack in (1.0, 1.5, 2.0):
            assert tdedup.auto_budget_fraction(float(ema), slack=slack) == \
                jdedup.auto_budget_fraction(float(ema), slack=slack)


@pytest.mark.parametrize("p,size", [(0.3, 5), (0.3, 40), (0.9, 200), (0.0, 3)])
def test_rank_compact_matches_jax(p, size):
    rng = np.random.default_rng(int(p * 10) + size)
    mask = rng.random((3, 128)) < p
    idx, n, rank = tcompact.rank_compact(torch.from_numpy(mask), size)
    for t in range(3):
        want = jcompact.rank_compact(jnp.asarray(mask[t]), size)
        np.testing.assert_array_equal(idx[t].numpy(), np.asarray(want[0]))
        assert int(n[t]) == int(want[1])
        np.testing.assert_array_equal(rank[t].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("sentinel", [INT32_MIN, -1])
@pytest.mark.parametrize("budget", [None, 20, 5])
def test_hash_dedup_matches_jax(sentinel, budget):
    """Per table: the same overflow count; uids[inverse] rebuilds every
    budgeted position and inverse is 0 elsewhere; without overflow the
    (uid, count) multisets are equal. With overflow WHICH ids make the
    budget is path-dependent, but both keep size - 1 of them."""
    rng = np.random.default_rng(0 if budget is None else budget)
    T, N = 4, 96
    ids = rng.integers(0, 60, (T, N)).astype(np.int32)
    ids[rng.random((T, N)) < 0.2] = sentinel
    size = tdedup.resolve_size(N if budget is None else budget, N)
    uids, inv, counts, ovf = tdedup.hash_dedup(torch.from_numpy(ids), size,
                                               sentinel=sentinel)
    assert uids.shape == (T, size) and inv.shape == (T, N) and ovf.shape == (T,)
    for t in range(T):
        wu, wi, wc, wo = (np.asarray(x) for x in jdedup.hash_dedup(
            jnp.asarray(ids[t]), size, sentinel=sentinel))
        u, i, c = uids[t].numpy(), inv[t].numpy(), counts[t].numpy()
        assert int(ovf[t]) == int(wo)
        assert u[0] == sentinel and c[0] == 0
        np.testing.assert_array_equal(u[i][i > 0], ids[t][i > 0])
        np.testing.assert_array_equal(i[ids[t] == sentinel], 0)
        assert int((c > 0).sum()) == int((wc > 0).sum())
        if int(wo) == 0:
            assert sorted(zip(u.tolist(), c.tolist())) == sorted(zip(wu.tolist(), wc.tolist()))
    if budget == 5:
        assert int(ovf.min()) > 0


def _trainers(unique_budget):
    jtr = JaxTrainer(JaxDLRMDCN(**KW), JaxAdagrad(lr=LR), optax.adam(DENSE_LR),
                     unique_budget=unique_budget)
    trainer = Trainer(DLRMDCN(**KW), Adagrad(lr=LR), adam(DENSE_LR), device="cpu",
                      unique_budget=unique_budget)
    return jtr, trainer


def _batches(n, seed=0):
    gen = SyntheticCriteo(batch_size=B, num_cat=NUM_CAT, num_dense=NUM_DENSE,
                          vocab=500, seed=seed)
    return [gen.batch() for _ in range(n)]


@pytest.mark.parametrize("mode", [None, "off", "auto", 40, 100])
def test_budget_modes_and_sizes_match_jax(mode):
    jtr, trainer = _trainers(mode)
    assert trainer._budget_modes == jtr._budget_modes
    ids = torch.zeros((1, B, 1), dtype=torch.int32)
    for bname, b in trainer.bundles.items():
        jb = jtr.bundles[bname]
        for train in (True, False):
            assert trainer._budget_for_lookup(b, ids, train) == \
                jtr._budget_for_lookup(jb, jnp.zeros((B, 1)), train)


def test_unique_budget_validated_like_jax():
    for bad in (0, -3, "on", 2.5, True):
        with pytest.raises(ValueError, match="unique_budget"):
            Trainer(DLRMDCN(**KW), Adagrad(lr=LR), device="cpu", unique_budget=bad)
        with pytest.raises(ValueError, match="unique_budget"):
            JaxTrainer(JaxDLRMDCN(**KW), JaxAdagrad(lr=LR), unique_budget=bad)


@pytest.fixture(scope="module")
def budget_run():
    """3 steps of both packages under an int budget (56 ids of 64
    positions per table: below N, above the batch's uniques)."""
    jtr, trainer = _trainers(56)
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    losses = []
    for b in _batches(3):
        jst, jm = jtr.train_step(jst, _jbatch(b))
        st, m = trainer.train_step(st, b)
        losses.append((float(m["loss"]), float(jm["loss"])))
    return dict(jtr=jtr, jst=jst, trainer=trainer, st=st, losses=losses)


def test_budgeted_train_steps_match_jax(budget_run):
    r = budget_run
    for loss, jloss in r["losses"]:
        np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    _assert_tables_agree(_port_tables(r["trainer"], r["st"]),
                         _jax_tables(r["jtr"], r["jst"]))
    _assert_dense_agree(r["trainer"], r["st"], r["jst"], 3)


def test_budgeted_counters_match_jax(budget_run):
    r = budget_run
    for bname, ts in r["st"].tables.items():
        jts = r["jst"].tables[bname]
        for name in ("dedup_unique", "dedup_ids", "dedup_overflow", "insert_fails"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(jts, name)), err_msg=name)
        assert int(ts.dedup_overflow.sum()) == 0
    assert r["trainer"].dedup_stats(r["st"]) == r["jtr"].dedup_stats(r["jst"])


def test_update_budgets_matches_jax():
    """"auto": two steps at U = N through the hash engine, then
    update_budgets on both sides gives the same report and bucket, resets
    the counters, and the next step runs at the same unique size."""
    jtr, trainer = _trainers("auto")
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    batches = _batches(3, seed=4)
    for b in batches[:2]:
        jst, _ = jtr.train_step(jst, _jbatch(b))
        st, _ = trainer.train_step(st, b)
    jst, jrep = jtr.update_budgets(jst)
    st, rep = trainer.update_budgets(st)
    assert rep == jrep
    assert trainer._auto_frac == jtr._auto_frac and trainer._auto_frac
    assert trainer._unique_ema == jtr._unique_ema
    for ts in st.tables.values():
        assert int(ts.dedup_ids.sum()) == int(ts.dedup_unique.sum()) == 0
    ids = torch.zeros((1, B, 1), dtype=torch.int32)
    for bname, b in trainer.bundles.items():
        size = trainer._budget_for_lookup(b, ids, True)
        assert size == jtr._budget_for_lookup(jtr.bundles[bname], jnp.zeros((B, 1)), True)
        assert size < tdedup.resolve_size(B, B)  # the budget engaged
    jst, jm = jtr.train_step(jst, _jbatch(batches[2]))
    st, m = trainer.train_step(st, batches[2])
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
    assert trainer.dedup_stats(st) == jtr.dedup_stats(jst)


def test_budget_overflow_counted_as_in_jax():
    """A budget below the batch's uniques: the port routes the train
    lookups through the hash engine and counts the refused ids into
    dedup_overflow exactly as the JAX package does (before, it dedup'd at
    U = N and the counter stayed 0)."""
    jtr, trainer = _trainers(8)
    jst = jtr.init(0)
    st = _port_from_jax(trainer, jst)
    b = _batches(1, seed=2)[0]
    jst, jm = jtr.train_step(jst, _jbatch(b))
    st, m = trainer.train_step(st, b)
    total = 0
    for bname, ts in st.tables.items():
        np.testing.assert_array_equal(ts.dedup_overflow.numpy(),
                                      np.asarray(jst.tables[bname].dedup_overflow))
        total += int(ts.dedup_overflow.sum())
    assert total > 0
    assert np.isfinite(float(m["loss"]))
    assert trainer.dedup_stats(st) == jtr.dedup_stats(jst)
    # eval lookups stay exact at U = N: nothing is refused, nothing counted
    before = [ts.dedup_overflow.clone() for ts in st.tables.values()]
    trainer.eval_step(st, b)
    for ts, was in zip(st.tables.values(), before):
        assert torch.equal(ts.dedup_overflow, was)
