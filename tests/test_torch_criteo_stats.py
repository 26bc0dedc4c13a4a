"""The port's copy of `CriteoStats` (the Criteo-marginal stream) against
the JAX package's on the CPU: `batch_at` and `probs_at` bit for bit over
seeds, splits, indices and id dtypes, the calibrated intercept, the Bayes
AUC and the exact rank `_auc`, and the stream position (`save`,
`restore`, `attach_consumer`, `mark_consumed`) through the port's staging
ring."""
import time

import numpy as np
import pytest
import torch

from deeprec_tpu.data import synthetic as jsyn
from deeprec_tpu_torch.data import synthetic as tsyn
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)


def _pair(**kw):
    return jsyn.CriteoStats(**kw), tsyn.CriteoStats(**kw)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,split,dtype,cap", [
    (0, "train", np.int32, 1 << 22), (1, "eval", np.int32, 1 << 22),
    (7, "train", np.int64, 1 << 12), (3, "calib", np.int32, 1 << 16)])
def test_batch_at_bit_for_bit(seed, split, dtype, cap):
    kw = dict(batch_size=128, seed=seed, split=split, dtype=dtype, cardinality_cap=cap)
    j, t = _pair(**kw)
    assert j.intercept == t.intercept
    assert j.cards == t.cards
    np.testing.assert_array_equal(j.zipf_a, t.zipf_a)
    np.testing.assert_array_equal(j.strength, t.strength)
    for i in (0, 1, 17, 1000):
        _assert_batches_equal(j.batch_at(i), t.batch_at(i))
        (jb, jp), (tb, tp) = j.probs_at(i, n=64), t.probs_at(i, n=64)
        _assert_batches_equal(jb, tb)
        np.testing.assert_array_equal(jp, tp)


def test_narrow_schema_and_iteration():
    j, t = _pair(batch_size=32, seed=2, num_cat=5, num_dense=3)
    ji, ti = iter(j), iter(t)
    for _ in range(3):
        _assert_batches_equal(next(ji), next(ti))
    assert j.save() == t.save() == {"index": 3}
    assert sorted(k for k in t.batch_at(0) if k.startswith("C")) == [f"C{i}" for i in range(1, 6)]


def test_bayes_auc_and_auc_helper_bit_for_bit():
    j, t = _pair(batch_size=16, seed=4)
    assert j.bayes_auc(n=20_000) == t.bayes_auc(n=20_000)
    rng = np.random.default_rng(0)
    label = (rng.random(5000) < 0.3).astype(np.float32)
    for score in (rng.random(5000), rng.integers(0, 7, 5000).astype(np.float64),
                  np.zeros(5000)):
        assert jsyn._auc(label, score) == tsyn._auc(label, score)
    assert tsyn._auc(np.zeros(4, np.float32), np.arange(4.0)) == 0.5
    assert tsyn._auc(np.array([0, 0, 1, 1], np.float32), np.arange(4.0)) == 1.0


def test_mix64_and_hash_normal_bit_for_bit():
    keys = np.arange(0, 1 << 40, (1 << 40) // 997, dtype=np.uint64)
    np.testing.assert_array_equal(jsyn._mix64(keys), tsyn._mix64(keys))
    np.testing.assert_array_equal(jsyn._hash_normal(keys, 0x5EED), tsyn._hash_normal(keys, 0x5EED))
    assert jsyn.CRITEO_KAGGLE_CARDINALITIES == tsyn.CRITEO_KAGGLE_CARDINALITIES


def test_save_restore_and_consumed_index_behind_the_ring():
    """Unstaged, save() reports the producer index; staged through
    Trainer.stage (depth 2), the consumed one; restore() rewinds both, as
    the JAX stream does."""
    j, t = _pair(batch_size=16, seed=5, num_cat=2, num_dense=2)
    for _ in range(4):
        j.batch()
        t.batch()
    assert t.save() == j.save() == {"index": 4}
    t.restore({"index": 2})
    j.restore({"index": 2})
    _assert_batches_equal(j.batch(), t.batch())

    trainer = Trainer(WDL(emb_dim=4, capacity=256, hidden=(8,), num_cat=2, num_dense=2),
                      Adagrad(lr=0.1), adam(1e-3), device="cpu")
    gen = tsyn.CriteoStats(batch_size=16, seed=5, num_cat=2, num_dense=2,
                           cardinality_cap=128)
    data = trainer.stage(gen, depth=2)
    assert gen.save() == {"index": 0}  # attached before the ring ran ahead
    it = iter(data)
    got = [next(it) for _ in range(3)]
    deadline = time.monotonic() + 30
    while gen._index <= 3 and time.monotonic() < deadline:
        time.sleep(0.01)  # the ring's producer runs ahead
    assert gen.save() == {"index": 3} and gen._index > 3
    want = gen.batch_at(2)
    np.testing.assert_array_equal(got[2]["C1"].numpy(), want["C1"])
    data.close()
