"""The port's pipelined K-step window on the CPU, the mirror of
tests/test_pipeline_overlap.py on one device: `pipeline_mode` "lookahead",
"chunked" and "nested" (the last two run as "lookahead" on one device)
against "off" bit for bit — losses, accuracies, keys, metadata, counters,
value rows, optimizer slots, dense parameters and Adam state — for fresh
ids mid-window, the tiny-vocabulary hazard (each batch rewrites rows the
next one reads), K = 1, a unique budget, a shared-table model, and bf16
tables under counter and counting-Bloom admission; and a bad mode is
rejected.

The JAX package's own lookahead is not bitwise equal to its "off" for
shared tables on this tree's jax, so the port's pipelined modes are held
against the port's "off"; tests/test_torch_train_loop.py holds the port's
"off" window against the JAX package."""
import numpy as np
import pytest
import torch
from torch import nn

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.features import DenseFeature, SparseFeature
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.trainer import PIPELINE_MODES, Trainer

torch.set_num_threads(1)


def _wdl(ev=tcfg.EmbeddingVariableOption(), value_dtype=None):
    model = WDL(emb_dim=8, capacity=1 << 12, hidden=(16,), num_cat=4, num_dense=2,
                ev=ev)
    if value_dtype is not None:
        import dataclasses

        model.features = [
            dataclasses.replace(f, table=dataclasses.replace(f.table, value_dtype=value_dtype))
            if isinstance(f, SparseFeature) else f for f in model.features]
    return model


class TinyShared(nn.Module):
    """Two features on one shared table, and a linear head."""

    def __init__(self):
        super().__init__()
        tab = tcfg.TableConfig(name="item", dim=8, capacity=1 << 10)
        self.features = [SparseFeature("item", table=tab),
                         SparseFeature("item2", shared_table="item"),
                         DenseFeature("d", 1)]
        self.w = nn.Parameter(torch.linspace(-0.2, 0.2, 16))

    def forward(self, inputs):
        x = torch.cat([inputs.pooled["item"], inputs.pooled["item2"]], -1)
        return x @ self.w


def window_batches(K=4, batch_size=64, seed=7, fresh_ids=True):
    """fresh_ids: later batches bring ids no earlier batch held; else one
    vocabulary of 40, so consecutive batches overlap heavily."""
    gen = SyntheticCriteo(batch_size=batch_size, num_cat=4, num_dense=2,
                          vocab=500 if fresh_ids else 40, seed=seed)
    batches = [gen.batch() for _ in range(K)]
    if fresh_ids:
        for t in range(1, K):
            batches[t]["C1"] = batches[t]["C1"] + np.int32(10_000 * t)
    return batches


def shared_batches(K=3, n=32):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(K):
        ids = rng.integers(0, 20, size=(n,)).astype(np.int32)
        out.append({"item": ids, "item2": ids[::-1].copy(),
                    "d": rng.normal(size=(n, 1)).astype(np.float32),
                    "label": (rng.random(n) < 0.5).astype(np.float32)})
    return out


def assert_states_bitwise(a, b):
    assert a.step == b.step
    for bname in a.tables:
        x, y = a.tables[bname], b.tables[bname]
        for field in ("keys", "meta", "values", "insert_fails", "dedup_unique",
                      "dedup_ids", "dedup_overflow", "bloom"):
            u, v = getattr(x, field), getattr(y, field)
            assert (u is None) == (v is None), field
            if u is not None:
                assert torch.equal(u, v), (bname, field)
        assert x.slots.keys() == y.slots.keys()
        for k in x.slots:
            assert torch.equal(x.slots[k], y.slots[k]), (bname, k)
    for n in a.dense:
        assert torch.equal(a.dense[n], b.dense[n]), n
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for n in a.dense:
        assert torch.equal(a.opt_state.mu[n], b.opt_state.mu[n]), n
        assert torch.equal(a.opt_state.nu[n], b.opt_state.nu[n]), n


CASES = {
    "fresh_ids": lambda: (_wdl, {}, window_batches(4), 0.1),
    "tiny_vocab": lambda: (_wdl, {}, window_batches(4, fresh_ids=False), 0.3),
    "k1": lambda: (_wdl, {}, window_batches(1), 0.1),
    "unique_budget": lambda: (_wdl, {"unique_budget": 64}, window_batches(3), 0.1),
    "shared_table": lambda: (TinyShared, {}, shared_batches(), 0.2),
    "bf16_counter": lambda: (
        lambda: _wdl(tcfg.EmbeddingVariableOption(counter_filter=tcfg.CounterFilter(2)),
                     "bfloat16"), {}, window_batches(4, fresh_ids=False), 0.3),
    "bf16_cbf": lambda: (
        lambda: _wdl(tcfg.EmbeddingVariableOption(cbf_filter=tcfg.CBFFilter(
            filter_freq=2, max_element_size=1 << 12)), "bfloat16"), {},
        window_batches(4, fresh_ids=False), 0.3),
}


@pytest.mark.parametrize("mode", ["lookahead", "chunked", "nested"])
@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_window_matches_off_bitwise(mode, case):
    make_model, kw, batches, lr = CASES[case]()
    model = make_model()
    runs = {}
    for m in ("off", mode):
        trainer = Trainer(model, Adagrad(lr=lr), adam(2e-3), device="cpu",
                          pipeline_mode=m, **kw)
        runs[m] = trainer.train_steps(trainer.init(), batches)
    (s0, m0), (s1, m1) = runs["off"], runs[mode]
    assert m1["loss"].shape == (len(batches),)
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["accuracy"], m1["accuracy"])
    assert s1.step == len(batches)
    assert_states_bitwise(s0, s1)
    if case == "shared_table":
        b = next(iter(trainer.bundles.values()))
        assert not b.stacked and len(b.features) == 2


def test_pipeline_mode_validated():
    assert PIPELINE_MODES == ("off", "lookahead", "chunked", "nested")
    with pytest.raises(ValueError, match="pipeline_mode"):
        Trainer(_wdl(), Adagrad(lr=0.1), device="cpu", pipeline_mode="sideways")
