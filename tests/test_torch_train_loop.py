"""The port's training loop on the CPU, the mirror of
tests/test_train_steps.py, tests/test_accum.py and tests/test_auto_stage.py:
the K-step window `train_steps` against K port `train_step` calls (bit for
bit) and against the JAX `train_steps` from one initial state carried
across with convert.py; a stacked [K, ...] input; ids first seen in the
middle of a window; `train_step_accum` against the JAX one, and its dense
gradients against the full batch's; `remat`; and the staged input:
`stage_batch` keeps the model's inputs and labels, stage="off" returns the
source, the `Prefetcher` reads ahead while the loop computes, and
`on_consume` counts deliveries.

Tolerances against JAX (the same f32 math in another summation order, bf16
operand roundings in the MLPs, initializer rows within 65 ulps of erfinv):
losses RTOL, table rows ROW_ATOL, dense parameters 2 x lr per Adam step
(a gradient element near zero may flip sign under another order)."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo as JaxSyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training import stack_batches as jax_stack_batches
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.data import Prefetcher, SyntheticCriteo, staged
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.optim import Adagrad, GradientDescent, adam
from deeprec_tpu_torch.training.trainer import Trainer, stack_batches

torch.set_num_threads(1)

SENTINEL = int(np.iinfo(np.int32).min)
RTOL, ROW_ATOL = 1e-4, 1e-5
LR, DENSE_LR = 0.1, 2e-3
KW = dict(emb_dim=8, capacity=1 << 12, hidden=(16,), num_cat=4, num_dense=2)


def window_batches(K=4, batch_size=64, seed=7):
    """K batches whose later ones bring ids no earlier batch held."""
    gen = SyntheticCriteo(batch_size=batch_size, num_cat=4, num_dense=2, vocab=500,
                          seed=seed)
    batches = [gen.batch() for _ in range(K)]
    for t in range(1, K):
        batches[t]["C1"] = batches[t]["C1"] + np.int32(10_000 * t)
    return batches


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _trainer(**kw):
    return Trainer(WDL(**KW), Adagrad(lr=LR), adam(DENSE_LR), device="cpu", **kw)


def _port_from_jax(trainer, jst):
    tables = {bname: {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
                      "meta": np.asarray(ts.meta),
                      "slots": {k: np.asarray(v) for k, v in ts.slots.items()}}
              for bname, ts in jst.tables.items()}
    return convert.train_state_from_arrays(
        trainer, int(jst.step), tables,
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.dense)],
        [np.asarray(l) for l in jax.tree_util.tree_leaves(jst.opt_state)])


def _rows(keys, values, accum, meta):
    keys = np.asarray(keys)
    return {int(keys[i]): (np.asarray(values)[i], np.asarray(accum)[i],
                           tuple(np.asarray(meta)[:, i]))
            for i in np.nonzero(keys != SENTINEL)[0]}


def _assert_tables_agree(trainer, st, jst):
    """Per key of every table: freq, version and dirty exact, value and
    accumulator rows within ROW_ATOL."""
    for bname, b in trainer.bundles.items():
        ts, jts = st.tables[bname], jst.tables[bname]
        for k in range(b.num_tables):
            got = _rows(ts.keys[k], ts.values[k], ts.slots["accum"][k], ts.meta[k])
            want = _rows(jts.keys[k], jts.values[k], jts.slots["accum"][k], jts.meta[k])
            assert got.keys() == want.keys()
            for key, (wv, wa, wm) in want.items():
                gv, ga, gm = got[key]
                assert gm == wm, key
                np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ROW_ATOL)
                np.testing.assert_allclose(ga, wa, rtol=RTOL, atol=ROW_ATOL)


def _assert_dense_agree(trainer, st, jst, steps):
    for name, leaf in zip(jax_leaf_names(trainer.model),
                          jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_allclose(st.dense[name].numpy(), np.asarray(leaf), rtol=0,
                                   atol=2 * DENSE_LR * steps + 1e-6, err_msg=name)


def _assert_same_state(a, b):
    assert a.step == b.step
    for bname in a.tables:
        x, y = a.tables[bname], b.tables[bname]
        for f in ("keys", "meta", "values", "insert_fails", "dedup_unique", "dedup_ids"):
            assert torch.equal(getattr(x, f), getattr(y, f)), (bname, f)
        for k in x.slots:
            assert torch.equal(x.slots[k], y.slots[k])
    for n in a.dense:
        assert torch.equal(a.dense[n], b.dense[n]), n
        assert torch.equal(a.opt_state.mu[n], b.opt_state.mu[n]), n
        assert torch.equal(a.opt_state.nu[n], b.opt_state.nu[n]), n


# ------------------------------------------------------------- train_steps


def test_train_steps_equals_sequential_steps_bitwise():
    K = 4
    batches = window_batches(K)
    trainer = _trainer()
    s_seq, seq = trainer.init(), []
    for b in batches:
        s_seq, m = trainer.train_step(s_seq, b)
        seq.append(m["loss"])
    s_win, mets = _trainer().train_steps(_trainer().init(), batches)
    assert mets["loss"].shape == mets["accuracy"].shape == (K,)
    assert torch.equal(mets["loss"], torch.stack(seq))
    assert s_win.step == s_seq.step == K
    _assert_same_state(s_win, s_seq)


def test_train_steps_matches_jax():
    """One window of K = 4 in both packages from the JAX initial state."""
    batches = window_batches(4)
    jtr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=LR), optax.adam(DENSE_LR))
    jst = jtr.init(0)
    trainer = _trainer()
    st = _port_from_jax(trainer, jst)
    jst, jm = jtr.train_steps(jst, [_jb(b) for b in batches])
    st, m = trainer.train_steps(st, batches)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=RTOL)
    np.testing.assert_array_equal(m["accuracy"].numpy(), np.asarray(jm["accuracy"]))
    assert st.step == int(jst.step) == 4
    _assert_tables_agree(trainer, st, jst)
    _assert_dense_agree(trainer, st, jst, 4)
    assert int(st.opt_state.count) == int(jst.opt_state[0].count) == 4


def test_train_steps_takes_stacked_input():
    batches = window_batches(3)
    stacked = stack_batches(batches)
    assert stacked["C1"].shape == (3, 64)
    jstacked = jax_stack_batches([_jb(b) for b in batches])
    np.testing.assert_array_equal(stacked["C1"], np.asarray(jstacked["C1"]))
    s1, m1 = _trainer().train_steps(_trainer().init(), stacked)
    s2, m2 = _trainer().train_steps(_trainer().init(), batches)
    assert torch.equal(m1["loss"], m2["loss"]) and s1.step == 3
    _assert_same_state(s1, s2)
    dev = stack_batches([_trainer().device_batch(b) for b in batches])
    assert torch.is_tensor(dev["C1"]) and dev["C1"].shape == (3, 64)


def test_train_steps_inserts_new_ids_mid_window():
    """Ids first seen at inner step 3 are in the table, stamped version 3."""
    batches = window_batches(4)
    trainer = _trainer()
    st, _ = trainer.train_steps(trainer.init(), batches)
    (bname, b), = trainer.bundles.items()
    k = [f.name for f in b.features].index("C1")
    keys = st.tables[bname].keys[k].numpy()
    version = st.tables[bname].meta[k, 1].numpy()
    last = batches[3]["C1"]
    assert np.isin(last, keys).all()
    stamp = dict(zip(keys.tolist(), version.tolist()))
    assert all(stamp[int(i)] == 3 for i in last)


def test_train_steps_needs_a_sparse_optimizer():
    trainer = Trainer(WDL(**KW), device="cpu")
    with pytest.raises(ValueError, match="sparse optimizer"):
        trainer.train_steps(trainer.init(), window_batches(1))


# ---------------------------------------------------------------- accum


def test_accum_matches_jax():
    """Two micro-batched steps (A = 4 of 64 rows) in both packages: losses,
    tables per key, dense parameters; one global step per call."""
    gen = JaxSyntheticCriteo(batch_size=256, num_cat=4, num_dense=2, vocab=1000, seed=3)
    batches = [gen.batch() for _ in range(2)]
    jtr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=LR), optax.adam(DENSE_LR))
    jst = jtr.init(0)
    trainer = _trainer()
    st = _port_from_jax(trainer, jst)
    for b in batches:
        jst, jm = jtr.train_step_accum(jst, _jb(b), accum_steps=4)
        st, m = trainer.train_step_accum(st, b, accum_steps=4)
        assert m["loss"].shape == ()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=RTOL)
        np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]), atol=1e-7)
    assert st.step == int(jst.step) == 2
    _assert_tables_agree(trainer, st, jst)
    _assert_dense_agree(trainer, st, jst, 2)
    with pytest.raises(ValueError, match="micro-batches"):
        trainer.train_step_accum(st, batches[0], accum_steps=3)


class _Sgd:
    """Plain SGD with the dense optimizer's interface, for the test."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return None

    def update(self, grads, state, params=None):
        return {n: -self.lr * g for n, g in grads.items()}, state


def test_accum_dense_gradients_match_full_batch():
    """With sparse lr 0 the micro-batches see the same rows, so the mean of
    the micro-batch dense gradients is the full batch's gradient (a mean
    loss) up to f32 summation order: after one SGD(0.5) step the dense
    parameters agree within 2e-4, as in the JAX test; the tables take the
    same inserts and the micro-batches' freq counts add up to the full
    batch's."""
    b = SyntheticCriteo(batch_size=256, num_cat=4, num_dense=2, vocab=500, seed=5).batch()
    t1 = Trainer(WDL(**KW), GradientDescent(lr=0.0), _Sgd(0.5), device="cpu")
    t2 = Trainer(WDL(**KW), GradientDescent(lr=0.0), _Sgd(0.5), device="cpu")
    s1, _ = t1.train_step(t1.init(), b)
    s2, _ = t2.train_step_accum(t2.init(), b, accum_steps=4)
    for n in s1.dense:
        np.testing.assert_allclose(s1.dense[n].numpy(), s2.dense[n].numpy(), atol=2e-4)
    for bname in s1.tables:
        assert _key_meta(s1.tables[bname]) == _key_meta(s2.tables[bname])


def _key_meta(ts):
    """{(table, key): (freq, version, dirty)} of every live slot."""
    return {(t, int(k)): tuple(ts.meta[t, :, i].tolist())
            for t in range(ts.keys.shape[0])
            for i, k in enumerate(ts.keys[t].tolist()) if k != SENTINEL}


# ------------------------------------------------------------------ remat


def test_remat_matches_plain_bitwise():
    batches = window_batches(3)
    s0, m0 = _trainer().train_steps(_trainer().init(), batches)
    t = _trainer(remat=True)
    s1, m1 = t.train_steps(t.init(), batches)
    assert torch.equal(m0["loss"], m1["loss"])
    _assert_same_state(s0, s1)


# ------------------------------------------------------------ staged input


def test_input_keys_and_stage_batch_filters():
    trainer = _trainer()
    assert trainer.input_keys() == {"C1", "C2", "C3", "C4", "I1", "I2"}
    batch = SyntheticCriteo(batch_size=32, num_cat=4, num_dense=2, vocab=100).batch()
    batch["junk_column"] = np.zeros(32)
    batch["label_aux"] = np.zeros(32, np.float32)
    st = trainer.stage_batch(batch)
    assert "junk_column" not in st
    assert {"label", "label_aux"} <= st.keys()
    assert all(torch.is_tensor(v) and v.device.type == "cpu" for v in st.values())
    assert np.array_equal(st["C1"].numpy(), batch["C1"])
    again = trainer.stage_batch(st)
    assert all(again[k] is st[k] for k in st)  # re-staging passes tensors through
    state, m = trainer.train_step(trainer.init(), again)
    assert np.isfinite(float(m["loss"]))


def test_stage_off_returns_the_source_and_bad_mode_raises():
    src = iter([1, 2, 3])
    assert _trainer(stage="off").stage(src) is src
    with pytest.raises(ValueError, match="stage"):
        _trainer(stage="sometimes")


def test_staged_window_equals_unstaged_bitwise():
    """Two windows fed by `stage` and two fed with the host batches."""
    batches = window_batches(8)
    runs = []
    for mode in ("auto", "off"):
        trainer = _trainer(stage=mode)
        st, losses = trainer.init(), []
        data = iter(trainer.stage(iter(batches), depth=2))
        for _ in range(2):
            st, m = trainer.train_steps(st, [next(data) for _ in range(4)])
            losses.append(m["loss"])
        runs.append((st, torch.cat(losses)))
    assert isinstance(_trainer().stage(iter(batches)), Prefetcher)
    assert torch.equal(runs[0][1], runs[1][1])
    _assert_same_state(runs[0][0], runs[1][0])


def test_prefetcher_overlaps_io_with_compute():
    """With a depth-2 ring the producer pulls batch i+1 while the consumer
    still computes on batch i (sleep-based: holds on one core)."""
    trainer = _trainer()
    gen = SyntheticCriteo(batch_size=16, num_cat=4, num_dense=2, vocab=100)
    pulls = []

    def slow_source(n=6):
        for _ in range(n):
            time.sleep(0.04)  # "IO"
            pulls.append(time.monotonic())
            yield gen.batch()

    finishes = []
    for _ in trainer.stage(slow_source()):
        time.sleep(0.08)  # "compute"
        finishes.append(time.monotonic())
    assert len(finishes) == len(pulls) == 6
    assert sum(pulls[i + 1] < finishes[i] for i in range(5)) >= 4, (pulls, finishes)


class _Stream:
    """A source with the stream-position contract (mark_consumed,
    attach_consumer)."""

    def __init__(self, n):
        self.n, self.produced, self.consumed, self.attached = n, 0, 0, False

    def __iter__(self):
        gen = SyntheticCriteo(batch_size=8, num_cat=4, num_dense=2, vocab=50)
        for _ in range(self.n):
            self.produced += 1
            yield gen.batch()

    def attach_consumer(self):
        self.attached = True

    def mark_consumed(self):
        self.consumed += 1


def test_on_consume_counts_deliveries():
    """Deliveries, not productions: the ring reads ahead of the loop. The
    explicit callback, the auto-wired `mark_consumed`, the end of the
    stream, a reader error and close()."""
    src = _Stream(5)
    calls = []
    ring = staged(iter(src), depth=2, on_consume=lambda: calls.append(1), device="cpu")
    next(ring)
    time.sleep(0.2)
    assert len(calls) == 1 and src.produced >= 2
    assert len(list(ring)) == 4 and len(calls) == 5
    src = _Stream(3)
    ring = _trainer().stage(src)
    assert src.attached
    first = next(ring)
    assert src.consumed == 1 and isinstance(first["C1"], torch.Tensor)
    ring.close()
    assert not ring._thread.is_alive()

    def broken():
        yield SyntheticCriteo(batch_size=8, num_cat=4, num_dense=2, vocab=50).batch()
        raise OSError("reader failed")

    ring = Prefetcher(broken(), device="cpu")
    next(ring)
    with pytest.raises(OSError, match="reader failed"):
        next(ring)
    ring.close()
    assert not ring._thread.is_alive()


def test_new_entry_points_raise_without_cuda(monkeypatch):
    """No device and no CUDA: the trainer with the loop's options and the
    default Prefetcher raise, never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(WDL(**KW), Adagrad(lr=LR), pipeline_mode="lookahead", remat=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Prefetcher(iter([]))


def test_init_seed_draws_the_dense_leaves_again():
    """`Trainer.init(seed)`, as the JAX `init(seed)` the modelzoo calls:
    init(0) twice gives equal leaves, init(0) and init(1) different ones,
    init() the model's own parameters; the tables start empty either way.
    (The port's draws are not jax.random's: parity tests carry state.)"""
    tr = _trainer()
    a, b, c, own = tr.init(0), tr.init(0), tr.init(1), tr.init()
    assert a.dense.keys() == c.dense.keys() == own.dense.keys()
    assert all(torch.equal(a.dense[n], b.dense[n]) for n in a.dense)
    assert all(not torch.equal(a.dense[n], c.dense[n]) for n in a.dense
               if a.dense[n].abs().sum() > 0)
    assert any(not torch.equal(a.dense[n], c.dense[n]) for n in a.dense)
    assert all(torch.equal(own.dense[n], p) for n, p in tr.model.named_parameters())
    assert all(a.dense[n].shape == own.dense[n].shape for n in a.dense)
    for st in (a, c):
        assert all(int(tr.bundles[bn].table.size(ts).sum()) == 0 for bn, ts in st.tables.items())
        assert torch.equal(st.opt_state.count, own.opt_state.count)
    tr.init(1)
    assert all(torch.equal(own.dense[n], p) for n, p in tr.model.named_parameters())


def test_prefetcher_peek_runs_on_raw_batches_in_the_producer():
    """`Prefetcher(peek=)`: the hook sees each raw host batch, before
    `transform`, in the producer thread; a peek that raises ends the stream
    with its error, as in the JAX package."""
    import threading

    seen = []
    ring = Prefetcher(iter([{"x": np.arange(3)}, {"x": np.arange(4)}]), depth=1,
                      transform=lambda b: {"x": torch.as_tensor(b["x"]) * 2},
                      peek=lambda b: seen.append((threading.current_thread().name,
                                                  type(b["x"]), len(b["x"]))))
    out = list(ring)
    assert [o["x"].tolist() for o in out] == [[0, 2, 4], [0, 2, 4, 6]]
    assert [s[1:] for s in seen] == [(np.ndarray, 3), (np.ndarray, 4)]
    assert all(name != threading.current_thread().name for name, _, _ in seen)

    def bad_peek(b):
        raise ValueError("peek failed")

    ring = staged(iter([{"x": np.arange(3)}] * 3), device="cpu", peek=bad_peek)
    with pytest.raises(ValueError, match="peek failed"):
        next(ring)
    ring.close()
    assert not ring._thread.is_alive()
