"""The port's model-quality firewall (`deeprec_tpu_torch/guard/`) on the CPU,
the mirror of tests/test_guard.py: the sentinel's flags against the JAX
package's (the pure fold and whole train steps from one state carried
across with convert.py), the untripped sentinel as a bit-for-bit no-op
(single steps, the K-step window in "off" and "lookahead", the accumulated
step), rollback as a clean run minus the poisoned batch, permanent
quarantine after R trips, reader positions pinned across a rollback,
maintain()'s anomaly eviction against the JAX report, the metrics and
heartbeat wiring, the fingerprint and dead-letter files byte for byte
against the JAX package's, and the sort-and-index quantile past
`torch.nanquantile`'s 2^24-element limit.

Tolerances: flags exactly (inputs away from every threshold); the EMA and
`grad_norm_sq` within 1e-5 relative (the port sums the squares in another
order than XLA's tree order); the quantile bit for bit; rows, counts and
files bit for bit."""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo as JaxSyntheticCriteo
from deeprec_tpu.guard import SentinelConfig as JaxSentinelConfig
from deeprec_tpu.guard import batch_fingerprint as jax_batch_fingerprint
from deeprec_tpu.guard import rows as jax_rows
from deeprec_tpu.guard import sentinel as jax_sentinel
from deeprec_tpu.guard.quarantine import DeadLetter as JaxDeadLetter
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.online import faults as jax_faults
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.guard import (
    FLAG_GRAD_NORM, FLAG_LOSS_SPIKE, FLAG_NONFINITE_GRAD, FLAG_NONFINITE_LOSS,
    FLAG_ROW_NORM, DeadLetter, GuardPolicy, SentinelConfig, batch_fingerprint)
from deeprec_tpu_torch.guard import rows as guard_rows
from deeprec_tpu_torch.guard import sentinel as guard_sentinel
from deeprec_tpu_torch.guard.sentinel import flag_kinds, guard_carry, step_flags
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.online import faults
from deeprec_tpu_torch.online.loop import TrainLoop
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

EMA_RTOL = 1e-5
SENTINEL = int(np.iinfo(np.int32).min)
KW = dict(emb_dim=4, capacity=1 << 10, hidden=(16,), num_cat=2, num_dense=2)
SEN_KW = dict(spike_ratio=4.0, grad_norm_max=1e4, row_norm_max=100.0,
              row_evict_quantile=0.9, row_evict_factor=8.0)
SEN = SentinelConfig(**SEN_KW)


def _trainer(sentinel=True, **kw):
    return Trainer(WDL(**KW), Adagrad(lr=0.2), adam(5e-3), device="cpu",
                   sentinel=SEN if sentinel else None, **kw)


def _batches(n, seed=7, B=64):
    gen = JaxSyntheticCriteo(batch_size=B, num_cat=2, num_dense=2, vocab=300, seed=seed)
    return [gen.batch() for _ in range(n)]


def _port_from_jax(trainer, jst):
    tables = {bname: {"keys": np.asarray(ts.keys), "values": np.asarray(ts.values),
                      "meta": np.asarray(ts.meta),
                      "slots": {k: np.asarray(v) for k, v in ts.slots.items()}}
              for bname, ts in jst.tables.items()}
    return convert.train_state_from_arrays(
        trainer, int(jst.step), tables,
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jst.dense)],
        [np.asarray(x) for x in jax.tree_util.tree_leaves(jst.opt_state)])


def _tensors(state):
    """Every tensor of a port TrainState, named, for a bit-for-bit check."""
    out = {}
    for bname, ts in state.tables.items():
        for f in dataclasses.fields(ts):
            v = getattr(ts, f.name)
            if isinstance(v, dict):
                out.update({f"{bname}.{f.name}.{k}": t for k, t in v.items()})
            elif v is not None:
                out[f"{bname}.{f.name}"] = v
    out.update({f"dense.{k}": v for k, v in state.dense.items()})
    for f in dataclasses.fields(state.opt_state):
        v = getattr(state.opt_state, f.name)
        if isinstance(v, dict):
            out.update({f"opt.{f.name}.{k}": t for k, t in v.items()})
        elif torch.is_tensor(v):
            out[f"opt.{f.name}"] = v
    return out


def _assert_same_state(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def _logical_rows(st):
    """{(bundle, member, key): (value row, freq, version)}: restores re-probe
    keys, so equality is on content, not slot layout."""
    out = {}
    for bname, ts in st.tables.items():
        keys = ts.keys.numpy()
        for m in range(keys.shape[0]):
            for i in np.nonzero(keys[m] != SENTINEL)[0]:
                out[(bname, m, int(keys[m, i]))] = (
                    ts.values[m, i].numpy().tobytes(), int(ts.meta[m, 0, i]),
                    int(ts.meta[m, 1, i]))
    return out


# ------------------------------------------------------ the pure fold

FOLD_CFG = dict(spike_ratio=2.0, ema_decay=0.5, grad_norm_max=10.0, row_norm_max=5.0)
# (name, ema, loss, grads_finite, grad_norm_sq, row_max)
FOLD_CASES = [
    ("clean_seeds", -1.0, 1.0, True, 4.0, 1.0),
    ("clean_decays", 1.0, 1.5, True, 4.0, 1.0),
    ("nonfinite_loss", 1.0, np.nan, True, 4.0, 1.0),
    ("inf_loss", 1.0, np.inf, True, 4.0, 1.0),
    ("nonfinite_grad", 1.0, 1.0, False, 4.0, 1.0),
    ("grad_norm", 1.0, 1.0, True, 101.0 ** 2, 1.0),
    ("grad_norm_inf", 1.0, 1.0, True, np.inf, 1.0),
    ("loss_spike", 1.0, 2.5, True, 4.0, 1.0),
    ("row_norm", 1.0, 1.0, True, 4.0, 6.0),
    ("row_norm_nan", 1.0, 1.0, True, 4.0, np.nan),
    ("everything", 1.0, np.nan, False, np.nan, np.inf),
]


@pytest.mark.parametrize("case", FOLD_CASES, ids=[c[0] for c in FOLD_CASES])
def test_step_flags_matrix_matches_jax(case):
    """Every sentinel bit through the pure fold, against the JAX fold on the
    same inputs: flags exactly, the EMA within EMA_RTOL (a tripped step
    keeps it)."""
    _, ema, loss, ok, sq, row = case
    jf, jg = jax_sentinel.step_flags(
        JaxSentinelConfig(**FOLD_CFG), jnp.float32(loss), jnp.asarray(ok),
        jnp.float32(sq), jnp.float32(row), {"ema": jnp.float32(ema)})
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    pf, pg = step_flags(SentinelConfig(**FOLD_CFG), f32(loss), torch.tensor(ok),
                        f32(sq), f32(row), {"ema": f32(ema)})
    assert pf.dtype == torch.int32 and pf.dim() == 0
    assert int(pf) == int(jf)
    np.testing.assert_allclose(float(pg["ema"]), float(jg["ema"]), rtol=EMA_RTOL)
    if int(pf):
        assert float(pg["ema"]) == ema
    assert flag_kinds(int(pf)) == jax_sentinel.flag_kinds(int(jf))


def test_flag_kinds_and_guard_carry():
    assert flag_kinds(FLAG_NONFINITE_LOSS | FLAG_ROW_NORM) == ["nonfinite_loss", "row_norm"]
    assert flag_kinds(FLAG_NONFINITE_GRAD | FLAG_GRAD_NORM | FLAG_LOSS_SPIKE) == [
        "nonfinite_grad", "grad_norm", "loss_spike"]
    assert guard_carry({"loss": 1}) is None
    assert float(guard_carry({"guard_ema": torch.tensor([0.5, 0.25])})["ema"]) == 0.25
    g = guard_sentinel.guard_init("cpu")
    assert g["ema"].dtype == torch.float32 and float(g["ema"]) == -1.0


@pytest.mark.parametrize("poison", ["none", "nan", "inf", "huge"])
def test_grad_observations_match_jax(poison):
    """Finiteness exactly; the squared norm within EMA_RTOL (inf where JAX
    has inf)."""
    rng = np.random.default_rng(3)
    dense = {"a": rng.normal(size=(8, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)}
    embs = [rng.normal(size=(2, 5, 4)).astype(np.float32)]
    if poison == "nan":
        embs[0][1, 2, 3] = np.nan
    elif poison == "inf":
        dense["b"][1] = -np.inf
    elif poison == "huge":
        dense["a"][0, 0] = 1e30  # finite, but its square overflows f32
    jf, jsq = jax_sentinel.grad_observations(
        {k: jnp.asarray(v) for k, v in dense.items()}, {"e": jnp.asarray(embs[0])})
    pf, psq = guard_sentinel.grad_observations(
        {k: torch.tensor(v) for k, v in dense.items()}, [torch.tensor(embs[0])])
    assert bool(pf) == bool(jf)
    if np.isfinite(float(jsq)):
        np.testing.assert_allclose(float(psq), float(jsq), rtol=EMA_RTOL)
    else:
        assert (np.isnan(float(psq)) and np.isnan(float(jsq))) or float(psq) == float(jsq)


# -------------------------------------------- train steps against JAX

@pytest.fixture(scope="module")
def jax_guarded():
    """A JAX trainer with the sentinel, its state after one clean step (so
    the tables hold rows), and the next batches."""
    tr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=0.2), optax.adam(5e-3),
                    sentinel=JaxSentinelConfig(**SEN_KW))
    st = tr.init(0)
    bs = _batches(3, seed=21)
    st, _ = tr.train_step(st, {k: jnp.asarray(v) for k, v in bs[0].items()})
    return tr, st, bs[1:]


# (poison of the batch, the guard EMA handed in; None = a fresh carry).
# "extreme" trips nothing with a fresh carry (the loss stays finite, the
# model's log transform keeps the gradients under the bound): it is held
# to the JAX flags only.
STEP_CASES = [("clean", None), ("nan", None), ("extreme", None), ("spike", 0.1),
              ("label_flip", 0.1)]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_step_flags_match_jax(jax_guarded, case):
    """One train step from the same carried state and batch in both packages:
    flags exactly, the EMA within EMA_RTOL. `spike` hands in an EMA under
    the clean loss / spike_ratio, so the loss-spike bit fires in both."""
    poison, ema = case
    jtr, jst, bs = jax_guarded
    batch = bs[0] if poison in ("clean", "spike") else jax_faults.poison_batch(bs[0], poison)
    tr = _trainer()
    pst = _port_from_jax(tr, jst)
    jg = None if ema is None else {"ema": jnp.float32(ema)}
    pg = None if ema is None else {"ema": torch.tensor(ema, dtype=torch.float32)}
    _, jm = jtr.train_step(jax.tree.map(jnp.copy, jst),
                           {k: jnp.asarray(v) for k, v in batch.items()}, guard=jg)
    _, pm = tr.train_step(pst, batch, guard=pg)
    assert int(pm["guard_flags"]) == int(jm["guard_flags"]), (
        flag_kinds(int(pm["guard_flags"])), flag_kinds(int(jm["guard_flags"])))
    if poison == "clean":
        assert int(pm["guard_flags"]) == 0
    elif poison in ("spike", "label_flip"):
        assert int(pm["guard_flags"]) & FLAG_LOSS_SPIKE
    elif poison == "nan":
        assert int(pm["guard_flags"]) & FLAG_NONFINITE_LOSS
    np.testing.assert_allclose(float(pm["guard_ema"]), float(jm["guard_ema"]),
                               rtol=EMA_RTOL)


def test_train_steps_window_flags_match_jax(jax_guarded):
    """A K = 3 window with the middle batch poisoned: [K] flags equal to the
    JAX scan's, in "off" and "lookahead"; the EMA carried within EMA_RTOL."""
    jtr, jst, _ = jax_guarded
    bs = _batches(3, seed=11)
    bs[1] = jax_faults.poison_batch(bs[1], "nan")
    _, jm = jtr.train_steps(jax.tree.map(jnp.copy, jst),
                            [{k: jnp.asarray(v) for k, v in b.items()} for b in bs])
    for mode in ("off", "lookahead"):
        tr = _trainer(pipeline_mode=mode)
        _, pm = tr.train_steps(_port_from_jax(tr, jst), bs)
        assert pm["guard_flags"].shape == (3,)
        np.testing.assert_array_equal(pm["guard_flags"].numpy(),
                                      np.asarray(jm["guard_flags"]))
        assert int(pm["guard_flags"][0]) == 0 and int(pm["guard_flags"][1]) != 0
        np.testing.assert_allclose(pm["guard_ema"].numpy(), np.asarray(jm["guard_ema"]),
                                   rtol=EMA_RTOL)


# ------------------------------------------------ the bit-exact no-op

@pytest.mark.parametrize("path", ["train_step", "off", "lookahead", "accum"])
def test_sentinel_is_bitexact_noop_when_untripped(path):
    """Sentinel ON (untripped) against OFF over the same clean batches: every
    tensor of the state equal bit for bit — table keys, rows, metadata,
    slots and counters, dense parameters and Adam moments — through single
    steps, the K = 4 window in "off" and "lookahead", and the accumulated
    step; then a NaN batch trips the expected bits."""
    mode = path if path in ("off", "lookahead") else "off"
    tr0, tr = _trainer(sentinel=False, pipeline_mode=mode), _trainer(pipeline_mode=mode)
    s0 = tr0.init()
    s = copy.deepcopy(s0)
    bs = _batches(4, seed=7)
    g = None
    if path == "train_step":
        for b in bs[:3]:
            s, m = tr.train_step(s, b, guard=g)
            g = guard_carry(m)
            s0, _ = tr0.train_step(s0, b)
            assert int(m["guard_flags"]) == 0
    elif path == "accum":
        big = {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
        s, m = tr.train_step_accum(s, big, 4)
        s0, _ = tr0.train_step_accum(s0, big, 4)
        assert int(m["guard_flags"]) == 0 and m["guard_ema"].dim() == 0
        g = guard_carry(m)
    else:
        s, m = tr.train_steps(s, bs)
        s0, _ = tr0.train_steps(s0, bs)
        assert m["guard_flags"].tolist() == [0, 0, 0, 0]
        g = guard_carry(m)
    _assert_same_state(s, s0)
    bad = faults.poison_batch(_batches(1, seed=8)[0], "nan")
    _, m = tr.train_step(s, bad, guard=g)
    flags = int(m["guard_flags"])
    assert flags & FLAG_NONFINITE_LOSS and flags & FLAG_NONFINITE_GRAD


def test_trainer_rejects_a_sentinel_of_another_type():
    with pytest.raises(TypeError, match="SentinelConfig"):
        Trainer(WDL(**KW), Adagrad(lr=0.2), device="cpu", sentinel={"spike_ratio": 2.0})


# -------------------------------------------------- rollback + quarantine

def test_rollback_resumes_bit_identically_minus_poisoned_batch(tmp_path):
    """The recovery contract: a guarded run over a poisoned stream ends with
    exactly the model of a clean run over the same stream minus the
    poisoned batch — logical rows and dense parameters bit for bit — the
    batch dead-lettered, detection within one dispatch."""
    clean = _batches(14, seed=7)
    poisoned = list(clean)
    poisoned[6] = faults.poison_batch(clean[6], "nan")
    tr = _trainer()
    ck = CheckpointManager(str(tmp_path / "ckA"), tr)
    loop = TrainLoop(tr, ck, iter(poisoned), save_every=4, full_every=2,
                     guard=GuardPolicy(dead_letter_dir=str(tmp_path / "dl"),
                                       max_batch_trips=2), max_steps=14)
    stA, code = loop.run()
    assert code == 0
    assert loop.guard_trips == 1 and loop.rollbacks == 1
    assert loop.last_rollback_ms is not None
    assert loop.trip_log[0][1] - loop.trip_log[0][0] <= 1  # within one dispatch
    fp = batch_fingerprint(poisoned[6])
    assert (tmp_path / "dl" / f"batch-{fp}.npz").exists()
    assert (tmp_path / "dl" / f"batch-{fp}.json").exists()

    tr2 = _trainer(sentinel=False)
    stB, _ = TrainLoop(tr2, CheckpointManager(str(tmp_path / "ckB"), tr2),
                       iter(clean[:6] + clean[7:]), save_every=4, full_every=2,
                       max_steps=13).run()
    assert int(stA.step) == int(stB.step) == 13
    assert _logical_rows(stA) == _logical_rows(stB)
    for k in stA.dense:
        assert torch.equal(stA.dense[k], stB.dense[k]), k


def test_permanent_quarantine_after_R_trips(tmp_path):
    """The crash-loop breaker: a batch redelivered across R rollbacks is
    permanently quarantined, later deliveries are skipped before dispatch,
    and the quarantine survives a fresh DeadLetter (a restart)."""
    clean = _batches(10, seed=3)
    bad = faults.poison_batch(clean[2], "nan")
    stream = clean[:2] + [bad] + clean[3:5] + [bad] + clean[5:7] + [bad] + clean[7:]
    tr = _trainer()
    loop = TrainLoop(tr, CheckpointManager(str(tmp_path / "ck"), tr), iter(stream),
                     save_every=3, full_every=2,
                     guard=GuardPolicy(dead_letter_dir=str(tmp_path / "dl"),
                                       max_batch_trips=2))
    loop.run()
    fp = batch_fingerprint(bad)
    assert loop.dead_letter.trip_count(fp) == 2
    assert loop.dead_letter.is_quarantined(fp)
    assert loop.dead_letter.permanent_count == 1
    assert loop.batches_skipped == 1
    assert DeadLetter(str(tmp_path / "dl"), 2).is_quarantined(fp)
    assert JaxDeadLetter(str(tmp_path / "dl"), 2).is_quarantined(fp)


def test_rollback_pins_stream_reader_positions(tmp_path):
    """A rollback restores MODEL state only: a registered reader is never
    rewound (not even transiently) and is re-attached after."""

    class _Reader:
        def __init__(self):
            self.offset = 0
            self.rewinds = 0

        def save(self):
            return {"offset": self.offset}

        def restore(self, st):
            if int(st["offset"]) < self.offset:
                self.rewinds += 1
            self.offset = int(st["offset"])

    reader = _Reader()
    clean = _batches(10, seed=15)
    stream = list(clean)
    stream[5] = faults.poison_batch(clean[5], "nan")
    tr = _trainer()
    ck = CheckpointManager(str(tmp_path / "ck"), tr, datasets={"stream": reader})
    loop = TrainLoop(tr, ck, iter(stream), save_every=3, full_every=2,
                     guard=GuardPolicy(dead_letter_dir=str(tmp_path / "dl"),
                                       max_batch_trips=2))
    loop.on_step = lambda step: setattr(reader, "offset", 1000 + step)
    loop.run()
    assert loop.rollbacks == 1
    assert reader.rewinds == 0
    assert ck.datasets == {"stream": reader}


def test_guard_requires_sentinel(tmp_path):
    with pytest.raises(ValueError, match="sentinel"):
        TrainLoop(_trainer(sentinel=False), None, [],
                  guard=GuardPolicy(dead_letter_dir=str(tmp_path / "x")))


# ------------------------------------------------------- maintain hygiene

def test_maintain_reinitializes_exploded_rows_as_jax():
    """Row hygiene from one carried state with one row blown up in each
    package: the same rows_reinit in maintain()'s report (and in
    deeprec_guard_rows_reinit{table}), the same keys left, the exploded key
    gone, every other row equal bit for bit."""
    jtr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=0.2), optax.adam(5e-3),
                     sentinel=JaxSentinelConfig(**SEN_KW))
    jst = jtr.init(0)
    for b in _batches(3, seed=5):
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    bn = next(iter(jst.tables))
    ts = jst.tables[bn]
    slot = int(np.nonzero(np.asarray(ts.keys)[0] != SENTINEL)[0][0])
    blown_key = int(np.asarray(ts.keys)[0, slot])
    jst = jst.replace(tables={**jst.tables, bn: ts.replace(values=ts.values.at[0, slot].set(1e9))})
    tr = _trainer()
    pst = _port_from_jax(tr, jst)
    from deeprec_tpu_torch.obs import metrics as obs_metrics

    counter = obs_metrics.default_registry().counter("deeprec_guard_rows_reinit", "",
                                                     {"table": bn})
    c0 = counter.value
    jst2, jrep = jtr.maintain(jst)
    pst2, prep = tr.maintain(pst)
    assert prep[bn]["rows_reinit"] == jrep[bn]["rows_reinit"] >= 1
    assert counter.value - c0 == prep[bn]["rows_reinit"]
    assert prep[bn]["occupancy"] == jrep[bn]["occupancy"]
    prows = _logical_rows(pst2)
    assert (bn, 0, blown_key) not in prows
    jkeys = np.asarray(jst2.tables[bn].keys)
    jvals = np.asarray(jst2.tables[bn].values)
    want = {(bn, m, int(jkeys[m, i])): jvals[m, i].tobytes()
            for m in range(jkeys.shape[0]) for i in np.nonzero(jkeys[m] != SENTINEL)[0]}
    assert {k: v[0] for k, v in prows.items() if k[0] == bn} == want
    assert float(pst2.tables[bn].values.norm(dim=-1).max()) < 1e6


@pytest.mark.parametrize("seed", [0, 1])
def test_anomalous_row_mask_matches_jax(seed):
    """The mask over a [T, C, D] state with NaN, inf and exploded rows and
    empty slots: equal to the JAX mask member by member (quantile 0.9,
    factor 8; the norms sit far from the bound)."""
    from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
    from deeprec_tpu_torch.config import TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable

    rng = np.random.default_rng(seed)
    T, C, D = 2, 64, 4
    vals = rng.normal(size=(T, C, D)).astype(np.float32)
    keys = np.where(rng.random((T, C)) < 0.6, rng.integers(1, 10**6, (T, C)),
                    SENTINEL).astype(np.int32)
    vals[0, 3], vals[1, 5, 2], vals[1, 9, 0] = 1e4, np.nan, np.inf
    keys[0, 3] = keys[1, 5] = keys[1, 9] = 7
    cfg = TableConfig(name="t", dim=D, capacity=C)
    table = EmbeddingTable(cfg)
    ts = table.create(T, "cpu")
    ts.keys.copy_(torch.tensor(keys))
    ts.values.copy_(torch.tensor(vals))
    got = guard_rows.anomalous_row_mask(table, ts, 0.9, 8.0).numpy()
    import deeprec_tpu.config as jcfg

    jtable = JaxTable(jcfg.TableConfig(name="t", dim=D, capacity=C))
    for m in range(T):
        js = jtable.create().replace(keys=jnp.asarray(keys[m]), values=jnp.asarray(vals[m]))
        want = np.asarray(jax_rows.anomalous_row_mask(jtable, js, 0.9, 8.0))
        np.testing.assert_array_equal(got[m], want)
    assert got[0, 3] and got[1, 5] and got[1, 9]


# (n, NaN share): the last size is past torch.nanquantile's 2^24 limit
QUANTILE_CASES = [(1, 0.0), (2, 0.5), (7, 0.0), (1000, 0.3), (4096, 1.0), ((1 << 24) + 3, 0.25)]


@pytest.mark.parametrize("n,nan_share", QUANTILE_CASES,
                         ids=[f"{n}-{s}" for n, s in QUANTILE_CASES])
def test_nanquantile_matches_jax(n, nan_share):
    """The sort-and-index quantile against `jnp.nanquantile` (linear), bit
    for bit at q 0.0, 0.37, 0.9 and 1.0, including an all-NaN input and one
    of 2^24 + 3 elements (where `torch.nanquantile` refuses)."""
    rng = np.random.default_rng(n)
    x = rng.lognormal(size=n).astype(np.float32)
    x[rng.random(n) < nan_share] = np.nan
    qs = (0.9,) if n > 1 << 20 else (0.0, 0.37, 0.9, 1.0)
    for q in qs:
        want = np.asarray(jnp.nanquantile(jnp.asarray(x), jnp.float32(q)))
        got = guard_rows.nanquantile(torch.tensor(x), q).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_touched_row_norms_and_clamp_match_jax(dtype):
    """touched_row_norms against the JAX function (1e-6 relative: the
    squares sum in another order); clamp_rows rewrites exactly the rows
    over the bound (f32: within 1e-6 of JAX's rows; bf16: within one bf16
    ulp, the rounding bits are the port's) and, with nothing over the
    bound, leaves every bit of the table as it was."""
    from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
    import deeprec_tpu.config as jcfg

    rng = np.random.default_rng(5)
    C, D, U = 64, 4, 10
    vals = rng.normal(size=(C, D)).astype(np.float32)
    vals[[3, 7]] *= 100.0
    vals[11, 1] = np.nan
    ix = np.array([3, 7, 11, 0, 5, -1, 20, 30, -1, 40], np.int32)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jtable = JaxTable(jcfg.TableConfig(name="t", dim=D, capacity=C, value_dtype=dtype))
    jv = jnp.asarray(vals).astype(jdt)
    pv = torch.tensor(vals).to(tdt)[None].contiguous()
    jn = np.asarray(jax_rows.touched_row_norms(jtable, jv, jnp.asarray(ix)))
    pn = guard_rows.touched_row_norms(pv, torch.tensor(ix)[None])[0].numpy()
    np.testing.assert_allclose(pn, jn, rtol=1e-6)
    assert pn[5] == 0 and np.isnan(pn[2])
    # nothing over the bound (the NaN row left out of the index): no bit moves
    before = pv.clone()
    fine = torch.tensor(np.where(ix == 11, -1, ix))[None]
    guard_rows.clamp_rows(pv, fine, torch.tensor(pn)[None], 1e6, 0)
    assert torch.equal(pv.view(torch.int16), before.view(torch.int16)) if dtype == "bfloat16" \
        else torch.equal(pv.view(torch.int32), before.view(torch.int32))
    jout = np.asarray(jax_rows.clamp_rows(jtable, jv, jnp.asarray(ix), jnp.asarray(jn), 5.0,
                                          0).astype(jnp.float32))
    guard_rows.clamp_rows(pv, torch.tensor(ix)[None], torch.tensor(pn)[None], 5.0, 0)
    got = pv[0].to(torch.float32).numpy()
    changed = np.nonzero(np.any(np.asarray(jout != np.asarray(jv.astype(jnp.float32)))
                                | np.isnan(jout), axis=-1))[0]
    assert set(changed) == {3, 7, 11}
    ok = np.isfinite(jout)
    atol = 1e-6 if dtype == "float32" else 0.0
    rtol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got[ok], jout[ok], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(jout))
    assert np.all(np.linalg.norm(got[[3, 7]], axis=-1) <= 5.0 * (1 + rtol))


# ----------------------------------------------------------- the obs wiring

def test_guard_metrics_and_heartbeat_wiring(tmp_path):
    """Guard events land in the process-wide obs plane and in the heartbeat
    the Supervisor reads its guard-trip field from."""
    import sys

    from deeprec_tpu_torch.obs import metrics as obs_metrics
    from deeprec_tpu_torch.online.supervisor import Heartbeat, ProcessSpec, Supervisor

    clean = _batches(6, seed=21)
    stream = list(clean)
    stream[3] = faults.poison_batch(clean[3], "nan")
    tr = _trainer()
    hb_path = str(tmp_path / "w.hb")
    loop = TrainLoop(tr, CheckpointManager(str(tmp_path / "ck"), tr), iter(stream),
                     save_every=3, full_every=2, heartbeat=Heartbeat(hb_path),
                     guard=GuardPolicy(dead_letter_dir=str(tmp_path / "dl"),
                                       max_batch_trips=1))
    loop.run()
    text = obs_metrics.render_snapshot(obs_metrics.default_registry().snapshot())
    assert 'deeprec_guard_trips_total{kind="nonfinite_loss"}' in text
    assert "deeprec_guard_rollbacks_total" in text
    assert "deeprec_guard_batches_quarantined_total" in text
    assert "deeprec_guard_last_verified_step" in text
    beat = Heartbeat.read(hb_path)
    assert beat["guard_trips"] == 1 and beat["rollbacks"] == 1
    assert beat["batches_quarantined"] == 1
    assert beat["last_verified_step"] == loop.last_verified_step
    spec = ProcessSpec(name="w", argv=[sys.executable, "-c", "pass"],
                       heartbeat_path=hb_path, lease_secs=None)
    st = Supervisor([spec], on_event=lambda m: None).stats()["w"]
    assert st["guard_trips"] == 1 and st["batches_quarantined"] == 1


def test_dedup_and_maintain_obs_gauges():
    """dedup_stats publishes deeprec_dedup_unique_fraction / _overflow per
    table."""
    from deeprec_tpu_torch.obs import metrics as obs_metrics

    tr = _trainer(unique_budget="auto")
    st = tr.init()
    st, _ = tr.train_step(st, _batches(1)[0])
    stats = tr.dedup_stats(st)
    text = obs_metrics.render_snapshot(obs_metrics.default_registry().snapshot())
    for tname, rec in stats.items():
        assert f'deeprec_dedup_overflow{{table="{tname}"}}' in text
        if rec["unique_fraction"] is not None:
            assert f'deeprec_dedup_unique_fraction{{table="{tname}"}}' in text


# ------------------------------------------- fingerprints and dead letters

def _batch_variants():
    b = _batches(1, seed=30)[0]
    return b, {k: torch.tensor(v) for k, v in b.items()}


def test_batch_fingerprint_matches_jax():
    """The same fingerprint as the JAX package for a numpy batch, for the
    same batch as CPU tensors, and for a poisoned copy; a different batch
    gets a different one."""
    b, tb = _batch_variants()
    assert batch_fingerprint(b) == jax_batch_fingerprint(b) == batch_fingerprint(tb)
    bad = faults.poison_batch(b, "nan", seed=6)
    assert batch_fingerprint(bad) == jax_batch_fingerprint(jax_faults.poison_batch(b, "nan", seed=6))
    assert batch_fingerprint(bad) != batch_fingerprint(b)
    for mode in ("extreme", "label_flip"):
        np.testing.assert_array_equal(
            faults.poison_batch(b, mode, seed=2)["I1"],
            jax_faults.poison_batch(b, mode, seed=2)["I1"])


def test_dead_letter_files_match_jax_byte_for_byte(tmp_path):
    """The same trips recorded by each package's DeadLetter write the same
    bytes (payload npz, meta json, index), and each package reads the
    other's directory."""
    b, tb = _batch_variants()
    fp = batch_fingerprint(b)
    dirs = {}
    for name, cls, batch in (("jax", JaxDeadLetter, b), ("port", DeadLetter, tb)):
        d = str(tmp_path / name)
        dl = cls(d, max_batch_trips=2)
        assert dl.record_trip(fp, 5, 3, ["nonfinite_loss", "nonfinite_grad"], batch) is False
        assert dl.record_trip(fp, 9, 8, ["loss_spike"], batch) is True
        dirs[name] = d
    files = sorted(os.listdir(dirs["jax"]))
    assert files == sorted(os.listdir(dirs["port"])) == sorted(
        ["quarantine.json", f"batch-{fp}.npz", f"batch-{fp}.json"])
    for f in files:
        with open(os.path.join(dirs["jax"], f), "rb") as a, \
                open(os.path.join(dirs["port"], f), "rb") as c:
            assert a.read() == c.read(), f
    with open(os.path.join(dirs["port"], f"batch-{fp}.json")) as f:
        assert json.load(f)["trips"] == 2
    assert DeadLetter(dirs["jax"]).is_quarantined(fp)
    assert JaxDeadLetter(dirs["port"]).is_quarantined(fp)
    assert DeadLetter(dirs["jax"]).trip_count(fp) == 2


def test_tier_counters_publish_like_jax():
    """The deeprec_tier_* counters and gauges of one demoting sync move by
    the same amounts in the port's registry as in the JAX package's, and
    by the round's TierStats."""
    from deeprec_tpu.obs import metrics as jax_metrics
    from deeprec_tpu_torch.obs import metrics as obs_metrics
    from test_torch_multi_tier import Pair  # noqa: E402  (the shared fixture)

    names = ("deeprec_tier_demoted_rows", "deeprec_tier_promoted_rows",
             "deeprec_tier_spilled_rows")
    gauges = ("deeprec_tier_host_rows", "deeprec_tier_device_rows")
    lab = {"table": "mt"}
    regs = (jax_metrics.default_registry(), obs_metrics.default_registry())
    before = [[r.counter(n, "", lab).value for n in names] for r in regs]
    p = Pair()
    js = p.jt.create()
    for _ in range(5):
        js, _ = p.jt.lookup_unique(js, jnp.arange(10, dtype=jnp.int32), step=1)
    js, _ = p.jt.lookup_unique(js, jnp.arange(10, 52, dtype=jnp.int32), step=2)
    ps = p.carry(js)
    js, ps, st = p.sync(js, ps, 3)
    assert st.demoted > 0
    moved = [[r.counter(n, "", lab).value - b for n, b in zip(names, bb)]
             for r, bb in zip(regs, before)]
    assert moved[1] == moved[0] == [st.demoted, st.promoted, st.spilled]
    assert [regs[1].gauge(n, "", lab).value for n in gauges] == \
        [regs[0].gauge(n, "", lab).value for n in gauges] == [st.host_size, st.device_size]
