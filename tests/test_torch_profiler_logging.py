"""The port's `training/profiler.py` and `training/logging.py` against the
JAX package's on the CPU: `LatencyHistogram` (buckets, percentiles,
summary, merge) equal to the JAX histogram on the same samples; the
`PhaseProfiler` report; `phase_scope` ranges in a torch.profiler trace of a
train step; `StepWindowTracer` writing a Chrome trace only inside its
window; `MetricsLogger` lines and `table_gauges` equal to the JAX
package's for the same carried state."""
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training import logging as jlog
from deeprec_tpu.training import profiler as jprof
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training import logging as tlog
from deeprec_tpu_torch.training import profiler as tprof
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

KW = dict(emb_dim=4, capacity=256, hidden=(8,), num_cat=3, num_dense=2)


def _samples(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-7, 2, n), [0.0, 1e-7, 50e-6, 119.9, 500.0]])


@pytest.mark.parametrize("lo,hi", [(50e-6, 120.0), (1e-3, 10.0)])
def test_latency_histogram_equals_jax(lo, hi):
    j, t = jprof.LatencyHistogram(lo, hi), tprof.LatencyHistogram(lo, hi)
    assert j._bounds == t._bounds
    for s in _samples(2000, 1):
        j.record(s)
        t.record(s)
    assert j._counts == t._counts
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert j.percentile(q) == t.percentile(q)
    assert j.summary() == t.summary()
    j2, t2 = jprof.LatencyHistogram(lo, hi), tprof.LatencyHistogram(lo, hi)
    for s in _samples(300, 2):
        j2.record(s)
        t2.record(s)
    j.merge(j2)
    t.merge(t2)
    assert j.summary() == t.summary() and j._counts == t._counts
    assert tprof.LatencyHistogram().summary() == jprof.LatencyHistogram().summary()


def test_phase_profiler_report():
    p = tprof.PhaseProfiler()
    for _ in range(3):
        with p.phase("lookup"):
            torch.ones(8).sum()
    with p.phase("apply", block=torch.zeros(1)):
        pass
    assert p.timed("dense", lambda x: x * 2, torch.ones(2)).tolist() == [2.0, 2.0]
    p.record("ckpt_stall", 0.25)
    rep = p.phase_report()
    assert set(rep) == {"lookup", "apply", "dense", "ckpt_stall"}
    assert rep["lookup"]["calls"] == 3 and rep["ckpt_stall"]["total_ms"] == 250.0
    for r in rep.values():
        assert set(r) == {"calls", "total_ms", "mean_ms", "min_ms"}
        assert r["min_ms"] <= r["mean_ms"] <= r["total_ms"]
    # the JAX report has the same shape for the same records
    jp = jprof.PhaseProfiler()
    jp.record("ckpt_stall", 0.25)
    p.reset()
    p.record("ckpt_stall", 0.25)
    assert p.phase_report() == jp.phase_report()


def _trainer():
    return Trainer(WDL(**KW), Adagrad(lr=0.1), adam(1e-3), device="cpu")


def _batches(n):
    g = SyntheticCriteo(batch_size=32, num_cat=3, num_dense=2, vocab=200, seed=1)
    return [g.batch() for _ in range(n)]


def _trace_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_trace_holds_the_train_steps_phase_ranges(tmp_path):
    tr = _trainer()
    st = tr.init()
    with tprof.trace(str(tmp_path)) as d:
        st, _ = tr.train_step(st, _batches(1)[0])
    names = _trace_names(os.path.join(d, tprof.TRACE_FILE))
    assert {"phase_lookup", "phase_dense_fwd_bwd", "phase_sparse_apply",
            "phase_dense_apply"} <= names


def test_step_window_tracer_traces_only_its_window(tmp_path):
    tr = _trainer()
    st = tr.init()
    inside, outside = str(tmp_path / "in"), str(tmp_path / "out")
    tracers = [tprof.StepWindowTracer(2, 4, inside), tprof.StepWindowTracer(10, 12, outside)]
    for b in _batches(6):
        for t in tracers:
            t.on_step(st.step)
        st, _ = tr.train_step(st, b)
    assert tracers[0]._prof is None  # closed on reaching step 4
    for t in tracers:
        t.close()
    names = _trace_names(os.path.join(inside, tprof.TRACE_FILE))
    assert "phase_lookup" in names
    assert not os.path.exists(os.path.join(outside, tprof.TRACE_FILE))
    # a run resumed past the start still enters what is left of the window
    late = tprof.StepWindowTracer(2, 4, str(tmp_path / "late"))
    late.on_step(3)
    assert late._prof is not None
    late.close()
    assert os.path.exists(os.path.join(str(tmp_path / "late"), tprof.TRACE_FILE))


def test_metrics_logger_lines_equal_jax(tmp_path):
    recs = [(8, dict(loss=torch.tensor(0.6931), steps_per_sec=12.5, note="x")),
            (16, dict(loss=np.float32(0.5), auc=0.71))]
    for who, mod in (("port", tlog), ("jax", jlog)):
        lg = mod.MetricsLogger(str(tmp_path / who / "m.jsonl"))
        for step, kw in recs:
            kw = {k: (jnp.asarray(v.item()) if who == "jax" and torch.is_tensor(v) else v)
                  for k, v in kw.items()}
            lg.log(step, **kw)
        lg.close()
    lines = {}
    for who in ("port", "jax"):
        with open(str(tmp_path / who / "m.jsonl")) as f:
            lines[who] = [json.loads(line) for line in f]
    assert len(lines["port"]) == len(recs)
    for a, b in zip(lines["port"], lines["jax"]):
        a.pop("time"), b.pop("time")
        assert a == b


def test_table_gauges_and_table_state_equal_jax():
    from test_torch_table_lifecycle import _port_from_jax

    jtr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=0.1), optax.adam(1e-3))
    jst = jtr.init(0)
    for b in _batches(3):
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
    tr = _trainer()
    st = _port_from_jax(tr, jst)
    assert tlog.table_gauges(tr, st) == jlog.table_gauges(jtr, jst)
    assert sorted(tr.tables) == sorted(jtr.tables)
    for name in tr.tables:
        ts, jts = tr.table_state(st, name), jtr.table_state(jst, name)
        np.testing.assert_array_equal(ts.keys.numpy()[0], np.asarray(jts.keys))
    with pytest.raises(KeyError):
        tr.table_state(st, "nope")
