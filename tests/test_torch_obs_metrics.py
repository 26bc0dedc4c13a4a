"""The port's metrics registry (its copy of deeprec_tpu/obs/metrics.py)
held against the JAX package's on the CPU: each scenario of
tests/test_obs.py's registry tests runs on an injected clock through both
modules and must give the same numbers, renders and snapshots — labeled
counters, gauges and histograms, windowed rate / slope / p99, the
Prometheus render and parse round trip with callbacks, extra labels and
stale marking, family-header dedup, mergeable snapshots (the two packages'
snapshots merge with each other), the `DEEPREC_OBS=off` null plane, and the
histogram summary of the port's own `LatencyHistogram`."""
import os
import subprocess
import sys

import pytest

from deeprec_tpu.obs import metrics as JM
from deeprec_tpu_torch.obs import metrics as TM

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _both(scenario):
    """scenario(module, registry, clock) run on each package's module with a
    registry on its own injected clock; returns (port result, JAX result)."""
    out = []
    for mod in (TM, JM):
        clk = [1000.0]
        out.append(scenario(mod, mod.MetricsRegistry(clock=lambda: clk[0]), clk))
    return out


def _counter(mod, reg, clk):
    c = reg.counter("deeprec_x_steps", "steps")
    for _ in range(20):
        c.inc()
        clk[0] += 1.0
    assert reg.counter("deeprec_x_steps", "steps") is c
    assert reg.counter("deeprec_x_steps", labels={"a": "b"}) is not c
    return c.value, reg.window("deeprec_x_steps", seconds=10.0)


def _gauge(mod, reg, clk):
    g = reg.gauge("deeprec_x_imb", "imbalance", {"table": "t0"})
    for i in range(8):
        g.set(2.0 + 0.5 * i)
        clk[0] += 2.0
    return reg.window("deeprec_x_imb", {"table": "t0"}, seconds=30.0)


def _histogram(mod, reg, clk):
    h = reg.histogram("deeprec_x_lat", "lat", {"stage": "e2e"})
    for _ in range(100):
        h.record(0.5)
    clk[0] += 300.0
    for _ in range(100):
        h.record(0.001)
    return h.window_summary(60.0), h.summary(), h.percentile(0.99)


def _prometheus(mod, reg, clk):
    reg.counter("deeprec_x_req", "requests", {"stage": "e2e"}).inc(7)
    reg.gauge("deeprec_x_g", "a gauge").set(1.5)
    reg.histogram("deeprec_x_h", "hist").record(0.01)
    depth = [3]
    reg.register_callback("deeprec_x_depth", lambda: depth[0], "queue", {"srv": "a"})
    text = reg.render_prometheus()
    first = mod.parse_prometheus(text)
    depth[0] = 9
    reg.reset()
    return text, first, mod.parse_prometheus(reg.render_prometheus())


def _render(mod, reg, clk):
    reg.counter("deeprec_x_req", "r").inc()
    a = mod.render_snapshot(reg.snapshot(), extra_labels={"member": "h:1"})
    b = mod.render_snapshot(reg.snapshot(), extra_labels={"member": "h:2"}, stale=True)
    text = mod.concat_prometheus([a, b])
    return b, text, mod.parse_prometheus(text)


def _merge(mod, reg, clk):
    reg.counter("deeprec_x_req", "r").inc(3)
    reg.histogram("deeprec_x_h", "h").record(0.01)
    s = reg.snapshot()
    return s, mod.merge_snapshots([s, s, s])


@pytest.mark.parametrize("scenario", [_counter, _gauge, _histogram, _prometheus, _render, _merge],
                         ids=lambda f: f.__name__.strip("_"))
def test_scenario_matches_jax(scenario):
    got, want = _both(scenario)
    assert got == want


def test_scenario_values():
    (value, win), _ = _both(_counter)
    assert value == 20 and win["delta"] == pytest.approx(10.0, abs=2.0)
    assert win["rate_per_sec"] == pytest.approx(1.0, abs=0.2)
    g, _ = _both(_gauge)
    assert g["last"] == 5.5 and g["slope_per_sec"] == pytest.approx(0.25, rel=0.05)
    (win, life, _), _ = _both(_histogram)
    assert win["count"] == 100 and win["p99_ms"] < 10.0 and life["p99_ms"] > 100.0
    (_, first, after), _ = _both(_prometheus)
    assert first[("deeprec_x_req_total", '{stage="e2e"}')] == 7.0
    assert first[("deeprec_x_g", "")] == 1.5 and first[("deeprec_x_h_count", "")] == 1.0
    assert after[("deeprec_x_depth", '{srv="a"}')] == 9.0
    assert ("deeprec_x_req_total", '{stage="e2e"}') not in after
    (stale, text, parsed), _ = _both(_render)
    assert TM.parse_prometheus(stale)[("deeprec_x_req_total", '{member="h:2",stale="1"}')] == 1.0
    assert text.splitlines().count("# TYPE deeprec_x_req counter") == 1
    (_, merged), _ = _both(_merge)
    assert merged["metrics"]["deeprec_x_req"]["series"][0]["value"] == 9.0
    assert merged["metrics"]["deeprec_x_h"]["series"][0]["n"] == 3


def test_snapshots_merge_across_packages():
    """A port snapshot and a JAX snapshot merge and render alike in either
    package (the snapshot is plain JSON)."""
    (snap, _), (jsnap, _) = _both(_merge)
    for mod in (TM, JM):
        merged = mod.merge_snapshots([snap, jsnap])
        assert merged["metrics"]["deeprec_x_req"]["series"][0]["value"] == 6.0
    assert TM.render_snapshot(snap) == JM.render_snapshot(snap)


def test_histogram_summary_matches_the_port_latency_histogram():
    from deeprec_tpu_torch.training.profiler import LatencyHistogram

    h = TM.MetricsRegistry().histogram("deeprec_x_h", "")
    ref = LatencyHistogram()
    for v in (0.0001, 0.002, 0.03, 0.4, 5.0, 0.002, 0.002):
        h.record(v)
        ref.record(v)
    assert h.summary() == ref.summary()


def test_disabled_plane_hands_out_noops():
    TM.set_metrics_enabled(False)
    try:
        assert not TM.metrics_enabled()
        reg = TM.MetricsRegistry()
        c, g, h = reg.counter("deeprec_x", ""), reg.gauge("deeprec_y", ""), reg.histogram("deeprec_z", "")
        assert c is g is h
        c.inc()
        g.set(3)
        h.record(0.5)
        assert h.summary()["count"] == 0 and reg.snapshot() == {"metrics": {}}
    finally:
        TM.set_metrics_enabled(None)
    assert TM.metrics_enabled()


def test_deeprec_obs_off_silences_the_input_counters():
    """With DEEPREC_OBS=off the readers' and the pipeline's counters are
    no-ops in a fresh process; the registry is the port's own module."""
    code = ("import deeprec_tpu_torch.obs as o; from deeprec_tpu_torch.data.readers import "
            "RecordErrors; from deeprec_tpu_torch.data.pipeline import record_stall; "
            "RecordErrors().count('bad_id', 3); record_stall('staged', 1.0); "
            "print(o.metrics_enabled(), o.default_registry().snapshot())")
    outs = []
    for flag in ("off", "on"):
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                              text=True, timeout=120,
                              env=dict(os.environ, DEEPREC_OBS=flag, PYTHONPATH=REPO))
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.strip())
    assert outs[0] == "False {'metrics': {}}"
    assert outs[1].startswith("True") and "deeprec_record_errors" in outs[1]
    assert "deeprec_input_stall_seconds" in outs[1]
