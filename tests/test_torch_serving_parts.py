"""The serving slice's small modules in the PyTorch port held against their
JAX twins on the same numpy inputs: `utils/ragged`, `obs/schema`,
`obs/trace`, `guard/canary` (QualityGate, np_auc), `serving/reuse`
(ReuseCache, request_fingerprint), `serving/stats` (ServingStats),
`ops/traffic.serving_residency_bytes`, `nn.apply_grouped` and
`nn.fixed_rows`. Every comparison is exact unless a tolerance is named."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import nn as jnn
from deeprec_tpu.guard import canary as jcanary
from deeprec_tpu.obs import schema as jschema
from deeprec_tpu.obs import trace as jtrace
from deeprec_tpu.ops import traffic as jtraffic
from deeprec_tpu.serving import reuse as jreuse
from deeprec_tpu.serving.stats import ServingStats as JaxStats
from deeprec_tpu.utils import ragged as jragged
from deeprec_tpu_torch import nn as tnn
from deeprec_tpu_torch.guard import canary as tcanary
from deeprec_tpu_torch.obs import metrics as tmetrics
from deeprec_tpu_torch.obs import schema as tschema
from deeprec_tpu_torch.obs import trace as ttrace
from deeprec_tpu_torch.ops import traffic as ttraffic
from deeprec_tpu_torch.serving import reuse as treuse
from deeprec_tpu_torch.serving.stats import ServingStats as TorchStats
from deeprec_tpu_torch.utils import ragged as tragged

torch.set_num_threads(1)


# ------------------------------------------------------------------ ragged


@pytest.mark.parametrize("rows, L, pad, dtype", [
    ([[1, 2, 3], [4], [], [5, 6, 7, 8, 9]], 4, -1, np.int32),
    ([[7], [8], [9, 10, 11]], 1, 0, np.int64),
    ([[], []], 2, -1, np.int32),
    ([[0.5, 1.5], [2.5]], 3, 0.0, np.float32),
])
def test_pad_ragged_matches_jax(rows, L, pad, dtype):
    want = jragged.pad_ragged(rows, L, pad, dtype)
    got = tragged.pad_ragged(rows, L, pad, dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arr, L", [(np.arange(5), 3), (np.arange(12).reshape(4, 3), 5),
                                    (np.arange(12).reshape(3, 4), 2)])
def test_pad_rect_matches_jax(arr, L):
    np.testing.assert_array_equal(tragged.pad_rect(arr, L, -1, np.int32),
                                  jragged.pad_rect(arr, L, -1, np.int32))


# ------------------------------------------------------------------ schema


@pytest.mark.parametrize("status, kw", [
    ("ok", {}),
    ("degraded", dict(model_version=3, step=40, staleness_seconds=1.5,
                      consecutive_poll_failures=2, quarantined=1,
                      degraded_reason="quality_gate", replicas=2)),
])
def test_health_payload_matches_jax(status, kw):
    got = tschema.health_payload(status, **kw)
    want = jschema.health_payload(status, **kw)
    assert got == want and list(got) == list(want)
    assert tschema.CANONICAL_HEALTH_KEYS == jschema.CANONICAL_HEALTH_KEYS


# ------------------------------------------------------------------- trace


def test_trace_wire_and_header_match_jax():
    ctx = (0x0123456789ABCDEF, 0xFEDCBA9876543210)
    assert ttrace.to_header(ctx) == jtrace.to_header(ctx)
    assert ttrace.pack_wire(ctx) == jtrace.pack_wire(ctx)
    for raw in (ttrace.to_header(ctx), "garbage", None, "12-"):
        assert ttrace.from_header(raw) == jtrace.from_header(raw)
    assert ttrace.unpack_wire(ttrace.pack_wire(ctx)) == ctx
    assert ttrace.HEADER == jtrace.HEADER and ttrace.WIRE_BYTES == jtrace.WIRE_BYTES


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_trace_spans_and_phase_spans_match_jax(tmp_path):
    """The same spans written by each package's tracer give events of the
    same names, categories, phases and keys; off, span() is the no-op
    singleton in both."""
    out = {}
    for name, mod in (("jax", jtrace), ("torch", ttrace)):
        assert mod.span("x") is mod.NOOP_SPAN  # off by default
        path = str(tmp_path / f"{name}.jsonl")
        mod.configure(path, sample=1.0, service="svc")
        try:
            with mod.server_span("http_predict", "edge"):
                with mod.span("dispatch", "serving") as sp:
                    mod.emit("stage_device", "serving", 1.0, 1.25, ctx=mod.child(sp.ctx),
                             parent=sp.ctx[1])
            mod.phase_span("phase_lookup", 2.0, 2.5)
        finally:
            mod.shutdown()
        out[name] = _events(path)
    assert [e["name"] for e in out["torch"]] == [e["name"] for e in out["jax"]] == [
        "stage_device", "dispatch", "http_predict", "phase_lookup"]
    for a, b in zip(out["torch"], out["jax"]):
        assert set(a) == set(b) and set(a.get("args", {})) == set(b.get("args", {}))
        assert (a["cat"], a["ph"]) == (b["cat"], b["ph"])
    for i in (0, 3):
        assert out["torch"][i]["dur"] == out["jax"][i]["dur"]


def test_profiler_phase_and_ckpt_writer_land_as_spans(tmp_path):
    """PhaseProfiler.phase and the async checkpoint writer emit the JAX
    package's timeline spans (`phase_<name>`, `ckpt_write_<kind>`)."""
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.profiler import PhaseProfiler
    from deeprec_tpu_torch.training.trainer import Trainer

    path = str(tmp_path / "t.jsonl")
    ttrace.configure(path)
    try:
        with PhaseProfiler().phase("lookup"):
            pass
        tr = Trainer(WDL(emb_dim=4, capacity=1 << 8, hidden=(8,), num_cat=2, num_dense=1),
                     Adagrad(lr=0.1), device="cpu")
        ck = CheckpointManager(str(tmp_path / "ck"), tr)
        ck.save_async(tr.init())
        ck.wait()
    finally:
        ttrace.shutdown()
    names = [e["name"] for e in _events(path)]
    assert "phase_lookup" in names and "ckpt_write_full" in names


# ------------------------------------------------------------------ canary


@pytest.mark.parametrize("ties", [False, True])
def test_np_auc_matches_jax(ties):
    rng = np.random.default_rng(3)
    p = rng.random(500).astype(np.float32)
    if ties:
        p = np.round(p, 1)
    y = (rng.random(500) < p).astype(np.float32)
    assert tcanary.np_auc(p, y) == jcanary.np_auc(p, y)


def test_quality_gate_decisions_match_jax():
    """One sequence of candidate predictions through both gates: the same
    passes, the same rejection reasons and details, the same counters."""
    rng = np.random.default_rng(5)
    probe = {"x": np.zeros((64, 1), np.float32)}
    labels = (rng.random(64) < 0.5).astype(np.float32)
    base = rng.random(64).astype(np.float32)
    cands = [base + 0.01, base + 0.6, np.where(np.arange(64) == 3, np.nan, base),
             {"a": base, "b": base}, base]
    gates = [m.QualityGate(probe=probe, labels=labels, auc_floor=0.3, max_shift=0.25)
             for m in (jcanary, tcanary)]
    errs = (jcanary.QualityGateRejected, tcanary.QualityGateRejected)
    for g in gates:
        g.set_reference(base)
    for c in cands:
        outs = []
        for g, err in zip(gates, errs):
            try:
                g.check(c)
                g.set_reference(c)
                outs.append(None)
            except err as e:
                outs.append(e.reason)
        assert outs[0] == outs[1], c
    assert gates[0].rejections == gates[1].rejections >= 2
    assert gates[0].last_rejection == gates[1].last_rejection


# ------------------------------------------------------------------- reuse


def _features(rng, n=4):
    return {"C1": rng.integers(0, 100, (n, 3)).astype(np.int32),
            "I1": rng.random((n, 1)).astype(np.float32)}


def test_request_fingerprint_matches_jax():
    rng = np.random.default_rng(7)
    f = _features(rng)
    for kw in ({}, {"extra": b"g"}, {"names": ["C1"]}):
        assert treuse.request_fingerprint(f, **kw) == jreuse.request_fingerprint(f, **kw)
    assert treuse.value_nbytes(f["C1"]) == jreuse.value_nbytes(f["C1"])
    g = dict(reversed(list(f.items())))
    assert treuse.request_fingerprint(g) == treuse.request_fingerprint(f)


def test_reuse_cache_lru_and_version_invalidation_match_jax():
    """The same puts, gets and version bumps through both caches: the same
    hits, misses, evictions, invalidations and resident entries."""
    version = [0]
    caches = [m.ReuseCache(200, "predict", version_fn=lambda: version[0])
              for m in (jreuse, treuse)]
    rng = np.random.default_rng(9)
    vals = [rng.random(8).astype(np.float32) for _ in range(12)]  # 32 B each
    for step in range(40):
        op = step % 5
        k = bytes([step % 12])
        for c in caches:
            if op in (0, 1):
                c.put(k, version[0], vals[step % 12])
            else:
                c.get_current(k)
        if step in (17, 31):
            version[0] += 1
            assert caches[0].invalidate_stale() == caches[1].invalidate_stale()
    assert caches[1].put(b"big", version[0], np.zeros(100, np.float32)) is False
    a, b = (c.snapshot() for c in caches)
    assert a == b and a["evictions"] > 0 and a["invalidations"] > 0


# ------------------------------------------------------------------- stats


@pytest.mark.parametrize("obs_on", [True, False])
def test_serving_stats_snapshot_matches_jax(obs_on, monkeypatch):
    """The same stage timings, batches and errors through both ServingStats
    give the same snapshot (but the uptime), with the metrics on and off;
    on, the port's registry renders the JAX series names."""
    from deeprec_tpu.obs import metrics as jmetrics

    monkeypatch.setenv("DEEPREC_OBS", "on" if obs_on else "off")
    jmetrics.set_metrics_enabled(None)
    tmetrics.set_metrics_enabled(None)
    try:
        stats = [JaxStats(), TorchStats()]
        rng = np.random.default_rng(11)
        for i in range(50):
            for s in stats:
                s.record_stage("queue", 1e-4 * (i % 7 + 1))
                s.record_stage("device", 3e-3 + 1e-4 * (i % 3))
                s.record_stage("e2e", 5e-3 * (i % 5 + 1))
            n = int(rng.integers(1, 300))
            for s in stats:
                s.record_batch(3, n)
        for s in stats:
            s.record_error(2)
        a, b = (s.snapshot() for s in stats)
        a.pop("uptime_s"), b.pop("uptime_s")
        assert a == b
        assert (stats[1].registry is None) == (not obs_on)
        if obs_on:
            text = tmetrics.render_snapshot(stats[1].metrics_snapshot())
            assert "deeprec_serving_stage_seconds" in text
            assert stats[1].window_p99_ms("e2e") == stats[0].window_p99_ms("e2e")
    finally:
        jmetrics.set_metrics_enabled(None)
        tmetrics.set_metrics_enabled(None)


# ----------------------------------------------------------------- traffic


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_serving_residency_bytes_matches_jax(dtype):
    for cap, dim in ((1 << 20, 128), (1 << 12, 8), (100, 3)):
        assert (ttraffic.serving_residency_bytes(capacity=cap, dim=dim, value_dtype=dtype)
                == jtraffic.serving_residency_bytes(capacity=cap, dim=dim,
                                                    value_dtype=dtype))
    with pytest.raises(ValueError):
        ttraffic.serving_residency_bytes(capacity=1, dim=1, value_dtype="int4")


# ---------------------------------------------------------------------- nn


@pytest.mark.parametrize("num_groups", [3, 4, 8])
def test_apply_grouped_matches_jax(num_groups):
    """apply_grouped over a row-independent function: the port's rows equal
    the JAX function's, and the plain per-row result (within f32 product
    order, 1e-6); groups past num_groups come back NaN in both."""
    rng = np.random.default_rng(13)
    gids = np.array([5, 2, 5, 9, 2, 2, 7, 9], np.int32)
    # rows of one group carry one feature row (one user's features)
    x = rng.standard_normal((10, 6)).astype(np.float32)[gids]
    w = rng.standard_normal((6, 4)).astype(np.float32)
    want = np.asarray(jnn.apply_grouped(lambda t: {"y": t["x"] @ w}, {"x": jnp.asarray(x)},
                                        jnp.asarray(gids), num_groups)["y"])
    got = tnn.apply_grouped(lambda t: {"y": t["x"] @ torch.tensor(w)},
                            {"x": torch.tensor(x)}, torch.tensor(gids), num_groups)["y"].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-6)
    if num_groups >= 4:
        np.testing.assert_allclose(got, x @ w, rtol=0, atol=1e-6)


def test_fixed_rows_gives_one_shape_per_call():
    """fixed_rows calls fn at exactly `rows` rows (dataclass and tuple
    leaves padded alike) and returns the unpadded rows; dict outputs too."""
    from deeprec_tpu_torch.training.trainer import ModelInputs

    seen = []
    x = ModelInputs(pooled={"a": torch.randn(11, 3)}, dense={"d": torch.randn(11, 2)},
                    seq={"s": (torch.randn(11, 4, 3), torch.ones(11, 4, dtype=torch.bool))})

    def fn(ins):
        seen.append(ins.pooled["a"].shape[0])
        return {"p": ins.pooled["a"].sum(-1) * ins.dense["d"][:, 0],
                "q": ins.seq["s"][0].sum((1, 2))}

    got = tnn.fixed_rows(fn, x, 4)
    want = fn(x)
    assert seen[:-1] == [4, 4, 4]
    for k in want:
        assert torch.equal(got[k], want[k])


def test_method_call_runs_a_method_over_a_state():
    """nn.method_call runs a module method with the parameters of a dense
    dict, leaving the module's own parameters untouched."""
    from deeprec_tpu_torch.models import DSSM

    m = DSSM(emb_dim=4, capacity=1 << 8, num_user_feats=2, num_item_feats=2, hidden=(8, 4))
    dense = {n: torch.randn_like(p) for n, p in m.named_parameters()}
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    from deeprec_tpu_torch.training.trainer import ModelInputs

    ins = ModelInputs(pooled={n: torch.randn(3, 4) for n in m.user_feats + m.item_feats},
                      dense={})
    got = tnn.method_call(m, dense, "user_vector", ins)
    m.load_state_dict(dense)
    assert torch.equal(got, m.user_vector(ins))
    m.load_state_dict(before)
    assert all(torch.equal(p, before[n]) for n, p in m.named_parameters())
