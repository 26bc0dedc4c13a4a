"""The port's serving updates held against the JAX package on one
JAX-written chain (a full save and deltas of a small WDL): `poll_updates`
delta replay and full reloads, chunked and unchunked restores, corrupt and
quality-gated deltas quarantined alike, the poll-health fields, the
torn-read contract through `_pre_swap`, feature-store read-through and
`parse_features`. Probabilities agree within PROB_ATOL (the port's CPU
tolerance for dense layers: both sides round operands to bf16 and sum in
f32, in another order); the port's own invariants hold bit for bit."""
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.guard.canary import QualityGate as JaxGate
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.serving.predictor import BadRequest as JaxBadRequest
from deeprec_tpu.serving.predictor import parse_features as jax_parse
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.guard import QualityGate
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.serving import ModelServer, Predictor
from deeprec_tpu_torch.serving.predictor import BadRequest, parse_features

torch.set_num_threads(1)

KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4, num_dense=2)
PROB_ATOL = 1e-4


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def strip(b):
    return {k: np.asarray(v) for k, v in b.items() if not k.startswith("label")}


class Chain:
    """A JAX trainer writing a chain into `d`: a full save after 5 steps,
    then `delta()` / `full()` after 3 more steps each."""

    def __init__(self, d, seed=33):
        self.d = str(d)
        self.tr = JaxTrainer(JaxWDL(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
        self.st = self.tr.init(0)
        self.gen = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=800,
                                   seed=seed)
        self.ck = JaxCkpt(self.d, self.tr)
        self.steps(5)
        self.st, _ = self.ck.save(self.st)
        self.req = strip(self.gen.batch())

    def steps(self, n):
        for _ in range(n):
            self.st, _ = self.tr.train_step(self.st, J(self.gen.batch()))

    def delta(self, n=3):
        self.steps(n)
        self.st, path = self.ck.save_incremental(self.st)
        return path

    def full(self, n=3):
        self.steps(n)
        self.st, path = self.ck.save(self.st)
        return path


def pair(d, **kw):
    return (Predictor(WDL(**KW), d, device="cpu", **kw),
            JaxPredictor(JaxWDL(**KW), d, **kw))


def agree(p, j, req):
    np.testing.assert_allclose(p.predict(req), np.asarray(j.predict(req)), rtol=0,
                               atol=PROB_ATOL)


def per_key(p):
    """{(table, key): (row bits, freq, version)} of a port Predictor."""
    out = {}
    for name in p._trainer.tables:
        ts = p._trainer.table_state(p._state, name)
        keys = ts.keys[0].numpy()
        for i in np.nonzero(keys != np.iinfo(keys.dtype).min)[0]:
            out[(name, int(keys[i]))] = (ts.values[0, i].numpy().tobytes(),
                                         int(ts.meta[0, 0, i]), int(ts.meta[0, 1, i]))
    return out


# ------------------------------------------------------------------ polls


def test_poll_updates_on_a_jax_chain_matches_jax(tmp_path):
    """Two JAX-written deltas, polled by both predictors: the same changes,
    versions, steps and table sizes, answers within PROB_ATOL; nothing new
    is no change; the poll-health fields move as the JAX ones do."""
    c = Chain(tmp_path)
    p, j = pair(c.d)
    agree(p, j, c.req)
    assert p.poll_updates() is j.poll_updates() is False
    for v in (1, 2):
        c.delta()
        assert p.poll_updates() is j.poll_updates() is True
        assert p.version == j.version == v
        assert p.model_info() == j.model_info()
        agree(p, j, c.req)
    assert p.update_count == j.update_count == 2
    assert p.last_good_version == j.last_good_version == 2
    assert p.last_apply_lag_seconds is not None and p.last_apply_lag_seconds >= 0
    assert p.consecutive_poll_failures == 0
    h, jh = p.health(), j.health()
    assert list(h) == list(jh) and h["status"] == jh["status"] == "ok"
    assert (h["model_version"], h["step"]) == (jh["model_version"], jh["step"])


def test_newer_full_save_reloads_as_jax_does(tmp_path):
    """A delta then a newer full save: the full save is a full reload in
    both packages (one version bump for the round), answers within
    PROB_ATOL."""
    c = Chain(tmp_path)
    p, j = pair(c.d)
    c.delta()
    c.full()
    assert p.poll_updates() is j.poll_updates() is True
    assert p.version == j.version == 1 and p.step == j.step == c.st.step
    agree(p, j, c.req)
    assert p._applied == j._applied


def test_chunked_and_unchunked_restores_are_equal(tmp_path):
    """Full restores at chunks 64, 4096 and "auto" and the exact-shape
    restore give the same rows per key, bit for bit, and the same answers;
    the delta replay through restore_into at chunk 64 and 4096 too, with
    the live state untouched. "auto" sizes the chunk as the JAX Predictor
    does."""
    c = Chain(tmp_path)
    preds = [Predictor(WDL(**KW), c.d, device="cpu", restore_chunk=k)
             for k in (64, 4096, "auto")]
    assert preds[2]._restore_chunk == JaxPredictor(JaxWDL(**KW), c.d)._restore_chunk
    exact = preds[0]._ck.restore()
    want = per_key(preds[0])
    base = preds[0].predict(c.req)
    for p in preds[1:]:
        assert per_key(p) == want
        np.testing.assert_array_equal(p.predict(c.req), base)
    keys0 = {n: ts.keys.clone() for n, ts in exact.tables.items()}
    path = c.delta()
    live = preds[0]._state
    shadows = [preds[0]._ck.restore_into(live, path, chunk=k) for k in (64, 4096)]
    for ts_a, ts_b in zip(shadows[0].tables.values(), shadows[1].tables.values()):
        a = dict(zip(ts_a.keys.flatten().tolist(), ts_a.values.reshape(-1, 8).tolist()))
        b = dict(zip(ts_b.keys.flatten().tolist(), ts_b.values.reshape(-1, 8).tolist()))
        assert a == b
    assert shadows[0].step == c.st.step
    np.testing.assert_array_equal(preds[0].predict(c.req), base)  # live untouched
    assert all(torch.equal(keys0[n], ts.keys) for n, ts in exact.tables.items())


# ------------------------------------------------------- faults, alike


def _copies(c, tmp_path):
    """Two copies of the chain directory: each package quarantines in its
    own."""
    dp, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(c.d, dp)
    shutil.copytree(c.d, dj)
    return dp, dj


def _flip(path):
    f = sorted(os.path.join(path, n) for n in os.listdir(path) if n.startswith("table_"))[0]
    with open(f, "r+b") as fh:
        fh.seek(os.path.getsize(f) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_corrupt_delta_is_quarantined_alike(tmp_path):
    """A flipped byte in a delta: both packages quarantine it under the same
    name, keep serving the version they had and report the same
    quarantine count; the port's answers do not move."""
    c = Chain(tmp_path / "src")
    p0 = Predictor(WDL(**KW), c.d, device="cpu")
    path = c.delta()
    _flip(path)
    dp, dj = _copies(c, tmp_path)
    p, j = Predictor(WDL(**KW), dp, device="cpu"), JaxPredictor(JaxWDL(**KW), dj)
    np.testing.assert_array_equal(p.predict(c.req), p0.predict(c.req))
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
    assert any(n.endswith(".quarantined") for n in os.listdir(dp))
    assert p.poll_updates() is j.poll_updates() is False
    assert p.version == j.version == 0
    assert p.health()["quarantined"] == j.health()["quarantined"] == 1
    agree(p, j, c.req)


def test_quality_gated_delta_is_quarantined_alike(tmp_path):
    """A delta whose dense leaves are NaN, behind a QualityGate on a probe
    batch: both packages reject it (non-finite predictions), rename it
    alike, report degraded / quality_gate and keep serving the previous
    snapshot (the port's bit for bit); the next honest delta publishes."""
    c = Chain(tmp_path / "src")
    dp, dj = _copies(c, tmp_path)
    probe = c.req
    p = Predictor(WDL(**KW), dp, device="cpu", quality_gate=QualityGate(probe=probe))
    j = JaxPredictor(JaxWDL(**KW), dj, quality_gate=JaxGate(probe=probe))
    before = p.predict(c.req)
    good = jax.tree.map(lambda a: jnp.array(a, copy=True), c.st)  # steps donate
    c.st = c.st.replace(dense=jax.tree.map(lambda a: jnp.full_like(a, jnp.nan), c.st.dense))
    path = c.delta(n=1)
    for d in (dp, dj):
        shutil.copytree(path, os.path.join(d, os.path.basename(path)))
    assert p.poll_updates() is j.poll_updates() is False
    assert sorted(os.listdir(dp)) == sorted(os.listdir(dj))
    assert os.path.exists(os.path.join(dp, os.path.basename(path) + ".quarantined"))
    np.testing.assert_array_equal(p.predict(c.req), before)
    h, jh = p.health(), j.health()
    assert (h["status"], h["degraded_reason"]) == (jh["status"], jh["degraded_reason"]) == (
        "degraded", "quality_gate")
    assert h["quality_gate_rejections"] == jh["quality_gate_rejections"] == 1
    assert h["last_quality_rejection"] == jh["last_quality_rejection"]
    # an honest delta after it re-anchors and publishes in both
    c.st = good
    path = c.full(n=2)
    for d in (dp, dj):
        shutil.copytree(path, os.path.join(d, os.path.basename(path)))
    assert p.poll_updates() is j.poll_updates() is True
    assert p.health()["status"] == j.health()["status"] == "ok"
    agree(p, j, c.req)


def test_poll_failures_are_counted_and_recover_as_in_jax(tmp_path, monkeypatch):
    """A poll that raises (the directory listing fails) counts into
    consecutive_poll_failures and degrades health in both packages; the
    next good poll resets it."""
    c = Chain(tmp_path)
    p, j = pair(c.d)
    for pred in (p, j):
        real = pred._dirs
        monkeypatch.setattr(pred, "_dirs", lambda: (_ for _ in ()).throw(OSError("gone")))
        with pytest.raises(OSError):
            pred.poll_updates()
        with pytest.raises(OSError):
            pred.poll_updates()
        monkeypatch.setattr(pred, "_dirs", real)
    assert p.consecutive_poll_failures == j.consecutive_poll_failures == 2
    assert p.health()["status"] == j.health()["status"] == "degraded"
    c.delta()
    assert p.poll_updates() is j.poll_updates() is True
    assert p.consecutive_poll_failures == j.consecutive_poll_failures == 0
    assert p.health()["status"] == j.health()["status"] == "ok"


def test_replay_failure_quarantines_and_serves_what_replayed(tmp_path, monkeypatch):
    """A verified delta whose replay raises is quarantined and the chain
    stops there: what replayed before it still publishes."""
    c = Chain(tmp_path)
    p = Predictor(WDL(**KW), c.d, device="cpu")
    c.delta()
    bad = os.path.basename(c.delta())
    real = p._ck.restore_into

    def restore_into(state, path, **kw):
        if os.path.basename(path) == bad:
            raise RuntimeError("rows exceed capacity")
        return real(state, path, **kw)

    monkeypatch.setattr(p._ck, "restore_into", restore_into)
    assert p.poll_updates() is True
    assert p.version == 1 and bad not in p._applied
    assert os.path.exists(os.path.join(c.d, bad + ".quarantined"))


# -------------------------------------------------------------- torn reads


def test_torn_read_predict_never_mixes_versions(tmp_path):
    """The swap held at `_pre_swap`: predicts while the next state is built
    but unpublished serve the old version in both fields, bit for bit;
    after the swap the new one, as the JAX eval of the new state."""
    c = Chain(tmp_path)
    p = Predictor(WDL(**KW), c.d, device="cpu")
    old, v0 = p.predict_versioned(c.req)
    c.delta()
    _, expect = c.tr.eval_step(c.st, J({**c.req, "label": np.zeros(128, np.float32)}))
    built, release = threading.Event(), threading.Event()

    def gate():
        built.set()
        assert release.wait(timeout=60)

    p._pre_swap = gate
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("changed", p.poll_updates()))
    th.start()
    assert built.wait(timeout=60)
    mid, vm = p.predict_versioned(c.req)
    assert vm == v0 and p.model_info()["model_version"] == v0
    np.testing.assert_array_equal(mid, old)
    release.set()
    th.join(timeout=60)
    assert out["changed"] is True
    new, v1 = p.predict_versioned(c.req)
    assert v1 == v0 + 1
    np.testing.assert_allclose(new, np.asarray(expect), rtol=0, atol=PROB_ATOL)
    assert np.abs(new - old).max() > 1e-6


def test_background_poll_loop_applies_updates(tmp_path):
    """ModelServer(poll_updates_secs=) polls on its own thread: a delta is
    served without a call."""
    import time

    c = Chain(tmp_path)
    ms = ModelServer(Predictor(WDL(**KW), c.d, device="cpu"), max_batch=64,
                     poll_updates_secs=0.05)
    try:
        c.delta()
        t0 = time.monotonic()
        while ms.predictor.version < 1 and time.monotonic() - t0 < 60:
            time.sleep(0.02)
        assert ms.predictor.version == 1
        assert ms.request_versioned(c.req)[1] == 1
    finally:
        ms.close()


# ------------------------------------------------------------------ stores


def test_feature_store_read_through_matches_jax(tmp_path):
    """Keys missing from the device table read the store's row: the port
    over its native HostKV, the JAX package over its HostKV, the same rows;
    answers within PROB_ATOL, moved from the store-less answers, and known
    keys unchanged."""
    from deeprec_tpu.native import HostKV as JaxKV
    from deeprec_tpu_torch.native import HostKV

    c = Chain(tmp_path)
    novel = 999_999
    tname = sorted(c.tr.tables)[0]
    kvs = []
    for cls in (HostKV, JaxKV):
        kv = cls(dim=8, initial_capacity=64)
        kv.put(np.asarray([novel], np.int64), np.full((1, 8), 2.5, np.float32),
               np.asarray([1], np.int32), np.asarray([1], np.int32))
        kvs.append(kv)
    p = Predictor(WDL(**KW), c.d, device="cpu", stores={tname: kvs[0]})
    j = JaxPredictor(JaxWDL(**KW), c.d, stores={tname: kvs[1]})
    plain = Predictor(WDL(**KW), c.d, device="cpu")
    req = dict(c.req)
    req[tname] = np.full_like(req[tname], novel)
    got = p.predict(req)
    np.testing.assert_allclose(got, np.asarray(j.predict(req)), rtol=0, atol=PROB_ATOL)
    assert np.abs(got - plain.predict(req)).max() > 1e-6
    np.testing.assert_array_equal(p.predict(c.req), plain.predict(c.req))


# ------------------------------------------------------- parse_features


def test_parse_features_matches_jax(tmp_path):
    """The wire firewall on the same payloads: equal arrays (ragged bags,
    negative ids clamped to the pad, dense widened), the same record-error
    counts, and the same BadRequest details."""
    c = Chain(tmp_path)
    p, j = pair(c.d)
    feats = {k: v.tolist() for k, v in c.req.items()}
    feats["C1"][0] = -7  # a bad id: clamped to the pad
    a, b = parse_features(p, feats), jax_parse(j, feats)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])
    assert p.record_errors == j.record_errors == {"bad_id": 1}
    assert p.feature_dtypes == j.feature_dtypes
    bads = [None, {}, {"C1": [1]}, dict(feats, I1=[float("nan")] * 128),
            dict(feats, C2=[[1, 2]] * 3), dict(feats, C3=["x"] * 128)]
    for bad in bads:
        with pytest.raises(BadRequest) as e1:
            parse_features(p, bad)
        with pytest.raises(JaxBadRequest) as e2:
            jax_parse(j, bad)
        if "cannot coerce" in str(e2.value):
            assert e1.value.details["feature"] == e2.value.details["feature"]
        else:
            assert e1.value.details == e2.value.details
    assert p.record_errors == j.record_errors
