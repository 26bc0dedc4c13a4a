"""The port's socket tier (deeprec_tpu_torch/serving/frontend.py) held
against the JAX package, case for case with tests/test_frontend.py and
tests/test_retrieval_fleet.py, on JAX-trained checkpoints served by the
port's backends on the CPU: wire parity with a local Predictor and with the
JAX Predictor (PROB_ATOL), the wire protocol across packages (a JAX
frontend drives a port backend and the other way round), the edge's
feature dtypes equal to the JAX frontend's without any table, user-group
routing, merged stats, worst-member health, the fault matrix (a killed
backend costs a retry on a sibling, never a failed request), and the
retrieval fan-out: RETR/RITM, the edge merge against a single engine and
against the JAX merge, partial answers, draining members, empty shards."""
import json
import os
import signal
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo, SyntheticTwoTower
from deeprec_tpu.models import DSSM as JaxDSSM
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import BackendServer as JaxBackend
from deeprec_tpu.serving import Frontend as JaxFrontend
from deeprec_tpu.serving import ModelServer as JaxServer
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.serving.retrieval import merge_shard_topk as jax_merge
from deeprec_tpu.training import Trainer
from deeprec_tpu.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.models import DSSM, WDL
from deeprec_tpu_torch.serving import (
    BackendServer,
    Frontend,
    HttpServer,
    ModelServer,
    Predictor,
    RetrievalEngine,
    spawn_backends,
)
from deeprec_tpu_torch.serving.predictor import BadRequest, parse_features
from deeprec_tpu_torch.serving.retrieval import fill_missing_item_features

torch.set_num_threads(1)

WDL_KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32, 16), num_cat=4, num_dense=2)
DSSM_KW = dict(emb_dim=8, capacity=1 << 12, num_user_feats=2, num_item_feats=2,
               hidden=(16, 8))
VOCAB = 200
# the port's answers against the JAX Predictor's on one checkpoint
PROB_ATOL = 1e-4


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def strip_labels(b):
    return {k: np.asarray(v) for k, v in b.items() if not k.startswith("label")}


def make_trained(tmp_path, steps=3):
    tr = Trainer(JaxWDL(**WDL_KW), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=4, num_dense=2, vocab=2000, seed=13)
    for _ in range(steps):
        st, _ = tr.train_step(st, J(gen.batch()))
    ck = CheckpointManager(str(tmp_path), tr)
    st, _ = ck.save(st)
    return WDL(**WDL_KW), tr, st, ck, gen


def _pred(model, ckpt):
    return Predictor(model, ckpt, device="cpu")


@pytest.fixture(scope="module")
def wdl_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fe-wdl")
    model, tr, st, ck, gen = make_trained(tmp)
    req = strip_labels(gen.batch())
    expect = np.asarray(_pred(model, str(tmp)).predict(req))
    return model, str(tmp), req, expect


def make_tier(model, ckpt, n=2, **fe_kwargs):
    backends = [BackendServer(ModelServer(_pred(model, ckpt), max_batch=64,
                                          max_wait_ms=1.0)).start()
                for _ in range(n)]
    fe = Frontend([("127.0.0.1", b.port) for b in backends], model, **fe_kwargs)
    return backends, fe


def test_frontend_parity_and_merged_surfaces(wdl_ckpt):
    """Requests through the socket tier equal a local predictor's (and the
    JAX Predictor's within PROB_ATOL); the merged /v1/stats spans every
    member; /healthz is worst-member; a grouped request against a
    tower-less model is a structured BadRequest through the wire; the
    edge's feature dtypes equal the JAX frontend's; a JAX frontend drives
    a port backend and a port frontend a JAX backend."""
    model, ckpt, req, expect = wdl_ckpt
    np.testing.assert_allclose(
        expect, np.asarray(JaxPredictor(JaxWDL(**WDL_KW), ckpt).predict(req)),
        atol=PROB_ATOL, rtol=0)
    backends, fe = make_tier(model, ckpt, n=2)
    try:
        assert fe.warmup(req) == 2
        out, ver = fe.request_versioned(req)
        np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-5)
        assert ver == 0
        with pytest.raises(BadRequest, match="tower"):
            fe.request(req, group_users=True)
        for _ in range(6):  # round-robin spreads plain requests
            fe.request(req)
        mstats = [m.snapshot() for m in fe._members]
        assert all(s["requests"] > 0 for s in mstats), mstats

        jfe = JaxFrontend([("127.0.0.1", backends[0].port)], JaxWDL(**WDL_KW))
        try:
            assert fe.predictor.feature_dtypes == jfe.predictor.feature_dtypes
            got, _ = jfe.request_versioned(req)
            np.testing.assert_allclose(np.asarray(got), expect, rtol=1e-5, atol=1e-5)
        finally:
            jfe.close()
        jb = JaxBackend(JaxServer(JaxPredictor(JaxWDL(**WDL_KW), ckpt), max_batch=64,
                                  max_wait_ms=1.0)).start()
        fe2 = Frontend([("127.0.0.1", jb.port)], model)
        try:
            np.testing.assert_allclose(np.asarray(fe2.request(req)), expect,
                                       atol=PROB_ATOL, rtol=0)
        finally:
            fe2.close()
            jb.stop()

        http = HttpServer(fe, port=0).start()
        try:
            body = json.dumps({"features": {k: v.tolist() for k, v in req.items()}}).encode()
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{http.port}/v1/predict", data=body,
                headers={"Content-Type": "application/json"}, method="POST"), timeout=30)
            got = json.loads(r.read())
            np.testing.assert_allclose(np.asarray(got["predictions"]), expect,
                                       rtol=1e-4, atol=1e-4)
            stats = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/v1/stats", timeout=10).read())
            assert len(stats["members"]) == 2
            assert stats["backend_totals"]["requests"] >= 8
            assert all("stats" in m for m in stats["members"])
            h = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/healthz", timeout=10).read())
            assert h["status"] == "ok"
            assert h["members"] == 2 and h["reachable"] == 2
            info = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/v1/model_info", timeout=10).read())
            assert info["members"] == 2 and info["step"] == 3
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{http.port}/metrics", timeout=10).read().decode()
            assert "deeprec_member_up" in text
        finally:
            http.stop()
    finally:
        fe.close()
        for b in backends:
            b.stop()


def test_frontend_fault_matrix_kill_retry_recover(wdl_ckpt):
    """Backend death mid-traffic: requests retry on the sibling (zero
    failed requests), /healthz degrades to the worst member, and a
    restarted backend is marked back up by the next health round."""
    model, ckpt, req, expect = wdl_ckpt
    backends, fe = make_tier(model, ckpt, n=2)
    try:
        fe.warmup(req)
        errors, done = [], threading.Event()

        def driver():
            try:
                while not done.is_set():
                    np.testing.assert_allclose(np.asarray(fe.request(req)), expect,
                                               rtol=1e-5, atol=1e-5)
            except Exception as e:  # pragma: no cover - the assertion
                errors.append(e)

        th = threading.Thread(target=driver)
        th.start()
        time.sleep(0.2)
        backends[0].stop()  # severs live and pooled connections, as SIGKILL
        time.sleep(0.3)
        done.set()
        th.join(timeout=30)
        assert not errors, errors
        h = fe.predictor.health()
        assert h["status"] == "degraded" and h["reachable"] == 1
        b0 = BackendServer(ModelServer(_pred(model, ckpt), max_batch=64, max_wait_ms=1.0),
                           port=backends[0].port).start()
        try:
            h2 = fe.predictor.health()
            assert h2["status"] == "ok" and h2["reachable"] == 2
            np.testing.assert_allclose(np.asarray(fe.request(req)), expect,
                                       rtol=1e-5, atol=1e-5)
        finally:
            b0.stop()
    finally:
        fe.close()
        for b in backends:
            b.stop()


def test_frontend_all_backends_down_raises(wdl_ckpt):
    model, ckpt, req, expect = wdl_ckpt
    backends, fe = make_tier(model, ckpt, n=2)
    try:
        fe.warmup(req)
        for b in backends:
            b.stop()
        with pytest.raises(RuntimeError, match="unreachable"):
            fe.request(req)
        assert fe.stats.snapshot()["errors"] >= 1
        h = fe.predictor.health()
        assert h["status"] == "down" and h["reachable"] == 0
    finally:
        fe.close()


@pytest.mark.slow
def test_frontend_delta_updates_per_backend(tmp_path):
    """Each backend replays the delta chain itself; a frontend-driven poll
    round rolls the update across the tier and the version advances."""
    model, tr, st, ck, gen = make_trained(tmp_path)
    req = strip_labels(gen.batch())
    backends, fe = make_tier(model, str(tmp_path), n=2, poll_backends=True)
    try:
        fe.warmup(req)
        for _ in range(2):
            st, _ = tr.train_step(st, J(gen.batch()))
        st, _ = ck.save_incremental(st)
        assert fe.predictor.poll_updates()
        for _ in range(4):
            _, ver = fe.request_versioned(req)
            assert ver == 1
        expect = np.asarray(_pred(model, str(tmp_path)).predict(req))
        np.testing.assert_allclose(np.asarray(fe.request(req)), expect, rtol=1e-5, atol=1e-5)
    finally:
        fe.close()
        for b in backends:
            b.stop()


@pytest.mark.slow
def test_frontend_groups_route_by_user(tmp_path):
    """group_users requests route by user-feature hash: one user's requests
    land on ONE member and equal the direct grouped path."""
    tr = Trainer(JaxDSSM(emb_dim=8, capacity=1 << 12, num_user_feats=2, num_item_feats=2,
                         hidden=(32, 16)), Adagrad(lr=0.1), optax.adam(2e-3))
    st = tr.init(0)
    gen = SyntheticTwoTower(batch_size=128, num_user=2, num_item=2, vocab=500, seed=29)
    for _ in range(3):
        st, _ = tr.train_step(st, J(gen.batch()))
    CheckpointManager(str(tmp_path), tr).save(st)
    model = DSSM(emb_dim=8, capacity=1 << 12, num_user_feats=2, num_item_feats=2,
                 hidden=(32, 16))
    base = strip_labels(gen.batch())

    def user_req(u, n_items=8):
        out = {}
        for k, v in base.items():
            rows = v[u * n_items:(u + 1) * n_items].copy()
            if k in model.user_feats:
                rows = np.repeat(v[u:u + 1], n_items, axis=0)
            out[k] = rows
        return out

    backends, fe = make_tier(model, str(tmp_path), n=2)
    pred = _pred(model, str(tmp_path))
    try:
        fe.warmup(user_req(0))
        routed = {}
        for u in range(4):
            req = user_req(u)
            before = [m.snapshot()["requests"] for m in fe._members]
            for _ in range(2):
                out, _ = fe.request_versioned(req, group_users=True)
                np.testing.assert_allclose(np.asarray(out), np.asarray(pred.predict(req)),
                                           rtol=2e-5, atol=2e-5)
            after = [m.snapshot()["requests"] for m in fe._members]
            hit = [i for i, (a, b) in enumerate(zip(before, after)) if b > a]
            assert len(hit) == 1, (u, before, after)
            routed[u] = hit[0]
        assert len(set(routed.values())) == 2, routed
    finally:
        fe.close()
        for b in backends:
            b.stop()


@pytest.mark.slow
def test_frontend_backend_sigkill_subprocess(tmp_path):
    """Two backend PROCESSES (spawn_backends with --device cpu), SIGKILL
    one mid-load: the frontend retries onto the survivor with zero failed
    requests, and health degrades."""
    model, tr, st, ck, gen = make_trained(tmp_path)
    req = strip_labels(gen.batch())
    mj = json.dumps({**WDL_KW, "hidden": list(WDL_KW["hidden"])})
    procs, addrs = spawn_backends(2, ckpt=str(tmp_path), model="wdl", model_json=mj,
                                  device="cpu", env={"OMP_NUM_THREADS": "1"})
    fe = Frontend(addrs, model)
    expect = np.asarray(_pred(model, str(tmp_path)).predict(req))
    try:
        fe.warmup(req)
        errors, done = [], threading.Event()

        def driver():
            try:
                while not done.is_set():
                    np.testing.assert_allclose(np.asarray(fe.request(req)), expect,
                                               rtol=1e-5, atol=1e-5)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        th = threading.Thread(target=driver)
        th.start()
        time.sleep(0.3)
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait()
        time.sleep(0.7)
        done.set()
        th.join(timeout=60)
        assert not errors, errors
        h = fe.predictor.health()
        assert h["status"] == "degraded" and h["reachable"] == 1
    finally:
        fe.close()
        for p in procs:
            p.kill()
            p.wait()


def test_backend_argv_carries_device():
    from deeprec_tpu_torch.serving.frontend import backend_argv

    argv = backend_argv(ckpt="/ck", device="cuda", quantize="bf16", retrieval_shard="1/2")
    assert argv[argv.index("--device") + 1] == "cuda"
    assert argv[argv.index("--quantize") + 1] == "bf16"
    assert "deeprec_tpu_torch.serving.frontend" in argv
    assert "--device" not in backend_argv(ckpt="/ck")


# ------------------------------------------------------- retrieval fleet


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("retr-fleet"))
    tr = Trainer(JaxDSSM(**DSSM_KW), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticTwoTower(batch_size=256, num_user=2, num_item=2, vocab=VOCAB, seed=3)
    for _ in range(8):
        st, _ = tr.train_step(st, J(gen.batch()))
    CheckpointManager(tmp, tr).save(st)
    return tmp, DSSM(**DSSM_KW), gen


def make_items(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(1, n + 1, dtype=np.int64)
    return ids, {"V0": VOCAB + rng.integers(0, VOCAB, size=n),
                 "V1": 2 * VOCAB + rng.integers(0, VOCAB, size=n)}


def spawn_fleet(tmp, model, shards=2):
    backends = []
    for i in range(shards):
        p = _pred(model, tmp)
        ms = ModelServer(p, max_batch=64, max_wait_ms=0.5)
        ms.attach_retrieval(RetrievalEngine(p, quantize="int8", block_rows=256, chunk=128,
                                            shard_index=i, num_shards=shards))
        backends.append(BackendServer(ms, port=0).start())
    return backends, Frontend([("127.0.0.1", b.port) for b in backends], model)


def user_batch(pred, gen, rows=4):
    b = gen.batch()
    user = {k: np.asarray(v)[:rows] for k, v in b.items() if k.startswith("U")}
    return parse_features(pred, fill_missing_item_features(pred, user))


def test_two_shard_merge_parity_and_kill_partial(trained):
    """The broadcast ingest partitions itself; the merged two-shard answer
    equals one engine over every item (and the JAX merge of the shards'
    answers); a dead member makes the answer partial, never failed."""
    tmp, model, gen = trained
    backends, fe = spawn_fleet(tmp, model)
    try:
        ids, feats = make_items(2000)
        acc = fe.ingest_items(ids, feats)
        assert len(acc) == 2 and sum(acc.values()) == 2000
        assert all(v > 0 for v in acc.values())
        ref_pred = _pred(model, tmp)
        ref = RetrievalEngine(ref_pred, quantize="int8", block_rows=256, chunk=128)
        ref.upsert_items(ids, feats)
        batch = user_batch(ref_pred, gen)
        res_fleet = fe.retrieve_versioned(batch, 10)
        res_ref = ref.retrieve(batch, 10)
        assert not res_fleet.partial
        assert res_fleet.scanned == res_ref.scanned == 2000 * 4
        np.testing.assert_array_equal(res_fleet.ids, res_ref.ids)
        np.testing.assert_array_equal(res_fleet.scores, res_ref.scores)
        shard_res = [b.server.retrieval.engine.retrieve(batch, 10) for b in backends]
        want = jax_merge([r.ids for r in shard_res], [r.scores for r in shard_res], 10)
        np.testing.assert_array_equal(res_fleet.ids, want[0])
        snap = fe.stats_snapshot()
        assert snap["frontend"]["retrieval_requests"] == 1
        assert snap["frontend"]["retrieval_partials"] == 0

        backends[0].stop(unregister=False)  # process-death stand-in
        res_part = fe.retrieve_versioned(batch, 10)
        assert res_part.partial
        assert (res_part.ids >= 0).all()
        surviving = set(backends[1].server.retrieval.engine.host_vectors()[0].tolist())
        assert set(res_part.ids.ravel().tolist()) <= surviving
        h = fe.predictor.health()
        assert h["status"] in ("degraded", "down")
        assert h["reachable"] == 1
        assert h["retrieval_partials"] == 1
        res_next = fe.retrieve_versioned(batch, 10)
        assert res_next.partial
        assert set(res_next.ids.ravel().tolist()) <= surviving
    finally:
        for b in backends:
            try:
                b.stop()
            except Exception:
                pass
        fe.close()


def test_retr_op_leaves_grouped_routing_sticky(trained):
    """RETR fan-outs (to EVERY member) leave the grouped routing sticky."""
    tmp, model, gen = trained
    backends, fe = spawn_fleet(tmp, model)
    try:
        ids, feats = make_items(500)
        fe.ingest_items(ids, feats)
        b = gen.batch()

        def grouped_req(u):
            req = {}
            for k, v in b.items():
                if k.startswith("label"):
                    continue
                v = np.asarray(v)
                req[k] = (np.repeat(v[u:u + 1], 4, axis=0)
                          if k in model.user_feats else v[u * 4:(u + 1) * 4])
            return req

        owners = {}
        for u in range(4):
            fe.request(grouped_req(u), group_users=True)
            owners[u] = fe._ring.preference(fe._group_key(grouped_req(u)))[0]
        ubatch = user_batch(_pred(model, tmp), gen)
        for _ in range(3):
            fe.retrieve_versioned(ubatch, 5)
        for u in range(4):
            fe.request(grouped_req(u), group_users=True)
            assert fe._ring.preference(fe._group_key(grouped_req(u)))[0] == owners[u]
        assert {e["addr"]: e["requests"] for e in (m.snapshot() for m in fe._members)}
    finally:
        for srv in backends:
            srv.stop()
        fe.close()


def test_draining_member_stays_in_retrieval_fanout(trained):
    tmp, model, gen = trained
    backends, fe = spawn_fleet(tmp, model)
    try:
        ids, feats = make_items(1000)
        fe.ingest_items(ids, feats)
        batch = user_batch(_pred(model, tmp), gen)
        full = fe.retrieve_versioned(batch, 10)
        fe._members[0].draining = True  # what the membership sweep sets
        drained = fe.retrieve_versioned(batch, 10)
        assert not drained.partial
        assert drained.scanned == full.scanned
        np.testing.assert_array_equal(drained.ids, full.ids)
    finally:
        for b in backends:
            b.stop()
        fe.close()


def test_empty_shard_after_restart_degrades_health(trained):
    tmp, model, gen = trained
    backends, fe = spawn_fleet(tmp, model)
    try:
        ids, feats = make_items(600)
        backends[1].server.retrieval.engine.upsert_items(ids, feats)
        batch = user_batch(_pred(model, tmp), gen)
        res = fe.retrieve_versioned(batch, 5)
        assert not res.partial
        h = fe.predictor.health()
        assert h["status"] == "degraded", h
        assert h.get("degraded_reason") == "retrieval_shard_empty", h
        assert h["retrieval_empty_shards"] == 1
    finally:
        for b in backends:
            b.stop()
        fe.close()


def test_frontend_http_clamps_bad_ids_instead_of_crashing(trained):
    tmp, model, gen = trained
    backends, fe = spawn_fleet(tmp, model)
    http = HttpServer(fe, port=0).start()
    try:
        ids, feats = make_items(200)
        fe.ingest_items(ids, feats)
        b = gen.batch()
        user = {k: np.asarray(v)[:2].tolist() for k, v in b.items() if k.startswith("U")}
        user["U0"][0] = -7  # negative id: clamp to the pad, never a crash
        body = json.dumps({"features": user, "k": 5}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{http.port}/v1/retrieve", data=body,
            headers={"Content-Type": "application/json"}, method="POST"), timeout=30)
        out = json.loads(r.read())
        assert len(out["items"]) == 2 and len(out["items"][0]) == 5
        assert fe.predictor.record_errors.get("bad_id") == 1
    finally:
        http.stop()
        for srv in backends:
            srv.stop()
        fe.close()


def test_backend_without_retrieval_rejects_retr(trained):
    tmp, model, gen = trained
    p = _pred(model, tmp)
    backend = BackendServer(ModelServer(p, max_batch=16, max_wait_ms=0.5), port=0).start()
    fe = Frontend([("127.0.0.1", backend.port)], model)
    try:
        with pytest.raises(BadRequest, match="retrieval not enabled"):
            fe.retrieve_versioned(user_batch(p, gen), 5)
    finally:
        backend.stop()
        fe.close()


def test_http_retrieve_route(trained):
    """POST /v1/retrieve end to end through ModelServer.attach_retrieval."""
    tmp, model, gen = trained
    p = _pred(model, tmp)
    ms = ModelServer(p, max_batch=16, max_wait_ms=0.5)
    ms.attach_retrieval(RetrievalEngine(p, quantize="int8", block_rows=256, chunk=128))
    ids, feats = make_items(300)
    ms.retrieval.engine.upsert_items(ids, feats)
    http = HttpServer(ms, port=0).start()
    try:
        b = gen.batch()
        user = {k: np.asarray(v)[:2].tolist() for k, v in b.items() if k.startswith("U")}

        def post(k):
            body = json.dumps({"features": user, "k": k}).encode()
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{http.port}/v1/retrieve", data=body,
                headers={"Content-Type": "application/json"}, method="POST"), timeout=30)
            return json.loads(r.read().decode())

        out = post(7)
        assert len(out["items"]) == 2 and len(out["items"][0]) == 7
        assert all(i in set(ids.tolist()) for i in out["items"][0])
        assert out["partial"] is False
        assert out["candidates_scanned"] == 600
        assert "model_version" in out
        wide = post(400)  # k past the corpus: ids -1, scores null
        assert wide["items"][0][-1] == -1
        assert wide["scores"][0][-1] is None
        assert all(s is not None for s in wide["scores"][0][:300])
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{http.port}/v1/stats", timeout=10).read())
        assert stats["retrieval"]["requests"] == 2
        assert stats["retrieval_corpus"]["corpus_rows"] == 300
    finally:
        http.stop()
        ms.close()
