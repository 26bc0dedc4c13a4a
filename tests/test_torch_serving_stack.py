"""The port's micro-batching server held against the JAX package on the
same checkpoints: coalescing (coalesced answers equal solo predicts within
COALESCE_ATOL), the bucket ladder, the adaptive wait, warmup, grouped-user
coalescing (DSSM: the user tower once per distinct user), the
user-tower and answer caches, ServerGroup degrading to one member on one
device, and torn reads held off through `_pre_swap`. Answers agree with
the JAX ModelServer's within PROB_ATOL."""
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo, SyntheticTwoTower
from deeprec_tpu.models import DSSM as JaxDSSM
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import ModelServer as JaxServer
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.serving.predictor import _ArrivalEWMA as JaxEWMA
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.models import DSSM, WDL
from deeprec_tpu_torch.serving import ModelServer, Predictor, ServerGroup
from deeprec_tpu_torch.serving.predictor import BadRequest, _ArrivalEWMA

torch.set_num_threads(1)

KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4, num_dense=2)
DSSM_KW = dict(emb_dim=8, capacity=1 << 12, num_user_feats=2, num_item_feats=2,
               hidden=(32, 16))
PROB_ATOL = 1e-4
# A request coalesced into a larger batch against the same rows predicted
# alone (the JAX test's bound, tests/test_serving.py:354): the GEMMs' row
# count differs, which on the CPU moves an answer by at most a few f32 ulps.
COALESCE_ATOL = 1e-6


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def strip(b):
    return {k: np.asarray(v) for k, v in b.items() if not k.startswith("label")}


def _save(tr, st, d):
    JaxCkpt(str(d), tr).save(st)
    return str(d)


@pytest.fixture(scope="module")
def wdl(tmp_path_factory):
    tr = JaxTrainer(JaxWDL(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=800, seed=21)
    for _ in range(4):
        st, _ = tr.train_step(st, J(gen.batch()))
    return _save(tr, st, tmp_path_factory.mktemp("wdl")), strip(gen.batch())


@pytest.fixture(scope="module")
def dssm(tmp_path_factory):
    tr = JaxTrainer(JaxDSSM(**DSSM_KW), Adagrad(lr=0.1), optax.adam(2e-3))
    st = tr.init(0)
    gen = SyntheticTwoTower(batch_size=128, num_user=2, num_item=2, vocab=500, seed=31)
    for _ in range(3):
        st, _ = tr.train_step(st, J(gen.batch()))
    return _save(tr, st, tmp_path_factory.mktemp("dssm")), strip(gen.batch())


def _user_req(base, user_feats, u, n_items=8):
    """A `<user, n_items>` request: user u's features on every row."""
    out = {}
    for k, v in base.items():
        rows = v[u * n_items:(u + 1) * n_items].copy()
        if k in user_feats:
            rows = np.repeat(v[u:u + 1], n_items, axis=0)
        out[k] = rows
    return out


def _concurrent(fn, n):
    outs, errs = [None] * n, []

    def run(i):
        try:
            outs[i] = fn(i)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errs, errs
    return outs


# ------------------------------------------------------------ coalescing


def test_coalesced_answers_equal_solo_and_jax(wdl):
    """16 concurrent requests of 1-9 rows coalesce into few device
    batches; each answer equals the solo predict of its rows within
    COALESCE_ATOL and the JAX ModelServer's answer within PROB_ATOL."""
    d, req = wdl
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"), max_batch=64,
                         max_wait_ms=20)
    jserver = JaxServer(JaxPredictor(JaxWDL(**KW), d), max_batch=64, max_wait_ms=20)
    try:
        reqs = [{k: v[i:i + 1 + i % 9] for k, v in req.items()} for i in range(16)]
        outs = _concurrent(lambda i: server.request_versioned(reqs[i]), 16)
        jouts = _concurrent(lambda i: jserver.request(reqs[i]), 16)
        for r, (out, v), jout in zip(reqs, outs, jouts):
            assert v == 0
            np.testing.assert_allclose(out, server.predictor.predict(r), rtol=0,
                                       atol=COALESCE_ATOL)
            np.testing.assert_allclose(out, np.asarray(jout), rtol=0, atol=PROB_ATOL)
        snap = server.stats_snapshot()
        assert snap["requests"] == 16 and snap["batches"] < 16
        assert snap["rows"] == sum(len(r["C1"]) for r in reqs)
    finally:
        server.close()
        jserver.close()


@pytest.mark.parametrize("max_batch", [8, 64, 100, 2048])
def test_bucket_ladder_matches_jax(wdl, max_batch):
    d, _ = wdl
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"), max_batch=max_batch)
    jserver = JaxServer.__new__(JaxServer)  # the ladder only reads max_batch
    jserver.max_batch = max_batch
    try:
        assert server._buckets() == JaxServer._buckets(jserver)
        for total in (1, 7, 8, 9, 63, 64, 65, max_batch, max_batch + 1):
            assert server._bucket_for(total) == JaxServer._bucket_for(jserver, total)
    finally:
        server.close()


def test_batches_never_overflow_the_ladder(wdl):
    """A request that would push the forming batch past max_batch rows
    leads the next batch instead (5 + 5 > 8: one request a batch)."""
    d, req = wdl
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"), max_batch=8,
                         max_wait_ms=5.0)
    try:
        five = {k: v[:5] for k, v in req.items()}
        outs = _concurrent(lambda i: server.request(five), 10)
        assert all(o.shape == (5,) for o in outs)
        snap = server.stats.snapshot()
        assert snap["requests"] == 10 and snap["batch_rows"]["max"] <= 8
    finally:
        server.close()


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_wait_matches_jax(wdl, adaptive):
    """The deadline policy over the same arrival estimates: full buckets
    and sparse traffic never wait, dense traffic waits to fill the bucket,
    capped by max_wait — as the JAX server decides."""
    d, _ = wdl
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"), max_batch=64,
                         max_wait_ms=2.0, adaptive=adaptive)
    j = JaxServer.__new__(JaxServer)
    j.max_batch, j.max_wait, j.adaptive, j._arrivals = 64, 2e-3, adaptive, JaxEWMA()
    try:
        cases = [(None, None, 8), (None, None, 64), (0.5, 8.0, 8), (5e-3, 8.0, 8),
                 (50e-6, 8.0, 8), (50e-6, 1.0, 1), (1e-4, 3.0, 40)]
        for tau, rows, have in cases:
            for s in (server, j):
                s._arrivals._tau, s._arrivals._rows = tau, rows
            assert server._pick_wait(have) == JaxServer._pick_wait(j, have)
        ew, jew = _ArrivalEWMA(), JaxEWMA()
        for t, r in ((0.0, 4), (0.010, 4), (0.013, 9), (0.02, 1)):
            ew.note(t, r)
            jew.note(t, r)
            assert ew.estimate() == jew.estimate()
    finally:
        server.close()


def test_warmup_runs_and_registers_every_bucket(wdl):
    """warmup runs each bucket once and registers it with the predictor, so
    an update runs the same ladder before its swap; the count is the JAX
    server's."""
    d, req = wdl
    p = Predictor(WDL(**KW), d, device="cpu")
    server = ModelServer(p, max_batch=64)
    jserver = JaxServer(JaxPredictor(JaxWDL(**KW), d), max_batch=64)
    try:
        n = server.warmup(req)
        assert n == jserver.warmup(req) == len(server._buckets())
        assert sorted(v["C1"].shape[0] for v in p._warm_batches.values()) == \
            server._buckets()
        warmed = []
        real = p._predict_impl
        p._predict_impl = lambda st, b: warmed.append(len(b["C1"])) or real(st, b)
        p.reload()
        assert sorted(warmed) == server._buckets()
    finally:
        server.close()
        jserver.close()


def _rows_seen(cls, name):
    """(calls, restore): record the rows of every `cls.<name>` call (the
    dense model's input rows) until restore() is called."""
    from deeprec_tpu_torch.nn import _leading_rows

    seen, orig = [], getattr(cls, name)

    def spy(self, *args):
        seen.append(_leading_rows(args))
        return orig(self, *args)

    setattr(cls, name, spy)
    return seen, lambda: setattr(cls, name, orig)


def test_fixed_read_rows_pad_once_in_the_predictor(wdl):
    """The card's policy at 16 rows (`read_rows`, set by hand on the CPU):
    the Predictor runs its dense model only at 16-row calls, the server
    keeps no ladder and pads nothing (warmup registers one batch), answers
    stay within COALESCE_ATOL of the unpadded Predictor's, and so does a
    coalesced answer of the solo one."""
    d, req = wdl
    plain = Predictor(WDL(**KW), d, device="cpu")
    assert plain.read_rows is None
    p = Predictor(WDL(**KW), d, device="cpu")
    p.read_rows = 16
    server = ModelServer(p, max_batch=64, max_wait_ms=20)
    try:
        assert server._buckets() == [64] and server._bucket_for(5) == 5
        assert server._bucket_for(100) == 100
        assert server.warmup(req) == 1
        assert [v["C1"].shape[0] for v in p._warm_batches.values()] == [64]
        rs = [{k: v[:n] for k, v in req.items()} for n in (1, 5, 37)]
        want = [plain.predict(r) for r in rs]
        seen, restore = _rows_seen(WDL, "forward")
        try:
            got = [p.predict(r) for r in rs]
        finally:
            restore()
        assert seen == [16] * (1 + 1 + 3)  # 37 rows: three 16-row calls
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=COALESCE_ATOL)
        reqs = [{k: v[i:i + 1 + i % 9] for k, v in req.items()} for i in range(12)]
        outs = _concurrent(lambda i: server.request(reqs[i]), 12)
        for r, out in zip(reqs, outs):  # a row's offset in its slice moves
            # the CPU's blocking: COALESCE_ATOL here, bit for bit on the card
            np.testing.assert_allclose(out, p.predict(r), rtol=0, atol=COALESCE_ATOL)
        assert server.stats_snapshot()["batches"] < 12 + 1
    finally:
        server.close()


# ---------------------------------------------------------- grouped users


def test_grouped_predict_equals_plain_and_jax(dssm):
    """predict(group_users=True) on DSSM: rows equal the plain path's within
    COALESCE_ATOL and the JAX grouped Predictor's within PROB_ATOL; the
    user-vector lanes (grouped with vectors, then candidate-only) give the
    same rows."""
    d, base = dssm
    p = Predictor(DSSM(**DSSM_KW), d, device="cpu")
    j = JaxPredictor(JaxDSSM(**DSSM_KW), d)
    req = {k: np.concatenate([_user_req(base, p.model.user_feats, u)[k] for u in range(3)])
           [:21] for k in base}
    plain = p.predict(req)
    grouped = p.predict(req, group_users=True)
    np.testing.assert_allclose(grouped, plain, rtol=0, atol=COALESCE_ATOL)
    np.testing.assert_allclose(grouped, np.asarray(j.predict(req, group_users=True)),
                               rtol=0, atol=PROB_ATOL)
    probs, uvec, v = p.predict_grouped_uvec_versioned(req)
    np.testing.assert_array_equal(probs, grouped)
    assert uvec.shape == (21, 16) and v == 0
    cand, v2 = p.predict_with_user_versioned(req, uvec)
    np.testing.assert_allclose(cand, grouped, rtol=0, atol=COALESCE_ATOL)


def test_grouped_requests_coalesce_with_one_user_tower_row_per_user(dssm):
    """Four concurrent `<user, 8 items>` grouped requests share one device
    batch whose user tower runs on at most one row per distinct user; each
    answer equals its direct predict within COALESCE_ATOL and is stamped
    with the one version; a plain request never shares their dispatch."""
    d, base = dssm
    model = DSSM(**DSSM_KW)
    pred = Predictor(model, d, device="cpu")
    reqs = {u: _user_req(base, model.user_feats, u) for u in range(4)}
    expect = {u: pred.predict(r) for u, r in reqs.items()}
    seen = []
    orig = type(model).user_vector

    def spy(self, inputs):
        seen.append(int(inputs.pooled[self.user_feats[0]].shape[0]))
        return orig(self, inputs)

    server = ModelServer(pred, max_batch=64, max_wait_ms=50)
    try:
        server.request(reqs[0], group_users=True)
        type(model).user_vector = spy
        replies = {u: server.submit(reqs[u], group_users=True) for u in reqs}
        results = {u: r.get(timeout=60) for u, r in replies.items()}
        plain = server.request(reqs[0])
    finally:
        type(model).user_vector = orig
        server.close()
    for u, (out, v) in results.items():
        np.testing.assert_allclose(out, expect[u], rtol=0, atol=COALESCE_ATOL)
        assert v == 0
    np.testing.assert_allclose(plain, expect[0], rtol=0, atol=COALESCE_ATOL)
    assert server.stats_snapshot()["requests"] == 6
    assert seen and min(seen) <= 8 and all(s & (s - 1) == 0 for s in seen)


def test_grouped_user_tower_keeps_its_groups_under_fixed_read_rows(dssm):
    """With `read_rows` set (the card's policy, here at 16 rows) the grouped
    path runs the user tower at its G rows (a power of two, never padded to
    16) and the item tower at 16-row calls; rows are not padded to a power
    of two first, and the answers equal the plain path's within
    COALESCE_ATOL."""
    d, base = dssm
    plain = Predictor(DSSM(**DSSM_KW), d, device="cpu")
    p = Predictor(DSSM(**DSSM_KW), d, device="cpu")
    p.read_rows = 16
    req = {k: np.concatenate([_user_req(base, p.model.user_feats, u)[k] for u in range(3)])
           [:21] for k in base}
    users, restore_u = _rows_seen(DSSM, "user_vector")
    items, restore_i = _rows_seen(DSSM, "apply_with_user")
    try:
        got = p.predict(req, group_users=True)
    finally:
        restore_u()
        restore_i()
    assert users == [4] and items == [16, 16]
    assert p._grouped_batch(req)[1:] == (21, 4)
    np.testing.assert_allclose(got, plain.predict(req), rtol=0, atol=COALESCE_ATOL)


def test_user_tower_cache_serves_the_candidate_only_lane(dssm):
    """With compute reuse on, a second grouped request of a cached user
    rides the candidate-only lane (the user tower does not run) and
    answers as the full evaluation within COALESCE_ATOL; the answer cache
    replies to a repeat bit for bit; no_cache evaluates anyway."""
    d, base = dssm
    model = DSSM(**DSSM_KW)
    pred = Predictor(model, d, device="cpu")
    server = ModelServer(pred, max_batch=64, reuse_cache_bytes=1 << 20)
    try:
        r0 = _user_req(base, model.user_feats, 0)
        r0b = {k: (v if k in model.user_feats else v[::-1].copy()) for k, v in r0.items()}
        first = server.request(r0, group_users=True)
        again = server.request_versioned(r0, group_users=True)
        np.testing.assert_array_equal(again[0], first)
        snap = server.stats_snapshot()["reuse"]
        assert snap["predict"]["hits"] == 1 and snap["user_tower"]["entries"] == 1
        calls = []
        orig = type(model).user_vector
        type(model).user_vector = lambda self, ins: calls.append(1) or orig(self, ins)
        try:
            out = server.request(r0b, group_users=True)
        finally:
            type(model).user_vector = orig
        assert not calls  # the cached vector: no user tower
        np.testing.assert_allclose(out, pred.predict(r0b, group_users=True), rtol=0,
                                   atol=COALESCE_ATOL)
        fresh = server.request_versioned(r0, group_users=True, no_cache=True)
        np.testing.assert_allclose(fresh[0], first, rtol=0, atol=COALESCE_ATOL)
        assert server.stats_snapshot()["reuse"]["predict"]["hits"] == 1
    finally:
        server.close()


# ------------------------------------------------------------- the group


def test_server_group_degrades_to_one_member_on_one_device(wdl):
    """ServerGroup(replicas=4) on one device has one member (requested
    replicas cap at the device count), answers through the shared queue,
    and its health and model_info name the replica count."""
    d, req = wdl
    group = ServerGroup(WDL(**KW), d, replicas=4, device="cpu", max_wait_ms=1.0)
    try:
        assert len(group.members) == 1
        assert group.predictor.model_info()["replicas"] == 1
        assert group.predictor.health()["replicas"] == 1
        sub = {k: v[:4] for k, v in req.items()}
        np.testing.assert_array_equal(group.request(sub),
                                      group.members[0].predictor.predict(sub))
        snap = group.stats_snapshot()
        assert snap["replicas"] == 1 and snap["requests"] == 1
        two = ServerGroup(WDL(**KW), d, devices=["cpu", "cpu"], max_wait_ms=1.0)
        assert len(two.members) == 1
        two.close()
    finally:
        group.close()


# ------------------------------------------------------------ torn reads


def test_torn_reads_through_the_server_are_stamped_with_one_version(wdl, tmp_path):
    """Requests racing an update held at `_pre_swap` each carry ONE stamped
    version, and every pre-swap answer is the old model's bit for bit."""
    import shutil

    d = str(tmp_path / "ck")
    shutil.copytree(wdl[0], d)
    req = wdl[1]
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"), max_batch=64,
                         max_wait_ms=2)
    p = server.predictor
    single = {k: v[:4] for k, v in req.items()}
    old, v0 = server.request_versioned(single)
    # a delta: the JAX trainer restores the chain and steps twice
    tr = JaxTrainer(JaxWDL(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
    ck = JaxCkpt(d, tr)
    st = ck.restore()
    gen = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=800, seed=22)
    for _ in range(2):
        st, _ = tr.train_step(st, J(gen.batch()))
    ck.save_incremental(st)
    built, release = threading.Event(), threading.Event()
    p._pre_swap = lambda: (built.set(), release.wait(timeout=60)) and None
    th = threading.Thread(target=p.poll_updates)
    th.start()
    try:
        assert built.wait(timeout=60)
        outs = _concurrent(lambda i: server.request_versioned(single), 6)
        for out, v in outs:
            assert v == v0
            np.testing.assert_array_equal(out, old)
    finally:
        release.set()
        th.join(timeout=60)
    new, v1 = server.request_versioned(single)
    assert v1 == v0 + 1 and np.abs(new - old).max() > 1e-6
    server.close()


def test_towerless_grouping_and_retrieval_are_refused(wdl):
    """group_users on a model without towers is a client error (the
    predictor's ValueError, the server's BadRequest); a retrieval engine
    needs the two-tower split (the JAX engine's ValueError), and with no
    lane attached the server answers as the JAX server does."""
    from deeprec_tpu_torch.serving import RetrievalEngine

    d, req = wdl
    server = ModelServer(Predictor(WDL(**KW), d, device="cpu"))
    try:
        with pytest.raises(ValueError, match="tower"):
            server.predictor.predict(req, group_users=True)
        with pytest.raises(BadRequest, match="tower"):
            server.submit(req, group_users=True)
        with pytest.raises(ValueError, match="two-tower"):
            server.attach_retrieval(RetrievalEngine(server.predictor))
        assert server.retrieval is None and server.predictor._retrieval is None
        with pytest.raises(BadRequest, match="retrieval not enabled"):
            server.retrieve_versioned(req, 5)
    finally:
        server.close()


def test_predicts_beside_a_trainer_on_the_same_model_object(wdl):
    """Stress: 10 threads predicting while a trainer on the SAME model
    object trains and a poller publishes, with a short interpreter switch
    interval. `functional_call` swaps a module's parameters while it runs;
    each predicting thread runs its own replica, so every answer equals a
    published version's answer bit for bit and no train step fails."""
    import sys

    from deeprec_tpu_torch.data import SyntheticCriteo as TorchCriteo
    from deeprec_tpu_torch.optim import Adagrad as TorchAdagrad
    from deeprec_tpu_torch.training.trainer import Trainer

    d, req = wdl
    model = WDL(**KW)
    p = Predictor(model, d, device="cpu")
    sub = {k: v[:16] for k, v in req.items()}
    want = p.predict(sub)
    tr = Trainer(model, TorchAdagrad(lr=0.1), device="cpu")
    st = tr.init()
    gen = TorchCriteo(batch_size=64, num_cat=4, num_dense=2, vocab=800, seed=5)
    batches = [gen.batch() for _ in range(4)]
    stop = threading.Event()
    errs, wrong = [], []

    def predictor():
        while not stop.is_set():
            try:
                out, v = p.predict_versioned(sub)
                if v == 0 and not np.array_equal(out, want):
                    wrong.append(float(np.abs(out - want).max()))
            except Exception as e:
                errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=predictor) for _ in range(10)]
    try:
        for t in threads:
            t.start()
        for i in range(12):
            st, m = tr.train_step(st, batches[i % 4])
            assert np.isfinite(float(m["loss"]))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errs and not wrong, (errs[:1], wrong[:3])
