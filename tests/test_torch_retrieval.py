"""The port's full-corpus retrieval (deeprec_tpu_torch/ops/topk.py and
serving/retrieval.py) held against the JAX package, case for case with
tests/test_retrieval.py: the blocked top-k against an argsort and against
the JAX `blocked_topk` (integer-valued vectors: every sum is exact, so ids
AND scores are equal bit for bit, ties included, at every block size), the
tie order, the edges, `merge_shard_topk`, and the engine on a JAX-trained
DSSM checkpoint restored by the port: f32 vectors within VEC_ATOL of the
JAX engine's, int8 codes within one step and scales within the item
vector's own difference over 127 plus one ulp, the
same delta-fold rows, the fingerprint drift, the shard partition,
coalescing and its accounting."""
import shutil
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticTwoTower
from deeprec_tpu.models import DSSM as JaxDSSM
from deeprec_tpu.ops.topk import blocked_topk as jax_blocked_topk
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.serving import RetrievalEngine as JaxEngine
from deeprec_tpu.serving.retrieval import merge_shard_topk as jax_merge
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu.training.trainer import TrainState as JaxTrainState
from deeprec_tpu.utils.hashing import hash_shard_np as jax_hash_shard
from deeprec_tpu_torch.models import DSSM, WDL
from deeprec_tpu_torch.ops import topk
from deeprec_tpu_torch.ops.topk import blocked_topk
from deeprec_tpu_torch.serving import ModelServer, Predictor, RetrievalEngine
from deeprec_tpu_torch.serving.predictor import parse_features
from deeprec_tpu_torch.serving.retrieval import (
    fill_missing_item_features,
    merge_shard_topk,
)
from deeprec_tpu_torch.utils.hashing import fold64_np, hash_shard_np, mix32_np

torch.set_num_threads(1)

VOCAB = 200
DSSM_KW = dict(emb_dim=8, capacity=1 << 12, num_user_feats=2, num_item_feats=2,
               hidden=(16, 8))
ENG = dict(block_rows=256, chunk=128)
# f32 item and user vectors against the JAX engine's: the same math on the
# CPU in another order of operations (XLA fuses, eager PyTorch does not)
VEC_ATOL = 1e-5


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def exact_topk_np(scores, valid, k):
    """Reference: full argsort with the engine's tie order (score desc, row
    asc); invalid rows lose, short corpora pad with -1."""
    s = np.where(valid[None, :], scores, -np.inf)
    rows = np.broadcast_to(np.arange(s.shape[1]), s.shape)
    order = np.lexsort((rows, -s), axis=-1)[:, :k]
    vals = np.take_along_axis(s, order, axis=1)
    idx = np.where(np.isfinite(vals), order, -1)
    pad = k - order.shape[1]
    if pad > 0:
        vals = np.concatenate([vals, np.full((s.shape[0], pad), -np.inf)], axis=1)
        idx = np.concatenate([idx, np.full((s.shape[0], pad), -1, idx.dtype)], axis=1)
    return vals, idx


def _topk(user, corpus, valid, k, block, scale=None):
    vals, rows = blocked_topk(torch.as_tensor(user), torch.as_tensor(corpus),
                              torch.as_tensor(valid), k, block_rows=block,
                              scale=None if scale is None else torch.as_tensor(scale))
    return vals.numpy(), rows.numpy()


def _jax_topk(user, corpus, valid, k, block, scale=None):
    vals, rows = jax_blocked_topk(jnp.asarray(user), jnp.asarray(corpus),
                                  jnp.asarray(valid), k, block_rows=block,
                                  scale=None if scale is None else jnp.asarray(scale))
    return np.asarray(vals), np.asarray(rows)


@pytest.mark.parametrize("block", [8, 32, 128])
@pytest.mark.parametrize("k", [1, 5, 40])
@pytest.mark.parametrize("span", ["default", "block"])
def test_blocked_topk_matches_argsort(block, k, span, monkeypatch):
    """The blocked merge equals a full-scan argsort for every block size,
    k > block included; on integer-valued vectors (many equal scores) its
    ids and scores equal the JAX function's bit for bit, and so do those
    of an int8 corpus with a per-row scale of powers of two. With a sweep
    step of one block the carry merges across many steps; the answer is
    the same as with the whole corpus in one step."""
    if span == "block":
        monkeypatch.setattr(topk, "SWEEP_ROWS", block)
    rng = np.random.default_rng(0)
    C, H, B = 256, 16, 3
    corpus = rng.normal(size=(C, H)).astype(np.float32)
    valid = rng.random(C) < 0.9
    user = rng.normal(size=(B, H)).astype(np.float32)
    vals, rows = _topk(user, corpus, valid, k, block)
    ref_vals, ref_rows = exact_topk_np(user @ corpus.T, valid, k)
    np.testing.assert_array_equal(rows, ref_rows)
    np.testing.assert_allclose(vals[ref_rows >= 0], ref_vals[ref_rows >= 0], rtol=1e-5)

    icorpus = rng.integers(-3, 4, size=(C, H)).astype(np.float32)
    iuser = rng.integers(-3, 4, size=(B, H)).astype(np.float32)
    got, want = _topk(iuser, icorpus, valid, k, block), _jax_topk(iuser, icorpus, valid, k, block)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], exact_topk_np(iuser @ icorpus.T, valid, k)[1])
    q = icorpus.astype(np.int8)
    scale = (2.0 ** rng.integers(-3, 3, size=C)).astype(np.float32)
    got = _topk(iuser, q, valid, k, block, scale)
    want = _jax_topk(iuser, q, valid, k, block, scale)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_tie_determinism_block_size_independent(monkeypatch):
    """Duplicate corpus rows score equal: the lowest row wins at every
    block size, whether the sweep takes the corpus in one step or one block
    a step (ties then meet in the carry merge across steps), as in the JAX
    function (bit for bit)."""
    rng = np.random.default_rng(1)
    H = 8
    base = rng.normal(size=(4, H)).astype(np.float32)
    corpus = np.tile(base, (16, 1))  # 64 rows, every vector x16
    valid = np.ones(64, bool)
    user = rng.normal(size=(2, H)).astype(np.float32)
    picks = [_topk(user, corpus, valid, 8, block)[1] for block in (4, 16, 64)]
    for block in (4, 16, 64):
        with monkeypatch.context() as m:
            m.setattr(topk, "SWEEP_ROWS", block)
            picks.append(_topk(user, corpus, valid, 8, block)[1])
    for p in picks[1:]:
        np.testing.assert_array_equal(picks[0], p)
    _, ref_rows = exact_topk_np(user @ corpus.T, valid, 8)
    np.testing.assert_array_equal(picks[0], ref_rows)
    for block in (4, 16, 64):
        np.testing.assert_array_equal(picks[0], _jax_topk(user, corpus, valid, 8, block)[1])


def test_topk_empty_and_overask_edges():
    """Zero valid rows -> all -1; k past the valid count pads with -1; an
    all-padding block never wins; the same answers as the JAX function."""
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(16, 4)).astype(np.float32)
    user = rng.normal(size=(1, 4)).astype(np.float32)
    _, rows = _topk(user, corpus, np.zeros(16, bool), 5, 8)
    assert (rows == -1).all()
    valid = np.zeros(16, bool)
    valid[:3] = True
    vals, rows = _topk(user, corpus, valid, 5, 8)
    assert set(rows[0, :3]) == {0, 1, 2}
    assert (rows[0, 3:] == -1).all()
    assert np.isneginf(vals[0, 3:]).all()
    np.testing.assert_array_equal(rows, _jax_topk(user, corpus, valid, 5, 8)[1])


def test_merge_shard_topk_order_and_invalid():
    ids = [np.array([[5, 3, -1]], np.int64), np.array([[4, 9, 2]], np.int64)]
    scores = [np.array([[3.0, 1.0, -np.inf]], np.float32),
              np.array([[3.0, 2.0, 0.5]], np.float32)]
    out_i, out_v = merge_shard_topk(ids, scores, 4)
    # score desc, the tie on 3.0 by id asc (4 < 5), -1 never chosen
    assert out_i[0].tolist() == [4, 5, 9, 3]
    np.testing.assert_allclose(out_v[0], [3.0, 3.0, 2.0, 1.0])
    # against the JAX merge on random shards with ties and short shards
    rng = np.random.default_rng(5)
    ids = [rng.permutation(40)[:6].reshape(2, 3).astype(np.int64) + 100 * s for s in range(3)]
    scores = [rng.integers(0, 3, size=(2, 3)).astype(np.float32) for _ in range(3)]
    ids[1][0, 2] = -1
    scores[1][0, 2] = -np.inf
    for k in (1, 4, 9):
        got, want = merge_shard_topk(ids, scores, k), jax_merge(ids, scores, k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_hash_shard_np_bit_exact():
    """The fleet's shard assignment: int32, int64 (narrowed) and uint ids
    land on the same shard as in the JAX package."""
    rng = np.random.default_rng(9)
    for ids in (rng.integers(-2**31, 2**31, 500, dtype=np.int64),
                rng.integers(0, 2**31, 500).astype(np.int32),
                rng.integers(0, 2**63, 500, dtype=np.uint64),
                np.arange(1, 2000, dtype=np.int64)):
        for n in (1, 2, 3, 8):
            np.testing.assert_array_equal(hash_shard_np(ids, n), jax_hash_shard(ids, n))
    from deeprec_tpu.utils.hashing import fold64_np as jf, mix32_np as jm

    x = rng.integers(-2**62, 2**62, 300, dtype=np.int64)
    np.testing.assert_array_equal(fold64_np(x), jf(x))
    np.testing.assert_array_equal(mix32_np(x.astype(np.uint32)), jm(x.astype(np.uint32)))


# ------------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def base_ckpt(tmp_path_factory):
    """A JAX-trained DSSM (8 Adagrad + Adam steps) saved once; each case
    copies it, as each JAX case trains its own."""
    model = JaxDSSM(**DSSM_KW)
    tr = JaxTrainer(model, JaxAdagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticTwoTower(batch_size=256, num_user=2, num_item=2, vocab=VOCAB, seed=3)
    for _ in range(8):
        st, _ = tr.train_step(st, J(gen.batch()))
    d = tmp_path_factory.mktemp("dssm_base")
    JaxCkpt(str(d), tr).save(st)
    return str(d), model, tr, st


def make_stack(base_ckpt, tmp_path, quantize="int8", jax_engine=False, **eng_kw):
    """(JAX model, trainer, state, checkpoint manager over a copy of the
    base checkpoint, generator, port Predictor, port engine[, JAX
    Predictor, JAX engine])."""
    src, jmodel, tr, _ = base_ckpt
    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    ck = JaxCkpt(d, tr)
    st = ck.restore()  # a state of its own: a train step donates its input
    gen = SyntheticTwoTower(batch_size=256, num_user=2, num_item=2, vocab=VOCAB, seed=4)
    pred = Predictor(DSSM(**DSSM_KW), d, device="cpu")
    eng = RetrievalEngine(pred, quantize=quantize, **ENG, **eng_kw)
    out = [jmodel, tr, st, ck, gen, pred, eng]
    if jax_engine:
        jpred = JaxPredictor(jmodel, d)
        out += [jpred, JaxEngine(jpred, quantize=quantize, **ENG, **eng_kw)]
    return out


def make_items(n, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.arange(1, n + 1, dtype=np.int64)
    feats = {"V0": VOCAB + rng.integers(0, VOCAB, size=n),
             "V1": 2 * VOCAB + rng.integers(0, VOCAB, size=n)}
    return ids, feats


def user_batch(pred, gen, rows=4):
    b = gen.batch()
    user = {k: np.asarray(v)[:rows] for k, v in b.items() if k.startswith("U")}
    return parse_features(pred, fill_missing_item_features(pred, user))


def _vecs(eng, n):
    return eng._corpus.vecs[:n].to(torch.float32).numpy()


def test_engine_recall_floor_vs_exact_fp32(base_ckpt, tmp_path):
    """int8 sweep against the exact f32 scan over the same items: tie-aware
    recall@{10,100} floors; the f32 engine against its own vectors exactly;
    and both engines against the JAX engines on the same checkpoint: f32
    vectors within VEC_ATOL, int8 codes within one step and scales within
    the vectors' difference / 127 plus one ulp, f32 answers equal wherever neighbouring scores are more than
    VEC_ATOL apart."""
    *_, gen, pred, eng8, jpred, jeng8 = make_stack(base_ckpt, tmp_path, jax_engine=True)
    eng32 = RetrievalEngine(pred, quantize="fp32", **ENG)
    jeng32 = JaxEngine(jpred, quantize="fp32", **ENG)
    ids, feats = make_items(5000)
    for e in (eng8, eng32, jeng8, jeng32):
        e.upsert_items(ids, feats)
    batch = user_batch(pred, gen, rows=8)
    hids, hv = eng32.host_vectors()
    uvec = eng32._user(pred._snap.state, batch).numpy()[:8]
    exact = uvec @ hv.T
    res = eng8.retrieve(batch, 100)
    cols = np.searchsorted(hids, res.ids)
    got = np.take_along_axis(exact, np.clip(cols, 0, exact.shape[1] - 1), axis=1)
    got = np.where(res.ids >= 0, got, -np.inf)
    for k in (10, 100):
        kth = -np.partition(-exact, k - 1, axis=1)[:, k - 1]
        recall = float((got[:, :k] >= kth[:, None] - 1e-6).mean())
        assert recall >= 0.95, (k, recall)
    res32 = eng32.retrieve(batch, 50)
    _, ref_rows = exact_topk_np(exact, np.ones(exact.shape[1], bool), 50)
    np.testing.assert_array_equal(res32.ids, hids[ref_rows])

    # against the JAX engines
    juvec = np.asarray(jeng32._user_jit(jpred._snap.state, J(batch)))[:8]
    np.testing.assert_allclose(uvec, juvec, atol=VEC_ATOL, rtol=0)
    jhids, jhv = jeng32.host_vectors()
    np.testing.assert_array_equal(hids, jhids)
    np.testing.assert_allclose(hv, jhv, atol=VEC_ATOL, rtol=0)
    q = _vecs(eng8, 5000)
    jq = np.asarray(jeng8._corpus.vecs)[:5000].astype(np.float32)
    assert np.abs(q - jq).max() <= 1
    s, js = eng8._corpus.scale[:5000].numpy(), np.asarray(jeng8._corpus.scale)[:5000]
    # scale = max|v| / 127: per item within the item's own f32 vector
    # difference from the JAX engine's, over 127, plus one ulp (XLA turns
    # the division into a product)
    dv = np.abs(hv - jhv).max(axis=1)
    assert (np.abs(s - js) <= dv / 127 + np.spacing(np.abs(js))).all()
    jres32 = jeng32.retrieve(batch, 50)
    np.testing.assert_allclose(res32.scores, jres32.scores, atol=VEC_ATOL, rtol=0)
    gap = np.diff(jres32.scores, axis=1)
    apart = np.ones_like(res32.ids, bool)
    apart[:, 1:] &= np.abs(gap) > VEC_ATOL
    apart[:, :-1] &= np.abs(gap) > VEC_ATOL
    np.testing.assert_array_equal(res32.ids[apart], jres32.ids[apart])


def test_engine_empty_one_block_and_growth(base_ckpt, tmp_path):
    """An empty corpus serves all -1; a one-block corpus works; ingest past
    capacity grows by power-of-two blocks, as the JAX engine's."""
    *_, gen, pred, eng = make_stack(base_ckpt, tmp_path)
    batch = user_batch(pred, gen)
    res = eng.retrieve(batch, 5)
    assert (res.ids == -1).all() and res.scanned == 0
    ids, feats = make_items(10)
    eng.upsert_items(ids, feats)
    res = eng.retrieve(batch, 20)
    assert set(res.ids[0][res.ids[0] >= 0]) == set(ids.tolist())
    assert (res.ids[0] == -1).sum() == 10  # k past the corpus pads -1
    cap0 = eng.capacity
    ids2, feats2 = make_items(cap0 + 100, seed=7)
    eng.upsert_items(ids2, feats2)
    assert eng.capacity == 2 * cap0 and eng.capacity % eng.block_rows == 0
    assert eng.corpus_rows() == cap0 + 100
    res = eng.retrieve(batch, 10)
    assert (res.ids >= 0).all()
    si = eng.sweep_info()
    assert si["measured_bytes"] == si["modeled_bytes"]
    from deeprec_tpu.ops import traffic as jtraffic

    assert si["modeled_bytes"] == jtraffic.retrieval_sweep_bytes(
        corpus_rows=eng.capacity, dim=eng.dim, value_dtype="int8", block_rows=eng.block_rows)


def frozen_dense(tr, st, ck_dir, model):
    """The sparse-only online-update regime (embeddings train, the towers
    frozen): the JAX test's trainer over the same checkpoint directory."""
    tr2 = JaxTrainer(model, JaxAdagrad(lr=0.1), optax.set_to_zero())
    st2 = JaxTrainState(step=st.step, tables=st.tables, dense=st.dense,
                        opt_state=tr2.dense_opt.init(st.dense))
    return tr2, st2, JaxCkpt(ck_dir, tr2)


def test_delta_fold_targets_changed_items(base_ckpt, tmp_path):
    """With the item tower frozen, delta replay folds ONLY the corpus rows
    whose item keys the delta touched, in the same poll round — the same
    rows as the JAX engine — and the folded rows equal a fresh engine's
    encode of the same state bit for bit."""
    jmodel, tr0, st0, ck0, gen, pred, eng, jpred, jeng = make_stack(
        base_ckpt, tmp_path, jax_engine=True)
    tr, st, ck = frozen_dense(tr0, st0, ck0.dir, jmodel)
    ids, feats = make_items(1000)
    # items 0..9 carry reserved V0/V1 ids the rest of the corpus never uses
    res0, res1 = 2 * VOCAB - 1, 3 * VOCAB - 1
    feats = {k: v.copy() for k, v in feats.items()}
    feats["V0"][10:] = VOCAB + (feats["V0"][10:] % (VOCAB - 1))
    feats["V1"][10:] = 2 * VOCAB + (feats["V1"][10:] % (VOCAB - 1))
    feats["V0"][:10] = res0
    feats["V1"][:10] = res1
    eng.upsert_items(ids, feats)
    jeng.upsert_items(ids, feats)
    batch = user_batch(pred, gen)

    def land_delta():
        nonlocal st
        for _ in range(2):
            b = gen.batch()
            b["V0"] = np.full_like(b["V0"], res0)
            b["V1"] = np.full_like(b["V1"], res1)
            st, _ = tr.train_step(st, J(b))
        st, _ = ck.save_incremental(st)

    before = _vecs(eng, 1000).copy()
    jbefore = np.asarray(jeng._corpus.vecs)[:1000].copy()
    land_delta()
    assert pred.poll_updates() and jpred.poll_updates()
    assert eng.last_fold["rows"] == jeng.last_fold["rows"] == 10, eng.last_fold
    assert not eng.last_fold["full"] and not eng.last_fold["dense_drift"]
    changed = np.nonzero((_vecs(eng, 1000) != before).any(axis=1))[0]
    jchanged = np.nonzero((np.asarray(jeng._corpus.vecs)[:1000] != jbefore).any(axis=1))[0]
    assert set(changed.tolist()) <= set(range(10))
    assert set(jchanged.tolist()) <= set(range(10))
    eng.retrieve(batch, 10)
    land_delta()
    assert pred.poll_updates()
    res = eng.retrieve(batch, 10)
    assert res.version == pred.version and eng.folds == 2
    eng2 = RetrievalEngine(pred, quantize="int8", **ENG)
    eng2.upsert_items(ids, feats)
    np.testing.assert_array_equal(_vecs(eng, 1000), _vecs(eng2, 1000))


def test_full_reload_refreshes_whole_corpus(base_ckpt, tmp_path):
    """A full checkpoint reload marks every resident row dirty."""
    _, tr, st, ck, gen, pred, eng = make_stack(base_ckpt, tmp_path)
    ids, feats = make_items(500)
    eng.upsert_items(ids, feats)
    for _ in range(2):
        st, _ = tr.train_step(st, J(gen.batch()))
    ck.save(st)
    assert pred.poll_updates()
    assert eng.last_fold["full"] and eng.last_fold["rows"] == 500


def test_dense_tower_drift_escalates_fold_to_full(base_ckpt, tmp_path):
    """A delta that moved the item tower's dense parameters escalates the
    fold to a full re-encode (as the JAX engine's), and the refreshed corpus
    equals a fresh engine's encode of the post-delta state bit for bit."""
    _, tr, st, ck, gen, pred, eng, jpred, jeng = make_stack(
        base_ckpt, tmp_path, jax_engine=True)
    ids, feats = make_items(300)
    eng.upsert_items(ids, feats)
    jeng.upsert_items(ids, feats)
    for _ in range(2):  # Adam: the dense parameters move every step
        st, _ = tr.train_step(st, J(gen.batch()))
    ck.save_incremental(st)
    assert pred.poll_updates() and jpred.poll_updates()
    for e in (eng, jeng):
        assert e.last_fold["dense_drift"] and e.last_fold["full"]
        assert e.last_fold["rows"] == 300
    eng2 = RetrievalEngine(pred, quantize="int8", **ENG)
    eng2.upsert_items(ids, feats)
    np.testing.assert_array_equal(_vecs(eng, 300), _vecs(eng2, 300))


def test_upsert_updates_existing_and_shards_partition(base_ckpt, tmp_path):
    """Re-ingesting an id keeps its row and re-encodes it; sharded engines
    keep disjoint, exhaustive subsets — each shard the ids the JAX engine's
    shard keeps."""
    *_, gen, pred, eng, jpred, _ = make_stack(base_ckpt, tmp_path, jax_engine=True)
    ids, feats = make_items(100)
    assert eng.upsert_items(ids, feats) == 100
    rows0 = eng.corpus_rows()
    feats2 = {k: v.copy() for k, v in feats.items()}
    feats2["V0"][:] = VOCAB + 1
    before = _vecs(eng, 100).copy()
    assert eng.upsert_items(ids[:10], {k: v[:10] for k, v in feats2.items()}) == 10
    assert eng.corpus_rows() == rows0  # updated in place, no new rows
    assert (_vecs(eng, 100)[10:] == before[10:]).all()
    shards = [RetrievalEngine(pred, quantize="fp32", shard_index=i, num_shards=2, **ENG)
              for i in range(2)]
    jshards = [JaxEngine(jpred, quantize="fp32", shard_index=i, num_shards=2, **ENG)
               for i in range(2)]
    counts = [s.upsert_items(ids, feats) for s in shards]
    assert sum(counts) == 100 and all(c > 0 for c in counts)
    for s, js in zip(shards, jshards):
        js.upsert_items(ids, feats)
        np.testing.assert_array_equal(s.host_vectors()[0], js.host_vectors()[0])
    all_ids = np.concatenate([s.host_vectors()[0] for s in shards])
    assert sorted(all_ids.tolist()) == ids.tolist()


def test_retrieval_server_coalesces_and_accounts(base_ckpt, tmp_path):
    """Concurrent requests share sweeps, equal their solo answers, and land
    in the stats plane: the retrieval stage histogram, the candidates
    counter, the corpus gauges."""
    *_, gen, pred, eng = make_stack(base_ckpt, tmp_path)
    ids, feats = make_items(800)
    eng.upsert_items(ids, feats)
    ms = ModelServer(pred, max_batch=64, max_wait_ms=1.0)
    rs = ms.attach_retrieval(eng)
    batches = [user_batch(pred, gen, rows=2) for _ in range(6)]
    solo = [eng.retrieve(b, 8) for b in batches]
    rs.engine.warmup(batches[0], k=8)
    outs = [None] * 6

    def call(i):
        outs[i] = ms.retrieve_versioned(batches[i], 8)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o is not None and o.ids.shape == (2, 8) for o in outs)
    for o, s in zip(outs, solo):
        np.testing.assert_array_equal(o.ids, s.ids)
        np.testing.assert_allclose(o.scores, s.scores, atol=1e-6, rtol=0)
    snap = ms.stats_snapshot()
    assert snap["retrieval"]["requests"] == 6
    assert snap["retrieval"]["candidates_scanned"] > 0
    assert snap["stages"]["retrieval"]["count"] == 6
    assert snap["retrieval_corpus"]["corpus_rows"] == 800
    assert (snap["retrieval_corpus"]["measured_bytes"]
            == snap["retrieval_corpus"]["modeled_bytes"])
    assert snap["health"]["retrieval_corpus_rows"] == 800
    if ms.stats.registry is not None:
        text = ms.metrics_text()
        assert "deeprec_retrieval_corpus_rows" in text
        assert "deeprec_retrieval_candidates_scanned" in text
    ms.close()


def test_non_two_tower_model_raises(tmp_path):
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    model = WDL(emb_dim=8, capacity=1 << 10, hidden=(16,), num_cat=2, num_dense=2)
    tr = Trainer(model, Adagrad(lr=0.1), adam(1e-3), device="cpu")
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=64, num_cat=2, num_dense=2, vocab=500, seed=1)
    st, _ = tr.train_step(st, tr.device_batch(gen.batch()))
    CheckpointManager(str(tmp_path), tr).save(st)
    pred = Predictor(model, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="two-tower"):
        RetrievalEngine(pred)
