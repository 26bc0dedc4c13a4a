"""The port's composite embeddings held against the JAX package on the CPU,
the counterparts of tests/test_compose_elastic.py's multi-hash and adaptive
tests and tests/test_dyndim_tools.py's dynamic-dimension test:
`MultiHashTable` (the JAX params carried across with convert.py: every
strategy's lookup bit for bit, ids read as uint32, gradients through
autograd against `jax.grad`), `DynamicDimEmbedding` (the tier masks and
`effective_dim` exact; rows bit for bit on a state carried from JAX,
initializer rows within ROW_ATOL), and `AdaptiveEmbedding` (the static
table carried across: the routing by admission, the static bucket (salt
0xADA) and its rows exact, the split gradients).

Tolerances: initializer rows of new keys within ROW_ATOL (the port's
erfinv against XLA's, 65 f32 ulps at most); the multi-hash gradients within
GRAD_ATOL (the two backward passes sum a bucket's rows in another order).
Everything else is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import CounterFilter as JaxCounterFilter
from deeprec_tpu import EmbeddingTable as JaxEmbeddingTable
from deeprec_tpu import EmbeddingVariableOption as JaxEVOption
from deeprec_tpu import TableConfig as JaxTableConfig
from deeprec_tpu.embedding import compose as jc
from deeprec_tpu.utils.hashing import hash_to_bucket as jax_hash_to_bucket
from deeprec_tpu_torch import convert
from deeprec_tpu_torch.config import CounterFilter, EmbeddingVariableOption, TableConfig
from deeprec_tpu_torch.embedding import EmbeddingTable
from deeprec_tpu_torch.embedding import compose as tc

torch.set_num_threads(1)

ROW_ATOL = 1e-5
GRAD_ATOL = 1e-6
SENTINEL = int(np.iinfo(np.int32).min)


def _mh(strategy, d=8, q=64, r=64):
    return (tc.MultiHashTable(tc.MultiHashConfig("mh", d, q, r, strategy)),
            jc.MultiHashTable(jc.MultiHashConfig("mh", d, q, r, strategy)))


IDS = np.concatenate([np.arange(0, 4000, 37), [-5, -1, 2 ** 31 - 1, 4096 * 64 + 3]]).astype(np.int32)


@pytest.mark.parametrize("strategy", ["add", "mul", "concat"])
def test_multihash_lookup_matches_jax(strategy):
    mh, jmh = _mh(strategy)
    jparams = jmh.create(jax.random.PRNGKey(0))
    params = convert.multihash_params_from_arrays(mh, [np.asarray(a) for a in jparams], "cpu")
    got = mh.lookup(params, torch.from_numpy(IDS)).numpy()
    want = np.asarray(jmh.lookup(jparams, jnp.asarray(IDS)))
    assert got.shape == want.shape == (len(IDS), mh.dim) and mh.dim == jmh.dim
    np.testing.assert_array_equal(got, want)
    qi, ri = mh.buckets(torch.from_numpy(IDS))
    u = IDS.astype(np.int64) & 0xFFFFFFFF
    np.testing.assert_array_equal(qi.numpy(), (u // 64) % 64)
    np.testing.assert_array_equal(ri.numpy(), u % 64)


def test_multihash_composes_and_compresses():
    mh, _ = _mh("add")
    params = mh.create(torch.Generator().manual_seed(0), device="cpu")
    ids = torch.arange(0, 4000, 37, dtype=torch.int32)
    emb = mh.lookup(params, ids)
    assert emb.shape == (len(ids), 8)
    assert len(np.unique(emb.numpy().round(5), axis=0)) == len(ids)
    assert params[0].shape == (64, 8) and params[1].shape == (64, 8)
    again = mh.create(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params, again))
    with pytest.raises(ValueError):
        tc.MultiHashTable(tc.MultiHashConfig("bad", 4, 8, 8, "max"))
    with pytest.raises(ValueError, match="shapes"):
        convert.multihash_params_from_arrays(mh, [np.zeros((32, 8)), np.zeros((64, 8))], "cpu")


@pytest.mark.parametrize("strategy", ["add", "mul", "concat"])
def test_multihash_gradients_match_jax(strategy):
    mh, jmh = _mh(strategy, d=4, q=32, r=32)
    jparams = jmh.create(jax.random.PRNGKey(1))
    params = tuple(p.requires_grad_() for p in convert.multihash_params_from_arrays(
        mh, [np.asarray(a) for a in jparams], "cpu"))
    ids = np.array([3, 99, 1000, 3, 35, -7], np.int32)
    (mh.lookup(params, torch.from_numpy(ids)) ** 2).sum().backward()
    jg = jax.grad(lambda p: jnp.sum(jmh.lookup(p, jnp.asarray(ids)) ** 2))(jparams)
    for p, g in zip(params, jg):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0, atol=GRAD_ATOL)
        assert float(p.grad.abs().sum()) > 0


def _tables(dim, capacity, filter_freq=None):
    ev, jev = ((EmbeddingVariableOption(counter_filter=CounterFilter(filter_freq=filter_freq)),
                JaxEVOption(counter_filter=JaxCounterFilter(filter_freq=filter_freq)))
               if filter_freq else (EmbeddingVariableOption(), JaxEVOption()))
    return (EmbeddingTable(TableConfig(name="t", dim=dim, capacity=capacity, ev=ev)),
            JaxEmbeddingTable(JaxTableConfig(name="t", dim=dim, capacity=capacity, ev=jev)))


def _carry(table, js):
    return convert.table_state_from_arrays(
        table.cfg, {"keys": np.asarray(js.keys), "values": np.asarray(js.values),
                    "meta": np.asarray(js.meta)}, 1, "cpu")


def _by_key(uids, rows):
    uids = np.asarray(uids).reshape(-1)
    rows = np.asarray(rows).reshape(len(uids), -1)
    return {int(u): rows[i] for i, u in enumerate(uids) if u != SENTINEL}


def test_dynamic_dim_masks_by_frequency_like_jax():
    t, jt = _tables(16, 256)
    dd = tc.DynamicDimEmbedding(t, dim_tiers=(4, 8, 16), freq_tiers=(3, 6))
    jdd = jc.DynamicDimEmbedding(jt, dim_tiers=(4, 8, 16), freq_tiers=(3, 6))
    js = jt.create()
    for i in range(7):
        js, _ = jdd.lookup_unique(js, jnp.array([1], jnp.int32), step=i)
    s = _carry(t, js)
    ids = np.array([1, 2, 2, 5], np.int32)
    res = dd.lookup_unique(s, torch.from_numpy(ids)[None], step=8)
    js, jres = jdd.lookup_unique(js, jnp.asarray(ids), step=8)
    got, want = _by_key(res.uids, res.embeddings), _by_key(jres.uids, jres.embeddings)
    assert got.keys() == want.keys() == {1, 2, 5}
    np.testing.assert_array_equal(got[1], want[1])  # carried row: bit for bit
    assert np.abs(got[1][8:]).max() > 0  # freq 8 >= 6: all 16 dims
    for k in (2, 5):  # new keys: tier 0, initializer rows
        np.testing.assert_array_equal(got[k] == 0, want[k] == 0)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ROW_ATOL)
        assert np.abs(got[k][:4]).max() > 0 and not got[k][4:].any()
    eff = _by_key(res.uids, dd.effective_dim(s, res).numpy())
    jeff = _by_key(jres.uids, np.asarray(jdd.effective_dim(js, jres)))
    assert eff == jeff and int(eff[1][0]) == 16 and int(eff[2][0]) == 4


def test_dynamic_dim_tiers_step_up_and_absent_keys_read_tier_zero():
    t, _ = _tables(8, 64)
    dd = tc.DynamicDimEmbedding(t, dim_tiers=(2, 4, 8), freq_tiers=(2, 4))
    s = t.create(2, device="cpu")
    dims = []
    for step in range(5):
        res = dd.lookup_unique(s, torch.tensor([[3], [3]], dtype=torch.int32), step=step)
        dims.append(dd.effective_dim(s, res)[:, 0].tolist())
    assert dims == [[2, 2], [4, 4], [4, 4], [8, 8], [8, 8]]
    res = dd.lookup_unique(s, torch.tensor([[99], [3]], dtype=torch.int32), train=False)
    assert not bool((res.slot_ix[0] >= 0).any()) and dd.effective_dim(s, res)[0, 0] == 2


def test_adaptive_embedding_routes_by_admission_like_jax():
    t, jt = _tables(4, 256, filter_freq=3)
    ae, jae = tc.AdaptiveEmbedding(t, static_buckets=64), jc.AdaptiveEmbedding(jt, 64)
    jstatic = jae.create_static(jax.random.PRNGKey(0))
    static = convert.adaptive_static_from_array(ae, np.asarray(jstatic), "cpu")
    ids = np.array([7, 7, 7, 42, 42, 9], np.int32)  # 7 seen 3x: admitted; 42, 9 cold
    s = t.create(1, device="cpu")
    res, use = ae.lookup_unique(s, static, torch.from_numpy(ids)[None])
    js, jres, juse = jae.lookup_unique(jt.create(), jstatic, jnp.asarray(ids))
    assert _by_key(res.uids, use.numpy()) == _by_key(jres.uids, np.asarray(juse))
    got, want = _by_key(res.uids, res.embeddings), _by_key(jres.uids, jres.embeddings)
    assert got.keys() == {7, 42, 9}
    for k in (42, 9):  # cold: the static bucket row, exact
        b = int(jax_hash_to_bucket(jnp.array([k], jnp.int32), 64, salt=0xADA)[0])
        assert int(ae.bucket(torch.tensor([k], dtype=torch.int32))[0]) == b
        np.testing.assert_array_equal(got[k], np.asarray(jstatic)[b])
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got[7], want[7], rtol=0, atol=ROW_ATOL)
    g = torch.ones_like(res.embeddings)
    g_exact, (bucket, g_static) = ae.grads(res, use, g)
    jg_exact, (jbucket, jg_static) = jae.grads(jres, juse, jnp.ones_like(jres.embeddings))
    for a, b in ((g_exact, jg_exact), (g_static, jg_static)):
        assert _by_key(res.uids, a.numpy()).keys() == _by_key(jres.uids, np.asarray(b)).keys()
        for k, v in _by_key(res.uids, a.numpy()).items():
            np.testing.assert_array_equal(v, _by_key(jres.uids, np.asarray(b))[k])
    assert _by_key(res.uids, bucket.numpy()) == _by_key(jres.uids, np.asarray(jbucket))
    assert _by_key(res.uids, g_exact.numpy())[42].sum() == 0
    assert _by_key(res.uids, g_static.numpy())[42].sum() > 0


def test_adaptive_static_table_is_seeded_and_checked():
    t, _ = _tables(4, 64)
    ae = tc.AdaptiveEmbedding(t, static_buckets=16)
    a = ae.create_static(torch.Generator().manual_seed(5), device="cpu")
    b = ae.create_static(torch.Generator().manual_seed(5), device="cpu")
    assert a.shape == (16, 4) and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        convert.adaptive_static_from_array(ae, np.zeros((8, 4)), "cpu")
    with pytest.raises(AssertionError):
        tc.AdaptiveEmbedding(t, static_buckets=12)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mh, _ = _mh("add")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mh.create(torch.Generator())
    t, _ = _tables(4, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.AdaptiveEmbedding(t, 16).create_static(torch.Generator())
