"""Parity of the PyTorch port's ops against the JAX package on the CPU:
hashing, the row gather (plain version vs the Pallas kernel in interpret
mode), sort-unique routing, and the DLRM / DLRM-DCN dense layers. Inputs
are made with numpy from a seed and handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import nn as jnn
from deeprec_tpu.ops import dedup as jdedup
from deeprec_tpu.ops.fused_lookup import gather_rows as jax_gather_rows
from deeprec_tpu.utils import hashing as jhash
from deeprec_tpu_torch import nn as tnn
from deeprec_tpu_torch.ops import dedup as tdedup
from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain
from deeprec_tpu_torch.utils import hashing as thash

torch.set_num_threads(1)

INT32_MIN = int(np.iinfo(np.int32).min)


def _edge_ids(rng, n):
    ids = rng.integers(INT32_MIN, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    ids[:4] = [INT32_MIN, -1, 0, 2**31 - 1]
    return ids


def test_mix32_fold64_bit_exact_int32():
    ids = _edge_ids(np.random.default_rng(0), 4096)
    want = np.asarray(jhash.mix32(jhash.fold64(jnp.asarray(ids)))).astype(np.int64)
    got = thash.mix32(thash.fold64(torch.from_numpy(ids))).numpy()
    np.testing.assert_array_equal(got, want)


def test_fold64_bit_exact_int64_against_numpy_mirror():
    """64-bit ids only exist in JAX with x64 on; its numpy mirror is the
    package's own reference for the int64 branch."""
    rng = np.random.default_rng(1)
    ids = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    want = jhash.mix32_np(jhash.fold64_np(ids)).astype(np.int64)
    got = thash.mix32(thash.fold64(torch.from_numpy(ids))).numpy()
    np.testing.assert_array_equal(got, want)


def test_name_salt_matches():
    for name in ("C1", "group0", "user_id"):
        assert thash.name_salt(name) == jhash.name_salt(name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 37])
def test_gather_rows_plain_matches_pallas_interpret(dtype, n):
    """Bit-exact, with negative and past-the-end indices (clamped per
    table) and n not a multiple of the Pallas block (8)."""
    rng = np.random.default_rng(2)
    T, C, D = 3, 64, 16
    vals = rng.normal(0, 1, (T, C, D)).astype(np.float32)
    ix = rng.integers(-10, C + 10, (T, n)).astype(np.int32)
    ix[:, 0] = -3 if n == 1 else ix[:, 0]
    jv = jnp.asarray(vals).astype(dtype)
    want = np.stack([
        np.asarray(jax_gather_rows(jv[t], jnp.asarray(ix[t]), interpret=True)
                   .astype(jnp.float32))
        for t in range(T)
    ])
    tv = torch.from_numpy(vals).to(getattr(torch, dtype))
    for fn in (gather_rows_plain, gather_rows):  # the wrapper on a CPU tensor
        got = fn(tv, torch.from_numpy(ix)).to(torch.float32).numpy()
        np.testing.assert_array_equal(got, want)


def test_gather_rows_rejects_bad_input():
    v = torch.zeros((1, 4, 2))
    with pytest.raises(TypeError):
        gather_rows(v.to(torch.float16), torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_rows(v[0], torch.zeros((3,), dtype=torch.int32))


@pytest.mark.parametrize("pad_frac", [0.0, 0.3])
def test_route_ids_matches_jax(pad_frac):
    """uids as a multiset (here even element-wise: both sort), counts per
    id, and uids[inverse] rebuilding the padded-to-sentinel input."""
    rng = np.random.default_rng(3)
    T, B, L = 4, 50, 3
    ids = rng.integers(0, 40, (T, B, L)).astype(np.int32)
    ids[rng.random((T, B, L)) < pad_frac] = -1
    got = tdedup.route_ids(torch.from_numpy(ids), pad_value=-1,
                           sentinel=INT32_MIN, lead=1)
    for t in range(T):
        want = jdedup.route_ids(jnp.asarray(ids[t]), pad_value=-1,
                                sentinel=INT32_MIN)
        uids, inv, counts, valid = (g[t].numpy() for g in got[:4])
        wuids, winv, wcounts, wvalid = (np.asarray(w) for w in want[:4])
        np.testing.assert_array_equal(np.sort(uids), np.sort(wuids))
        assert dict(zip(uids[valid], counts[valid])) == dict(
            zip(wuids[wvalid], wcounts[wvalid]))
        np.testing.assert_array_equal(counts[~valid], 0)
        flat = np.where(ids[t] == -1, INT32_MIN, ids[t])
        np.testing.assert_array_equal(uids[inv], flat)
        np.testing.assert_array_equal(wuids[winv], flat)


def _np_layers(rng, dims):
    return [
        {"w": rng.normal(0, 0.3, (a, b)).astype(np.float32),
         "b": rng.normal(0, 0.1, (b,)).astype(np.float32)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def _to(layers, f):
    return [{k: f(v) for k, v in layer.items()} for layer in layers]


def test_dense_layers_match_jax():
    """mlp (bf16 operands, f32 accumulation) and the f32 cross net; the
    only difference allowed is f32 summation order (rtol 1e-5)."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (32, 24)).astype(np.float32)
    mlp = _np_layers(rng, [24, 40, 8])
    cross = _np_layers(rng, [24, 24, 24])
    want = np.asarray(jax.jit(jnn.mlp_apply)({"layers": _to(mlp, jnp.asarray)},
                                             jnp.asarray(x)))
    got = tnn.mlp_apply(_to(mlp, torch.from_numpy), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(jax.jit(jnn.crossnet_apply)(
        {"layers": _to(cross, jnp.asarray)}, jnp.asarray(x)))
    got = tnn.crossnet_apply(_to(cross, torch.from_numpy), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dot_interaction_matches_jax():
    x = np.random.default_rng(5).normal(0, 1, (6, 5, 4)).astype(np.float32)
    want = np.asarray(jnn.dot_interaction(jnp.asarray(x)))
    got = tnn.dot_interaction(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("filter_freq", [0, 3])
def test_readonly_lookup_matches_jax(value_dtype, filter_freq):
    """A JAX table filled by train lookups (frequencies 1..4), carried
    across slot for slot: the port's read-only lookup serves the same row
    at every position — live ids, ids the counter filter blocks, unseen ids
    and pad ids — bit for bit."""
    from deeprec_tpu import config as jcfg
    from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch.convert import table_state_from_arrays
    from deeprec_tpu_torch.embedding.table import EmbeddingTable

    def cfg(mod):
        cf = mod.CounterFilter(filter_freq) if filter_freq else None
        ev = mod.EmbeddingVariableOption(
            counter_filter=cf,
            init=mod.InitializerOption(default_value_no_permission=0.25))
        return mod.TableConfig(name="t", dim=8, capacity=256, ev=ev,
                               value_dtype=value_dtype)

    rng = np.random.default_rng(6)
    jt = JaxTable(cfg(jcfg))
    st = jt.create()
    for k in range(4):  # id i is seen (i % 4) + 1 times; one shape, one compile
        ids = np.where(np.arange(100) % 4 >= k, np.arange(100), -1).astype(np.int32)
        st, _ = jt.lookup_unique(st, jnp.asarray(ids), step=k + 1, train=True)
    q = np.concatenate([rng.integers(0, 100, 40), rng.integers(1000, 2000, 10),
                        np.full(6, -1)]).astype(np.int32)
    rng.shuffle(q)
    _, jres = jt.lookup_unique(st, jnp.asarray(q), train=False)
    want = np.asarray(jres.embeddings.astype(jnp.float32))[np.asarray(jres.inverse)]

    tt = EmbeddingTable(cfg(tcfg))
    state = table_state_from_arrays(
        tt.cfg, {"keys": np.asarray(st.keys), "values": np.asarray(
            st.values.astype(jnp.float32)), "meta": np.asarray(st.meta)}, 1, "cpu")
    res = tt.lookup_unique(state, torch.from_numpy(q)[None], train=False)
    got = res.embeddings[0].float().numpy()[res.inverse[0].numpy()]
    np.testing.assert_array_equal(got, want)
    blocked = (q < 0) | (q >= 1000) | ((q % 4) + 1 < filter_freq)
    np.testing.assert_array_equal(got[blocked], 0.25)
    assert not np.any(got[~blocked] == 0.25)


@pytest.mark.parametrize("name", ["DLRM", "DLRMDCN"])
def test_model_forward_matches_jax(name):
    """The port's model on the JAX model's weights (dense.npz leaf order)
    and the same pooled embeddings and dense features: logits within f32
    summation order."""
    from deeprec_tpu import models as jmodels
    from deeprec_tpu.training.trainer import ModelInputs as JaxInputs
    from deeprec_tpu_torch import models as tmodels
    from deeprec_tpu_torch.convert import dense_from_leaves
    from deeprec_tpu_torch.training.trainer import ModelInputs
    from torch.func import functional_call

    kw = dict(emb_dim=8, capacity=64, bottom=(16, 8), top=(16, 1), num_cat=3,
              num_dense=2)
    if name == "DLRMDCN":
        kw["cross_depth"] = 2
    jm, tm = getattr(jmodels, name)(**kw), getattr(tmodels, name)(**kw)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    pooled = {f"C{i + 1}": rng.normal(0, 0.5, (16, 8)).astype(np.float32)
              for i in range(3)}
    dense = {f"I{i + 1}": rng.lognormal(0, 1, (16, 1)).astype(np.float32)
             for i in range(2)}
    want = np.asarray(jax.jit(lambda p, x: jm.apply(p, x, False))(
        params, JaxInputs(pooled={k: jnp.asarray(v) for k, v in pooled.items()},
                          seq={}, dense={k: jnp.asarray(v) for k, v in dense.items()})))
    weights = dense_from_leaves(
        tm, [np.asarray(l) for l in jax.tree_util.tree_leaves(params)], "cpu")
    got = functional_call(tm, weights, (ModelInputs(
        pooled={k: torch.from_numpy(v) for k, v in pooled.items()},
        dense={k: torch.from_numpy(v) for k, v in dense.items()}),)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
