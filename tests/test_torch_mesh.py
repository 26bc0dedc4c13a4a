"""The port's mesh layer held against the JAX package on the CPU: `hash_shard`
and `placement.plan_owner` bit for bit against the JAX functions,
`ops/traffic.py`'s exchange models equal to the JAX ones, `MeshConfig`; and
the collectives of `deeprec_tpu_torch/parallel/mesh.py` on 4 gloo ranks
(separate processes, `tests/torch_sharded_rank.py`) against their numpy
meaning: gathers in rank order, reduce-scatters and all-reduces summed in
rank order (bit for bit, the same on the 1-D and the 2 x 2 mesh), equal and
uneven all-to-alls, bf16 and bool payloads, the 2-D mesh's tiers, batch
slices and `plan_mesh_after_rescale`."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprec_tpu import config as jcfg
from deeprec_tpu.ops import traffic as JT
from deeprec_tpu.parallel import placement as jplacement
from deeprec_tpu.utils import hashing as jhashing
from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.ops import traffic as T
from deeprec_tpu_torch.parallel import placement
from deeprec_tpu_torch.utils import hashing
from torch_sharded_rank import spawn

torch.set_num_threads(1)


def _ids(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    ids[:4] = [0, -1, 2**31 - 1, -2**31]
    return ids


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_hash_shard_matches_jax(n):
    ids = _ids()
    want = np.asarray(jhashing.hash_shard(jnp.asarray(ids), n))
    np.testing.assert_array_equal(hashing.hash_shard(torch.from_numpy(ids), n).numpy(), want)
    np.testing.assert_array_equal(hashing.hash_shard_np(ids, n), want)
    small = np.abs(ids[ids > -2**31]).astype(np.int64)  # int64 ids in int32 range
    np.testing.assert_array_equal(hashing.hash_shard(torch.from_numpy(small), n).numpy(),
                                  hashing.hash_shard_np(small, n))


@pytest.mark.parametrize("stacked", [False, True])
def test_plan_owner_matches_jax(stacked):
    """The uniform hash, and plan leaves (a rotation and a hot-key table
    padded with the sentinel), per member of a stacked bundle."""
    ids = _ids(600, 1).reshape(2, 300) if stacked else _ids(600, 1)
    N = 4
    assert np.array_equal(placement.plan_owner(torch.from_numpy(ids), N).numpy(),
                          np.asarray(jplacement.plan_owner(jnp.asarray(ids), N)))
    hot = ids.reshape(-1)[5:9]
    leaves = {"offset": np.int32(3),
              "hot_keys": np.concatenate([hot, [np.iinfo(np.int32).min]]).astype(np.int32),
              "hot_owners": np.asarray([1, 0, 2, 3, 0], np.int32)}
    if stacked:
        got = placement.plan_owner(torch.from_numpy(ids), N, leaves).numpy()
        want = np.stack([np.asarray(jplacement.plan_owner(
            jnp.asarray(ids[t]), N, {k: jnp.asarray(v) for k, v in leaves.items()}))
            for t in range(2)])
    else:
        got = placement.plan_owner(torch.from_numpy(ids), N, leaves).numpy()
        want = np.asarray(jplacement.plan_owner(
            jnp.asarray(ids), N, {k: jnp.asarray(v) for k, v in leaves.items()}))
    np.testing.assert_array_equal(got, want)
    assert (got.reshape(-1)[5:9] == [1, 0, 2, 3]).all()


GRID = [dict(unique=u, num_shards=n, slack=s) for u in (1, 37, 512, 4096)
        for n in (1, 2, 4, 8) for s in (1.0, 2.0)]


@pytest.mark.parametrize("kw", GRID[::3] + [GRID[-1]])
def test_flat_exchange_models_match_jax(kw):
    np.testing.assert_array_equal(T.a2a_dest_budgets(**kw), JT.a2a_dest_budgets(**kw))
    assert T.a2a_bucket_rows(**kw) == JT.a2a_bucket_rows(**kw)
    hot = np.arange(kw["num_shards"]) * 3
    assert np.array_equal(T.a2a_dest_budgets(**kw, dest_hot=hot, hot_count=5),
                          JT.a2a_dest_budgets(**kw, dest_hot=hot, hot_count=5))
    assert (T.a2a_bucket_rows_global(**kw, hot_max=7)
            == JT.a2a_bucket_rows_global(**kw, hot_max=7))
    for d, wb in ((16, 2), (128, 4)):
        b = T.a2a_bucket_rows(**kw)
        assert (T.a2a_exchange_wire_bytes(bucket_rows=b, num_shards=kw["num_shards"], dim=d,
                                          wire_bytes=wb)
                == JT.a2a_exchange_wire_bytes(bucket_rows=b, num_shards=kw["num_shards"],
                                              dim=d, wire_bytes=wb))
        assert T.exchange_row_bytes(dim=d, wire_bytes=wb) == JT.exchange_row_bytes(
            dim=d, wire_bytes=wb)
    loads = np.arange(kw["num_shards"]) * kw["unique"]
    assert T.shard_imbalance(loads) == JT.shard_imbalance(loads)


@pytest.mark.parametrize("intra,inter", [(2, 2), (4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("factor", [None, 1.5])
def test_hier_models_match_jax(intra, inter, factor):
    for U in (1, 64, 700):
        kw = dict(unique=U, intra=intra, inter=inter, group_factor=factor)
        assert (T.hier_group_unique_budget(unique=U, intra=intra, group_factor=factor)
                == JT.hier_group_unique_budget(unique=U, intra=intra, group_factor=factor))
        assert T.hier_relay_rows(unique=U, intra=intra) == JT.hier_relay_rows(unique=U,
                                                                              intra=intra)
        np.testing.assert_array_equal(T.hier_dest_budgets(**kw), JT.hier_dest_budgets(**kw))
        hot = np.arange(intra * inter)
        np.testing.assert_array_equal(T.hier_dest_budgets(**kw, dest_hot=hot, hot_count=9),
                                      JT.hier_dest_budgets(**kw, dest_hot=hot, hot_count=9))
        assert T.hier_bucket_rows(**kw) == JT.hier_bucket_rows(**kw)
        assert (T.hier_exchange_bytes(**kw, dim=16, intra_bw_gbs=900, inter_bw_gbs=50)
                == JT.hier_exchange_bytes(**kw, dim=16, intra_bw_gbs=900, inter_bw_gbs=50))
        for comm in ("a2a", "allgather"):
            args = dict(unique=U, num_shards=intra * inter, intra=intra, comm=comm, dim=16)
            assert T.flat_exchange_tier_bytes(**args) == JT.flat_exchange_tier_bytes(**args)


def test_mesh_config_matches_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(tcfg.MeshConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jcfg.MeshConfig)])


def test_one_position_without_a_process_group():
    """No process group: make_mesh is one position whose collectives give
    back their input, and plan_mesh_after_rescale of a 1-D mesh is 1-D."""
    from deeprec_tpu_torch.parallel import mesh as M
    from deeprec_tpu_torch.parallel.elastic import plan_mesh_after_rescale

    mesh = M.make_mesh(device="cpu")
    x = torch.arange(6.0).reshape(1, 6)
    assert mesh.size == 1 and mesh.index == 0 and M.axis_size(mesh) == 1
    assert torch.equal(M.psum(mesh, x, "data"), x)
    assert torch.equal(M.psum_scatter(mesh, x, "data"), x[0])
    assert plan_mesh_after_rescale(1, mesh).axis_names == ("data",)
    assert torch.equal(M.put_global(np.arange(3), mesh), torch.arange(3))
    tiled = M.put_tiled_global(np.ones((2, 3)), (4, 1), mesh)
    assert tiled.shape == (4, 2, 3) and bool((tiled == 1).all())
    with pytest.raises(ValueError, match="2-D mesh"):
        from deeprec_tpu_torch.parallel.sharded import ShardedTable
        from deeprec_tpu_torch.embedding.table import EmbeddingTable

        ShardedTable(EmbeddingTable(tcfg.TableConfig(name="t", dim=4, capacity=16)), mesh,
                     comm="hier")


@pytest.fixture(scope="module")
def coll(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("coll"), 4,
                 [dict(name="c", kind="collectives")], "coll")["c"]


def _inputs():
    return [np.random.default_rng(100 + r).standard_normal((4, 3, 5)).astype(np.float32)
            for r in range(4)]


def _rank_sum(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x  # float32, in rank order
    return acc


@pytest.mark.parametrize("tag", ["1d", "2d"])
def test_collectives_in_rank_order(coll, tag):
    xs = _inputs()
    for r, o in enumerate(coll):
        assert int(o[f"{tag}:index"]) == r
        np.testing.assert_array_equal(o[f"{tag}:gather"], np.stack(xs))
        np.testing.assert_array_equal(o[f"{tag}:psum_scatter"], _rank_sum([x[r] for x in xs]))
        np.testing.assert_array_equal(o[f"{tag}:psum"], _rank_sum(xs))
        np.testing.assert_array_equal(o[f"{tag}:pmean"], _rank_sum(xs) / np.float32(4))
        np.testing.assert_array_equal(o[f"{tag}:a2a"], np.stack([x[r] for x in xs]))
        bf = torch.from_numpy(np.stack([x[r] for x in xs])).to(torch.bfloat16).float()
        np.testing.assert_array_equal(o[f"{tag}:a2a_bf16"], bf.numpy())
        np.testing.assert_array_equal(o[f"{tag}:gather_bool"], np.stack(xs) > 0)
        assert bool(o[f"{tag}:objects"])
        np.testing.assert_array_equal(o[f"{tag}:shard"], np.arange(16).reshape(8, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o[f"{tag}:shard_stacked"],
                                      np.arange(24).reshape(3, 8)[:, 2 * r:2 * r + 2])
        # uneven all-to-all: position j sent (j + r) % 3 rows of value 10 j + r to r
        counts = [(j + r) % 3 for j in range(4)]
        np.testing.assert_array_equal(o[f"{tag}:uneven_counts"], counts)
        want = np.concatenate([np.full((c, 2), 10 * j + r) for j, c in enumerate(counts)])
        np.testing.assert_array_equal(o[f"{tag}:uneven"], want.reshape(-1, 2))


def test_2d_tiers_group_host_major(coll):
    """Position (g, i) = flat rank 2 g + i; the intra tier is its host
    group (same g), the inter tier the positions of its intra index."""
    xs = _inputs()
    for r, o in enumerate(coll):
        g, i = divmod(r, 2)
        assert int(o["2d:intra:index"]) == i and int(o["2d:inter:index"]) == g
        intra = [2 * g + k for k in range(2)]
        inter = [2 * k + i for k in range(2)]
        np.testing.assert_array_equal(o["2d:intra:gather"], np.stack([xs[k][:2] for k in intra]))
        np.testing.assert_array_equal(o["2d:inter:gather"], np.stack([xs[k][:2] for k in inter]))
        np.testing.assert_array_equal(o["2d:intra:psum_scatter"],
                                      _rank_sum([xs[k][:2][i] for k in intra]))
        np.testing.assert_array_equal(o["2d:inter:psum_scatter"],
                                      _rank_sum([xs[k][:2][g] for k in inter]))
