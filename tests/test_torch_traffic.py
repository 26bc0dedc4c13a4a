"""The port's step-byte, pipelining, reuse and op-count models
(`deeprec_tpu_torch/ops/traffic.py`) held against the JAX package on the
CPU: every byte and reuse model equal to the JAX function with `==` over a
grid (diet on and off, the counter filter, value bytes 4 and 2, slot widths
(0,), (16,) and (16, 16), 1, 4 and 8 shards under allgather and a2a at
imbalance 1.0 and 1.7, every pipeline mode, reuse hit rates and costs, zipf
populations) and raising the same ValueError; `count_device_ops` of the
port's single-table lookup + apply equal to `expected_lookup_apply_ops` on
both apply arms, both dedup front ends and one or two per-row slots; and a
CPU ModelServer's answer cache reaching `zipf_expected_hit_rate` over a
16-user population once every user has been seen."""
import itertools

import numpy as np
import pytest
import torch

from deeprec_tpu.ops import traffic as JT
from deeprec_tpu.training.trainer import PIPELINE_MODES
from deeprec_tpu_torch.ops import traffic as T
from deeprec_tpu_torch.optim.apply import lookup_apply_region

torch.set_num_threads(1)

SLOT_WIDTHS = ((0,), (16,), (16, 16))
SHARDS = ((1, None), (4, "allgather"), (4, "a2a"), (8, "allgather"), (8, "a2a"))


def _same_raise(fn_port, fn_jax, **kw):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as got:
        fn_port(**kw)
    with pytest.raises(ValueError) as want:
        fn_jax(**kw)
    assert str(got.value) == str(want.value)


def test_meta_cols_match_jax_and_the_table():
    """3 int32 metadata columns, the rows of the port's fused [T, 3, C]
    metadata tensor."""
    from deeprec_tpu_torch.config import TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable

    meta = EmbeddingTable(TableConfig(name="m", dim=4, capacity=8)).create(2, "cpu").meta
    assert T.META_COLS == JT.META_COLS == meta.shape[1] == 3
    assert meta.dtype == torch.int32


@pytest.mark.parametrize("diet,counter_filter,value_bytes",
                         list(itertools.product((True, False), (False, True), (4, 2))))
def test_table_step_traffic_matches_jax(diet, counter_filter, value_bytes):
    for sw, (n, comm), imb, wire, U in itertools.product(
            SLOT_WIDTHS, SHARDS, (1.0, 1.7), (4, 2), (1, 137, 2048)):
        kw = dict(unique=U, dim=16, value_bytes=value_bytes, slot_widths=sw, diet=diet,
                  counter_filter=counter_filter, num_shards=n, comm=comm,
                  wire_bytes=wire, imbalance=imb)
        assert T.table_step_traffic(**kw) == JT.table_step_traffic(**kw), kw


@pytest.mark.parametrize("n", [4, 8])
def test_table_step_traffic_unknown_comm_raises_like_jax(n):
    _same_raise(T.table_step_traffic, JT.table_step_traffic, unique=64, dim=8,
                num_shards=n, comm="ring")


@pytest.mark.parametrize("fused,value_bytes",
                         list(itertools.product((True, False), (4, 2))))
def test_fused_sparse_step_traffic_matches_jax(fused, value_bytes):
    for sw, (N, B, U), D in itertools.product(
            SLOT_WIDTHS, ((2048, 2048, 1800), (204_800, 2048, 60_000), (7, 7, 1)),
            (7, 16, 128)):
        kw = dict(positions=N, batch=B, unique=U, dim=D, value_bytes=value_bytes,
                  slot_widths=sw, fused=fused)
        got = T.fused_sparse_step_traffic(**kw)
        assert got == JT.fused_sparse_step_traffic(**kw), kw


@pytest.mark.parametrize("mode", PIPELINE_MODES)
def test_dlrm_reference_traffic_matches_jax(mode):
    for (n, comm), diet, dtype, uf, sw in itertools.product(
            SHARDS, (True, False), ("float32", "bfloat16"), (1.0, 0.37, 0.0001),
            SLOT_WIDTHS):
        kw = dict(num_shards=n, comm=comm, diet=diet, exchange_dtype=dtype,
                  unique_fraction=uf, slot_widths=sw, pipeline_mode=mode)
        assert T.dlrm_reference_traffic(**kw) == JT.dlrm_reference_traffic(**kw), kw
    full = dict(batch=2048, num_tables=26, dim=128, slot_widths=(128,))
    assert T.dlrm_reference_traffic(**full)["total_bytes"] == 110_755_840.0


@pytest.mark.parametrize("mode", PIPELINE_MODES)
def test_pipeline_buffer_bytes_matches_jax(mode):
    for (n, comm), U, pos, vb, kb in itertools.product(
            SHARDS, (1, 136, 2048), (None, 2048, 204_800), (4, 2), (4, 8)):
        kw = dict(unique=U, dim=128, positions=pos, value_bytes=vb, key_bytes=kb,
                  num_shards=n, comm=comm, pipeline_mode=mode)
        assert T.pipeline_buffer_bytes(**kw) == JT.pipeline_buffer_bytes(**kw), kw


@pytest.mark.parametrize("mode", PIPELINE_MODES)
def test_modeled_overlap_step_matches_jax(mode):
    for d, r, o in itertools.product((0.0, 3.25, 12.5, -1.0), (0.0, 4.0, 20.125),
                                     (0.0, 7.5)):
        kw = dict(dense_ms=d, route_ms=r, other_ms=o, mode=mode, chunks=4)
        assert T.modeled_overlap_step(**kw) == JT.modeled_overlap_step(**kw), kw


@pytest.mark.parametrize("hit_cost_ratio", [0.0, 0.1379, 0.5, 0.999, 2.0])
def test_serving_reuse_speedup_matches_jax(hit_cost_ratio):
    for h in (0.0, 0.25, 0.5, 0.7742, 0.999, 1.0):
        kw = dict(hit_rate=h, hit_cost_ratio=hit_cost_ratio)
        if h == 1.0 and hit_cost_ratio == 0.0:
            _same_raise(T.serving_reuse_speedup, JT.serving_reuse_speedup, **kw)
            continue
        assert T.serving_reuse_speedup(**kw) == JT.serving_reuse_speedup(**kw), kw


@pytest.mark.parametrize("kw", [dict(hit_rate=-0.1), dict(hit_rate=1.5),
                                dict(hit_rate=0.5, hit_cost_ratio=-1.0),
                                dict(hit_rate=1.0, hit_cost_ratio=0.0)])
def test_serving_reuse_speedup_raises_like_jax(kw):
    _same_raise(T.serving_reuse_speedup, JT.serving_reuse_speedup, **kw)


@pytest.mark.parametrize("hit_cost_ratio", [0.0, 0.1379, 0.5, -0.25])
def test_reuse_hit_rate_for_speedup_matches_jax(hit_cost_ratio):
    for s in (1.0, 1.5, 2.0, 6.87, 1000.0):
        kw = dict(speedup=s, hit_cost_ratio=hit_cost_ratio)
        got = T.reuse_hit_rate_for_speedup(**kw)
        assert got == JT.reuse_hit_rate_for_speedup(**kw), kw
        if 0.0 <= got <= 1.0 and hit_cost_ratio >= 0.0 and got * (1 - hit_cost_ratio) < 1:
            back = T.serving_reuse_speedup(hit_rate=got, hit_cost_ratio=hit_cost_ratio)
            assert back == pytest.approx(s, rel=1e-9)


@pytest.mark.parametrize("kw", [dict(speedup=0.5), dict(speedup=2.0, hit_cost_ratio=1.0)])
def test_reuse_hit_rate_for_speedup_raises_like_jax(kw):
    _same_raise(T.reuse_hit_rate_for_speedup, JT.reuse_hit_rate_for_speedup, **kw)


@pytest.mark.parametrize("users,alpha", [(1, 1.1), (16, 1.1), (64, 1.1), (64, 0.0),
                                         (1000, 1.6)])
def test_zipf_expected_hit_rate_matches_jax(users, alpha):
    for resident in sorted({0, 1, users // 4, users, users + 5}):
        kw = dict(users=users, alpha=alpha, resident=resident)
        assert T.zipf_expected_hit_rate(**kw) == JT.zipf_expected_hit_rate(**kw), kw


@pytest.mark.parametrize("kw", [dict(users=0, alpha=1.1, resident=0),
                                dict(users=8, alpha=1.1, resident=-1)])
def test_zipf_expected_hit_rate_raises_like_jax(kw):
    _same_raise(T.zipf_expected_hit_rate, JT.zipf_expected_hit_rate, **kw)


# ------------------------------------------------------------------ op counts


def _optimizer(name):
    from deeprec_tpu_torch.optim.sparse import Adagrad, Adam

    return {"adagrad": (Adagrad(lr=0.1), 1), "adam": (Adam(lr=0.01), 2)}[name]


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
@pytest.mark.parametrize("budgeted", [True, False])
@pytest.mark.parametrize("diet", [True, False])
def test_count_device_ops_equals_the_model(opt, budgeted, diet):
    """The port's single-table lookup + apply program on the CPU dispatches
    what `expected_lookup_apply_ops` says, and its row-kernel calls are the
    per-row-slot share: the value gather (legacy arm only), one gather per
    slot, the initializer write and one write per row and slot."""
    sparse, n_slots = _optimizer(opt)
    region = lookup_apply_region(sparse, diet=diet, budgeted=budgeted, device="cpu")
    got = T.count_device_ops(region)
    assert {k: got[k] for k in ("gather", "scatter")} == T.expected_lookup_apply_ops(
        diet=diet, budgeted=budgeted, n_row_slots=n_slots)
    assert got["row_gather"] == 1 + (0 if diet else 1) + n_slots
    assert got["row_scatter"] == 2 + n_slots


def test_expected_lookup_apply_ops_keeps_the_jax_signature_and_arms():
    """Same keywords and keys as the JAX model; the legacy apply costs 2
    gathers and 1 scatter more on the port, each extra per-row slot one of
    each."""
    for budgeted, n in itertools.product((True, False), (1, 2, 3)):
        d = T.expected_lookup_apply_ops(diet=True, budgeted=budgeted, n_row_slots=n)
        legacy = T.expected_lookup_apply_ops(diet=False, budgeted=budgeted, n_row_slots=n)
        assert set(d) == set(JT.expected_lookup_apply_ops(budgeted=budgeted)) == {
            "gather", "scatter"}
        assert (legacy["gather"] - d["gather"], legacy["scatter"] - d["scatter"]) == (2, 1)
        one = T.expected_lookup_apply_ops(budgeted=budgeted)
        assert (d["gather"] - one["gather"], d["scatter"] - one["scatter"]) == (n - 1, n - 1)


def test_count_device_ops_counts_dispatched_ops_once():
    """Ops called from Python count once by class; a row-kernel call counts
    once whatever its plain version dispatches inside it; ops outside the
    region do not count."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    values = torch.zeros((1, 8, 4))
    ix = torch.tensor([[1, 3, 5]], dtype=torch.int32)
    x = torch.arange(8.0)

    def region():
        x[torch.tensor([0, 2])]                     # aten::index: a gather
        x.gather(0, torch.tensor([1, 1]))           # a gather
        x.clone().scatter_add_(0, torch.tensor([0]), torch.tensor([1.0]))  # a scatter
        x.clone()[torch.tensor([3])] = 1.0          # aten::index_put_: a scatter
        torch.take_along_dim(x, torch.tensor([4]))  # a gather (its gather not again)
        rows = gather_rows(values, ix)              # one row gather
        apply_rows_sr(values, ix, rows + 1.0)       # one row scatter
        x.sum()                                     # neither

    x[torch.tensor([1])]  # outside the region
    assert T.count_device_ops(region) == {"gather": 4, "scatter": 3, "row_gather": 1,
                                          "row_scatter": 1}


# --------------------------------------------------------------- compute reuse


@pytest.fixture(scope="module")
def wdl_ckpt(tmp_path_factory):
    """A small WDL trained 3 steps by the port and saved; a request batch."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    kw = dict(emb_dim=8, capacity=1 << 12, hidden=(16,), num_cat=4, num_dense=2)
    tr = Trainer(WDL(**kw), Adagrad(lr=0.1), adam(1e-3), device="cpu")
    st = tr.init()
    gen = SyntheticCriteo(batch_size=64, num_cat=4, num_dense=2, vocab=500, seed=5)
    for _ in range(3):
        st, _ = tr.train_step(st, gen.batch())
    d = str(tmp_path_factory.mktemp("reuse"))
    CheckpointManager(d, tr).save(st)
    req = {k: v for k, v in gen.batch().items() if not k.startswith("label")}
    return kw, d, req


def _user_payload(req, u, rows=4):
    """User u's persistent request: a `rows`-slice with the dense columns
    shifted by u * 1e-3 and the categorical ones rolled by u (distinct
    fingerprints, one shape)."""
    out = {}
    for k, v in req.items():
        a = np.asarray(v)
        out[k] = (a[:rows] + a.dtype.type(u) * a.dtype.type(1e-3)
                  if np.issubdtype(a.dtype, np.floating) else np.roll(a, u, axis=0)[:rows])
    return out


@pytest.mark.parametrize("alpha", [0.8, 1.1, 1.6])
def test_answer_cache_reaches_the_zipf_model(wdl_ckpt, alpha):
    """16 users, each seen once; then 96 zipf(alpha) requests: every one a
    hit at the live version, the rate `zipf_expected_hit_rate(resident=16)`
    gives, and each hit equal to its user's first answer bit for bit."""
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.serving import ModelServer, Predictor

    kw, d, req = wdl_ckpt
    users = 16
    pool = [_user_payload(req, u) for u in range(users)]
    server = ModelServer(Predictor(WDL(**kw), d, device="cpu"), max_batch=16,
                         reuse_cache_bytes=1 << 20)
    try:
        first = [server.request_versioned(p) for p in pool]
        h0, m0 = server.reuse.hits, server.reuse.misses
        assert (h0, m0) == (0, users)
        ranks = np.arange(1, users + 1, dtype=np.float64) ** -alpha
        draw = np.random.default_rng(7).choice(users, 96, p=ranks / ranks.sum())
        for u in draw:
            out, ver = server.request_versioned(pool[u])
            assert ver == first[u][1]
            np.testing.assert_array_equal(out, first[u][0])
        hits, misses = server.reuse.hits - h0, server.reuse.misses - m0
        want = T.zipf_expected_hit_rate(users=users, alpha=alpha, resident=users)
        assert hits / (hits + misses) == want == 1.0
        assert len(server.reuse) == users
        assert server.reuse.occupancy_bytes() <= server.reuse.capacity_bytes
    finally:
        server.close()
