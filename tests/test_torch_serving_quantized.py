"""The port's quantized serving residencies (train f32, serve bf16 or int8)
held against the JAX package on the same checkpoints: `quantize_rows_int8`
bit for bit; an int8 Predictor's rows (q and scale) bit for bit per key and
its answers within PROB_ATOL of the JAX int8 Predictor; a bf16 Predictor's
rows within one bf16 ulp (the stochastic-rounding bits are the port's own)
and its answers within BF16_PROB_ATOL; the residency bytes; delta replay
and the prune rebuild carrying the scale; the int8 train-lookup raise."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.embedding.table import EmbeddingTable as JaxTable
from deeprec_tpu.embedding.table import quantize_rows_int8 as jax_quantize
from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad
from deeprec_tpu.serving import Predictor as JaxPredictor
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.embedding.table import QMAX, EmbeddingTable, quantize_rows_int8
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.serving import Predictor

torch.set_num_threads(1)

KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32, 16), num_cat=4, num_dense=2)
# f32 dense layers in another summation order (tests/test_torch_serving.py)
PROB_ATOL = 1e-4
# bf16 rows one ulp apart (2^-8 relative) move a probability further;
# measured max |diff| over these batches: 2.4e-4.
BF16_PROB_ATOL = 1e-3


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def strip(b):
    return {k: np.asarray(v) for k, v in b.items() if not k.startswith("label")}


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """4 JAX train steps and a full save; the trainer, state, manager and
    generator stay for deltas."""
    d = str(tmp_path_factory.mktemp("quant"))
    tr = JaxTrainer(JaxWDL(**KW), Adagrad(lr=0.1), optax.adam(1e-3))
    st = tr.init(0)
    gen = SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2, vocab=2000, seed=7)
    for _ in range(4):
        st, _ = tr.train_step(st, J(gen.batch()))
    ck = JaxCkpt(d, tr)
    st, _ = ck.save(st)
    return dict(dir=d, tr=tr, st=st, ck=ck, gen=gen, req=strip(gen.batch()))


def _rows_by_key(keys, values, qscale=None):
    keys = np.asarray(keys).reshape(-1)
    values = np.asarray(values).reshape(keys.shape[0], -1)
    live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
    scale = None if qscale is None else np.asarray(qscale).reshape(-1)
    return {int(keys[i]): (values[i], None if scale is None else scale[i]) for i in live}


def _port_rows(p, name):
    ts = p._trainer.table_state(p._state, name)
    vals = ts.values[0]
    if vals.dtype == torch.bfloat16:
        vals = vals.float()
    return _rows_by_key(ts.keys[0].numpy(), vals.numpy(),
                        None if ts.qscale is None else ts.qscale[0].numpy())


def _jax_rows(p, name):
    ts = p._trainer.table_state(p._state, name)
    vals = np.asarray(ts.values.astype(jnp.float32)) if ts.values.dtype == jnp.bfloat16 \
        else np.asarray(ts.values)
    return _rows_by_key(ts.keys, vals, ts.qscale)


# --------------------------------------------------------- the quantizer


@pytest.mark.parametrize("case", ["normal", "zeros", "tiny", "huge", "halves"])
def test_quantize_rows_int8_matches_jax_bit_for_bit(case):
    rng = np.random.default_rng(1)
    rows = {
        "normal": rng.standard_normal((64, 16)).astype(np.float32) * 0.05,
        "zeros": np.zeros((4, 8), np.float32),
        "tiny": rng.standard_normal((16, 8)).astype(np.float32) * 1e-38,
        "huge": rng.standard_normal((16, 8)).astype(np.float32) * 1e30,
        # q = row / scale lands exactly on .5: rounds half to even in both
        "halves": np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 63.5, -126.5]], np.float32),
    }[case]
    # as the JAX restore calls it (`import_rows` runs eagerly)
    jq, js = jax_quantize(jnp.asarray(rows))
    q, s = quantize_rows_int8(torch.tensor(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(q.abs().max()) <= QMAX


# ------------------------------------------------------------ residency


def test_int8_rows_and_answers_match_jax(chain):
    """The int8 residency of one checkpoint: per key the same int8 row and
    the same f32 scale as the JAX int8 Predictor; answers within
    PROB_ATOL of it, and within the JAX test's 5e-3 of f32."""
    p8 = Predictor(WDL(**KW), chain["dir"], device="cpu", quantize="int8")
    j8 = JaxPredictor(JaxWDL(**KW), chain["dir"], quantize="int8")
    for f in p8._trainer.sparse_specs:
        got, want = _port_rows(p8, f.name), _jax_rows(j8, f.name)
        assert got.keys() == want.keys() and len(got) > 0
        for k, (row, scale) in got.items():
            assert row.dtype == np.int8
            np.testing.assert_array_equal(row, want[k][0])
            assert scale == want[k][1]
    a = p8.predict(chain["req"])
    np.testing.assert_allclose(a, np.asarray(j8.predict(chain["req"])), rtol=0,
                               atol=PROB_ATOL)
    f32 = Predictor(WDL(**KW), chain["dir"], device="cpu").predict(chain["req"])
    assert np.abs(a - f32).max() < 5e-3


def test_bf16_rows_and_answers_match_jax(chain):
    """The bf16 residency: per key within one bf16 ulp of the JAX bf16
    Predictor's rows (the import's stochastic rounding draws the port's
    bits), answers within BF16_PROB_ATOL of it and within 2e-2 of f32."""
    pb = Predictor(WDL(**KW), chain["dir"], device="cpu", quantize="bf16")
    jb = JaxPredictor(JaxWDL(**KW), chain["dir"], quantize="bf16")
    for f in pb._trainer.sparse_specs:
        got, want = _port_rows(pb, f.name), _jax_rows(jb, f.name)
        assert got.keys() == want.keys()
        for k, (row, _) in got.items():
            ulp = np.abs(want[k][0]) * 2.0 ** -7 + 1e-38
            assert np.all(np.abs(row - want[k][0]) <= ulp), k
    a = pb.predict(chain["req"])
    np.testing.assert_allclose(a, np.asarray(jb.predict(chain["req"])), rtol=0,
                               atol=BF16_PROB_ATOL)
    f32 = Predictor(WDL(**KW), chain["dir"], device="cpu").predict(chain["req"])
    assert np.abs(a - f32).max() < 2e-2


def test_residency_bytes_match_the_model_and_jax(chain):
    """measured == modelled for every residency, the same numbers as the
    JAX residency_info; int8 at most 0.55 of f32, bf16 half."""
    infos = {}
    for q in ("fp32", "bf16", "int8"):
        ri = Predictor(WDL(**KW), chain["dir"], device="cpu", quantize=q).residency_info()
        jri = JaxPredictor(JaxWDL(**KW), chain["dir"], quantize=q).residency_info()
        assert ri["measured_bytes"] == ri["modeled_bytes"] == jri["measured_bytes"]
        assert ri["tables"] == jri["tables"] and ri["quantize"] == jri["quantize"]
        infos[q] = ri["measured_bytes"]
    assert infos["int8"] <= 0.55 * infos["fp32"] and infos["bf16"] * 2 == infos["fp32"]


def test_unknown_quantize_mode_raises(chain):
    with pytest.raises(ValueError, match="quantize must be one of"):
        Predictor(WDL(**KW), chain["dir"], device="cpu", quantize="int4")


# --------------------------------------------------------- updates


def test_int8_delta_replay_matches_jax(chain, tmp_path):
    """Deltas replayed onto an int8 residency (quantize on import, chunked):
    shapes and dtypes stay, per key q and scale equal the JAX int8
    Predictor's after the same polls, answers within PROB_ATOL of it and
    within 5e-3 of a fresh f32 Predictor."""
    import shutil

    d = str(tmp_path / "ck")
    shutil.copytree(chain["dir"], d)
    tr, gen = chain["tr"], SyntheticCriteo(batch_size=128, num_cat=4, num_dense=2,
                                           vocab=2000, seed=8)
    ck = JaxCkpt(d, tr)
    st = chain["st"]
    p8 = Predictor(WDL(**KW), d, device="cpu", quantize="int8", restore_chunk=64)
    j8 = JaxPredictor(JaxWDL(**KW), d, quantize="int8", restore_chunk=64)
    name = p8._trainer.sparse_specs[0].name
    shape0 = {k: (tuple(v.shape), v.dtype) for k, v in dataclasses.asdict(
        p8._trainer.table_state(p8._state, name)).items() if torch.is_tensor(v)}
    for _ in range(2):
        for _ in range(2):
            st, _ = tr.train_step(st, J(gen.batch()))
        st, _ = ck.save_incremental(st)
        assert p8.poll_updates() and j8.poll_updates()
    assert p8.version == j8.version == 2
    shape1 = {k: (tuple(v.shape), v.dtype) for k, v in dataclasses.asdict(
        p8._trainer.table_state(p8._state, name)).items() if torch.is_tensor(v)}
    assert shape0 == shape1
    for f in p8._trainer.sparse_specs:
        got, want = _port_rows(p8, f.name), _jax_rows(j8, f.name)
        assert got.keys() == want.keys()
        for k, (row, scale) in got.items():
            np.testing.assert_array_equal(row, want[k][0])
            assert scale == want[k][1]
    out = p8.predict(chain["req"])
    np.testing.assert_allclose(out, np.asarray(j8.predict(chain["req"])), rtol=0,
                               atol=PROB_ATOL)
    expect = Predictor(WDL(**KW), d, device="cpu").predict(chain["req"])
    assert np.abs(out - expect).max() < 5e-3


def test_prune_rebuild_carries_the_scale(chain):
    """The keep-mask rebuild (the delta replay's prune) moves each row's
    scale with it: surviving keys decode the same, dropped keys serve the
    f32 initializer row as the JAX int8 table does."""
    p8 = Predictor(WDL(**KW), chain["dir"], device="cpu", quantize="int8")
    name = p8._trainer.sparse_specs[0].name
    table = p8._trainer.tables[name]
    ts = p8._trainer.table_state(p8._state, name)
    keys = ts.keys[0].numpy()
    live = keys[keys != np.iinfo(keys.dtype).min]
    assert live.size > 8
    drop = live[: live.size // 2]
    keep = ~torch.isin(ts.keys, torch.as_tensor(drop))
    ids = torch.as_tensor(live[live.size // 2:][:8].reshape(1, -1, 1))
    before = table.lookup_readonly(ts, ids)
    pruned = table.rebuild(ts, keep=keep)
    assert pruned.qscale is not None and pruned.values.dtype == torch.int8
    assert torch.equal(table.lookup_readonly(pruned, ids), before)
    gone = torch.as_tensor(drop[:4].reshape(1, -1))
    got = table.lookup_readonly(pruned, gone)[0]
    assert got.dtype == torch.float32
    jcfg = next(f.table for f in JaxWDL(**KW).features if f.name == name)
    # the port table's own name (a stacked bundle's) salts its initializer
    jt = JaxTable(dataclasses.replace(jcfg, name=table.cfg.name, value_dtype="int8"))
    want = np.asarray(jt._init_rows(jnp.asarray(drop[:4])))
    # the initializer through torch.erfinv: within 65 ulps of XLA's erfinv
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


def test_int8_training_lookup_raises():
    """int8 residency is serving-only: a train-mode lookup fails loudly,
    with the JAX message."""
    m = WDL(emb_dim=8, capacity=1 << 10, hidden=(16,), num_cat=1, num_dense=1)
    cfg = dataclasses.replace(next(f.table for f in m.features if hasattr(f, "table")),
                              value_dtype="int8")
    table = EmbeddingTable(cfg)
    state = table.create(device="cpu")
    assert state.values.dtype == torch.int8 and state.qscale.shape == (1, 1 << 10)
    with pytest.raises(ValueError, match="serving-only"):
        table.lookup_unique(state, torch.arange(8, dtype=torch.int32).reshape(1, -1),
                            train=True)
    state = table.create(device="cpu")
    res = table.lookup_unique(state, torch.arange(8, dtype=torch.int32).reshape(1, -1),
                              train=False)
    assert res.embeddings.dtype == torch.float32
