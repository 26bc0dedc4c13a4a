"""The port's sharded trainer (`deeprec_tpu_torch/parallel/`) held against
the JAX package's ShardedTrainer on the CPU.

The JAX side runs in this process on the virtual CPU devices of
tests/conftest.py; the port runs as 2 or 4 gloo ranks, separate processes
(`tests/torch_sharded_rank.py`: torch and the port only) meeting through a
file:// rendezvous under tmp_path. Both start from the JAX state of
`init(0)`, carried with `convert.sharded_train_state_from_arrays`, and
train a small DLRM-DCN (emb 16, 4 categorical and 3 dense features, global
batch 64) 3 steps on the same batches.

Tolerances: losses within 1e-4 relative and rows within (1e-4 rel, 1e-5
abs), as the single-device slice's (tests/test_torch_training.py): the
same f32 math in another summation order, bf16 operand rounding in the
MLPs and initializer rows within 2 ulps of XLA's erfinv; with the f32
exchange wire. With the default bf16 wire a gradient element that sits at
a bf16 rounding boundary can round to the neighbouring bf16 value in one
package and not the other (2^-8 relative of that element), so the bf16
case holds losses within 1e-3 relative. The integer state (keys, freq and
version, the insert, dedup, a2a overflow and owner counters per shard) is
equal exactly. Within the port the flat comms are bitwise equal on a 1-D
and a 2-D mesh, "lookahead", "chunked" and "nested" bitwise equal to "off",
and part files saved at 4 positions restore exactly at 2 and 1.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from deeprec_tpu.data import SyntheticCriteo
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.parallel import ShardedTrainer as JaxSharded
from deeprec_tpu.parallel import make_mesh as jax_mesh
from deeprec_tpu.parallel import make_mesh_2d as jax_mesh_2d
from torch_sharded_rank import spawn as _spawn

KW = dict(emb_dim=16, capacity=1 << 10, bottom=(16, 16), top=(16, 1), num_cat=4,
          num_dense=3, cross_depth=2)
LR, DENSE_LR, B, STEPS = 0.05, 1e-3, 64, 3
BASE = dict(model=KW, lr=LR, dense_lr=DENSE_LR)
RTOL, ATOL, BF16_RTOL = 1e-4, 1e-5, 1e-3
SENTINEL = int(np.iinfo(np.int32).min)
COUNTERS = ("insert_fails", "dedup_unique", "dedup_ids", "dedup_overflow",
            "a2a_overflow", "owner_arrivals", "owner_unique")


def _batches(n=7, seed=0):
    gen = SyntheticCriteo(batch_size=B, num_cat=KW["num_cat"], num_dense=KW["num_dense"],
                          vocab=500, seed=seed)
    return [gen.batch() for _ in range(n)]


# ------------------------------------------------------------- JAX side


def _jax_model(exchange="bfloat16"):
    model = JaxDLRMDCN(**KW)
    if exchange != "bfloat16":
        model.features = [
            dataclasses.replace(f, table=dataclasses.replace(f.table, exchange_dtype=exchange))
            if getattr(f, "table", None) is not None else f for f in model.features]
    return model


def _jax_trainer(mesh, comm, exchange="bfloat16"):
    return JaxSharded(_jax_model(exchange), JaxAdagrad(lr=LR), optax.adam(DENSE_LR),
                      mesh=mesh, comm=comm)


def export_jax_state(jst, path):
    """The JAX sharded state as the rank helper's .npz (`load_state`)."""
    out = {"step": np.asarray(int(jst.step))}
    for bname, ts in jst.tables.items():
        for f in dataclasses.fields(ts):
            v = getattr(ts, f.name)
            if v is None:
                continue
            if f.name == "slots":
                for s, a in v.items():
                    out[f"t:{bname}:slots:{s}"] = np.asarray(a)
            else:
                out[f"t:{bname}:{f.name}"] = np.asarray(v)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jst.dense)):
        out[f"d{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree_util.tree_leaves(jst.opt_state)):
        out[f"o{i}"] = np.asarray(leaf)
    np.savez(path, **out)


def jax_rows(jtr, jst):
    """{(bundle, member, key): (shard, value, accum, freq, version)} and
    {(bundle, member, shard, counter): value}."""
    rows, counters = {}, {}
    for bname, b in jtr.bundles.items():
        ts = jst.tables[bname]
        keys = np.asarray(ts.keys)
        vals = np.asarray(ts.values.astype(jnp.float32))
        acc = np.asarray(ts.slots["accum"])
        meta = np.asarray(ts.meta)
        if not b.stacked:
            keys, vals, acc, meta = keys[None], vals[None], acc[None], meta[None]
        T, N = keys.shape[:2]
        for t in range(T):
            for s in range(N):
                for c in np.nonzero(keys[t, s] != SENTINEL)[0]:
                    rows[(bname, t, int(keys[t, s, c]))] = (
                        s, vals[t, s, c].reshape(-1), acc[t, s, c].reshape(-1),
                        int(meta[t, s, 0, c]), int(meta[t, s, 1, c]))
        for name in COUNTERS:
            v = np.asarray(getattr(ts, name)).reshape(T, N) if b.stacked else \
                np.asarray(getattr(ts, name)).reshape(1, N)
            for t in range(T):
                for s in range(N):
                    counters[(bname, t, s, name)] = int(v[t, s])
    return rows, counters


def port_rows(outs):
    """The same two maps from every rank's output."""
    rows, counters = {}, {}
    for s, o in enumerate(outs):
        for key in o:
            if key.startswith("r:") and key.endswith(":key"):
                bname = key.split(":")[1]
                mem, k = o[f"r:{bname}:member"], o[f"r:{bname}:key"]
                for i in range(len(k)):
                    rows[(bname, int(mem[i]), int(k[i]))] = (
                        s, o[f"r:{bname}:value"][i], o[f"r:{bname}:accum"][i].reshape(-1),
                        int(o[f"r:{bname}:meta"][i][0]), int(o[f"r:{bname}:meta"][i][1]))
            if key.startswith("c:"):
                _, bname, name = key.split(":")
                for t, v in enumerate(o[key]):
                    counters[(bname, t, s, name)] = int(v)
    return rows, counters


def assert_rows_agree(got, want, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k, (ws, wv, wa, wf, wver) in want.items():
        gs, gv, ga, gf, gver = got[k]
        assert (gs, gf, gver) == (ws, wf, wver), k  # owner shard, freq, version
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol, err_msg=str(k))
        np.testing.assert_allclose(ga, wa, rtol=rtol, atol=atol, err_msg=str(k))


def assert_same_bits(a, b):
    """Two port runs (one rank's outputs each): the same losses, rows and
    dense parameters bit for bit."""
    np.testing.assert_array_equal(a["losses"], b["losses"])
    for k in a:
        if k.startswith(("r:", "d:", "c:")) and "owner" not in k:
            # a save clears the dirty column: freq and version only
            x, y = (a[k][:, :2], b[k][:, :2]) if k.endswith(":meta") else (a[k], b[k])
            np.testing.assert_array_equal(x, y, err_msg=k)


def _jax_run(mesh, comm, batches, exchange="bfloat16"):
    """3 JAX steps: (rows, counters, losses, dense leaves) as host values."""
    jtr = _jax_trainer(mesh, comm, exchange)
    jst = jtr.init(0)
    losses = []
    for b in batches[:STEPS]:
        jst, m = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    rows, counters = jax_rows(jtr, jst)
    return rows, counters, losses, [np.asarray(x) for x in jax.tree_util.tree_leaves(jst.dense)]


def shared(tmp_path_factory, name, compute):
    """compute(directory) once per test run: pytest-xdist workers that need
    the same fixture wait on a lock and load the first one's pickled result
    (a worker gets any test of a module, so a module fixture would run once
    per worker)."""
    import fcntl
    import pickle

    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return compute(str(tmp_path_factory.mktemp(name)))
    root = tmp_path_factory.getbasetemp().parent
    d, path = root / f"{name}-{uid}", root / f"{name}-{uid}.pkl"
    with open(root / f"{name}-{uid}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        d.mkdir(exist_ok=True)
        res = compute(str(d))
        with open(path, "wb") as f:
            pickle.dump(res, f)
        return res


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """N = 4: the JAX allgather, a2a (1-D) and hier (2 x 2) runs with the f32
    wire and an allgather run with the bf16 wire; the port's matching runs,
    the flat comms on the 2 x 2 mesh, the pipeline modes against "off" over
    two windows of K = 2, and a part-file save, on 4 gloo ranks."""
    return shared(tmp_path_factory, "sharded4", _four)


def _four(tmp):
    batches = _batches()
    m1, m2 = jax_mesh(4), jax_mesh_2d(2, 2)
    jax_runs = {"ag": _jax_run(m1, "allgather", batches, "float32"),
                "a2a": _jax_run(m1, "a2a", batches, "float32"),
                "hier": _jax_run(m2, "hier", batches, "float32"),
                "ag_bf16": _jax_run(m1, "allgather", batches)}
    state = os.path.join(tmp, "jax_init.npz")
    export_jax_state(_jax_trainer(m1, "allgather").init(0), state)
    f32 = dict(state=state, steps=STEPS, exchange_dtype="float32")
    jobs = [dict(name="ag", comm="allgather", mesh=[4], **f32),
            dict(name="a2a", comm="a2a", mesh=[4], **f32),
            dict(name="hier", comm="hier", mesh=[2, 2], **f32),
            dict(name="ag_bf16", comm="allgather", mesh=[4], state=state, steps=STEPS),
            dict(name="ag_2d", comm="allgather", mesh=[2, 2], state=state, steps=STEPS),
            dict(name="a2a_2d", comm="a2a", mesh=[2, 2], state=state, steps=STEPS),
            dict(name="a2a_1d", comm="a2a", mesh=[4], state=state, steps=STEPS)]
    for mode, comm, mesh in (("off", "hier", [2, 2]), ("lookahead", "hier", [2, 2]),
                             ("nested", "hier", [2, 2]), ("off", "a2a", [4]),
                             ("chunked", "a2a", [4])):
        jobs.append(dict(name=f"{mode}_{comm}", comm=comm, mesh=mesh, mode=mode, state=state,
                         steps=4, window=2, chunks=3, unique_budget=48))
    jobs[-1].update(save=os.path.join(tmp, "parts"), eval=[5, 7], after=4)
    jobs.append(dict(name="restored4", comm="a2a", mesh=[4], restore=jobs[-1]["save"],
                     steps=1, first=4))
    port = spawn(tmp, 4, jobs, batches, "w4")
    return dict(batches=batches, jax=jax_runs, port=port, parts=jobs[-2]["save"])


@pytest.mark.parametrize("comm", ["ag", "a2a", "hier"])
def test_losses_and_rows_match_jax_at_4(four, comm):
    want_rows, want_c, jlosses, _ = four["jax"][comm]
    outs = four["port"][comm]
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=RTOL)
    for o in outs[1:]:  # every position reports the same global mean
        np.testing.assert_array_equal(o["losses"], outs[0]["losses"])
    got_rows, got_c = port_rows(outs)
    assert_rows_agree(got_rows, want_rows)
    assert got_c == want_c


def test_bf16_wire_matches_jax_at_4(four):
    """The default bf16 exchange wire: losses within BF16_RTOL, keys, freq,
    version and counters exactly."""
    want_rows, want_c, jlosses, _ = four["jax"]["ag_bf16"]
    outs = four["port"]["ag_bf16"]
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=BF16_RTOL)
    got_rows, got_c = port_rows(outs)
    assert got_rows.keys() == want_rows.keys()
    assert {k: v[0] for k, v in got_rows.items()} == {k: v[0] for k, v in want_rows.items()}
    assert got_c == want_c


def test_dense_params_match_jax_at_4(four):
    """Adam moves each dense element by about lr a step: within 2 lr per
    step of the JAX parameters (the single-device slice's bound)."""
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.nn import jax_leaf_names

    dense = four["jax"]["ag"][3]
    names = jax_leaf_names(DLRMDCN(**KW))
    for r in four["port"]["ag"]:
        for name, leaf in zip(names, dense):
            np.testing.assert_allclose(r[f"d:{name}"], leaf, rtol=0,
                                       atol=2 * DENSE_LR * STEPS + 1e-6, err_msg=name)


def test_first_loss_is_the_same_across_comms(four):
    """Forward exactness: allgather, a2a and hier serve every position the
    same rows, so the first step's loss is equal bit for bit."""
    p = four["port"]
    firsts = {n: p[n][0]["losses"][0] for n in ("ag_bf16", "ag_2d", "a2a_2d", "a2a_1d")}
    firsts["hier"] = p["off_hier"][0]["losses"][0]
    assert len(set(firsts.values())) == 1, firsts


def test_flat_comms_bitwise_on_1d_and_2d_meshes(four):
    p = four["port"]
    for r in range(4):
        assert_same_bits(p["ag_bf16"][r], p["ag_2d"][r])
        assert_same_bits(p["a2a_1d"][r], p["a2a_2d"][r])
    assert sum(int(o["a2a_overflow_total"]) for o in p["a2a_2d"][:1]) == 0


@pytest.mark.parametrize("mode", ["lookahead_hier", "nested_hier", "chunked_a2a"])
def test_pipeline_modes_bitwise_to_off(four, mode):
    p = four["port"]
    base = "off_hier" if mode.endswith("hier") else "off_a2a"
    for r in range(4):
        assert_same_bits(p[mode][r], p[base][r])
        assert int(p[mode][r]["step"]) == 4


def test_a2a_budgets_and_dedup_stats(four):
    """No overflow at slack 2; the compiled bucket equals the traffic
    model's; dedup_stats reports every position's owner load, the same on
    every rank."""
    from deeprec_tpu_torch.ops import traffic as T

    outs = four["port"]["a2a_1d"]
    assert int(outs[0]["a2a_overflow_total"]) == 0
    U = B // 4 + 1  # U = N local positions (+ the sentinel row of sort_unique's pad)
    for key in outs[0]:
        if key.startswith("bucket:"):
            assert int(outs[0][key]) in {T.a2a_bucket_rows(unique=u, num_shards=4)
                                          for u in (B // 4, U)}
    stats = [json.loads(str(o["dedup_stats"])) for o in outs]
    assert all(s == stats[0] for s in stats)
    for tname, rec in stats[0].items():
        ps = rec["per_shard"]
        assert len(ps["owner_arrivals"]) == 4 and ps["imbalance"] >= 1.0


def test_part_files_restore_exactly_at_4_2_and_1(four, tmp_path):
    """The chunked a2a run's state, saved as part files at 4 positions:
    restored at 4, its next step's loss equals the uninterrupted run's bit
    for bit; restored at 2 (the 1-D mesh plan_mesh_after_rescale gives for
    the 2 x 2 shape) and at 1, every key's row, accumulator, freq and
    version are equal, and the next step's loss agrees within RTOL (another
    world size sums the batch in another order)."""
    src = four["port"]["chunked_a2a"]
    want, _ = port_rows(src)
    files = sorted(os.listdir(os.path.join(four["parts"], "full-4")))
    assert "table_group0_t0.part00003.npz" in files and "manifest.json" in files
    cont = float(src[0]["after_loss"])
    assert float(four["port"]["restored4"][0]["losses"][0]) == cont
    for world in (2, 1):
        jobs = [dict(name="restored", comm="a2a", restore=four["parts"], rescale_from=[2, 2]),
                dict(name="stepped", comm="a2a", restore=four["parts"], steps=1, first=4,
                     rescale_from=[2, 2])]
        res = spawn(tmp_path, world, jobs, four["batches"], f"re{world}")
        got, _ = port_rows(res["restored"])
        assert got.keys() == want.keys()
        for k, (_, wv, wa, wf, wver) in want.items():
            _, gv, ga, gf, gver = got[k]
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(ga, wa)
            assert (gf, gver) == (wf, wver)
        out = res["stepped"][0]
        assert int(out["mesh_size"]) == world and int(out["step"]) == 5
        np.testing.assert_allclose(float(out["losses"][0]), cont, rtol=RTOL)


def test_evaluate_is_global(four):
    """evaluate() over 2 held-out global batches: the same loss and AUC on
    every position."""
    outs = four["port"]["chunked_a2a"]
    for o in outs[1:]:
        assert float(o["eval_loss"]) == float(outs[0]["eval_loss"])
        assert float(o["eval_auc"]) == float(outs[0]["eval_auc"])
    assert 0.0 < float(outs[0]["eval_auc"]) < 1.0


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return shared(tmp_path_factory, "sharded2", _two)


def _two(tmp):
    batches = _batches(4, seed=3)
    m = jax_mesh(2)
    jax_runs = {c: _jax_run(m, c, batches, "float32") for c in ("allgather", "a2a")}
    state = os.path.join(tmp, "jax_init.npz")
    export_jax_state(_jax_trainer(m, "allgather").init(0), state)
    jobs = [dict(name=c, comm=c, mesh=[2], state=state, steps=STEPS, exchange_dtype="float32")
            for c in ("allgather", "a2a")]
    return dict(jax=jax_runs, port=spawn(tmp, 2, jobs, batches, "w2"))


@pytest.mark.parametrize("comm", ["allgather", "a2a"])
def test_losses_and_rows_match_jax_at_2(two, comm):
    want_rows, want_c, jlosses, _ = two["jax"][comm]
    outs = two["port"][comm]
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=RTOL)
    got_rows, got_c = port_rows(outs)
    assert_rows_agree(got_rows, want_rows)
    assert got_c == want_c


def test_placement_plan_raises_naming_slice_18():
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.parallel import ShardedTrainer, make_mesh

    with pytest.raises(NotImplementedError, match="slice 18"):
        ShardedTrainer(DLRMDCN(**KW), Adagrad(lr=LR), mesh=make_mesh(device="cpu"),
                       placement="plan")


def test_world_of_one_without_a_process_group_is_the_trainer():
    """No process group: the mesh is one position and the sharded step
    (allgather, f32 wire) is the single-device Trainer's bit for bit: the
    exchanges move each row unchanged, the owner sums add one source, and
    the means divide by 1."""
    import torch

    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.parallel import ShardedTrainer, make_mesh
    from deeprec_tpu_torch.training.trainer import Trainer

    torch.manual_seed(0)
    model = _port_model_f32()
    a = Trainer(model, Adagrad(lr=LR), adam(DENSE_LR), device="cpu")
    b = ShardedTrainer(_port_model_f32(), Adagrad(lr=LR), adam(DENSE_LR),
                       mesh=make_mesh(device="cpu"))
    sa, sb = a.init(0), b.init(0)
    for batch in _batches(3, seed=5):
        sa, ma = a.train_step(sa, batch)
        sb, mb = b.train_step(sb, batch)
        assert float(mb["loss"]) == float(ma["loss"])
    for bname, ts in sa.tables.items():
        tb = sb.tables[bname]
        for name in ("keys", "values", "meta"):
            assert torch.equal(getattr(tb, name), getattr(ts, name)), name
        assert torch.equal(tb.slots["accum"], ts.slots["accum"])
    for name, p in sa.dense.items():
        assert torch.equal(sb.dense[name], p), name


def _port_model_f32():
    from deeprec_tpu_torch.features import SparseFeature
    from deeprec_tpu_torch.models import DLRMDCN

    m = DLRMDCN(**KW)
    m.features = [dataclasses.replace(f, table=dataclasses.replace(
        f.table, exchange_dtype="float32")) if isinstance(f, SparseFeature) else f
        for f in m.features]
    return m


def spawn(tmp_path, world, jobs, batches, tag):
    return _spawn(tmp_path, world, jobs, tag, batches=batches, **BASE)
