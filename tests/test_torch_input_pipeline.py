"""The port's parallel input pipeline held against the JAX package on the
CPU: `plan_shards`; `ParallelInputPipeline` bit-identical to the serial
stream and to the JAX pipeline at any worker count, under a slow worker,
K-stacked; the staged ring's exactly-once resume (the same saved position
as the JAX pipeline's); Parquet against CSV and its resume; a SIGKILL of a
plain subprocess running the port, resumed exactly once; the input
metrics and the `Prefetcher`'s `record_stall("staged", ...)` reaching the
port's registry as the JAX ones reach the JAX registry.

And the slice as a whole: three small TSV files through each package's
`ParallelInputPipeline(k_stack=2)` into a small DLRM-DCN's `train_steps`
from one initial state carried across with convert.py — the same batches
bit for bit, losses, table rows per key and dense leaves within the
tolerances of tests/test_torch_train_loop.py."""
import hashlib
import json
import os
import signal
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.data import pipeline as jpl
from deeprec_tpu.data.prefetch import Prefetcher as JaxPrefetcher
from deeprec_tpu.models import DLRMDCN as JaxDLRMDCN
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu_torch.data import pipeline as tpl
from deeprec_tpu_torch.data.prefetch import Prefetcher
from deeprec_tpu_torch.data.readers import RecordErrors, criteo_hash_salts, sanitize_batch
from deeprec_tpu_torch.data.stream import criteo_line_parser
from deeprec_tpu_torch.models import DLRMDCN
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.trainer import Trainer

from test_torch_readers import _to_parquet, assert_batches_equal  # noqa: E402  (shared helpers)
from test_torch_train_loop import (  # noqa: E402  (shared helpers and tolerances)
    RTOL, _assert_tables_agree, _port_from_jax,
)

torch.set_num_threads(1)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ND, NC = 13, 26


def write_criteo(dirname, rows_per_file, seed=0):
    """Deterministic Criteo TSV files; I1 carries the global record index
    so every record is identity-checkable."""
    rng = np.random.default_rng(seed)
    paths, gid = [], 0
    for fi, n in enumerate(rows_per_file):
        p = os.path.join(str(dirname), f"day{fi}.tsv")
        lines = []
        for _ in range(n):
            cols = [str(rng.integers(0, 2)), str(gid)]
            cols += ["" if rng.random() < 0.1 else str(rng.integers(0, 100))
                     for _ in range(ND - 1)]
            cols += [f"{rng.integers(0, 1 << 20):x}" if rng.random() > 0.05 else ""
                     for _ in range(NC)]
            lines.append("\t".join(cols))
            gid += 1
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        paths.append(p)
    return paths


def serial_stream(paths, B):
    """Per-file `criteo_line_parser` batches, per-file remainder dropped."""
    err = RecordErrors(metrics=False)
    parse = criteo_line_parser(errors=err)
    for p in paths:
        with open(p) as f:
            lines = f.read().split("\n")[:-1]
        for i in range(len(lines) // B):
            yield sanitize_batch(parse(lines[i * B:(i + 1) * B]), err)


def _drain(pl):
    out = list(pl)
    pl.close()
    return out


@pytest.fixture
def files(tmp_path):
    return write_criteo(tmp_path, [700, 450, 96])


@pytest.mark.parametrize("B,k,shard_batches", [(64, 1, 2), (64, 2, 3), (50, 3, 1), (128, 1, 16)])
def test_plan_shards_matches_jax(files, B, k, shard_batches):
    got = tpl.plan_shards(files, B, k, shard_batches)
    want = jpl.plan_shards(files, B, k, shard_batches)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    for s in got:
        blob = open(s.path, "rb").read()
        assert s.lo == 0 or blob[s.lo - 1:s.lo] == b"\n"
        assert s.records == s.units * B * k
    assert [tuple(s) for s in tpl.plan_shards(files, B, k, shard_batches, False)] == \
        [tuple(s) for s in jpl.plan_shards(files, B, k, shard_batches, False)]


@pytest.mark.parametrize("workers", [1, 2, 5])
def test_pipeline_matches_serial_and_jax(files, workers):
    want = list(serial_stream(files, 64))
    got = _drain(tpl.ParallelInputPipeline(files, batch_size=64, num_workers=workers,
                                           shard_batches=2, metrics=False))
    assert_batches_equal(got, want, f"workers={workers}")
    jax_got = _drain(jpl.ParallelInputPipeline(files, batch_size=64, num_workers=workers,
                                               shard_batches=2, metrics=False))
    assert_batches_equal(got, jax_got, f"jax workers={workers}")


def test_pipeline_deterministic_under_slow_worker(files, monkeypatch):
    """Order comes from the reorder buffer, not thread timing."""
    want = list(serial_stream(files, 64))
    real, hit = tpl.criteo_block_parse, {"first": True}

    def slow(data, *a, **kw):
        if hit["first"]:
            hit["first"] = False
            time.sleep(0.25)
        return real(data, *a, **kw)

    monkeypatch.setattr(tpl, "criteo_block_parse", slow)
    got = _drain(tpl.ParallelInputPipeline(files, batch_size=64, num_workers=4,
                                           shard_batches=2, metrics=False))
    assert not hit["first"]
    assert_batches_equal(got, want, "slow worker")


@pytest.mark.parametrize("k", [2, 4])
def test_pipeline_k_stack_matches_jax(files, k):
    got = _drain(tpl.ParallelInputPipeline(files, batch_size=64, num_workers=3,
                                           shard_batches=2, k_stack=k, metrics=False))
    want = _drain(jpl.ParallelInputPipeline(files, batch_size=64, num_workers=3,
                                            shard_batches=2, k_stack=k, metrics=False))
    assert_batches_equal(got, want, f"k_stack={k}")
    serial = list(serial_stream(files, 64))
    flat = [{key: v[j] for key, v in item.items()} for item in got for j in range(k)]
    assert all(item["label"].shape == (k, 64) for item in got)
    # each unit is K consecutive serial batches of one file
    i = 0
    for unit in flat:
        while not np.array_equal(serial[i]["I1"], unit["I1"]):
            i += 1
        assert_batches_equal([unit], [serial[i]], "unit batch")
        i += 1
    with pytest.raises(ValueError, match="drop_remainder"):
        tpl.ParallelInputPipeline(files, k_stack=2, drop_remainder=False)


def test_staged_ring_exactly_once_resume_matches_jax(files):
    """pipeline -> staged ring with the consumed-position hooks; a save
    after 5 delivered batches (the ring ran ahead) is the JAX pipeline's
    save, and a fresh pipeline restored from it delivers the rest: every
    record exactly once."""
    want = list(serial_stream(files, 64))

    def head_and_state(mod, prefetcher):
        pl = mod.ParallelInputPipeline(files, batch_size=64, num_workers=3, shard_batches=2,
                                       metrics=False)
        pl.attach_consumer()
        ring = prefetcher(pl, depth=4, transform=lambda b: b, on_consume=pl.mark_consumed)
        head = [next(ring) for _ in range(5)]
        time.sleep(0.1)  # let the producers run ahead of the consumer
        state = pl.save()
        ring.close()
        pl.close()
        return head, state

    head, state = head_and_state(tpl, Prefetcher)
    _, jstate = head_and_state(jpl, JaxPrefetcher)
    assert state == jstate and state["consumed"] == 5
    pl2 = tpl.ParallelInputPipeline(files, batch_size=64, num_workers=3, shard_batches=2,
                                    metrics=False)
    pl2.restore(json.loads(json.dumps(state)))
    assert_batches_equal(head + _drain(pl2), want, "staged resume")
    pl3 = tpl.ParallelInputPipeline(files, batch_size=64, num_workers=3, shard_batches=2,
                                    metrics=False)
    next(iter(pl3))
    with pytest.raises(RuntimeError, match="precede"):
        pl3.restore(state)
    pl3.close()


def test_restore_without_offsets_rederives_them(files):
    want = list(serial_stream(files, 64))
    pl = tpl.ParallelInputPipeline(files, batch_size=64, num_workers=2, shard_batches=3,
                                   metrics=False)
    pl.restore({"consumed": 7})
    assert_batches_equal(_drain(pl), want[7:], "consumed only")


def test_parquet_pipeline_matches_csv_and_resumes(tmp_path):
    paths = write_criteo(tmp_path, [300, 170])
    pq_paths = [_to_parquet(p, p + ".parquet") for p in paths]
    want = _drain(tpl.ParallelInputPipeline(paths, batch_size=64, num_workers=2, shard_batches=2,
                                            metrics=False))

    def mk(mod):
        return mod.ParallelInputPipeline(pq_paths, batch_size=64, num_workers=2, fmt="parquet",
                                         hash_salts=criteo_hash_salts(), metrics=False)

    assert_batches_equal(_drain(mk(tpl)), want, "parquet vs csv")
    assert_batches_equal(_drain(mk(jpl)), want, "jax parquet vs csv")
    pl = mk(tpl)
    pl.attach_consumer()
    it = iter(pl)
    head = []
    for _ in range(3):
        head.append(next(it))
        pl.mark_consumed()
    state = pl.save()
    pl.close()
    pl2 = mk(tpl)
    pl2.restore(state)
    assert_batches_equal(head + _drain(pl2), want, "parquet resume")


SIGKILL_WORKER = textwrap.dedent(
    """
    import glob, hashlib, json, os, sys, time
    sys.path.insert(0, {repo!r})
    from deeprec_tpu_torch.data.pipeline import ParallelInputPipeline

    paths = sorted(glob.glob(os.path.join({data!r}, "*.tsv")))
    state_path = {state!r}
    pl = ParallelInputPipeline(paths, batch_size=64, num_workers=3,
                               shard_batches=2, metrics=False)
    if os.path.exists(state_path):
        with open(state_path) as f:
            pl.restore(json.load(f))
        print("RESUMED", flush=True)
    pl.attach_consumer()
    for batch in pl:
        digest = hashlib.md5(
            b"".join(batch[k].tobytes() for k in sorted(batch))).hexdigest()
        pl.mark_consumed()
        st = pl.save()
        print(f"BATCH {{st['consumed'] - 1}} {{digest}}", flush=True)
        with open(state_path + ".tmp", "w") as f:
            json.dump(st, f)
        os.replace(state_path + ".tmp", state_path)
        time.sleep(0.02)
    print("DONE", flush=True)
    """
)


def test_sigkill_midstream_resumes_exactly_once(tmp_path):
    """kill -9 a plain subprocess that consumes the port's pipeline (3
    workers at different offsets in different files); the restarted process
    restores the per-shard consumed offsets and the union of both runs is
    the serial stream, every record once."""
    import subprocess

    from deeprec_tpu.online import faults

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    paths = write_criteo(data_dir, [700, 450, 263], seed=3)
    oracle = [hashlib.md5(b"".join(b[k].tobytes() for k in sorted(b))).hexdigest()
              for b in serial_stream(paths, 64)]
    state = str(tmp_path / "stream_state.json")
    script = str(tmp_path / "worker.py")
    with open(script, "w") as f:
        f.write(SIGKILL_WORKER.format(repo=REPO, data=str(data_dir), state=state))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}

    p = subprocess.Popen([sys.executable, script], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    hit, lines1 = faults.wait_for_line(
        p, lambda line: line.startswith("BATCH") and int(line.split()[1]) >= 4, timeout=120)
    assert hit is not None, lines1[-10:]
    os.kill(p.pid, signal.SIGKILL)
    assert p.wait(timeout=30) == -signal.SIGKILL

    p = subprocess.Popen([sys.executable, script], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True, env=env)
    done, lines2 = faults.wait_for_line(p, lambda line: line.startswith("DONE"), timeout=120)
    assert done is not None, lines2[-10:]
    assert p.wait(timeout=30) == 0
    assert "RESUMED" in lines2, lines2[:3]
    run1 = {int(x.split()[1]): x.split()[2] for x in lines1 if x.startswith("BATCH")}
    run2 = {int(x.split()[1]): x.split()[2] for x in lines2 if x.startswith("BATCH")}
    combined = {i: d for i, d in run1.items() if i < min(run2)}
    combined.update(run2)
    assert sorted(combined) == list(range(len(oracle)))
    assert [combined[i] for i in range(len(oracle))] == oracle
    assert all(d == oracle[i] for i, d in run1.items())


def test_pipeline_exports_input_metrics(tmp_path):
    from deeprec_tpu_torch.obs import metrics as tm

    paths = write_criteo(tmp_path, [300])
    reg = tm.default_registry()
    before = {n: reg.counter(n).value for n in
              ("deeprec_input_batches", "deeprec_input_records", "deeprec_input_bytes")}
    pl = tpl.ParallelInputPipeline(paths, batch_size=64, num_workers=2, shard_batches=2)
    n = sum(b["label"].shape[0] for b in _drain(pl))
    assert n == (300 // 64) * 64
    assert reg.counter("deeprec_input_records").value - before["deeprec_input_records"] == n
    assert reg.counter("deeprec_input_batches").value - before["deeprec_input_batches"] == 4
    assert reg.counter("deeprec_input_bytes").value > before["deeprec_input_bytes"]
    text = reg.render_prometheus()
    assert 'deeprec_input_stall_seconds{site="pipeline"}' in text
    st = pl.stats()
    read = sum(s.hi - s.lo for s in tpl.plan_shards(paths, 64, 1, 2))
    assert st["records"] == n and st["bytes"] == read
    assert st["units"] == 4 and min(st["read_s"], st["parse_s"], st["pack_s"]) >= 0


@pytest.mark.parametrize("site", ["pipeline", "staged", "train_loop"])
def test_record_stall_matches_jax(site):
    from deeprec_tpu.obs import metrics as jm
    from deeprec_tpu_torch.obs import metrics as tm

    def read(mod):
        reg = mod.default_registry()
        return (reg.counter("deeprec_input_stall_seconds_total", "", {"site": site}).value,
                reg.gauge("deeprec_input_stall_seconds", "", {"site": site}).value)

    t0, j0 = read(tm), read(jm)
    tpl.record_stall(site, 0.25)
    jpl.record_stall(site, 0.25)
    t1, j1 = read(tm), read(jm)
    assert (t1[0] - t0[0], t1[1]) == (j1[0] - j0[0], j1[1]) == (0.25, 0.25)


def test_prefetcher_stall_reaches_the_port_registry():
    """A consumer that waits on an empty ring records the wait as
    `deeprec_input_stall_seconds{site="staged"}` in the port's registry,
    as the JAX Prefetcher does in the JAX registry; the Prefetcher keeps
    its own totals too."""
    from deeprec_tpu.obs import metrics as jm
    from deeprec_tpu_torch.obs import metrics as tm

    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield {"x": np.full(2, i)}

    def total(mod):
        return mod.default_registry().counter(
            "deeprec_input_stall_seconds_total", "", {"site": "staged"}).value

    for mod, make in ((tm, lambda s: Prefetcher(s, depth=1, transform=lambda b: b)),
                      (jm, lambda s: JaxPrefetcher(s, depth=1, transform=lambda b: b))):
        before = total(mod)
        pf = make(slow())
        got = [int(b["x"][0]) for b in pf]
        pf.close()
        waited = total(mod) - before
        assert got == [0, 1, 2] and waited > 0.05
        if mod is tm:
            assert pf.stalls >= 1 and abs(pf.stall_seconds - waited) < 1e-9
            assert mod.default_registry().gauge(
                "deeprec_input_stall_seconds", "", {"site": "staged"}).value > 0


# ----------------------------------------------------------- the slice


SLICE_KW = dict(emb_dim=8, capacity=1 << 12, bottom=(16, 8), top=(16, 1), num_cat=NC,
                num_dense=ND, cross_depth=1)
SLICE_LR, SLICE_DENSE_LR, SLICE_B, SLICE_K = 0.05, 1e-3, 64, 2


def test_slice_file_fed_train_steps_match_jax(tmp_path):
    """Three TSV files through each package's ParallelInputPipeline
    (k_stack=2) into DLRM-DCN's train_steps from one carried state: the
    units equal bit for bit; losses, rows per key and dense leaves agree."""
    paths = write_criteo(tmp_path, [300, 260, 200], seed=11)

    def units(mod):
        return _drain(mod.ParallelInputPipeline(paths, batch_size=SLICE_B, num_workers=2,
                                                k_stack=SLICE_K, shard_batches=2))

    tunits, junits = units(tpl), units(jpl)
    assert_batches_equal(tunits, junits, "units")
    assert len(tunits) == 300 // 128 + 260 // 128 + 200 // 128 == 5

    jtr = JaxTrainer(JaxDLRMDCN(**SLICE_KW), JaxAdagrad(lr=SLICE_LR), optax.adam(SLICE_DENSE_LR))
    jst = jtr.init(0)
    trainer = Trainer(DLRMDCN(**SLICE_KW), Adagrad(lr=SLICE_LR), adam(SLICE_DENSE_LR),
                      device="cpu", pipeline_mode="lookahead")
    st = _port_from_jax(trainer, jst)
    losses, jlosses = [], []
    for tu, ju in zip(tunits, junits):
        st, m = trainer.train_steps(st, tu)
        jst, jm_ = jtr.train_steps(jst, {k: jnp.asarray(v) for k, v in ju.items()})
        losses += m["loss"].tolist()
        jlosses += np.asarray(jm_["loss"]).tolist()
    steps = len(tunits) * SLICE_K
    assert st.step == int(jst.step) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL)
    _assert_tables_agree(trainer, st, jst)
    from deeprec_tpu_torch.nn import jax_leaf_names

    for name, leaf in zip(jax_leaf_names(trainer.model), jax.tree_util.tree_leaves(jst.dense)):
        np.testing.assert_allclose(st.dense[name].numpy(), np.asarray(leaf), rtol=0,
                                   atol=2 * SLICE_DENSE_LR * steps + 1e-6, err_msg=name)


def test_trainer_stage_wires_the_pipeline_and_saves_the_consumed_position(tmp_path):
    """Trainer.stage attaches the pipeline's consumer hooks: a save under
    the staging ring reports the windows delivered, not those read ahead,
    and a restored pipeline feeds the rest (the port's Trainer on the
    CPU)."""
    paths = write_criteo(tmp_path, [520, 400], seed=12)
    trainer = Trainer(DLRMDCN(**SLICE_KW), Adagrad(lr=SLICE_LR), adam(SLICE_DENSE_LR),
                      device="cpu")
    st = trainer.init()

    def mk():
        return tpl.ParallelInputPipeline(paths, batch_size=SLICE_B, num_workers=2,
                                         k_stack=SLICE_K, shard_batches=2)

    all_units = _drain(mk())
    pl = mk()
    ring = trainer.stage(pl, depth=3)
    for _ in range(2):
        st, _ = trainer.train_steps(st, next(ring))
    time.sleep(0.2)
    state = pl.save()
    ring.close()
    pl.close()
    assert state["consumed"] == 2
    pl2 = mk()
    pl2.restore(state)
    rest = _drain(pl2)
    assert_batches_equal(rest, all_units[2:], "rest")
