"""The PyTorch port's async checkpoint writer and device-compacted deltas,
held against the synchronous saver and the JAX package on the CPU (the
counterpart of tests/test_async_ckpt.py): async saves write the same files
as synchronous ones — also with training steps issued before `wait()`,
since the port trains in place and the stage half must have copied what it
reads; at most one save is in flight; the writer overlaps training (by
event order, never by the clock); a failed delta writer re-raises in
`wait()` and escalates the next save to a full one; retention sweeps
orphaned delta chains; and `transfer_bytes` follows the dirty rows and
equals the JAX package's count for the same carried state."""
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

KW = dict(emb_dim=8, capacity=1 << 12, hidden=(32,), num_cat=4, num_dense=2)


def make_trainer():
    return Trainer(WDL(**KW), Adagrad(lr=0.1), adam(1e-3), device="cpu")


def id_batch(ids):
    """A WDL batch touching exactly `ids` (dirty-row control)."""
    ids = np.asarray(ids, np.int32)
    n = len(ids)
    rng = np.random.default_rng(ids[0] if n else 0)
    b = {f"C{i + 1}": ids for i in range(4)}
    b["I1"] = rng.standard_normal((n, 1)).astype(np.float32)
    b["I2"] = rng.standard_normal((n, 1)).astype(np.float32)
    b["label"] = (rng.random(n) < 0.5).astype(np.float32)
    return b


def gen_batches(n, seed=3):
    g = SyntheticCriteo(batch_size=256, num_cat=4, num_dense=2, vocab=1500, seed=seed)
    return [g.batch() for _ in range(n)]


def files_of(path):
    """{file: {array: ndarray}} of a checkpoint directory, and its manifest
    without the step."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".npz"):
            with np.load(os.path.join(path, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    return out, m


def assert_same_files(a, b):
    (fa, ma), (fb, mb) = files_of(a), files_of(b)
    assert fa.keys() == fb.keys()
    for f in fa:
        assert fa[f].keys() == fb[f].keys(), f
        for k in fa[f]:
            assert fa[f][k].dtype == fb[f][k].dtype, (f, k)
            np.testing.assert_array_equal(fa[f][k], fb[f][k], err_msg=f"{f}:{k}")
    assert ma == mb


def assert_states_identical(tr, a, b):
    """Bit-exact on table ints, byte-exact on every float leaf."""
    assert a.step == b.step
    for bname in tr.bundles:
        ta, tb = a.tables[bname], b.tables[bname]
        for name in ("keys", "meta", "values"):
            assert torch.equal(getattr(ta, name), getattr(tb, name)), name
        assert ta.slots.keys() == tb.slots.keys()
        for s in ta.slots:
            assert torch.equal(ta.slots[s], tb.slots[s]), s
    for n in a.dense:
        assert torch.equal(a.dense[n], b.dense[n]), n


def _copy_state(st):
    """A copy of every tensor of a port TrainState."""
    from deeprec_tpu_torch.training.checkpoint import _clone_table_state

    o = st.opt_state
    opt = type(o)(count=o.count.clone(), mu={n: t.clone() for n, t in o.mu.items()},
                  nu={n: t.clone() for n, t in o.nu.items()})
    return type(st)(step=st.step,
                    tables={b: _clone_table_state(ts) for b, ts in st.tables.items()},
                    dense={n: t.clone() for n, t in st.dense.items()}, opt_state=opt)


# ------------------------------------------------------------ sync == async


def test_async_full_save_restores_identical_to_sync(tmp_path):
    tr = make_trainer()
    st = tr.init()
    for b in gen_batches(4):
        st, _ = tr.train_step(st, b)
    ck_s = CheckpointManager(str(tmp_path / "sync"), tr)
    ck_a = CheckpointManager(str(tmp_path / "async"), tr)
    copy = _copy_state(st)
    ck_s.save(copy)
    st, path = ck_a.save_async(st)
    ck_a.wait()
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert ck_a.last_save["async"] and ck_a.last_save["write_ms"] >= 0
    assert_same_files(os.path.join(str(tmp_path / "sync"), "full-4"), path)
    assert_states_identical(tr, copy, st)  # the dirty bits cleared alike
    r_s = CheckpointManager(str(tmp_path / "sync"), make_trainer()).restore()
    r_a = CheckpointManager(str(tmp_path / "async"), make_trainer()).restore()
    assert_states_identical(tr, r_s, r_a)


def test_async_incremental_chain_restores_identical_to_sync(tmp_path):
    """A full save and 2 deltas, one lineage synchronous and one async from
    the same states: the same files, the same restored chain."""
    tr = make_trainer()
    st = tr.init()
    for b in gen_batches(3):
        st, _ = tr.train_step(st, b)
    ck_s = CheckpointManager(str(tmp_path / "sync"), tr)
    ck_a = CheckpointManager(str(tmp_path / "async"), tr)
    extra = gen_batches(2, seed=11)
    for i, batch in enumerate([None, extra[0], extra[1]]):
        if batch is not None:
            st, _ = tr.train_step(st, batch)
        copy = _copy_state(st)
        if i == 0:
            ck_s.save(copy)
            st, _ = ck_a.save_async(st)
        else:
            ck_s.save_incremental(copy)
            st, _ = ck_a.save_incremental_async(st)
        ck_a.wait()
    for d in ("full-3", "incr-4", "incr-5"):
        assert_same_files(os.path.join(str(tmp_path / "sync"), d),
                          os.path.join(str(tmp_path / "async"), d))
    r_s = CheckpointManager(str(tmp_path / "sync"), make_trainer()).restore()
    r_a = CheckpointManager(str(tmp_path / "async"), make_trainer()).restore()
    assert_states_identical(tr, r_s, r_a)


def test_async_delta_with_steps_before_wait_writes_the_saved_state(tmp_path):
    """Training steps issued after save_incremental_async and before
    wait() write into the same tensors the stage half read: the files must
    still be those of a synchronous delta of a copy taken at the save."""
    tr = make_trainer()
    st = tr.init()
    batches = gen_batches(6, seed=5)
    for b in batches[:2]:
        st, _ = tr.train_step(st, b)
    ck_s = CheckpointManager(str(tmp_path / "sync"), tr)
    ck_a = CheckpointManager(str(tmp_path / "async"), tr)
    ck_s.save(_copy_state(st))
    st, _ = ck_a.save(st)
    st, _ = tr.train_step(st, batches[2])
    copy = _copy_state(st)
    gate = threading.Event()
    ck_a.on_write = lambda path: gate.wait(timeout=60)
    st, path = ck_a.save_incremental_async(st)
    for b in batches[3:]:  # these write the rows the delta holds
        st, _ = tr.train_step(st, b)
    gate.set()
    ck_a.wait()
    _, spath = ck_s.save_incremental(copy)
    assert_same_files(spath, path)


# ------------------------------------------------- transfer-bytes accounting


def test_incremental_transfer_bytes_scale_with_dirty_fraction_and_equal_jax(tmp_path):
    """transfer_bytes follows the dirty rows, not the capacity, and equals
    the JAX package's count at every save of the same carried state."""
    from test_torch_table_lifecycle import _port_from_jax

    jtr = JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=0.1), optax.adam(1e-3))
    jst = jtr.init(0)
    tr = make_trainer()

    def both(ids):
        nonlocal jst, st
        b = id_batch(ids)
        jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, _ = tr.train_step(st, b)

    jst, _ = jtr.train_step(jst, {k: jnp.asarray(v) for k, v in id_batch(np.arange(2048)).items()})
    st = _port_from_jax(tr, jst)
    ck, jck = CheckpointManager(str(tmp_path / "port"), tr), JaxCkpt(str(tmp_path / "jax"), jtr)
    seen = []

    def save(kind):
        nonlocal jst, st
        if kind == "full":
            jst, _ = jck.save(jst)
            st, _ = ck.save(st)
        else:
            jst, _ = jck.save_incremental(jst)
            st, _ = ck.save_incremental(st)
        assert ck.last_save["transfer_bytes"] == jck.last_save["transfer_bytes"], kind
        seen.append(ck.last_save["transfer_bytes"])

    save("full")
    both(np.arange(32))  # few dirty rows
    save("incr")
    both(np.arange(2048))  # many dirty rows
    save("incr")
    full_bytes, small_bytes, large_bytes = seen
    assert small_bytes < large_bytes < full_bytes
    assert small_bytes < large_bytes / 2, (small_bytes, large_bytes)
    assert small_bytes < full_bytes / 3, (small_bytes, full_bytes)
    r = CheckpointManager(str(tmp_path / "port"), make_trainer()).restore()
    assert r.step == st.step


# ------------------------------------------------------ ordering-based overlap


def test_async_writer_overlaps_training_by_ordering(tmp_path):
    """The writer parks on a gate only the training loop after the save
    opens: a writer inside save_async would time the gate out."""
    tr = make_trainer()
    st = tr.init()
    batches = gen_batches(3)
    for b in batches:
        st, _ = tr.train_step(st, b)
    ck = CheckpointManager(str(tmp_path), tr)
    events = []
    gate = threading.Event()

    def on_write(path):
        events.append("writer_enter")
        events.append("writer_gated" if gate.wait(timeout=60) else "writer_timeout")

    ck.on_write = on_write
    st, path = ck.save_async(st)
    events.append("save_returned")
    for i, b in enumerate(batches):
        st, mets = tr.train_step(st, b)
        float(mets["loss"])
        events.append(f"step{i}")
    gate.set()
    ck.wait()
    events.append("wait_done")
    assert "writer_timeout" not in events, events
    assert events.index("save_returned") < events.index("step2") < events.index("wait_done")
    assert os.path.exists(os.path.join(path, "manifest.json"))
    assert CheckpointManager(str(tmp_path), make_trainer()).restore().step == 3


def test_at_most_one_save_in_flight(tmp_path):
    """A second async save drains the first before staging: the writers'
    events never interleave."""
    tr = make_trainer()
    st = tr.init()
    for b in gen_batches(2):
        st, _ = tr.train_step(st, b)
    ck = CheckpointManager(str(tmp_path), tr)
    events = []
    gate = threading.Event()

    def on_write(path):
        events.append(("enter", os.path.basename(path)))
        gate.wait(timeout=60)
        events.append(("exit", os.path.basename(path)))

    ck.on_write = on_write
    st, p1 = ck.save_async(st)
    st, _ = tr.train_step(st, gen_batches(1)[0])
    threading.Timer(0.2, gate.set).start()
    st, p2 = ck.save_incremental_async(st)  # blocks until the first landed
    assert os.path.exists(os.path.join(p1, "manifest.json"))
    ck.wait()
    names = [n for _, n in events]
    assert names == [os.path.basename(p1)] * 2 + [os.path.basename(p2)] * 2
    assert [e for e, _ in events] == ["enter", "exit", "enter", "exit"]
    assert os.path.exists(os.path.join(p2, "manifest.json"))


def test_failed_incr_writer_escalates_next_save_to_full(tmp_path):
    """A dead delta writer re-raises in wait(); its rows were marked clean
    when it was staged, so the next save is a full one carrying them, equal
    to a reference full save of the same state; after it deltas resume."""
    tr = make_trainer()
    st = tr.init()
    st, _ = tr.train_step(st, id_batch(np.arange(256)))
    ck = CheckpointManager(str(tmp_path / "ck"), tr)
    st, _ = ck.save(st)
    st, _ = tr.train_step(st, id_batch(np.arange(64)))  # the doomed delta

    def die(path):
        raise KeyboardInterrupt("simulated writer death")

    ck.on_write = die
    st, dead = ck.save_incremental_async(st)
    with pytest.raises(RuntimeError, match="writer failed"):
        ck.wait()
    ck.on_write = None
    assert not os.path.exists(os.path.join(dead, "manifest.json"))
    ck.wait()  # the error was raised once

    st, _ = tr.train_step(st, id_batch(np.arange(64, 96)))
    st, path = ck.save_incremental(st)
    assert os.path.basename(path).startswith("full-"), path
    ref = CheckpointManager(str(tmp_path / "ref"), tr)
    ref.save(_copy_state(st))
    r = CheckpointManager(str(tmp_path / "ck"), make_trainer()).restore()
    r_ref = CheckpointManager(str(tmp_path / "ref"), make_trainer()).restore()
    assert_states_identical(tr, r, r_ref)
    st, _ = tr.train_step(st, id_batch(np.arange(8)))
    st, p2 = ck.save_incremental(st)
    assert os.path.basename(p2).startswith("incr-")


# --------------------------------------------------------------- GC


def test_gc_sweeps_orphaned_incr_chains(tmp_path):
    """Deltas whose base full save aged out of `keep` go; the deltas of a
    kept full save stay — the JAX listing of the same sequence."""
    tr = make_trainer()
    st = tr.init()
    ck = CheckpointManager(str(tmp_path), tr, keep=2)
    batches = gen_batches(8)
    for i in range(4):
        st, _ = tr.train_step(st, batches[2 * i])
        st, _ = ck.save_async(st)            # fulls @ 1, 3, 5, 7
        st, _ = tr.train_step(st, batches[2 * i + 1])
        st, _ = ck.save_incremental(st)      # deltas @ 2, 4, 6, 8
    ck.close()
    assert sorted(os.listdir(str(tmp_path))) == ["full-5", "full-7", "incr-6", "incr-8"]
    assert CheckpointManager(str(tmp_path), make_trainer()).restore().step == 8
