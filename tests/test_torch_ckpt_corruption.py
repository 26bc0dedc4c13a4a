"""The corruption matrix of tests/test_ckpt_corruption.py for the PyTorch
port, on the CPU: every way a committed link of a port-written chain can
rot — a truncated npz, a bit-flipped payload, a missing manifest, a missing
middle link, a torn manifest, a corrupt full anchor — restores the longest
valid prefix bit for bit, quarantines the same directories under the same
names and returns the same chain as the JAX package does on a copy of the
same directory, and never raises into serving: `Predictor.reload` serves
the prefix, and the trainer's next delta escalates to a full save that
re-anchors the chain. The injectors are the JAX package's
(`deeprec_tpu/online/faults.py`)."""
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import optax
import pytest
import torch

from deeprec_tpu.models import WDL as JaxWDL
from deeprec_tpu.online import faults
from deeprec_tpu.optim import Adagrad as JaxAdagrad
from deeprec_tpu.training import Trainer as JaxTrainer
from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt
from deeprec_tpu_torch.data import SyntheticCriteo
from deeprec_tpu_torch.models import WDL
from deeprec_tpu_torch.optim import Adagrad, adam
from deeprec_tpu_torch.serving import Predictor
from deeprec_tpu_torch.training.checkpoint import CheckpointCorrupt, CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)

KW = dict(emb_dim=4, capacity=1 << 10, hidden=(16,), num_cat=2, num_dense=2)


def _mk_trainer():
    model = WDL(**KW)
    return Trainer(model, Adagrad(lr=0.2), adam(5e-3), device="cpu"), model


def _jax_trainer():
    return JaxTrainer(JaxWDL(**KW), JaxAdagrad(lr=0.2), optax.adam(5e-3))


def _gen(seed):
    return SyntheticCriteo(batch_size=96, num_cat=2, num_dense=2, vocab=300, seed=seed)


def _tables_np(state):
    out = {}
    for bname, ts in state.tables.items():
        for name in ("keys", "meta", "values"):
            out[f"{bname}/{name}"] = getattr(ts, name).numpy()
    return out


def _assert_tables_equal(a, b):
    ka, kb = _tables_np(a), _tables_np(b)
    assert sorted(ka) == sorted(kb)
    for k in ka:
        np.testing.assert_array_equal(ka[k], kb[k])


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """One full save and two deltas written by the port, with the restore
    reference after each link: refs[s] is what a fresh consumer of a chain
    ending at step s must reproduce. Tests corrupt copies."""
    base = str(tmp_path_factory.mktemp("chain") / "ck")
    tr, _ = _mk_trainer()
    gen = _gen(3)

    def step(st):
        return tr.train_step(st, gen.batch())[0]

    ck = CheckpointManager(base, tr)
    st = tr.init()
    refs = {}
    for _ in range(2):
        st = step(st)
    st, _ = ck.save(st)                # full-2
    refs[2] = CheckpointManager(base, _mk_trainer()[0]).restore()
    st = step(st)
    st, _ = ck.save_incremental(st)    # incr-3
    refs[3] = CheckpointManager(base, _mk_trainer()[0]).restore()
    st = step(st)
    st, _ = ck.save_incremental(st)    # incr-4
    refs[4] = CheckpointManager(base, _mk_trainer()[0]).restore()
    return SimpleNamespace(dir=base, refs=refs)


def _copies(chain, tmp_path):
    """Two copies of the chain: the port's and the JAX package's."""
    out = []
    for who in ("port", "jax"):
        dst = str(tmp_path / who)
        shutil.copytree(chain.dir, dst)
        out.append(dst)
    return out


def _table_file(path):
    return os.path.join(
        path, sorted(f for f in os.listdir(path) if f.startswith("table_"))[0])


def _restore_both(d, dj):
    """Restore the port's copy in the port and the JAX copy in the JAX
    package; the quarantined names, the listings and the chains agree."""
    ck, jck = CheckpointManager(d, _mk_trainer()[0]), JaxCkpt(dj, _jax_trainer())
    restored, jst = ck.restore(), jck.restore()
    assert restored.step == int(jst.step)
    assert sorted(os.listdir(d)) == sorted(os.listdir(dj))
    assert ck.chain_dirs() == jck.chain_dirs()
    assert (ck.quarantine_count, os.path.basename(ck.last_quarantined or "")) == (
        jck.quarantine_count, os.path.basename(jck.last_quarantined or ""))
    return restored


def _corrupt(fn, *dirs):
    for d in dirs:
        fn(d)


def test_manifest_records_digests_and_base(chain):
    with open(os.path.join(chain.dir, "incr-4", "manifest.json")) as f:
        m = json.load(f)
    assert m["base"] == 3  # link to incr-3
    assert m["kind"] == "incr" and "bundles" not in m
    assert any(f.startswith("table_") for f in m["digests"])
    assert "dense.npz" in m["digests"]
    for arrays in m["digests"].values():
        for digest in arrays.values():
            assert digest.startswith("crc32:")
    with open(os.path.join(chain.dir, "incr-3", "manifest.json")) as f:
        assert json.load(f)["base"] == 2  # link to full-2
    with open(os.path.join(chain.dir, "full-2", "manifest.json")) as f:
        assert "bundles" in json.load(f)


def test_verify_passes_intact_and_catches_tamper(chain, tmp_path):
    d, dj = _copies(chain, tmp_path)
    ck = CheckpointManager(d, _mk_trainer()[0])
    for link in ("full-2", "incr-3", "incr-4"):
        ck.verify(os.path.join(d, link))
    _corrupt(lambda p: faults.flip_bit(_table_file(os.path.join(p, "incr-3"))), d, dj)
    ck2 = CheckpointManager(d, _mk_trainer()[0])  # fresh: no memoized verdicts
    with pytest.raises(CheckpointCorrupt):
        ck2.verify(os.path.join(d, "incr-3"))
    from deeprec_tpu.training.checkpoint import CheckpointCorrupt as JaxCorrupt

    with pytest.raises(JaxCorrupt):
        JaxCkpt(dj, _jax_trainer()).verify(os.path.join(dj, "incr-3"))


def test_truncated_npz_restores_longest_prefix(chain, tmp_path):
    d, dj = _copies(chain, tmp_path)
    _corrupt(lambda p: faults.truncate_file(_table_file(os.path.join(p, "incr-4"))), d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 3
    _assert_tables_equal(restored, chain.refs[3])
    assert os.path.exists(os.path.join(d, "incr-4.quarantined"))
    assert not os.path.exists(os.path.join(d, "incr-4"))


def test_bitflip_middle_link_truncates_at_gap(chain, tmp_path):
    """A flipped incr-3 is quarantined, the intact incr-4 (its base is the
    missing step) is dropped but left on disk, and full-2 restores."""
    d, dj = _copies(chain, tmp_path)
    _corrupt(lambda p: faults.flip_bit(_table_file(os.path.join(p, "incr-3"))), d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 2
    _assert_tables_equal(restored, chain.refs[2])
    assert os.path.exists(os.path.join(d, "incr-3.quarantined"))
    assert os.path.exists(os.path.join(d, "incr-4"))


def test_missing_manifest_is_invisible(chain, tmp_path):
    d, dj = _copies(chain, tmp_path)
    _corrupt(lambda p: os.remove(os.path.join(p, "incr-3", "manifest.json")), d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 2
    _assert_tables_equal(restored, chain.refs[2])


def test_missing_middle_link_truncates(chain, tmp_path):
    d, dj = _copies(chain, tmp_path)
    _corrupt(lambda p: shutil.rmtree(os.path.join(p, "incr-3")), d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 2
    _assert_tables_equal(restored, chain.refs[2])


def test_torn_manifest_quarantines(chain, tmp_path):
    d, dj = _copies(chain, tmp_path)

    def tear(p):
        with open(os.path.join(p, "incr-4", "manifest.json"), "w") as f:
            f.write('{"step": 4, "kind": "in')  # torn mid-write

    _corrupt(tear, d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 3
    _assert_tables_equal(restored, chain.refs[3])
    assert os.path.exists(os.path.join(d, "incr-4.quarantined"))
    with pytest.raises(ValueError, match="torn"):
        CheckpointManager(d, _mk_trainer()[0])._manifest(
            os.path.join(d, "incr-4.quarantined"))


def test_corrupt_full_falls_back_to_older_full(chain, tmp_path):
    """A rotten anchor falls back to the previous full save; its deltas
    replay over it."""
    d, dj = _copies(chain, tmp_path)
    tr = _mk_trainer()[0]
    ck = CheckpointManager(d, tr)
    st = ck.restore()
    st = tr.train_step(st, _gen(9).batch())[0]
    st, path = ck.save(st)                # full-5
    shutil.copytree(path, os.path.join(dj, "full-5"))
    _corrupt(lambda p: faults.flip_bit(_table_file(os.path.join(p, "full-5"))), d, dj)
    restored = _restore_both(d, dj)
    assert restored.step == 4             # full-2 + incr-3 + incr-4
    _assert_tables_equal(restored, chain.refs[4])
    assert os.path.exists(os.path.join(d, "full-5.quarantined"))


def test_corruption_never_raises_into_serving_and_self_heals(chain, tmp_path):
    """A corrupt delta under a live Predictor: the next reload quarantines
    it and serves the prefix (nothing raises, the answers are the old
    ones); the trainer's next delta sees the gap and escalates to a full
    save; the reload after it serves the new anchor."""
    d, _ = _copies(chain, tmp_path)
    tr, model = _mk_trainer()
    ck = CheckpointManager(d, tr)
    st = ck.restore()
    gen = _gen(5)
    p = Predictor(model, d, device="cpu")
    assert p.step == 4
    req = {k: v for k, v in gen.batch().items() if k != "label"}
    before = p.predict(req)

    st = tr.train_step(st, gen.batch())[0]
    st, delta = ck.save_incremental(st)        # incr-5
    faults.flip_bit(_table_file(delta))
    assert p.reload() is True                  # served through, no raise
    assert p.step == 4 and p.version == 1
    np.testing.assert_array_equal(before, p.predict(req))
    assert p._ck.quarantine_count == 1
    assert os.path.exists(delta + ".quarantined")

    st = tr.train_step(st, gen.batch())[0]
    st, path2 = ck.save_incremental(st)        # escalates
    assert os.path.basename(path2) == "full-6"
    assert p.reload() is True
    assert p.step == int(st.step) == 6
    assert np.all(np.isfinite(p.predict(req)))
    st = tr.train_step(st, gen.batch())[0]
    st, path3 = ck.save_incremental(st)        # the chain is whole again
    assert os.path.basename(path3) == "incr-7"
