"""The port's host and disk tier stores held against the JAX package on the
CPU: the native `HostKV` (its own copy of host_kv.cpp, built into
build/deeprec_tpu_torch/) against the JAX package's `HostKV` and against
the port's plain numpy store over the same put/get/erase/export sequences;
spill files and `DiskKV` logs written by each package and read by the other
(byte-identical files for the same operations); `DiskKV` compaction,
batched reads and a crash tail past the `.idx` sidecar; `_spill_dim`; and a
failed build raising instead of falling back.

Everything here is exact: the stores hold f32 rows and int32 metadata and
move them unchanged."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprec_tpu.embedding import multi_tier as jmt
from deeprec_tpu.native import HostKV as JaxHostKV
from deeprec_tpu_torch import native
from deeprec_tpu_torch.embedding import multi_tier as tmt
from deeprec_tpu_torch.native import HostKV, PlainHostKV

torch.set_num_threads(1)


def _ops(seed, dim, n_ops=12, key_range=3000):
    """A seeded sequence of ("put", keys, values, freqs, versions),
    ("erase", keys) and ("get", keys) operations; puts overwrite and grow
    the store past its initial 1024 slots."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n_ops):
        kind = ("put", "put", "erase", "get")[i % 4]
        n = int(rng.integers(1, 900))
        keys = rng.integers(-key_range, key_range, size=n).astype(np.int64)
        if kind == "put":
            keys = np.unique(keys)
            ops.append(("put", keys, rng.standard_normal((len(keys), dim)).astype(np.float32),
                        rng.integers(0, 100, len(keys)).astype(np.int32),
                        rng.integers(-1, 50, len(keys)).astype(np.int32)))
        else:
            ops.append((kind, keys))
    return ops


def _run(store, ops):
    """Apply ops; return every get's result."""
    out = []
    for op in ops:
        if op[0] == "put":
            store.put(*op[1:])
        elif op[0] == "erase":
            store.erase(op[1])
        else:
            out.append(store.get(op[1]))
    return out


def _sorted_export(store):
    k, v, f, ver = store.export()
    o = np.argsort(k)
    return k[o], v[o], f[o], ver[o]


@pytest.mark.parametrize("dim", [1, 4, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_kv_matches_jax_and_plain(dim, seed):
    """Same operations, same answers: every get, the size and the export
    (in slot order against the JAX native store, per key against the plain
    store)."""
    ops = _ops(seed, dim)
    port, jax_kv, plain = HostKV(dim, 1024), JaxHostKV(dim, 1024), PlainHostKV(dim, 1024)
    assert jax_kv.native  # the JAX side is its native store too
    got, want, ref = _run(port, ops), _run(jax_kv, ops), _run(plain, ops)
    for g, w, r in zip(got, want, ref):
        for a, b, c in zip(g, w, r):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert len(port) == len(jax_kv) == len(plain) > 1024
    for a, b in zip(port.export(), jax_kv.export()):
        np.testing.assert_array_equal(a, b)
    for a, c in zip(_sorted_export(port), _sorted_export(plain)):
        np.testing.assert_array_equal(a, c)
    # a missing key reads zeros, freq 0 and version -1
    v, f, ver, found = port.get(np.asarray([10 ** 9]))
    assert not found[0] and f[0] == 0 and ver[0] == -1 and not v.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_erase_keeps_the_jax_slot_layout(seed):
    """The port's erase re-places only the clusters it touches (and the one
    that wraps past the last slot); the JAX store re-puts every key. After
    every put and erase of a dense, erase-heavy sequence (up to 74 % load,
    clusters that wrap) both export the same rows in the same slot order."""
    rng = np.random.default_rng(seed)
    port, jax_kv = HostKV(2, 1024), JaxHostKV(2, 1024)
    live = np.zeros(0, np.int64)
    for step in range(60):
        if step % 3 < 2:
            keys = rng.integers(-5000, 5000, size=int(rng.integers(1, 200)))
            if len(live) + len(keys) > 740:
                keys = keys[:max(0, 740 - len(live))]
            vals = rng.standard_normal((len(keys), 2)).astype(np.float32)
            for kv in (port, jax_kv):
                kv.put(keys, vals, np.arange(len(keys)), np.full(len(keys), step))
            live = np.union1d(live, keys)
        else:
            keys = np.concatenate([rng.choice(live, min(len(live), int(rng.integers(1, 120)))),
                                   [10 ** 7]]) if len(live) else np.asarray([1])
            for kv in (port, jax_kv):
                kv.erase(keys)
            live = np.setdiff1d(live, keys)
        assert len(port) == len(jax_kv) == len(live)
        for a, b in zip(port.export(), jax_kv.export()):
            np.testing.assert_array_equal(a, b, err_msg=f"step {step}")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port"),
                                           ("plain", "port"), ("port", "plain")])
def test_spill_files_cross_read(tmp_path, writer, reader):
    """A host-store spill written by one store loads in another, and the
    spills of the port and the JAX package are the same bytes."""
    make = {"port": HostKV, "jax": JaxHostKV, "plain": PlainHostKV}
    ops = _ops(7, 5)
    src = make[writer](5, 1024)
    _run(src, ops)
    path = str(tmp_path / "spill.bin")
    src.save(path)
    assert tmt._spill_dim(path) == jmt._spill_dim(path) == 5
    dst = make[reader](5, 1024)
    dst.load(path)
    for a, b in zip(_sorted_export(dst), _sorted_export(src)):
        np.testing.assert_array_equal(a, b)
    if {writer, reader} == {"port", "jax"}:
        other = make[reader](5, 1024)
        _run(other, ops)
        other.save(str(tmp_path / "other.bin"))
        assert (tmp_path / "spill.bin").read_bytes() == (tmp_path / "other.bin").read_bytes()
    with pytest.raises(IOError):
        make[reader](6, 1024).load(path)  # another width


def _disk_ops(kv):
    """Puts with overwrites (enough to compact), erases, a save, then a tail
    appended after the save (a crash: no save, no close)."""
    keys = np.arange(300, dtype=np.int64)
    for r in range(5):
        kv.put(keys[r * 20:], np.full((300 - r * 20, 3), float(r), np.float32),
               np.full(300 - r * 20, r, np.int32), np.full(300 - r * 20, -r, np.int32))
    kv.erase(keys[:17])
    kv.save()
    kv.put(np.asarray([5, 400], np.int64), np.full((2, 3), 9.5, np.float32))
    kv._f.flush()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_disk_logs_cross_read(tmp_path, writer):
    """A DiskKV log written by either package opens in the other with the
    same contents, its tail past the sidecar's `_len` scanned; the same
    operations write the same log and sidecar bytes in both."""
    mods = {"port": tmt, "jax": jmt}
    paths = {}
    for name, mod in mods.items():
        paths[name] = str(tmp_path / f"{name}.ssd")
        _disk_ops(mod.DiskKV(paths[name], dim=3))
    for suffix in ("", ".idx"):
        assert (open(paths["port"] + suffix, "rb").read()
                == open(paths["jax"] + suffix, "rb").read()), suffix
    reader = "jax" if writer == "port" else "port"
    back = mods[reader].DiskKV(paths[writer])  # dim from the header
    want = mods[writer].DiskKV(paths[writer], dim=3)
    keys = np.arange(-2, 402, dtype=np.int64)
    for a, b in zip(back.get(keys), want.get(keys)):
        np.testing.assert_array_equal(a, b)
    vals, freqs, _, found = back.get(np.asarray([5, 400, 16, 17, 299]))
    assert found.tolist() == [True, True, False, True, True]
    np.testing.assert_array_equal(vals[:2, 0], [9.5, 9.5])  # the crash tail
    assert freqs[3] == 0 and freqs[4] == 4
    assert len(back) == len(want) == 300 - 17 + 2


def test_disk_log_checks_width_and_magic(tmp_path):
    p = str(tmp_path / "log.ssd")
    tmt.DiskKV(p, dim=4).close()
    with pytest.raises(ValueError, match="4 wide"):
        tmt.DiskKV(p, dim=5)
    (tmp_path / "bad.ssd").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="magic"):
        tmt.DiskKV(str(tmp_path / "bad.ssd"))
    with pytest.raises(FileNotFoundError):
        tmt.DiskKV(str(tmp_path / "none.ssd"))


def test_disk_compaction_matches_jax(tmp_path):
    """tests/test_multi_tier.py::test_diskkv_compaction_bounds_log on the
    port's DiskKV: overwrites compact the log (bounded, the latest round
    survives), a forced compaction after erases keeps 8 records, a reopen
    indexes them; the JAX DiskKV writes the same bytes."""
    sizes = {}
    for name, mod in (("port", tmt), ("jax", jmt)):
        path = str(tmp_path / f"{name}.ssd")
        kv = mod.DiskKV(path, dim=4)
        keys = np.arange(256, dtype=np.int64)
        for r in range(16):
            kv.put(keys, np.full((256, 4), float(r), np.float32),
                   np.full(256, r, np.int32), np.zeros(256, np.int32))
        total = os.path.getsize(path) // kv.rec_bytes
        assert total <= 2 * 256 + 256
        vals, _, _, found = kv.get(keys)
        assert found.all() and np.all(vals == 15.0)
        kv.erase(keys[8:])
        assert kv.compact(force=True)
        assert os.path.getsize(path) // kv.rec_bytes == 8
        kv.save()
        kv.close()
        kv2 = mod.DiskKV(path, dim=4)
        assert len(kv2) == 8
        vals, _, _, found = kv2.get(keys[:8])
        assert found.all() and np.all(vals == 15.0)
        sizes[name] = (total, open(path, "rb").read(), json.load(open(path + ".idx")))
    assert sizes["port"] == sizes["jax"]


def test_disk_batched_reads_coalesce(tmp_path):
    """tests/test_multi_tier.py::test_diskkv_batched_reads_coalesce at
    20,000 rows: a contiguous read is one run, a shuffled subset reads right
    in at most one run per hit, a half-rewritten log in at most 3 runs; the
    run counts equal the JAX DiskKV's."""
    runs = {}
    for name, mod in (("port", tmt), ("jax", jmt)):
        kv = mod.DiskKV(str(tmp_path / f"{name}.ssd"), dim=8)
        n = 20_000
        keys = np.arange(n, dtype=np.int64)
        vals = np.arange(n, dtype=np.float32)[:, None].repeat(8, 1)
        kv.put(keys, vals, np.ones(n, np.int32), np.ones(n, np.int32))
        got, _, _, found = kv.get(keys)
        assert found.all() and np.array_equal(got[:, 0], np.arange(n, dtype=np.float32))
        r = [kv.last_reads]
        some = np.random.RandomState(0).permutation(n)[:1000]
        got2, _, _, found2 = kv.get(some)
        assert found2.all() and np.array_equal(got2[:, 0], some.astype(np.float32))
        r.append(kv.last_reads)
        kv.put(keys[: n // 2], vals[: n // 2] + 1.0)
        got3, _, _, found3 = kv.get(keys)
        assert found3.all() and np.array_equal(got3[: n // 2, 0], np.arange(n // 2) + 1.0)
        r.append(kv.last_reads)
        kv.close()
        runs[name] = r
    assert runs["port"][0] == 1 and runs["port"][1] <= 1000 and runs["port"][2] <= 3
    assert runs["port"] == runs["jax"]


def test_spill_dim(tmp_path):
    """The width of a native spill's header, of an .npz spill, and a
    missing file, as the JAX `_spill_dim` reads them."""
    kv = HostKV(7)
    kv.put(np.arange(3), np.ones((3, 7), np.float32))
    kv.save(str(tmp_path / "a.bin"))
    np.savez(str(tmp_path / "b.npz"), values=np.zeros((2, 11), np.float32))
    for name in ("a.bin", "b", "b.npz"):
        p = str(tmp_path / name)
        assert tmt._spill_dim(p) == jmt._spill_dim(p)
    assert tmt._spill_dim(str(tmp_path / "a.bin")) == 7
    with pytest.raises(FileNotFoundError):
        tmt._spill_dim(str(tmp_path / "none.bin"))


def test_library_built_from_the_port_source_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The library is build/deeprec_tpu_torch/libhost_kv-<digest>.so, built
    from deeprec_tpu_torch/native/host_kv.cpp; a source that does not
    compile raises, and HostKV has no fallback."""
    lib = native.load_library()
    path = native._lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.SOURCE == Path(native.__file__).parent / "host_kv.cpp"
    assert lib is native.load_library()
    bad = tmp_path / "host_kv.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        HostKV(4)
