"""The native host runtime — the port's copy of `deeprec_tpu/native/`:
the host-DRAM key-value store of the multi-tier tables (`HostKV`, over
`host_kv.cpp`), the Criteo TSV parser (`criteo_parse_native`, over
`csv_parser.cpp`) and the serving C ABI (`load_processor_library`, over
`processor.cpp`, with the pure-C host `chost_demo.c` that boots it).

Each library builds at first use with `g++ -O3 -std=c++17 -fPIC -shared
-pthread` into `build/deeprec_tpu_torch/` at the checkout root, named by a
digest of its source and the flags (as `ops/_build.py` names the CUDA
libraries), and loads with ctypes. A failed build or load raises: there is
no silent fallback on the main path. The processor library also
compiles against the running interpreter's headers and links its
libpython (sysconfig's INCLUDEPY, LIBDIR and LDLIBRARY), so a C host that
dlopens it boots an embedded interpreter. `PlainHostKV` is a numpy dict with the
same interface, the reference the tests hold the native store against;
nothing else uses it. The parser's plain reference is
`data/readers.criteo_block_parse`.

Neither store is thread-safe: `MultiTierTable` serializes every access
(its background rounds own the store while they run).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

from deeprec_tpu_torch.analysis.annotations import not_thread_safe
from deeprec_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "host_kv.cpp"
CSV_SOURCE = Path(__file__).resolve().parent / "csv_parser.cpp"
PROCESSOR_SOURCE = Path(__file__).resolve().parent / "processor.cpp"
CHOST_SOURCE = Path(__file__).resolve().parent / "chost_demo.c"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lib = None
_csv_lib = None
_proc_lib = None
_lock = threading.Lock()


def _python_flags():
    """(compile flags, link flags) of the running interpreter, from
    sysconfig: its headers, and its shared libpython where it has one (a
    static interpreter exports the symbols itself, so a library loaded into
    it links nothing)."""
    cflags = [f"-I{sysconfig.get_config_var('INCLUDEPY')}"]
    libdir = sysconfig.get_config_var("LIBDIR")
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    lflags = []
    if sysconfig.get_config_var("Py_ENABLE_SHARED") and ldlib.startswith("lib"):
        name = ldlib[3:].split(".so")[0].split(".dylib")[0]
        lflags = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{name}"]
    return cflags, lflags


def _lib_path(source: Path = None, flags=CXX_FLAGS, name: str = None) -> Path:
    """build/deeprec_tpu_torch/<name>-<digest>[.so] of `source` (the host
    store's by default; `name` defaults to lib<stem>.so), the digest over
    the source and the flags."""
    source = SOURCE if source is None else source
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    stem, _, suffix = (name or f"lib{source.stem}.so").partition(".")
    return BUILD_DIR / (f"{stem}-{digest}" + (f".{suffix}" if suffix else ""))


def _build(out: Path, source: Path = None, flags=CXX_FLAGS, link=(),
           compilers=("g++", "c++")) -> None:
    source = SOURCE if source is None else source
    cxx = next((c for c in map(shutil.which, compilers) if c), None)
    if cxx is None:
        raise RuntimeError(f"{source.stem}: no compiler ({compilers[0]}) to build {source.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source), *link],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{source.stem}: {os.path.basename(cxx)} failed "
                           f"(exit {proc.returncode}):\n" + proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def _configure(lib: ctypes.CDLL) -> None:
    """The JAX package's ctypes signatures, one for one."""
    u64, i64p, f32p, i32p, u8p = (
        ctypes.c_uint64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.float32, flags="C"),
        np.ctypeslib.ndpointer(np.int32, flags="C"),
        np.ctypeslib.ndpointer(np.uint8, flags="C"),
    )
    lib.hkv_create.restype = ctypes.c_void_p
    lib.hkv_create.argtypes = [ctypes.c_int, u64]
    lib.hkv_destroy.argtypes = [ctypes.c_void_p]
    lib.hkv_size.restype = u64
    lib.hkv_size.argtypes = [ctypes.c_void_p]
    lib.hkv_put_batch.argtypes = [ctypes.c_void_p, u64, i64p, f32p, i32p, i32p]
    lib.hkv_get_batch.argtypes = [ctypes.c_void_p, u64, i64p, f32p, i32p, i32p, u8p]
    lib.hkv_erase_batch.argtypes = [ctypes.c_void_p, u64, i64p]
    lib.hkv_export.argtypes = [ctypes.c_void_p, i64p, f32p, i32p, i32p]
    lib.hkv_save.restype = ctypes.c_int
    lib.hkv_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.hkv_load.restype = ctypes.c_int
    lib.hkv_load.argtypes = [ctypes.c_void_p, ctypes.c_char_p]


def load_library() -> ctypes.CDLL:
    """The loaded host-store library, building it first if needed. Raises
    when the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            _lib = lib
        return _lib


def _configure_csv(lib: ctypes.CDLL) -> None:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    head = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    tail = [f32p, f32p, i32p, ctypes.POINTER(ctypes.c_int64)]
    lib.criteo_parse.restype = ctypes.c_int64
    lib.criteo_parse.argtypes = head + tail
    lib.criteo_parse_mt.restype = ctypes.c_int64
    lib.criteo_parse_mt.argtypes = head + [ctypes.c_int] + tail


def load_csv_library() -> ctypes.CDLL:
    """The loaded Criteo parser library, building it first if needed.
    Raises when the build or the load fails."""
    global _csv_lib
    with _lock:
        if _csv_lib is None:
            path = _lib_path(CSV_SOURCE)
            if not path.exists():
                _build(path, CSV_SOURCE)
            lib = ctypes.CDLL(str(path))
            _configure_csv(lib)
            _csv_lib = lib
        return _csv_lib


def _configure_processor(lib: ctypes.CDLL) -> None:
    """The C ABI's signatures (native/processor.cpp)."""
    vp, ip, vpp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p)
    lib.initialize.restype = vp
    lib.initialize.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ip]
    lib.process.restype = ctypes.c_int
    lib.process.argtypes = [vp, ctypes.c_char_p, ctypes.c_int, vpp, ip]
    lib.get_serving_model_info.restype = ctypes.c_int
    lib.get_serving_model_info.argtypes = [vp, vpp, ip]
    lib.batch_process.restype = ctypes.c_int
    lib.batch_process.argtypes = [vp, ctypes.POINTER(ctypes.c_char_p), ip, vpp, ip]
    lib.batch_process_n.restype = ctypes.c_int
    lib.batch_process_n.argtypes = [vp, ctypes.POINTER(ctypes.c_char_p), ip,
                                    ctypes.c_int, vpp, ip]
    lib.free_buffer.argtypes = [vp]
    lib.shutdown_processor.argtypes = [vp]


def processor_library_path() -> Path:
    """The processor library's path, built first if needed (raises when the
    build fails). What an external host dlopens."""
    cflags, lflags = _python_flags()
    flags = ["-O2", "-std=c++17", "-fPIC", "-shared", "-Wall", *cflags]
    path = _lib_path(PROCESSOR_SOURCE, flags + lflags, "libdeeprec_processor.so")
    with _lock:
        if not path.exists():
            _build(path, PROCESSOR_SOURCE, flags, lflags)
    return path


def load_processor_library() -> ctypes.CDLL:
    """The serving C ABI loaded into this process with ctypes (the
    interpreter is already running, so `initialize` skips its boot)."""
    global _proc_lib
    path = processor_library_path()
    with _lock:
        if _proc_lib is None:
            lib = ctypes.CDLL(str(path))
            _configure_processor(lib)
            _proc_lib = lib
        return _proc_lib


def build_chost_demo() -> Path:
    """The pure-C host (chost_demo.c: dlopen the processor library, boot
    the interpreter, serve one request), built with cc at first use."""
    flags = ["-O2", "-Wall"]
    path = _lib_path(CHOST_SOURCE, flags, "chost_demo")
    with _lock:
        if not path.exists():
            _build(path, CHOST_SOURCE, flags, ["-ldl"], compilers=("cc", "gcc"))
    return path


def criteo_parse_native(buf: bytes, max_rows: int, num_dense: int = 13,
                        num_cat: int = 26, threads: int = 0):
    """Parse up to `max_rows` complete lines of Criteo TSV bytes with the
    native parser: multi-threaded (`criteo_parse_mt`; threads=0 picks the
    hardware count, capped at 16) or, with threads=1, single-threaded
    (`criteo_parse`). Both give the same bits.

    Returns (rows, labels [max_rows] f32, dense [max_rows, num_dense] f32,
    cats [max_rows, num_cat] i32, consumed_bytes); `consumed` ends on a
    line boundary. The ids are `(crc32(token) ^ salt_c) & 0x7fffffff` with
    the salts of `data/readers.criteo_hash_salts`, -1 for an empty token."""
    lib = load_csv_library()
    labels = np.zeros(max_rows, np.float32)
    dense = np.zeros((max_rows, num_dense), np.float32)
    cats = np.zeros((max_rows, num_cat), np.int32)
    consumed = ctypes.c_int64(0)
    if threads != 1:
        rows = lib.criteo_parse_mt(
            buf, len(buf), max_rows, num_dense, num_cat, threads, labels,
            dense.reshape(-1), cats.reshape(-1), ctypes.byref(consumed))
    else:
        rows = lib.criteo_parse(
            buf, len(buf), max_rows, num_dense, num_cat, labels,
            dense.reshape(-1), cats.reshape(-1), ctypes.byref(consumed))
    return int(rows), labels, dense, cats, int(consumed.value)


@not_thread_safe
class HostKV:
    """int64 key -> (float32[dim] row, freq, version) host store, native
    (`host_kv.cpp`). Not thread-safe."""

    def __init__(self, dim: int, initial_capacity: int = 1 << 16):
        self.dim = dim
        self._lib = load_library()
        self._h = self._lib.hkv_create(dim, initial_capacity)

    def __len__(self) -> int:
        return int(self._lib.hkv_size(self._h))

    def put(self, keys, values, freqs=None, versions=None) -> None:
        """Insert or overwrite rows (freq 0 and version -1 by default)."""
        keys = np.ascontiguousarray(keys, np.int64)
        values = np.ascontiguousarray(values, np.float32).reshape(len(keys), self.dim)
        freqs = np.ascontiguousarray(
            freqs if freqs is not None else np.zeros(len(keys)), np.int32)
        versions = np.ascontiguousarray(
            versions if versions is not None else np.full(len(keys), -1), np.int32)
        self._lib.hkv_put_batch(self._h, len(keys), keys, values, freqs, versions)

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """-> (values [n, dim], freqs [n], versions [n], found [n] bool); a
        missing key reads zeros, freq 0 and version -1."""
        keys = np.ascontiguousarray(keys, np.int64)
        n = len(keys)
        values = np.zeros((n, self.dim), np.float32)
        freqs = np.zeros(n, np.int32)
        versions = np.full(n, -1, np.int32)
        found = np.zeros(n, np.uint8)
        self._lib.hkv_get_batch(self._h, n, keys, values, freqs, versions, found)
        return values, freqs, versions, found.astype(bool)

    def erase(self, keys) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        self._lib.hkv_erase_batch(self._h, len(keys), keys)

    def export(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Every row in the store's slot order: (keys, values, freqs,
        versions)."""
        n = len(self)
        keys = np.zeros(n, np.int64)
        values = np.zeros((n, self.dim), np.float32)
        freqs = np.zeros(n, np.int32)
        versions = np.zeros(n, np.int32)
        self._lib.hkv_export(self._h, keys, values, freqs, versions)
        return keys, values, freqs, versions

    def save(self, path: str) -> None:
        """Spill file: magic 0xDEE99EC0011, dim and n (u64 each), then per
        row key i64, values f32[dim], freq i32, version i32."""
        rc = self._lib.hkv_save(self._h, path.encode())
        if rc != 0:
            raise IOError(f"hkv_save({path}) failed rc={rc}")

    def load(self, path: str) -> None:
        rc = self._lib.hkv_load(self._h, path.encode())
        if rc != 0:
            raise IOError(f"hkv_load({path}) failed rc={rc}")

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            try:
                self._lib.hkv_destroy(self._h)
            except Exception:
                pass
            self._h = None


class PlainHostKV:
    """The plain reference of `HostKV`: a dict with the same interface and
    the same spill format (its export runs in insertion order, not the
    native slot order). Used by the tests only."""

    MAGIC = 0xDEE99EC0011

    def __init__(self, dim: int, initial_capacity: int = 1 << 16):
        del initial_capacity
        self.dim = dim
        self._rows = {}

    def __len__(self) -> int:
        return len(self._rows)

    def put(self, keys, values, freqs=None, versions=None) -> None:
        keys = np.asarray(keys, np.int64)
        values = np.asarray(values, np.float32).reshape(len(keys), self.dim)
        freqs = np.zeros(len(keys), np.int32) if freqs is None else np.asarray(freqs, np.int32)
        versions = (np.full(len(keys), -1, np.int32) if versions is None
                    else np.asarray(versions, np.int32))
        for i, k in enumerate(keys):
            self._rows[int(k)] = (values[i].copy(), int(freqs[i]), int(versions[i]))

    def get(self, keys):
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        values = np.zeros((n, self.dim), np.float32)
        freqs = np.zeros(n, np.int32)
        versions = np.full(n, -1, np.int32)
        found = np.zeros(n, bool)
        for i, k in enumerate(keys):
            hit = self._rows.get(int(k))
            if hit is not None:
                values[i], freqs[i], versions[i] = hit
                found[i] = True
        return values, freqs, versions, found

    def erase(self, keys) -> None:
        for k in np.asarray(keys, np.int64):
            self._rows.pop(int(k), None)

    def export(self):
        n = len(self._rows)
        keys = np.zeros(n, np.int64)
        values = np.zeros((n, self.dim), np.float32)
        freqs = np.zeros(n, np.int32)
        versions = np.zeros(n, np.int32)
        for i, (k, (v, f, ver)) in enumerate(self._rows.items()):
            keys[i], values[i], freqs[i], versions[i] = k, v, f, ver
        return keys, values, freqs, versions

    def _records(self) -> np.dtype:
        return np.dtype([("key", "<i8"), ("val", "<f4", (self.dim,)),
                         ("freq", "<i4"), ("ver", "<i4")])

    def save(self, path: str) -> None:
        k, v, f, ver = self.export()
        recs = np.zeros(len(k), self._records())
        recs["key"], recs["val"], recs["freq"], recs["ver"] = k, v, f, ver
        with open(path, "wb") as out:
            np.asarray([self.MAGIC, self.dim, len(k)], "<u8").tofile(out)
            recs.tofile(out)

    def load(self, path: str) -> None:
        with open(path, "rb") as f:
            magic, dim, n = np.fromfile(f, "<u8", 3)
            if int(magic) != self.MAGIC or int(dim) != self.dim:
                raise IOError(f"{path}: not a host-store spill of dim {self.dim}")
            recs = np.fromfile(f, self._records(), int(n))
        self.put(recs["key"], recs["val"], recs["freq"], recs["ver"])
