"""Build and load the package's CUDA kernels (plain C interface + ctypes).

Each `csrc/<name>.cu` compiles with nvcc for sm_90a into a shared library
under `build/deeprec_tpu_torch/` at the checkout root, named by a digest of
its source and flags, so a changed source rebuilds and an unchanged one
loads as is.
Nothing builds at import time: `load` runs at a kernel's first launch, and
`build_all` starts one nvcc per source at once (set-up time of a run).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deeprec_tpu_torch"
# -fmad=false: no a*b+c contraction into one FMA, so a kernel's float
# arithmetic rounds after every operation, as its plain PyTorch version does.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

# ctypes signatures of each library's launcher: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as 64-bit.
_SIGNATURES = {
    "apply_rows_sr": {
        "apply_rows_sr_launch": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
        + [ctypes.c_int, ctypes.c_void_p],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_dkdv": [ctypes.c_void_p] * 9
        + [ctypes.c_longlong] * 7
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "flash_attention_bwd_dq": [ctypes.c_void_p] * 8
        + [ctypes.c_longlong] * 7
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    },
    "flash_attention_fwd": {
        "flash_attention_fwd_launch": [ctypes.c_void_p] * 6
        + [ctypes.c_longlong] * 7
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    },
    "fused_gather_combine": {
        "fused_gather_combine_launch": [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_void_p],
    },
    "fused_sparse_backward": {
        "fused_sparse_backward_launch": [ctypes.c_void_p] * 10
        + [ctypes.c_longlong] * 6 + [ctypes.c_int] + [ctypes.c_float] * 8
        + [ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "fused_sparse_backward_workspace": [ctypes.c_longlong] * 5,
    },
    "fused_sparse_forward": {
        "fused_sparse_forward_launch": [ctypes.c_void_p] * 8
        + [ctypes.c_longlong] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    },
    "gather_rows": {
        "gather_rows_launch": [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4
        + [ctypes.c_void_p],
    },
}

# Launchers return a CUDA error code (int); these host functions return a size.
_RESTYPES = {"fused_sparse_backward_workspace": ctypes.c_longlong}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(src).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source into a temp file; None if already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n"
            + log.decode(errors="replace")
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build_all() -> List[str]:
    """Compile every kernel source, one nvcc per source, all started
    together. Returns the kernel names."""
    names = sorted(_SIGNATURES)
    with _lock:
        started = {name: _start(name) for name in names}
        for name in names:
            _finish(name, started[name])
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib
