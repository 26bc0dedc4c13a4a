"""Runtime trace-guard: assert a kernel-build budget over a code region —
the port's copy of `deeprec_tpu/analysis/trace_guard.py`.

The JAX guard counts XLA compilations. The port compiles nothing at run
time but its CUDA kernels: `ops/_build.py` runs nvcc for a source whose
library is not built yet and loads each library at its kernel's first
launch, and counts both (`_build.counts`). A build or a first load inside a
steady-state region means a kernel was not built or launched before it —
seconds of nvcc, or a library load, next to the step:

    from deeprec_tpu_torch.analysis import trace_guard

    with trace_guard(max_compiles=0) as g:
        state, mets = trainer.train_steps(state, batches)
    print(g.compiles, g.traces)           # builds, first loads

`compile_count()` is the process's count of nvcc builds, `trace_count()`
its count of first library loads; the budget bounds the builds, as the JAX
budget bounds the compiles, and the loads are reported beside them. The
port captures no CUDA graph, so there is nothing else to count. Counters
are process-wide: a guard sees builds from any thread inside its window.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional


class TraceGuardViolation(AssertionError):
    """A guarded region built more kernel libraries than its budget."""

    def __init__(self, message: str, compiles: int, max_compiles: int):
        super().__init__(message)
        self.compiles = compiles
        self.max_compiles = max_compiles


def _counts() -> dict:
    from deeprec_tpu_torch.ops import _build

    return _build.counts


def compile_count() -> int:
    """Process-lifetime count of nvcc builds of a kernel source."""
    return _counts()["builds"]


def trace_count() -> int:
    """Process-lifetime count of kernel libraries loaded (first loads)."""
    return _counts()["loads"]


class _Guard:
    """Live view of a guarded region's counters."""

    def __init__(self, c0: int, t0: int):
        self._c0 = c0
        self._t0 = t0

    @property
    def compiles(self) -> int:
        return compile_count() - self._c0

    @property
    def traces(self) -> int:
        return trace_count() - self._t0


@contextmanager
def trace_guard(max_compiles: Optional[int] = 0, note: str = ""):
    """Context manager asserting the region runs at most ``max_compiles``
    nvcc builds (``None`` = measure only, never raise). Yields a guard
    whose ``.compiles`` (builds) and ``.traces`` (first library loads) read
    live and remain valid after exit. Exceptions from the body propagate
    unchanged (the budget is not checked on an already-failing region)."""
    g = _Guard(compile_count(), trace_count())
    # a body exception propagates from the yield and skips the check
    yield g
    if max_compiles is not None and g.compiles > max_compiles:
        where = f" [{note}]" if note else ""
        raise TraceGuardViolation(
            f"trace_guard{where}: region built {g.compiles} kernel "
            f"librar{'y' if g.compiles == 1 else 'ies'}, budget {max_compiles} — a "
            "kernel source was not built before the region (call "
            "ops._build.build_all() at set-up, or warm the path first)",
            g.compiles, max_compiles)
