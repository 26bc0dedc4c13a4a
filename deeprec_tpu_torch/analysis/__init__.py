"""deeprec_tpu_torch.analysis — static lints and the runtime trace-guard,
the port's copy of `deeprec_tpu/analysis/`.

  * ``python -m deeprec_tpu_torch.analysis --check`` — the AST lint suite
    (DRT001–DRT007, see lint.py) against its checked-in baseline.
  * ``trace_guard(max_compiles=N)`` — a kernel-build budget over a region
    (`ops/_build.py`'s nvcc builds and library loads).
  * ``annotations`` — the @not_thread_safe / @guarded_by vocabulary the
    DRT004 lint reads.

The lint half is pure-AST: it never imports or executes the code it
analyzes.
"""
from deeprec_tpu_torch.analysis.annotations import guarded_by, not_thread_safe
from deeprec_tpu_torch.analysis.trace_guard import (
    TraceGuardViolation,
    compile_count,
    trace_count,
    trace_guard,
)

__all__ = [
    "guarded_by",
    "not_thread_safe",
    "trace_guard",
    "TraceGuardViolation",
    "compile_count",
    "trace_count",
]
