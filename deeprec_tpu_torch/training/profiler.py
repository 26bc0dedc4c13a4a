"""Profiling and tracing — the port of `deeprec_tpu/training/profiler.py`:
`trace` (a torch.profiler run exported as a Chrome trace), `phase_scope`
(the train step's named ranges), `PhaseProfiler` (host-side phase
timings), `LatencyHistogram` and `StepWindowTracer` (modelzoo's
`--timeline N`: steps [N, N + 10) traced).

`PhaseProfiler.phase` also lands each phase as an obs timeline span
(`obs/trace.py`, a no-op unless `DEEPREC_TRACE` is configured), as the JAX
package's does.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


def _start_profiler() -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof: torch.profiler.profile, logdir: str) -> str:
    """Stop `prof` and write its Chrome trace to `logdir`/trace.json."""
    prof.__exit__(None, None, None)
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Profile the enclosed block (host ranges, and the card's kernels on
    CUDA) and write it as a Chrome trace, `<logdir>/trace.json`."""
    os.makedirs(logdir, exist_ok=True)
    prof = _start_profiler()
    try:
        yield logdir
    finally:
        _stop_profiler(prof, logdir)


def phase_scope(name: str):
    """A `phase_<name>` range for torch.profiler (the JAX package's
    `jax.named_scope("phase_<name>")`): a profile attributes host time and
    the device time of the kernels launched inside it to the phase. The
    trainer wraps its step phases in it (lookup, route_next, finish_next,
    dense_fwd_bwd, sparse_apply, dense_apply, tier_sync, tier_fold). Costs a
    few microseconds when no profiler runs."""
    return torch.profiler.record_function(f"phase_{name}")


class PhaseProfiler:
    """Host-side named-phase timings: `phase(name)` wraps a block in a
    `phase_<name>` range and a wall-clock accumulator; `phase_report()`
    returns {phase: {calls, total_ms, mean_ms, min_ms}}."""

    def __init__(self):
        self._times: Dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block=None) -> Iterator[None]:
        """Time the enclosed block under `name`. Pass `block` (anything
        truthy; a tensor's device is used when it has one) to synchronise
        the device before the clock stops, so the kernels the block launched
        count to it and not to the next phase. With obs tracing configured
        (`DEEPREC_TRACE`), the phase also lands as a timeline span."""
        from deeprec_tpu_torch.obs import trace as obs_trace

        t0 = time.perf_counter()
        t0w = time.time()
        with phase_scope(name):
            try:
                yield
            finally:
                if block is not None and torch.cuda.is_available():
                    dev = getattr(block, "device", None)
                    if dev is None or dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                self._times.setdefault(name, []).append(time.perf_counter() - t0)
                obs_trace.phase_span(f"phase_{name}", t0w, time.time())

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn(*args, **kwargs) under `name`, synchronising the device
        before the clock stops; returns its result."""
        with self.phase(name, block=True):
            out = fn(*args, **kwargs)
        return out

    def record(self, name: str, seconds: float) -> None:
        """Fold a duration measured elsewhere into phase `name` (a
        checkpoint's `last_save["stall_ms"]`, a tier sync's stall)."""
        self._times.setdefault(name, []).append(float(seconds))

    def reset(self) -> None:
        self._times.clear()

    def phase_report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self._times.items():
            out[name] = {
                "calls": len(ts),
                "total_ms": round(sum(ts) * 1e3, 3),
                "mean_ms": round(sum(ts) / len(ts) * 1e3, 3),
                "min_ms": round(min(ts) * 1e3, 3),
            }
        return out


class LatencyHistogram:
    """Fixed-bucket log-scale latency histogram: O(1) record, bounded
    memory, mergeable. Buckets grow by 1.5x from `lo` seconds; values past
    the last bound land in an overflow bucket whose estimate is the exact
    max. Thread-safe."""

    GROWTH = 1.5

    def __init__(self, lo: float = 50e-6, hi: float = 120.0):
        bounds = []
        b = lo
        while b < hi:
            bounds.append(b)
            b *= self.GROWTH
        self._bounds = bounds  # upper edge of each bucket, seconds
        self._counts = [0] * (len(bounds) + 1)  # + the overflow bucket
        self._n = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        s = float(seconds)
        i = bisect.bisect_left(self._bounds, s)
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += s
            if s > self._max:
                self._max = s

    def merge(self, other: "LatencyHistogram") -> None:
        with other._lock:
            counts, n = list(other._counts), other._n
            tot, mx = other._sum, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._n += n
            self._sum += tot
            self._max = max(self._max, mx)

    def percentile(self, q: float) -> float:
        """Upper-bucket-edge estimate of the q-quantile in seconds, never
        above the exact max."""
        with self._lock:
            n, counts, mx = self._n, list(self._counts), self._max
        if n == 0:
            return 0.0
        target = min(int(q * n), n - 1)
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen > target:
                return min(self._bounds[i], mx) if i < len(self._bounds) else mx
        return mx

    def summary(self) -> Dict[str, float]:
        """{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms}."""
        with self._lock:
            n, tot, mx = self._n, self._sum, self._max
        return {
            "count": n,
            "mean_ms": round(tot / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(self.percentile(0.50) * 1e3, 3),
            "p90_ms": round(self.percentile(0.90) * 1e3, 3),
            "p99_ms": round(self.percentile(0.99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }


class StepWindowTracer:
    """Trace steps [start, stop) of a training loop into
    `<logdir>/trace.json` (a Chrome trace of torch.profiler)."""

    def __init__(self, start_step: int, stop_step: int, logdir: str):
        self.start = start_step
        self.stop = stop_step
        self.logdir = logdir
        self._prof: Optional[torch.profiler.profile] = None

    def on_step(self, step: int) -> None:
        """Call BEFORE running step `step`. Range-based, so a run resumed
        past `start` still enters the window if any of it remains."""
        if self.start <= step < self.stop and self._prof is None:
            os.makedirs(self.logdir, exist_ok=True)
            self._prof = _start_profiler()
        elif step >= self.stop and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            _stop_profiler(prof, self.logdir)
