"""Sampled cross-process request tracing with Chrome-trace/Perfetto
output.

One trace id is born at the HTTP edge (or extracted from the
``X-Deeprec-Trace`` request header), rides the frontend's length-prefixed
TCP frames into the backend (a flag bit on the PRED frame prefixes the
npz body with two little-endian u64s: trace id, parent span id), and
stamps every micro-batcher stage span (queue / pad / device / post) the
request passes through. Training-side spans — ``PhaseProfiler.phase``,
the checkpoint writer, the multi-tier worker, the delta poll loop —
carry no trace id (they are process-timeline events), but land in the
same files, so one train→delta→serve timeline can be rendered from them.

Event transport is an append-only JSONL file (one self-contained Chrome
"X" event per line): append mode means a supervisor-restarted worker
keeps extending the same file — the trace survives the process, which is
the point of tracing a fault. Wrapping the lines of one or many files as
``{"traceEvents": [...]}`` gives a file ui.perfetto.dev opens.

OFF BY DEFAULT, and free when off: ``span()``/``server_span()`` return a
module-level no-op singleton — no object is allocated on the disabled
path (pinned by a tracemalloc test). Enable with ``DEEPREC_TRACE=<path>``
(sample rate via ``DEEPREC_TRACE_SAMPLE``, default 1.0) or
``trace.configure(path, sample=...)``.

The port's copy of `deeprec_tpu/obs/trace.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

import atexit
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "configure",
    "shutdown",
    "tracing_enabled",
    "span",
    "server_span",
    "start_request",
    "current",
    "emit",
    "to_header",
    "from_header",
    "pack_wire",
    "unpack_wire",
    "WIRE_BYTES",
]

_lock = threading.Lock()
_path: Optional[str] = None
_sample: float = 1.0
_service: str = ""
_buffer: List[dict] = []
_FLUSH_EVERY = 256
_rng = random.Random()
_tls = threading.local()

# env autoconfiguration: a spawned worker (supervisor, bench subprocess)
# inherits tracing from its parent through the environment
_env_path = os.environ.get("DEEPREC_TRACE")
if _env_path:
    _path = _env_path
    try:
        _sample = float(os.environ.get("DEEPREC_TRACE_SAMPLE", "1.0"))
    except ValueError:
        _sample = 1.0


def tracing_enabled() -> bool:
    return _path is not None


def configure(path: str, sample: float = 1.0, service: str = "") -> None:
    """Start appending spans to `path` (created if missing, appended if
    present — restarts extend, never truncate). `sample` is the fraction
    of edge requests that start a trace; propagated contexts are always
    honored."""
    global _path, _sample, _service
    with _lock:
        _flush_locked()
        _path = path
        _sample = float(sample)
        _service = service or ""


def shutdown() -> None:
    """Flush and disable (tests; atexit flushes without disabling)."""
    global _path
    with _lock:
        _flush_locked()
        _path = None


def _flush_locked() -> None:
    global _buffer
    if not _buffer or _path is None:
        _buffer = []
        return
    lines = "".join(json.dumps(e, separators=(",", ":")) + "\n"
                    for e in _buffer)
    _buffer = []
    try:
        with open(_path, "a", encoding="utf-8") as f:
            f.write(lines)
    except OSError:
        pass  # tracing must never take the serving path down


def flush() -> None:
    with _lock:
        _flush_locked()


atexit.register(flush)


# ------------------------------------------------------------ span context


def _new_ctx(parent: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """(trace_id, span_id) — ids are 63-bit so they survive JSON/np
    int64 round trips."""
    tid = parent[0] if parent else _rng.getrandbits(63) or 1
    return (tid, _rng.getrandbits(63) or 1)


def child(ctx: Tuple[int, int]) -> Tuple[int, int]:
    """A fresh span id under `ctx`'s trace (retrospective emitters that
    bypass the span context manager)."""
    return (ctx[0], _rng.getrandbits(63) or 1)


def current() -> Optional[Tuple[int, int]]:
    """The calling thread's active (trace_id, span_id), if a span is
    open on it."""
    return getattr(_tls, "ctx", None)


def emit(name: str, cat: str, t0: float, t1: float,
         ctx: Optional[Tuple[int, int]] = None,
         parent: Optional[int] = None,
         args: Optional[Dict] = None) -> None:
    """Record one complete ("X") event from wall-clock endpoints —
    the retrospective entry point (the micro-batcher accounts stage
    times first and emits after the fact). No-op when tracing is off."""
    if _path is None:
        return
    ev = {
        "name": name,
        "cat": cat or "deeprec",
        "ph": "X",
        "ts": int(t0 * 1e6),
        "dur": max(int((t1 - t0) * 1e6), 0),
        "pid": os.getpid(),
        "tid": threading.get_ident() & 0xFFFFFFFF,
    }
    a = dict(args) if args else {}
    if ctx is not None:
        a["trace"] = "%016x" % ctx[0]
        a["span"] = "%016x" % ctx[1]
        if parent is not None:
            a["parent"] = "%016x" % parent
    if _service:
        a.setdefault("service", _service)
    if a:
        ev["args"] = a
    with _lock:
        _buffer.append(ev)
        if len(_buffer) >= _FLUSH_EVERY:
            _flush_locked()


class _Span:
    """An open span: times itself, publishes its ctx as the thread's
    current so nested spans parent under it."""

    __slots__ = ("name", "cat", "ctx", "parent", "_t0", "_prev")

    def __init__(self, name: str, cat: str, ctx: Tuple[int, int],
                 parent: Optional[int]):
        self.name = name
        self.cat = cat
        self.ctx = ctx
        self.parent = parent
        self._t0 = 0.0
        self._prev = None

    def __enter__(self) -> "_Span":
        self._t0 = time.time()
        self._prev = getattr(_tls, "ctx", None)
        _tls.ctx = self.ctx
        return self

    def __exit__(self, *exc) -> None:
        _tls.ctx = self._prev
        emit(self.name, self.cat, self._t0, time.time(), self.ctx,
             self.parent)


class _NoopSpan:
    """THE disabled-path object: one module-level instance, returned by
    every span() call while tracing is off or the request unsampled —
    the zero-allocation contract tests pin by identity and tracemalloc."""

    __slots__ = ()
    ctx = None
    parent = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP_SPAN = _NoopSpan()


def span(name: str, cat: str = "",
         ctx: Optional[Tuple[int, int]] = None):
    """A child span of `ctx` (or of the thread's current span). Returns
    the no-op singleton unless tracing is on AND there is a sampled
    context to attach to — bare spans inside an unsampled request cost
    nothing."""
    if _path is None:
        return NOOP_SPAN
    parent = ctx if ctx is not None else getattr(_tls, "ctx", None)
    if parent is None:
        return NOOP_SPAN
    return _Span(name, cat, (parent[0], _rng.getrandbits(63) or 1),
                 parent[1])


def start_request(sample: Optional[float] = None) -> Optional[Tuple[int, int]]:
    """Edge-side sampling decision: a fresh (trace_id, span_id) for this
    request, or None (unsampled / tracing off)."""
    if _path is None:
        return None
    s = _sample if sample is None else sample
    if s < 1.0 and _rng.random() >= s:
        return None
    return _new_ctx()


def server_span(name: str, cat: str = "",
                header: Optional[str] = None,
                ctx: Optional[Tuple[int, int]] = None):
    """The serving entry points' span: continue a propagated context
    (wire prefix or HTTP header), else make the edge sampling decision.
    Returns the no-op singleton when nothing is traced."""
    if _path is None:
        return NOOP_SPAN
    parent = ctx
    if parent is None and header:
        parent = from_header(header)
    if parent is not None:
        return _Span(name, cat, (parent[0], _rng.getrandbits(63) or 1),
                     parent[1])
    fresh = start_request()
    if fresh is None:
        return NOOP_SPAN
    return _Span(name, cat, fresh, None)


def phase_span(name: str, t0: float, t1: float, cat: str = "train") -> None:
    """Training-side timeline event (PhaseProfiler, checkpoint writer,
    tier worker, delta poll): no trace id — rendered on the
    process/thread track. Flushed IMMEDIATELY: these are low-rate
    (save/poll cadence) and the processes emitting them get SIGKILLed by
    design (fault benches) — a buffered span that dies with the process
    defeats the point of tracing the fault."""
    if _path is None:
        return
    emit(name, cat, t0, t1, ctx=getattr(_tls, "ctx", None))
    flush()


# ------------------------------------------------------------ propagation

HEADER = "X-Deeprec-Trace"
WIRE_BYTES = 16  # two little-endian u64s: trace_id, parent span_id


def to_header(ctx: Tuple[int, int]) -> str:
    return "%016x-%016x" % (ctx[0], ctx[1])


def from_header(value: Optional[str]) -> Optional[Tuple[int, int]]:
    if not value:
        return None
    try:
        t, s = value.strip().split("-", 1)
        ctx = (int(t, 16), int(s, 16))
    except ValueError:
        return None
    return ctx if ctx[0] else None


def pack_wire(ctx: Tuple[int, int]) -> bytes:
    import struct

    return struct.pack("<QQ", ctx[0], ctx[1])


def unpack_wire(raw: bytes) -> Optional[Tuple[int, int]]:
    import struct

    if len(raw) < WIRE_BYTES:
        return None
    t, s = struct.unpack("<QQ", raw[:WIRE_BYTES])
    return (t, s) if t else None
