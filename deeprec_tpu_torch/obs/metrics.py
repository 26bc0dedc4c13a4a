"""Process-wide metrics registry: labeled counters / gauges / histograms
with per-metric ring-buffer time series and Prometheus-text exposition —
the port's copy of `deeprec_tpu/obs/metrics.py` (standard library only;
the metric names are the JAX package's).

Design constraints (why this is not just a dict of floats):

  * **O(1) record, bounded memory.** Histograms reuse the log-bucket
    design of ``training.profiler.LatencyHistogram`` (geometric bucket
    edges, overflow bucket clamped to the tracked exact max) — record is
    a bisect + one lock. This module deliberately does NOT import that
    class: ``obs`` must be importable with the standard library alone
    (bare subprocesses run it).
  * **A time dimension.** Every metric keeps a fixed-depth ring of
    per-slot aggregates (default 64 slots × 2 s = a ~2 min window), so
    consumers can ask "p99 over the last 60 s", "request rate over the
    window", or "slope of shard imbalance" — the exact primitives the
    multi-host autoscaler and the placement drift detector need, without
    a scrape-and-store stack in the loop.
  * **Mergeable snapshots.** ``snapshot()`` is JSON-ready and
    ``merge_snapshots`` combines them (counters/histograms sum, gauges
    keep the freshest), so the socket frontend can expose one
    ``/metrics`` spanning every backend over the existing STAT-style
    wire protocol — down members re-render their last snapshot
    stale-marked instead of silently disappearing.
  * **Free to turn off.** ``DEEPREC_OBS=off`` makes the registry hand
    out no-op singletons; instrument sites keep their references and pay
    one attribute call. Only host-side values that already exist are
    ever recorded — no device sync, no compile (trace_guard/DRT002 hold
    with instrumentation on).

Label cardinality contract: label values must come from BOUNDED sets
(stage names, table names, member addresses, worker names) — never from
per-request data (user ids, raw keys).
"""
from __future__ import annotations

import bisect
import math
import os
import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "metrics_enabled",
    "set_metrics_enabled",
    "parse_prometheus",
    "merge_snapshots",
    "render_snapshot",
    "concat_prometheus",
]

# ------------------------------------------------------------ enable switch

_ENABLED: Optional[bool] = None


def metrics_enabled() -> bool:
    """True unless DEEPREC_OBS=off (or 0/false) — the metrics plane is on
    by default because it records only values the process already has."""
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("DEEPREC_OBS", "on").lower() not in (
            "off", "0", "false")
    return _ENABLED


def set_metrics_enabled(on: Optional[bool]) -> None:
    """Override the env switch (bench obs-overhead arms, tests).
    ``None`` re-reads DEEPREC_OBS on next use."""
    global _ENABLED
    _ENABLED = on


# ------------------------------------------------------------- ring buffer


class _Ring:
    """Fixed-depth time-sliced aggregate: ``slots`` buckets of ``width``
    seconds each, addressed by epoch so stale slots self-invalidate —
    O(1) per record, no background thread. The caller's lock guards it."""

    __slots__ = ("slots", "width", "epochs", "cells")

    def __init__(self, slots: int, width: float):
        self.slots = slots
        self.width = width
        self.epochs = [-1] * slots
        self.cells: List = [None] * slots

    def cell(self, now: float, make):
        """The live cell for `now`, resetting the slot if its epoch is
        stale. `make()` builds an empty cell."""
        epoch = int(now / self.width)
        i = epoch % self.slots
        if self.epochs[i] != epoch:
            self.epochs[i] = epoch
            self.cells[i] = make()
        return self.cells[i]

    def window(self, now: float, seconds: float) -> List:
        """Cells whose slot overlaps [now - seconds, now], oldest first."""
        lo = int((now - seconds) / self.width)
        hi = int(now / self.width)
        out = []
        for epoch in range(max(lo, hi - self.slots + 1), hi + 1):
            i = epoch % self.slots
            if self.epochs[i] == epoch and self.cells[i] is not None:
                out.append((epoch, self.cells[i]))
        return out


# ----------------------------------------------------------------- metrics


class Counter:
    """Monotonic labeled counter. Ring cells hold the per-slot increment,
    so `window_rate()` answers "events/sec over the last N s" straight
    from process memory."""

    kind = "counter"

    def __init__(self, ring_slots: int, ring_width: float, clock):
        self._lock = threading.Lock()
        self._clock = clock
        self.value = 0.0
        self._ring = _Ring(ring_slots, ring_width)

    def inc(self, n: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            self.value += n
            cell = self._ring.cell(now, float)
            i = int(now / self._ring.width) % self._ring.slots
            self._ring.cells[i] = cell + n

    def window_delta(self, seconds: float = 60.0) -> float:
        now = self._clock()
        with self._lock:
            return float(sum(c for _, c in self._ring.window(now, seconds)))

    def window_rate(self, seconds: float = 60.0) -> float:
        return self.window_delta(seconds) / max(seconds, 1e-9)

    def _sample(self):
        with self._lock:
            return {"value": self.value}


class Gauge:
    """Last-write-wins labeled gauge. Ring cells hold (last_t, last_v)
    per slot; `window_slope()` least-squares fits them — the drift
    signal Placement v2's replan cadence keys off."""

    kind = "gauge"

    def __init__(self, ring_slots: int, ring_width: float, clock):
        self._lock = threading.Lock()
        self._clock = clock
        self.value: Optional[float] = None
        self._ring = _Ring(ring_slots, ring_width)

    def _set_locked(self, now: float, v: float) -> None:
        self.value = v
        self._ring.cell(now, lambda: None)
        i = int(now / self._ring.width) % self._ring.slots
        self._ring.cells[i] = (now, v)

    def set(self, v: float) -> None:
        now = self._clock()
        v = float(v)
        with self._lock:
            self._set_locked(now, v)

    def inc(self, n: float = 1.0) -> None:
        # one lock acquisition across read-modify-write: concurrent
        # inc() calls must never lose updates
        now = self._clock()
        with self._lock:
            self._set_locked(now, float((self.value or 0.0) + n))

    def window_points(self, seconds: float = 60.0) -> List[Tuple[float, float]]:
        now = self._clock()
        with self._lock:
            return [c for _, c in self._ring.window(now, seconds)
                    if c is not None]

    def window_slope(self, seconds: float = 60.0) -> Optional[float]:
        """Least-squares d(value)/dt over the window's slot samples
        (None until two slots have data)."""
        pts = self.window_points(seconds)
        if len(pts) < 2:
            return None
        n = len(pts)
        mt = sum(t for t, _ in pts) / n
        mv = sum(v for _, v in pts) / n
        den = sum((t - mt) ** 2 for t, _ in pts)
        if den <= 0:
            return None
        return sum((t - mt) * (v - mv) for t, v in pts) / den

    def _sample(self):
        with self._lock:
            return {"value": self.value}


class Histogram:
    """Log-bucket histogram (the LatencyHistogram design: geometric
    edges from `lo`, overflow clamped to the exact max) plus a ring of
    per-slot bucket counts for windowed percentiles. `summary()` returns
    the same shape as ``training.profiler.LatencyHistogram.summary`` so
    serving's `/v1/stats` keeps its keys with the registry adopted."""

    kind = "histogram"
    GROWTH = 1.5

    def __init__(self, ring_slots: int, ring_width: float, clock,
                 lo: float = 50e-6, hi: float = 120.0):
        bounds = []
        b = lo
        while b < hi:
            bounds.append(b)
            b *= self.GROWTH
        self.bounds = bounds  # upper edge per bucket, in recorded units
        self._nb = len(bounds) + 1  # + overflow
        self._counts = [0] * self._nb
        self._n = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()
        self._clock = clock
        self._ring = _Ring(ring_slots, ring_width)

    # ---- recording

    def record(self, seconds: float) -> None:
        s = float(seconds)
        i = bisect.bisect_left(self.bounds, s)
        now = self._clock()
        with self._lock:
            self._counts[i] += 1
            self._n += 1
            self._sum += s
            if s > self._max:
                self._max = s
            cell = self._ring.cell(now, self._empty_cell)
            cell[0][i] += 1
            cell[1][0] += s
            if s > cell[1][1]:
                cell[1][1] = s

    def _empty_cell(self):
        # ([bucket counts], [sum, max])
        return ([0] * self._nb, [0.0, 0.0])

    # ---- totals

    def merge(self, other: "Histogram") -> None:
        with other._lock:
            counts, n = list(other._counts), other._n
            tot, mx = other._sum, other._max
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += c
            self._n += n
            self._sum += tot
            self._max = max(self._max, mx)

    def _percentile_of(self, counts, n, mx, q: float) -> float:
        if n == 0:
            return 0.0
        target = min(int(q * n), n - 1)
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen > target:
                return min(self.bounds[i], mx) if i < len(self.bounds) else mx
        return mx

    def percentile(self, q: float) -> float:
        with self._lock:
            n, counts, mx = self._n, list(self._counts), self._max
        return self._percentile_of(counts, n, mx, q)

    def summary(self) -> Dict[str, float]:
        """{count, mean_ms, p50_ms, p90_ms, p99_ms, max_ms} — the
        LatencyHistogram shape serving's snapshots are built from."""
        with self._lock:
            n, tot, mx = self._n, self._sum, self._max
            counts = list(self._counts)
        pct = lambda q: self._percentile_of(counts, n, mx, q)  # noqa: E731
        return {
            "count": n,
            "mean_ms": round(tot / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p90_ms": round(pct(0.90) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }

    # ---- windowed

    def window_summary(self, seconds: float = 60.0) -> Dict[str, float]:
        """Same summary shape, but over the ring window only — "p99 over
        the last 60 s", the autoscaler's input."""
        now = self._clock()
        counts = [0] * self._nb
        tot = 0.0
        mx = 0.0
        with self._lock:
            for _, (cc, (s, m)) in self._ring.window(now, seconds):
                for i, c in enumerate(cc):
                    counts[i] += c
                tot += s
                mx = max(mx, m)
        n = sum(counts)
        pct = lambda q: self._percentile_of(counts, n, mx, q)  # noqa: E731
        return {
            "count": n,
            "mean_ms": round(tot / n * 1e3, 3) if n else 0.0,
            "p50_ms": round(pct(0.50) * 1e3, 3),
            "p90_ms": round(pct(0.90) * 1e3, 3),
            "p99_ms": round(pct(0.99) * 1e3, 3),
            "max_ms": round(mx * 1e3, 3),
        }

    def _sample(self):
        with self._lock:
            return {
                "bounds": list(self.bounds),
                "counts": list(self._counts),
                "n": self._n,
                "sum": self._sum,
                "max": self._max,
            }


# ------------------------------------------------------------ null metrics


class _NullMetric:
    """Shared no-op stand-in handed out when DEEPREC_OBS=off — every
    recording method is a constant-return bound method, so an
    instrumented hot path pays one attribute call and nothing else."""

    kind = "null"

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def record(self, seconds: float) -> None:
        pass

    def window_delta(self, seconds: float = 60.0) -> float:
        return 0.0

    def window_rate(self, seconds: float = 60.0) -> float:
        return 0.0

    def window_slope(self, seconds: float = 60.0):
        return None

    def window_summary(self, seconds: float = 60.0) -> Dict[str, float]:
        return {"count": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p90_ms": 0.0,
                "p99_ms": 0.0, "max_ms": 0.0}

    summary = window_summary
    value = None


_NULL = _NullMetric()


# -------------------------------------------------------------- registry


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Thread-safe get-or-create registry of labeled metrics.

    One process-wide instance (``default_registry()``) carries the
    training / online / placement plane; serving components additionally
    create their OWN instance per server so two ModelServers in one
    process never share stage histograms (``/v1/stats`` stays
    per-server), and their ``/metrics`` renders both.
    """

    RING_SLOTS = 64
    RING_WIDTH = 2.0  # seconds per slot → ~128 s of history

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 ring_slots: int = RING_SLOTS,
                 ring_width: float = RING_WIDTH):
        self._lock = threading.Lock()
        self._clock = clock
        self._ring_slots = ring_slots
        self._ring_width = ring_width
        # name -> (kind, help, {label_key: metric})
        self._metrics: Dict[str, Tuple[str, str, Dict]] = {}
        # name -> (help, [(label_key, labels, fn)])
        self._callbacks: Dict[str, Tuple[str, List]] = {}

    # ---- construction

    def _get(self, name: str, kind: str, help: str, labels, make):
        if not metrics_enabled():
            return _NULL
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            ent = self._metrics.get(name)
            if ent is None:
                ent = (kind, help, {})
                self._metrics[name] = ent
            if ent[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {ent[0]}, "
                    f"not {kind}")
            m = ent[2].get(key)
            if m is None:
                m = make()
                ent[2][key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(name, "counter", help, labels, lambda: Counter(
            self._ring_slots, self._ring_width, self._clock))

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(name, "gauge", help, labels, lambda: Gauge(
            self._ring_slots, self._ring_width, self._clock))

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  lo: float = 50e-6, hi: float = 120.0) -> Histogram:
        return self._get(name, "histogram", help, labels, lambda: Histogram(
            self._ring_slots, self._ring_width, self._clock, lo=lo, hi=hi))

    def register_callback(self, name: str, fn: Callable[[], float],
                          help: str = "",
                          labels: Optional[Dict[str, str]] = None) -> None:
        """A gauge evaluated at collection time (queue depths, pool
        sizes) — zero cost between scrapes. Re-registering the same
        (name, labels) replaces the previous callback (a restarted
        server re-binds its queue)."""
        if not metrics_enabled():
            return
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            help_, entries = self._callbacks.get(name, (help, []))
            entries = [e for e in entries if e[0] != key]
            entries.append((key, dict(labels or {}), fn))
            self._callbacks[name] = (help_ or help, entries)

    # ---- windowed queries

    def window(self, name: str, labels: Optional[Dict[str, str]] = None,
               seconds: float = 60.0) -> Dict:
        """One windowed answer per metric kind: counters → delta + rate,
        gauges → points + slope, histograms → the summary shape."""
        with self._lock:
            ent = self._metrics.get(name)
            m = ent[2].get(_label_key(labels)) if ent else None
        if m is None:
            return {}
        if m.kind == "counter":
            return {"delta": m.window_delta(seconds),
                    "rate_per_sec": m.window_rate(seconds)}
        if m.kind == "gauge":
            pts = m.window_points(seconds)
            return {"points": len(pts), "last": m.value,
                    "slope_per_sec": m.window_slope(seconds)}
        return m.window_summary(seconds)

    # ---- exposition

    def snapshot(self) -> Dict:
        """JSON-ready view of every series (callbacks evaluated now) —
        the unit the frontend merges across backends over the wire."""
        out: Dict = {"metrics": {}}
        with self._lock:
            items = [(n, k, h, list(series.items()))
                     for n, (k, h, series) in self._metrics.items()]
            cbs = [(n, h, list(entries))
                   for n, (h, entries) in self._callbacks.items()]
        for name, kind, help, series in items:
            out["metrics"][name] = {
                "type": kind, "help": help,
                "series": [{"labels": dict(key), **m._sample()}
                           for key, m in series],
            }
        for name, help, entries in cbs:
            rows = []
            for _, labels, fn in entries:
                try:
                    v = float(fn())
                except Exception:
                    continue  # a dead callback must not kill the scrape
                rows.append({"labels": labels, "value": v})
            if rows:
                ent = out["metrics"].setdefault(
                    name, {"type": "gauge", "help": help, "series": []})
                ent["series"].extend(rows)
        return out

    def render_prometheus(self,
                          extra_labels: Optional[Dict[str, str]] = None,
                          stale: bool = False) -> str:
        return render_snapshot(self.snapshot(), extra_labels=extra_labels,
                               stale=stale)

    def reset(self) -> None:
        """Drop metric accumulations. Collector callbacks survive: they
        are bindings to live objects (queue depths), not accumulations —
        a stats reset must not unbind them."""
        with self._lock:
            self._metrics.clear()


# -------------------------------------------------- snapshot-level helpers


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _fmt_val(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "NaN"
    return repr(float(v))


def render_snapshot(snap: Dict,
                    extra_labels: Optional[Dict[str, str]] = None,
                    stale: bool = False) -> str:
    """Prometheus text format from a snapshot() dict. `extra_labels` are
    stamped onto every series (the frontend adds member="host:port");
    `stale=True` additionally stamps stale="1" — how a down backend's
    last-known series stay visible instead of silently disappearing."""
    extra = dict(extra_labels or {})
    if stale:
        extra["stale"] = "1"
    lines: List[str] = []
    for name in sorted(snap.get("metrics", {})):
        ent = snap["metrics"][name]
        kind = ent["type"]
        if ent.get("help"):
            lines.append(f"# HELP {name} {ent['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for s in ent["series"]:
            labels = {**s.get("labels", {}), **extra}
            if kind == "counter":
                lines.append(f"{name}_total{_fmt_labels(labels)} "
                             f"{_fmt_val(s['value'])}")
            elif kind == "gauge":
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_val(s['value'])}")
            else:  # histogram: cumulative le buckets + sum/count
                cum = 0
                for edge, c in zip(s["bounds"], s["counts"]):
                    cum += c
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels({**labels, 'le': repr(float(edge))})} "
                        f"{cum}")
                cum += s["counts"][len(s["bounds"]):][0] \
                    if len(s["counts"]) > len(s["bounds"]) else 0
                lines.append(
                    f"{name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                    f"{cum}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} "
                             f"{_fmt_val(s['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {s['n']}")
    return "\n".join(lines) + ("\n" if lines else "")


def concat_prometheus(parts: Iterable[str]) -> str:
    """Join independently rendered Prometheus text blocks into ONE valid
    exposition: real Prometheus parsers reject a second `# TYPE` (or
    `# HELP`) line for an already-seen metric family, and the frontend's
    tier `/metrics` renders the same families once per backend member —
    so repeated headers after the first are dropped here."""
    seen: set = set()
    out: List[str] = []
    for part in parts:
        for ln in part.splitlines():
            if ln.startswith("# TYPE ") or ln.startswith("# HELP "):
                key = tuple(ln.split(None, 3)[:3])  # ('#', kind, name)
                if key in seen:
                    continue
                seen.add(key)
            out.append(ln)
    return "\n".join(out) + ("\n" if out else "")


def merge_snapshots(snaps: Iterable[Dict]) -> Dict:
    """Combine snapshots from several processes into one: counters and
    histogram buckets sum, gauges keep the last value seen. Used for the
    tier-total view; the per-member view relabels instead (see
    Frontend.metrics_text)."""
    out: Dict = {"metrics": {}}
    for snap in snaps:
        for name, ent in (snap or {}).get("metrics", {}).items():
            dst = out["metrics"].setdefault(
                name, {"type": ent["type"], "help": ent.get("help", ""),
                       "series": []})
            if dst["type"] != ent["type"]:
                continue  # type clash across processes: keep the first
            by_labels = {_label_key(s.get("labels")): s
                         for s in dst["series"]}
            for s in ent["series"]:
                key = _label_key(s.get("labels"))
                cur = by_labels.get(key)
                if cur is None:
                    by_labels[key] = {**s, "labels": dict(s.get("labels", {}))}
                    dst["series"].append(by_labels[key])
                elif ent["type"] == "counter":
                    cur["value"] = (cur.get("value") or 0.0) + \
                        (s.get("value") or 0.0)
                elif ent["type"] == "gauge":
                    cur["value"] = s.get("value", cur.get("value"))
                else:
                    if cur.get("bounds") == s.get("bounds"):
                        cur["counts"] = [a + b for a, b in
                                         zip(cur["counts"], s["counts"])]
                        cur["n"] = cur["n"] + s["n"]
                        cur["sum"] = cur["sum"] + s["sum"]
                        cur["max"] = max(cur["max"], s["max"])
    return out


_PROM_LINE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")


def parse_prometheus(text: str) -> Dict[Tuple[str, str], float]:
    """Strict-enough parser for the text we emit (and the CI gate):
    {(metric_name, label_block): value}. Raises ValueError on a line
    that is neither a comment nor a well-formed sample."""
    out: Dict[Tuple[str, str], float] = {}
    for ln in text.splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        m = _PROM_LINE.match(ln)
        if not m:
            raise ValueError(f"unparseable metrics line: {ln!r}")
        name, labels, val = m.group(1), m.group(2) or "", m.group(3)
        out[(name, labels)] = float(val) if val != "NaN" else float("nan")
    return out


# --------------------------------------------------------- default registry

_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide plane (training loop, supervisor, placement,
    tier workers). Serving servers keep their own instance per server —
    see MetricsRegistry docstring."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT
