"""Serving observability: per-request stage timers aggregated into
histograms, reported into the obs metrics plane.

Every request through the micro-batching front is accounted in four
stages:

  * ``queue``  — enqueue until a batcher worker picks the request up
                 (coalescing wait + head-of-line blocking)
  * ``pad``    — concat + bucket-pad of the coalesced batch
  * ``device`` — the predict (host launches + device compute + D2H)
  * ``post``   — per-request slicing and reply delivery
  * ``e2e``    — enqueue to reply received (the client-visible latency)
  * ``retrieval`` — full-corpus top-k requests end to end (the retrieval
                 lane, a later slice of the port)

One ``ServingStats`` may be shared by several ``ModelServer`` members
(a ``ServerGroup`` passes one instance to every member), so the numbers
describe the serving front as a whole. Snapshots are cheap JSON-ready
dicts — `GET /v1/stats` returns one live.

Registry adoption (obs/metrics.py): unless ``DEEPREC_OBS=off``, the
stage histograms and counters live in a per-stats ``MetricsRegistry``
(per-stats so two servers in one process never share series and
`/v1/stats` stays per-server) — the SAME objects back both the legacy
snapshot() and the Prometheus ``GET /metrics`` exposition, and their
ring buffers answer windowed queries ("p99 over the last 60 s") for the
autoscaler. With the plane off, plain ``LatencyHistogram``s keep the
legacy surface identical at zero obs cost.

The port's copy of `deeprec_tpu/serving/stats.py`, over the port's own
`training/profiler.LatencyHistogram` and `obs/metrics.py`. The
``device`` stage ends in the device-to-host copy of the answer, which
synchronises with the card.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from deeprec_tpu_torch.analysis.annotations import guarded_by
from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.training.profiler import LatencyHistogram

STAGES = ("queue", "pad", "device", "post", "e2e", "retrieval")

_COUNTERS = ("requests", "batches", "rows", "errors")


@guarded_by("_lock")
class ServingStats:
    """Thread-safe aggregate of the serving front's stage timers plus
    batch-shape and error counters."""

    def __init__(self, registry: Optional["obs_metrics.MetricsRegistry"]
                 = None):
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        if registry is None and obs_metrics.metrics_enabled():
            registry = obs_metrics.MetricsRegistry()
        self.registry = registry  # None when the obs plane is off
        self._make_metrics()
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.errors = 0
        self.retrieval_requests = 0
        self.candidates_scanned = 0

    def _make_metrics(self) -> None:
        r = self.registry
        if r is not None:
            self.stage = {
                s: r.histogram(
                    "deeprec_serving_stage_seconds",
                    "per-request serving stage latency", {"stage": s})
                for s in STAGES
            }
            self.batch_rows = r.histogram(
                "deeprec_serving_batch_rows",
                "rows per coalesced device batch", lo=1.0, hi=1 << 20)
            self._counters = {
                k: r.counter(f"deeprec_serving_{k}",
                             f"serving front {k} total")
                for k in _COUNTERS
            }
            # Retrieval-lane counters (serving/retrieval.py): requests
            # through the lane and candidate rows scanned for them (a
            # request scanning a C-row corpus for B user rows counts
            # B*C). Unlabeled — DRT007 cardinality contract.
            self._retr_counters = {
                "requests": r.counter(
                    "deeprec_retrieval_requests",
                    "full-corpus retrieval requests served"),
                "candidates": r.counter(
                    "deeprec_retrieval_candidates_scanned",
                    "corpus candidate rows scanned by retrieval sweeps"),
            }
        else:
            self.stage = {s: LatencyHistogram() for s in STAGES}
            self.batch_rows = LatencyHistogram(lo=1.0, hi=1 << 20)
            self._counters = None
            self._retr_counters = None

    # ----------------------------------------------------------- recording

    def record_stage(self, stage: str, seconds: float) -> None:
        self.stage[stage].record(seconds)

    def record_batch(self, n_requests: int, n_rows: int) -> None:
        with self._lock:
            self.batches += 1
            self.requests += n_requests
            self.rows += n_rows
        self.batch_rows.record(float(n_rows))
        c = self._counters
        if c is not None:
            c["batches"].inc()
            c["requests"].inc(n_requests)
            c["rows"].inc(n_rows)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n
        if self._counters is not None:
            self._counters["errors"].inc(n)

    def record_retrieval(self, n_requests: int, candidates: int) -> None:
        """Account one coalesced retrieval dispatch: `n_requests` rode the
        sweep, which scanned `candidates` corpus rows in total."""
        with self._lock:
            self.retrieval_requests += n_requests
            self.candidates_scanned += candidates
        c = self._retr_counters
        if c is not None:
            c["requests"].inc(n_requests)
            c["candidates"].inc(candidates)

    # ----------------------------------------------------------- reporting

    def window_p99_ms(self, stage: str = "e2e",
                      seconds: float = 60.0) -> Optional[float]:
        """p99 of `stage` over the trailing window (None with the obs
        plane off) — the autoscaler's load signal, answered from the
        metric's own ring buffer."""
        h = self.stage.get(stage)
        if self.registry is None or h is None:
            return None
        return h.window_summary(seconds)["p99_ms"]

    def snapshot(self) -> Dict:
        """JSON-ready view: per-stage latency summaries + counters. The
        batch_rows histogram reuses the latency summary shape with rows in
        place of milliseconds (keys renamed accordingly)."""
        with self._lock:
            out = {
                "requests": self.requests,
                "batches": self.batches,
                "rows": self.rows,
                "errors": self.errors,
                "uptime_s": round(time.monotonic() - self._t0, 3),
            }
        out["stages"] = {s: h.summary() for s, h in self.stage.items()}
        with self._lock:
            if self.retrieval_requests:
                out["retrieval"] = {
                    "requests": self.retrieval_requests,
                    "candidates_scanned": self.candidates_scanned,
                }
        rows = self.batch_rows.summary()
        out["batch_rows"] = {
            "count": rows["count"],
            "mean": round(rows["mean_ms"] / 1e3, 2),
            "p50": rows["p50_ms"] / 1e3,
            "p99": rows["p99_ms"] / 1e3,
            "max": rows["max_ms"] / 1e3,
        }
        return out

    def metrics_snapshot(self) -> Optional[Dict]:
        """The registry snapshot (None with the plane off) — what the
        socket frontend merges across backends for its `/metrics`."""
        return None if self.registry is None else self.registry.snapshot()

    def reset(self) -> None:
        with self._lock:
            if self.registry is not None:
                # drops metric accumulations; collector callbacks
                # registered on this registry (queue depth, model
                # version) survive a stats reset by design
                self.registry.reset()
            self._make_metrics()
            self.requests = self.batches = self.rows = self.errors = 0
            self.retrieval_requests = self.candidates_scanned = 0
            self._t0 = time.monotonic()
