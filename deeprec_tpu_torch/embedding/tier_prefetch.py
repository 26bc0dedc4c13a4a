"""Demand-driven tier paging: a background probe/gather pump for upcoming
ids — the port's copy of `deeprec_tpu/embedding/tier_prefetch.py`
(numpy and threading only).

The promote scan of `MultiTierTable.sync` restores a demoted row only at
the next boundary; a demoted key that comes back mid-window trains from a
fresh initializer row until then. Tier paging closes that window: while a
batch waits in the host `Prefetcher` queue (its `peek` hook hands it here,
before it is staged to the card), a background thread probes its ids
against the tier stores and gathers resident packed rows
(`MultiTierTable.probe_rows`); the training thread folds them in at the
next dispatch boundary (`fold_candidates`), checked against the current
device freq so a row that trained past its tier copy is never clobbered.

Ownership: ONE background thread (`tier-prefetch`) calls `probe_rows`,
whose store reads serialize under each table's store lock. The training
thread owns `take` / `pending_keys` and the folds. The pending map is the
only state the two share, every touch under `self._lock`; the batch queue
hand-off goes through `self._cv`. Gathers are read-only on the stores, so
killing the pump mid-gather leaves them consistent.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class TierPrefetcher:
    """Background id-probe/row-gather pump feeding dispatch-boundary folds.

    resolve: key -> MultiTierTable | None (None = that member has no tier
        yet — nothing was ever demoted, nothing to page).
    extract: host batch -> {key: flat id array} for every multi-tier
        member (runs on the PUMP thread, so producer-side observe() stays
        O(1): it only enqueues a batch reference).
    depth: observed-batch queue bound; when the pump falls behind, the
        OLDEST unprobed batch drops (best-effort — a dropped probe only
        delays a fold to the next maintain scan, never loses data).
    max_pending: per-member bound on buffered candidate rows; beyond it
        new gathers drop (counted) until a fold drains the buffer.
    """

    def __init__(
        self,
        resolve: Callable[[Tuple], Any],
        extract: Callable[[Dict[str, np.ndarray]], Dict[Tuple, np.ndarray]],
        depth: int = 4,
        max_pending: int = 8192,
    ):
        self.resolve = resolve
        self.extract = extract
        self.max_pending = int(max_pending)
        self._q: deque = deque(maxlen=max(1, int(depth)))
        # last few probed batches, kept for requeue_recent(): a store-
        # writing boundary (demote) invalidates their gathers AND may
        # have demoted rows they are about to look up — re-probing the
        # pipeline window catches both.
        self._recent: deque = deque(maxlen=max(1, int(depth)))
        self._cv = threading.Condition()
        self._busy = False
        self._lock = threading.Lock()
        # key -> {"rev": gather-time tier revision, "ts": oldest gather
        # time, "rows": {id: (packed row, freq, ver, from_disk)}} — later
        # gathers for the same id win (the store row cannot have changed
        # at the same revision, so this is a dedup, not a race).
        self._pending: Dict[Tuple, dict] = {}
        self._stop = threading.Event()
        self.dropped_batches = 0
        self.dropped_rows = 0
        self.gather_errors = 0
        self.last_error: Optional[BaseException] = None
        self.on_gather = None  # test seam: called on the pump thread per batch
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="tier-prefetch"
        )
        self._thread.start()

    # ------------------------------------------------------- producer side

    def observe(self, batch: Dict[str, np.ndarray]) -> None:
        """Prefetcher `peek` hook (producer thread): hand the raw host
        batch to the pump. Never blocks, never raises — a full queue
        drops the oldest unprobed batch."""
        if self._stop.is_set():
            return
        with self._cv:
            if len(self._q) == self._q.maxlen:
                self.dropped_batches += 1
            self._q.append(batch)
            self._cv.notify()

    # ----------------------------------------------------------- pump loop

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop.is_set():
                    self._cv.wait(0.1)
                if self._stop.is_set():
                    return
                batch = self._q.popleft()
                self._recent.append(batch)
                self._busy = True
            try:
                if self.on_gather is not None:
                    self.on_gather(batch)
                for key, ids in self.extract(batch).items():
                    mt = self.resolve(key)
                    if mt is None:
                        continue
                    cand = mt.probe_rows(ids)
                    if cand is not None:
                        self._merge(key, cand)
            except BaseException as e:  # a failed gather must not kill the pump
                self.gather_errors += 1
                self.last_error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _merge(self, key: Tuple, cand: dict) -> None:
        with self._lock:
            cur = self._pending.get(key)
            if cur is None or cur["rev"] != cand["rev"]:
                # A generation bump means a row-WRITING boundary (demote,
                # load) mutated the stores: everything buffered at the old
                # generation is dead content — replace instead of merging
                # (the fold re-probes a stale package's keys itself, but a
                # fresh gather is already here: don't mix generations).
                cur = {"rev": cand["rev"], "ts": cand["ts"], "rows": {}}
                self._pending[key] = cur
            rows = cur["rows"]
            cur["ts"] = min(cur["ts"], cand["ts"])
            vers = cand.get("vers")
            for i, k in enumerate(cand["keys"]):
                k = int(k)
                if len(rows) >= self.max_pending and k not in rows:
                    self.dropped_rows += 1
                    continue
                rows[k] = (
                    cand["rows"][i], int(cand["freqs"][i]),
                    int(vers[i]) if vers is not None else 0,
                    bool(cand["from_disk"][i]),
                )

    def requeue_recent(self) -> None:
        """Re-enqueue the recently probed batches (training thread, after
        a store-WRITING boundary like maintain's demote): the boundary
        retired their gathered packages and may have demoted rows they
        are about to look up — re-probing the pipeline window lets the
        fold still land before those lookups. Never blocks."""
        if self._stop.is_set():
            return
        with self._cv:
            for b in list(self._recent):
                if len(self._q) == self._q.maxlen:
                    self.dropped_batches += 1
                self._q.append(b)
            self._cv.notify()

    # ------------------------------------------------------ consumer side

    def pending_keys(self) -> list:
        """Members with buffered candidates (training thread)."""
        with self._lock:
            return [k for k, v in self._pending.items() if v["rows"]]

    def take(self, key: Tuple) -> Optional[dict]:
        """Pop the merged candidate package for one member (training
        thread) — the argument `MultiTierTable.fold_candidates` takes."""
        with self._lock:
            cur = self._pending.pop(key, None)
        if not cur or not cur["rows"]:
            return None
        items = list(cur["rows"].items())
        return {
            "keys": np.asarray([k for k, _ in items], np.int64),
            "rows": np.stack([v[0] for _, v in items]),
            "freqs": np.asarray([v[1] for _, v in items], np.int32),
            "vers": np.asarray([v[2] for _, v in items], np.int32),
            "from_disk": np.asarray([v[3] for _, v in items], bool),
            "rev": cur["rev"],
            "ts": cur["ts"],
        }

    # ----------------------------------------------------------- lifecycle

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until every observed batch has been probed (tests and
        bench boundaries — folds then see a deterministic candidate set).
        True = idle; False = timed out with work still in flight."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._q or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.05))
        return True

    def close(self) -> None:
        """Stop the pump thread. Safe mid-gather: probes are read-only on
        the tier stores, so whatever the in-flight gather touched stays
        consistent and the next maintain scan converges without it."""
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=2.0)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            buffered = sum(len(v["rows"]) for v in self._pending.values())
        return {
            "dropped_batches": self.dropped_batches,
            "dropped_rows": self.dropped_rows,
            "gather_errors": self.gather_errors,
            "buffered_rows": buffered,
        }
