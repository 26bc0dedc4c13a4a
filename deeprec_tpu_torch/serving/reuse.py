"""Version-keyed compute-reuse caches for the serving tier.

Heavy traffic is redundant traffic: a power-law user population
re-requests the same user tower and the same candidate sets within
seconds. This module is the one primitive behind all three reuse sites
(predict answer cache, user-tower cache, retrieval candidate cache):

  * **Key derivation** — `request_fingerprint` hashes the request's
    feature arrays (name + dtype + shape + bytes, name-sorted so dict
    order never matters) into a 128-bit blake2b digest. The digest is
    the cache key together with the producing version; builtin `hash()`
    is never used (per-process salted) and 32-bit checksums are not
    enough (birthday collisions at ~77k hot entries would serve one
    user another user's answer).
  * **Invalidation by version, never by sweep** — every entry is keyed
    `(fingerprint, version)` where `version` comes from the owner's
    `version_fn` (model snapshot version for predict, `(model version,
    corpus_rev)` for retrieval). A hit is only a hit at the CURRENT
    version; a delta publish bumps the version and the publish edge
    calls `invalidate_stale()`, so a cache can never serve an answer
    across a model version.
  * **Byte-bounded LRU** — capacity is bytes of cached values, not
    entry count; inserts evict from the cold end until under budget and
    evictions are counted. An entry larger than the whole budget is
    simply not stored.

Observability (DRT007-clean: the only label is the cache's name, a
bounded set fixed at construction): `deeprec_reuse_{hits,misses,
evictions,invalidations}_total` counters plus occupancy/capacity/entry
callback gauges, all merged across the fleet by the frontend's
/metrics relabeling. docs/serving.md "Frontend compute reuse" is the
contract.

The port's copy of `deeprec_tpu/serving/reuse.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


def request_fingerprint(features: Dict[str, Any],
                        names: Optional[list] = None,
                        extra: bytes = b"") -> bytes:
    """128-bit digest of a request's feature arrays. `names` restricts
    the digest to a subset (the user-tower cache keys on user features
    only); `extra` folds request parameters that change the answer into
    the key (retrieval folds k). Name-bound and order-independent:
    permuting dict insertion order never moves the digest, renaming a
    feature always does."""
    h = hashlib.blake2b(digest_size=16)
    keys = sorted(names) if names is not None else sorted(features)
    for name in keys:
        v = np.ascontiguousarray(features[name])
        h.update(name.encode())
        h.update(b"\x00")
        h.update(v.dtype.str.encode())
        h.update(repr(v.shape).encode())
        h.update(v.tobytes())
    if extra:
        h.update(b"\x01")
        h.update(extra)
    return h.digest()


def value_nbytes(value: Any) -> int:
    """Bytes a cached value occupies (array leaves summed; dicts/tuples
    recursed) — the unit the LRU's byte budget is enforced in."""
    if isinstance(value, dict):
        return sum(value_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(value_nbytes(v) for v in value)
    if hasattr(value, "nbytes"):
        return int(value.nbytes)
    return int(np.asarray(value).nbytes)


class ReuseCache:
    """Byte-bounded LRU keyed ``(fingerprint, version)``.

    ``version_fn`` is read at lookup time: `get_current` only answers
    when the stored version equals the live one, so a stale entry is
    dead the instant the owner publishes — `invalidate_stale()` (called
    on the publish edge) merely reclaims the bytes and counts the
    drops. Thread-safe; the serving path holds the lock only for dict
    ops, never for compute."""

    def __init__(self, capacity_bytes: int, name: str,
                 registry=None,
                 version_fn: Optional[Callable[[], Any]] = None):
        self.capacity_bytes = int(capacity_bytes)
        self.name = name
        self.version_fn = version_fn
        self._lock = threading.Lock()
        self._entries: OrderedDict[Tuple[bytes, Any], Tuple[Any, int]] = (
            OrderedDict())
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._m_hits = self._m_misses = None
        self._m_evict = self._m_inval = None
        if registry is not None:
            lab = {"cache": name}  # bounded: one series per cache site
            self._m_hits = registry.counter(
                "deeprec_reuse_hits",
                "cache hits served without running the model", lab)
            self._m_misses = registry.counter(
                "deeprec_reuse_misses",
                "cache lookups that fell through to evaluation", lab)
            self._m_evict = registry.counter(
                "deeprec_reuse_evictions",
                "entries dropped by the LRU byte budget", lab)
            self._m_inval = registry.counter(
                "deeprec_reuse_invalidations",
                "entries dropped because their version went stale", lab)
            registry.register_callback(
                "deeprec_reuse_occupancy_bytes", lambda: self._bytes,
                "bytes of cached answers resident right now", lab)
            registry.register_callback(
                "deeprec_reuse_capacity_bytes",
                lambda: self.capacity_bytes,
                "LRU byte budget of this cache", lab)
            registry.register_callback(
                "deeprec_reuse_entries", lambda: len(self._entries),
                "entries resident right now", lab)

    # ------------------------------------------------------------- lookup

    def current_version(self) -> Any:
        return self.version_fn() if self.version_fn is not None else None

    def get_current(self, fp: bytes):
        """(value, version) when `fp` is cached AT the live version,
        else None (counted as a miss). Hits refresh LRU recency."""
        version = self.current_version()
        key = (fp, version)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.misses += 1
                if self._m_misses is not None:
                    self._m_misses.inc()
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            if self._m_hits is not None:
                self._m_hits.inc()
            return ent[0], version

    def put(self, fp: bytes, version: Any, value: Any,
            nbytes: Optional[int] = None) -> bool:
        """Insert (or refresh) an entry produced at `version`; evicts
        from the cold end until the byte budget holds. Returns whether
        the value is resident (False: larger than the whole budget, or
        already stale vs the live version)."""
        if nbytes is None:
            nbytes = value_nbytes(value)
        if nbytes > self.capacity_bytes:
            return False
        live = self.current_version()
        if self.version_fn is not None and version != live:
            return False  # produced before a publish: born stale
        key = (fp, version)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes)
            self._bytes += nbytes
            while self._bytes > self.capacity_bytes and self._entries:
                _, (_, nb) = self._entries.popitem(last=False)
                self._bytes -= nb
                self.evictions += 1
                if self._m_evict is not None:
                    self._m_evict.inc()
        return True

    # -------------------------------------------------------- invalidation

    def invalidate_stale(self) -> int:
        """Drop every entry whose version differs from the live one —
        the publish-edge hook (Predictor._publish / retrieval's
        corpus_rev bump). Returns the number dropped."""
        live = self.current_version()
        dropped = 0
        with self._lock:
            for key in [k for k in self._entries if k[1] != live]:
                _, nb = self._entries.pop(key)
                self._bytes -= nb
                dropped += 1
            self.invalidations += dropped
        if dropped and self._m_inval is not None:
            self._m_inval.inc(dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    # ----------------------------------------------------------- snapshot

    def occupancy_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> Dict[str, Any]:
        """Counters + occupancy for `/v1/stats`."""
        total = self.hits + self.misses
        return {
            "name": self.name,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "entries": len(self._entries),
            "occupancy_bytes": self._bytes,
            "capacity_bytes": self.capacity_bytes,
        }
