"""Poison-batch dead-lettering and the permanent-quarantine breaker — the
port of `deeprec_tpu/guard/quarantine.py`.

When the step sentinel trips, `TrainLoop` rolls the model back to the last
verified checkpoint and SKIPS the offending batch, but keeps it: operators
need the payload for forensics, and the loop needs memory of it, because a
restart-and-replay supervisor would otherwise feed the same poison forever.
The dead-letter directory:

    <dir>/batch-<fingerprint>.npz      the offending batch's arrays
    <dir>/batch-<fingerprint>.json     step, flags, tripped kinds, count
    <dir>/quarantine.json              fingerprint -> trip count + the
                                       permanent set (atomic tmp+rename)

A batch whose fingerprint trips across `GuardPolicy.max_batch_trips`
rollbacks is PERMANENTLY quarantined: the loop drops it before dispatch,
across process restarts. The fingerprint and the files are byte for byte
the JAX package's, so a dead-letter directory written by either package
reads in the other. Batch values may be numpy arrays or tensors (a tensor
is hashed and written as its host copy).
"""
from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


def _host(v) -> np.ndarray:
    """A batch value as a host array (a tensor through its CPU copy)."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def batch_fingerprint(batch: Dict) -> str:
    """Content fingerprint of one batch: sha1 over the sorted keys and
    raw array bytes — stable across processes, so a permanently
    quarantined batch stays quarantined through any restart/replay."""
    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode())
        a = np.ascontiguousarray(_host(batch[k]))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclass(frozen=True)
class GuardPolicy:
    """TrainLoop-side rollback/quarantine policy.

    ``max_batch_trips`` is R from the firewall spec: trips of one batch
    fingerprint before it is permanently quarantined.
    ``replay_window`` bounds the in-memory batch buffer used to resume
    bit-identically after a rollback (it must cover at least one save
    cadence; batches older than the window cannot be replayed and the
    rollback degrades to resuming at the restored step)."""

    dead_letter_dir: str
    max_batch_trips: int = 2
    replay_window: int = 256


class DeadLetter:
    """The dead-letter directory: payloads, trip counts, permanent set.

    Host-side and rollback-cadence only — nothing here is on the train
    hot path. The index commits atomically so a crash mid-update leaves
    the previous intact index, never a torn one."""

    INDEX = "quarantine.json"

    def __init__(self, directory: str, max_batch_trips: int = 2):
        self.dir = directory
        self.max_batch_trips = max(1, int(max_batch_trips))
        os.makedirs(directory, exist_ok=True)
        self._index: Dict = {"trips": {}, "permanent": []}
        try:
            with open(os.path.join(directory, self.INDEX)) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict):
                self._index["trips"].update(loaded.get("trips", {}))
                self._index["permanent"] = list(loaded.get("permanent", []))
        except (OSError, ValueError):
            pass  # fresh dir, or an unreadable index: start conservative

    # ------------------------------------------------------------ queries

    def is_quarantined(self, fingerprint: str) -> bool:
        return fingerprint in self._index["permanent"]

    def trip_count(self, fingerprint: str) -> int:
        return int(self._index["trips"].get(fingerprint, 0))

    @property
    def permanent_count(self) -> int:
        return len(self._index["permanent"])

    # ------------------------------------------------------------- record

    def record_trip(self, fingerprint: str, step: int, flags: int,
                    kinds: List[str], batch: Optional[Dict]) -> bool:
        """Account one sentinel trip against `fingerprint`; write the
        payload + meta on first sight. Returns True when the batch just
        crossed ``max_batch_trips`` and is now PERMANENTLY quarantined."""
        trips = self._index["trips"]
        trips[fingerprint] = int(trips.get(fingerprint, 0)) + 1
        payload = os.path.join(self.dir, f"batch-{fingerprint}.npz")
        if batch is not None and not os.path.exists(payload):
            try:
                np.savez(payload, **{k: _host(v) for k, v in batch.items()})
            except OSError:
                pass  # forensics are best-effort; the quarantine is not
        meta = {
            "fingerprint": fingerprint,
            "step": int(step),
            "flags": int(flags),
            "kinds": list(kinds),
            "trips": trips[fingerprint],
        }
        try:
            with open(os.path.join(
                    self.dir, f"batch-{fingerprint}.json"), "w") as f:
                json.dump(meta, f)
        except OSError:
            pass
        newly_permanent = (
            trips[fingerprint] >= self.max_batch_trips
            and fingerprint not in self._index["permanent"]
        )
        if newly_permanent:
            self._index["permanent"].append(fingerprint)
        self._commit()
        return newly_permanent

    def _commit(self) -> None:
        path = os.path.join(self.dir, self.INDEX)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(self._index, f)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
