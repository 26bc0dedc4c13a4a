"""WorkQueue: dynamic work-item sharding with checkpointable state — the
port's copy of `deeprec_tpu/data/work_queue.py`.

Parity with DeepRec's WorkQueue (python/ops/work_queue.py, spec
docs/docs_en/WorkQueue.md): a global queue of work items (file names, file
slices) that workers `take()` from dynamically — slow workers take fewer
items, which is the straggler mitigation and the elasticity primitive
(workers can join/leave between takes). Supports epochs, shuffling, slicing
and save/restore.

Two modes:
  * in-process (default): plain thread-safe queue.
  * file-coordinated: a shared JSON state file + lockfile lets N independent
    host processes (multi-host workers on a shared FS) take disjoint
    items — the stand-in for the PS-hosted queue resource.
"""
from __future__ import annotations

import fcntl
import json
import os
import random
import tempfile
import threading
from typing import Callable, Iterator, List, Optional, Sequence


class WorkQueue:
    def __init__(
        self,
        works: Sequence[str],
        num_epochs: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        num_slices: int = 1,
        coordination_file: Optional[str] = None,
    ):
        """num_slices > 1 splits each work item into `item#slice/total` —
        DeepRec's sliced-file sharding for large files."""
        items: List[str] = []
        for epoch in range(num_epochs):
            epoch_items = []
            for w in works:
                for s in range(num_slices):
                    epoch_items.append(
                        f"{w}#{s}/{num_slices}" if num_slices > 1 else w
                    )
            if shuffle:
                rng = random.Random(seed + epoch)
                rng.shuffle(epoch_items)
            items.extend(epoch_items)
        self._items = items
        self._cursor = 0
        self._lock = threading.Lock()
        self._coord = coordination_file
        # Test seam: called with (file_object, serialized_json) INSTEAD of
        # the final write inside the atomic commit — lets fault tests
        # emulate a worker killed mid-write (write partial bytes, raise)
        # and pin that concurrent takers never observe a torn file.
        self.on_coord_write: Optional[Callable] = None
        if self._coord and not os.path.exists(self._coord):
            self._write_coord({"cursor": 0, "items": items})

    # ------------------------------------------------------------ in-process

    def take(self) -> Optional[str]:
        """Next work item, or None when exhausted."""
        if self._coord:
            return self._take_coordinated()
        with self._lock:
            if self._cursor >= len(self._items):
                return None
            item = self._items[self._cursor]
            self._cursor += 1
            return item

    def size(self) -> int:
        if self._coord:
            st = self._read_coord()
            return len(st["items"]) - st["cursor"]
        with self._lock:
            return len(self._items) - self._cursor

    def __iter__(self) -> Iterator[str]:
        while True:
            item = self.take()
            if item is None:
                return
            yield item

    # ------------------------------------------------------- save / restore

    def save(self) -> dict:
        """Checkpointable state (WorkQueueSave parity)."""
        if self._coord:
            return self._read_coord()
        with self._lock:
            return {"cursor": self._cursor, "items": self._items}

    def restore(self, state: dict) -> None:
        if self._coord:
            self._write_coord(state)
            return
        with self._lock:
            self._items = list(state["items"])
            self._cursor = int(state["cursor"])

    # ----------------------------------------------------------- datasets

    def input_dataset(self, batch_size: int = 2048, reader_cls=None,
                      **reader_kw):
        """Stream parsed batches from taken work items — the
        `WorkQueue.input_dataset()` analog (work_queue.py API,
        docs/docs_en/WorkQueue.md): each `take()` yields a file (or a
        `path#k/n` slice), read with CriteoCSVReader (or `reader_cls`).
        Sliced items read only their byte range's complete lines."""
        from deeprec_tpu_torch.data.readers import CriteoCSVReader

        reader_cls = reader_cls or CriteoCSVReader
        # Slices are usually smaller than a batch; a per-slice reader that
        # drops remainders could silently deliver NOTHING. Deliver every
        # row unless the caller explicitly asks otherwise.
        reader_kw.setdefault("drop_remainder", False)

        def gen():
            for item in self:
                path, k, n = parse_slice(item)
                if n == 1:
                    yield from reader_cls([path], batch_size, **reader_kw)
                else:
                    yield from reader_cls(
                        [path], batch_size,
                        byte_range=self._slice_range(path, k, n), **reader_kw
                    )

        return gen()

    @staticmethod
    def _slice_range(path, k, n):
        """Line-snapped byte range of the k-th of n slices: boundaries snap
        forward to line starts so each line belongs to exactly one slice."""
        size = os.path.getsize(path)
        lo = size * k // n
        hi = size * (k + 1) // n
        with open(path, "rb") as f:
            if lo:
                f.seek(lo - 1)
                f.readline()  # consume the partial line (previous slice's)
                lo = f.tell()
            if hi:
                f.seek(hi - 1)
                f.readline()
                hi = f.tell()
        return lo, hi

    # ------------------------------------------------- file-coordinated mode

    def _with_lock(self, fn):
        lock_path = self._coord + ".lock"
        with open(lock_path, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                return fn()
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    def _read_coord(self) -> dict:
        def read():
            with open(self._coord) as f:
                return json.load(f)

        return self._with_lock(read)

    def _commit_coord(self, state: dict) -> None:
        """Atomically replace the shared cursor file. MUST be the only
        writer of `self._coord` (call under `_with_lock`).

        A worker killed at ANY point in here leaves the previous coord
        file intact: the new JSON lands in a uniquely named tempfile in
        the same directory, is fsync'd, and only then renamed over the
        target (rename is atomic on POSIX) — other workers either see the
        old complete state or the new complete state, never a torn JSON
        that would strand every taker on a parse error. Orphaned `.wq-*`
        temps from killed writers are inert (never matched by readers)."""
        dirname = os.path.dirname(self._coord) or "."
        fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".wq-", suffix=".tmp")
        try:
            data = json.dumps(state)
            with os.fdopen(fd, "w") as f:
                if self.on_coord_write is not None:
                    self.on_coord_write(f, data)  # fault-injection seam
                else:
                    f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._coord)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _write_coord(self, state: dict) -> None:
        self._with_lock(lambda: self._commit_coord(state))

    def _take_coordinated(self) -> Optional[str]:
        def take():
            with open(self._coord) as f:
                st = json.load(f)
            if st["cursor"] >= len(st["items"]):
                return None
            item = st["items"][st["cursor"]]
            st["cursor"] += 1
            self._commit_coord(st)
            return item

        return self._with_lock(take)


def parse_slice(item: str):
    """'path#k/n' -> (path, k, n); plain items -> (item, 0, 1)."""
    if "#" not in item:
        return item, 0, 1
    path, frac = item.rsplit("#", 1)
    k, n = frac.split("/")
    return path, int(k), int(n)
