"""Parallel host input pipeline: sharded readers + vectorized block parse
+ worker-side pack, feeding the staged prefetcher — the port's copy of
`deeprec_tpu/data/pipeline.py`.

One thread parsing Criteo text line by line (`criteo_line_parser`) can't
feed a training step on the card. The DeepRec analog is the fused reader +
Stage/SmartStage op stack; here it is N worker threads and three
contracts:

  * **Record-aligned shards.** A newline-counting plan pass
    (`plan_shards`) snaps every shard boundary to a multiple of
    `batch_size * k_stack` records, and shards never span files — so any
    batch (and any K-group fed to `Trainer.train_steps`) lives entirely
    inside one shard, and the N-worker stream can be reassembled
    bit-identically to the serial reader's, for ANY worker count.
  * **Deterministic reorder.** Workers claim shards in plan order, parse
    each with the vectorized `criteo_block_parse` (readers.py), sanitize
    + pack final fixed-shape arrays (the `stack_batches` K-stack happens
    HERE, on the worker), and push into a bounded reorder buffer keyed by
    global sequence number. The consumer pops strictly in order; a slow
    worker delays but never reorders. The producer of the
    next-to-emit sequence always passes the bound, so the window can
    never deadlock.
  * **Exactly-once resume.** `mark_consumed()` / `attach_consumer()`
    extend the CriteoStats contract (data/synthetic.py): under a staging
    ring, `save()` reports the CONSUMED position — as a unit count plus
    per-shard consumed byte offsets — and `restore()` seeks workers
    straight to those offsets, so a SIGKILL + restart replays each
    record exactly once across any number of workers.

Observability: `deeprec_input_batches` / `_records` / `_bytes` counters,
and the pipeline-stall gauge `deeprec_input_stall_seconds{site=}` (the
training-thread wait per dispatch; sites are the bounded set
pipeline|staged|train_loop). `stats()` gives the per-stage worker
seconds and the bytes, records and units emitted.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from deeprec_tpu_torch.data.readers import (
    RecordErrors,
    criteo_block_parse,
    sanitize_batch,
)

_STALL_SITES = ("pipeline", "staged", "train_loop")  # bounded (DRT007)


def record_stall(site: str, seconds: float) -> None:
    """One consumer-side wait-for-input, `seconds` long, at `site` (one of
    pipeline|staged|train_loop). Gauge = the last per-dispatch wait (what
    a scrape sees as 'how input-bound is the training thread right now'),
    counter = cumulative stall. No-ops when the metrics plane is off."""
    from deeprec_tpu_torch.obs import metrics as obs_metrics

    if not obs_metrics.metrics_enabled():
        return
    reg = obs_metrics.default_registry()
    reg.gauge(
        "deeprec_input_stall_seconds",
        "training-thread wait for input on the last dispatch",
        {"site": site},
    ).set(seconds)
    reg.counter(
        "deeprec_input_stall_seconds_total",
        "cumulative consumer wait for input",
        {"site": site},
    ).inc(seconds)


class Shard(NamedTuple):
    """One record-aligned unit of work: bytes [lo, hi) of `path`, holding
    `units` emission units (1 unit = k_stack batches) starting at global
    unit sequence `first_unit`. `records` counts parseable records in the
    span (the tail remainder past the last full unit is dropped by the
    drop_remainder contract, same as the serial reader's per-file drop)."""

    sid: int
    path: str
    lo: int
    hi: int
    records: int
    units: int
    first_unit: int


def _scan_file(path: str, stride: int):
    """One pass over `path`: total record count, byte offsets of the
    record starts at multiples of `stride` records, and the file size.
    An unterminated final line counts as a record (the serial readers
    terminate it on read)."""
    offs: List[int] = []
    rc = 0
    pos = 0
    target = stride
    last_byte = 10
    with open(path, "rb") as f:
        while True:
            chunk = f.read(4 << 20)
            if not chunk:
                break
            a = np.frombuffer(chunk, np.uint8)
            nl = np.flatnonzero(a == 10)
            cnt = len(nl)
            while target <= rc + cnt:
                offs.append(pos + int(nl[target - rc - 1]) + 1)
                target += stride
            rc += cnt
            pos += len(chunk)
            last_byte = chunk[-1]
    if pos and last_byte != 10:
        rc += 1
    return rc, offs, pos


def plan_shards(paths: Sequence[str], batch_size: int, k_stack: int = 1,
                shard_batches: int = 16, drop_remainder: bool = True
                ) -> List[Shard]:
    """Record-aligned shard plan. Deterministic in (paths, batch_size,
    k_stack, shard_batches) — restore() replans and the unit sequence
    numbers line up exactly with the interrupted run's."""
    k = max(1, k_stack)
    per_unit = batch_size * k
    shard_batches = max(k, (shard_batches + k - 1) // k * k)
    stride = batch_size * shard_batches
    shards: List[Shard] = []
    unit = 0
    for path in paths:
        rc, offs, size = _scan_file(path, stride)
        bounds = [0] + offs + ([size] if (not offs or offs[-1] < size) else [])
        counts = [stride] * (len(bounds) - 2) + [rc - stride * (len(bounds) - 2)]
        for lo, hi, records in zip(bounds[:-1], bounds[1:], counts):
            if drop_remainder:
                units = records // per_unit
                records = units * per_unit
            else:
                units = -(-records // per_unit)
            if units <= 0:
                continue
            shards.append(Shard(len(shards), path, lo, hi, records, units,
                                unit))
            unit += units
    return shards


class ParallelInputPipeline:
    """Multi-worker Criteo input pipeline — iterate it like any reader
    (`for batch in pipeline`), or hand it to `Trainer.stage` /
    `staged()`, whose ring, `sharding=` transform, and `peek=` tier tap
    it feeds unchanged. Emits one item per unit: a batch dict when
    `k_stack` is None/1, else a [K, ...]-stacked pytree ready for
    `Trainer.train_steps` — the training thread's only host work is the
    queue pop.

    fmt="csv" (Criteo TSV, the `criteo_line_parser` semantics) or
    "parquet" (ParquetReader routed through the same shard/reorder/resume
    machinery — one shard per file; pass the TSV `criteo_hash_salts()`
    via hash_salts for bit-exact format parity)."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int = 2048,
        num_workers: int = 4,
        num_dense: int = 13,
        num_cat: int = 26,
        k_stack: Optional[int] = None,
        shard_batches: int = 16,
        drop_remainder: bool = True,
        reorder_window: Optional[int] = None,
        fmt: str = "csv",
        hash_columns: Sequence[str] = (),
        hash_salts: Optional[Dict[str, int]] = None,
        criteo_layout: bool = True,
        metrics: bool = True,
    ):
        if fmt not in ("csv", "parquet"):
            raise ValueError(f"unknown format {fmt!r}")
        self.paths = list(paths)
        self.B = batch_size
        self.num_workers = max(1, num_workers)
        self.num_dense = num_dense
        self.num_cat = num_cat
        self.k = max(1, k_stack or 1)
        self.stacked = k_stack is not None and k_stack > 1
        if self.stacked and not drop_remainder:
            raise ValueError("k_stack > 1 requires drop_remainder")
        self.drop_remainder = drop_remainder
        self.format = fmt
        self.hash_columns = tuple(hash_columns)
        self.hash_salts = dict(hash_salts or {})
        self.criteo_layout = criteo_layout
        self.errors = RecordErrors(metrics=metrics)
        self._metrics = metrics
        if fmt == "csv":
            self._shards = plan_shards(self.paths, batch_size, self.k,
                                       shard_batches, drop_remainder)
        else:
            self._shards = self._plan_parquet()
        self._total = sum(s.units for s in self._shards)
        self.window = max(4, reorder_window or 2 * self.num_workers)
        # reorder buffer state (one condition variable for producers and
        # the consumer; the bound counts buffered units, not batches)
        self._cond = threading.Condition()
        self._buf: Dict[int, tuple] = {}
        self._next_claim = 0
        self._next_emit = 0
        self._error: Optional[BaseException] = None
        self._stopped = False
        self._threads: List[threading.Thread] = []
        # consumed-position bookkeeping (CriteoStats contract + offsets)
        self._consume_lock = threading.Lock()
        self._pending = collections.deque()  # (unit, sid, end_offset)
        self._consumed = 0
        self._consumer_attached = False
        self._shard_consumed: Dict[int, int] = {}
        self._resume: Dict[int, tuple] = {}  # sid -> (offset, first_unit)
        # per-stage accounting (stats())
        self._stats_lock = threading.Lock()
        self._stage = {"read_s": 0.0, "parse_s": 0.0, "pack_s": 0.0,
                       "stall_s": 0.0, "bytes": 0, "records": 0,
                       "units": 0}

    # ---------------------------------------------------------------- plan

    def _plan_parquet(self) -> List[Shard]:
        import pyarrow.parquet as pq

        per_unit = self.B * self.k
        shards: List[Shard] = []
        unit = 0
        for path in self.paths:
            rows = pq.ParquetFile(path).metadata.num_rows
            if self.drop_remainder:
                units = rows // per_unit
                records = units * per_unit
            else:
                units = -(-rows // per_unit)
                records = rows
            if units <= 0:
                continue
            shards.append(Shard(len(shards), path, 0, rows, records, units,
                                unit))
            unit += units
        return shards

    @property
    def total_units(self) -> int:
        return self._total

    # ------------------------------------------------------------- workers

    def _start(self) -> None:
        if self._threads or self._stopped:
            return
        for w in range(self.num_workers):
            t = threading.Thread(target=self._worker, name=f"input-{w}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self) -> None:
        try:
            while True:
                with self._cond:
                    if self._stopped or self._next_claim >= len(self._shards):
                        return
                    shard = self._shards[self._next_claim]
                    self._next_claim += 1
                if shard.units == 0:
                    continue
                if self.format == "csv":
                    self._run_csv_shard(shard)
                else:
                    self._run_parquet_shard(shard)
        except BaseException as e:  # surface to the consumer
            with self._cond:
                if self._error is None:
                    self._error = e
                self._cond.notify_all()

    def _acct(self, **kv) -> None:
        with self._stats_lock:
            for k, v in kv.items():
                self._stage[k] += v

    def _run_csv_shard(self, shard: Shard) -> None:
        lo, first_unit = shard.lo, shard.first_unit
        off, resumed_first = self._resume.get(shard.sid, (None, None))
        if off is not None:
            lo, first_unit = off, resumed_first
        t0 = time.perf_counter()
        with open(shard.path, "rb") as f:
            f.seek(lo)
            data = f.read(shard.hi - lo)
        t1 = time.perf_counter()
        cols = criteo_block_parse(data, self.num_dense, self.num_cat,
                                  self.errors)
        cols = sanitize_batch(cols, self.errors)
        t2 = time.perf_counter()
        # byte offset (absolute) after each record — the per-shard
        # consumed offsets of the save()/restore() contract
        ends = lo + np.flatnonzero(np.frombuffer(data, np.uint8) == 10) + 1
        if len(ends) < cols["label"].shape[0]:  # unterminated final line
            ends = np.append(ends, shard.hi)
        self._acct(read_s=t1 - t0, parse_s=t2 - t1, bytes=len(data))
        if self._metrics:
            from deeprec_tpu_torch.obs import metrics as obs_metrics

            if obs_metrics.metrics_enabled():
                obs_metrics.default_registry().counter(
                    "deeprec_input_bytes",
                    "raw bytes read by the parallel input pipeline",
                ).inc(len(data))
        units = shard.units - (first_unit - shard.first_unit)
        per_unit = self.B * self.k
        for u in range(units):
            seq = first_unit + u
            t3 = time.perf_counter()
            r0 = u * per_unit
            r1 = min(r0 + per_unit, cols["label"].shape[0])
            item = self._pack(cols, r0, r1)
            end_off = int(ends[r1 - 1])
            self._acct(pack_s=time.perf_counter() - t3, records=r1 - r0,
                       units=1)
            if not self._emit(seq, (item, shard.sid, end_off)):
                return

    def _run_parquet_shard(self, shard: Shard) -> None:
        from deeprec_tpu_torch.data.readers import ParquetReader

        off, resumed_first = self._resume.get(shard.sid, (None, None))
        skip_units = 0 if off is None else int(off)
        first_unit = shard.first_unit if resumed_first is None \
            else resumed_first
        reader = ParquetReader(
            [shard.path], batch_size=self.B,
            hash_columns=self.hash_columns, hash_salts=self.hash_salts,
            drop_remainder=self.drop_remainder)
        group: List[Dict[str, np.ndarray]] = []
        unit = 0  # 0-based unit index within the file, skipped included
        t0 = time.perf_counter()
        for batch in reader:
            if self.criteo_layout:
                batch = self._criteo_shape(batch)
            batch = sanitize_batch(batch, self.errors)
            group.append(batch)
            if len(group) < self.k and batch["label"].shape[0] == self.B:
                continue
            t1 = time.perf_counter()
            if unit >= skip_units:
                seq = first_unit + (unit - skip_units)
                item = group[0] if not self.stacked else {
                    k: np.stack([b[k] for b in group])
                    for k in group[0]
                }
                n = sum(b["label"].shape[0] for b in group)
                self._acct(read_s=t1 - t0, records=n, units=1,
                           pack_s=time.perf_counter() - t1)
                # parquet "offsets" count consumed UNITS within the file
                # (a columnar file has no record byte offsets; resume
                # re-reads and skips, it never re-emits)
                if not self._emit(seq, (item, shard.sid, unit + 1)):
                    return
            group = []
            unit += 1
            if unit >= shard.units:
                return
            t0 = time.perf_counter()

    def _criteo_shape(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """Coerce parquet-stored columns to the exact CSV batch layout:
        label [n] f32, I* [n, 1] f32, C*/ids [n] i32 — so the two formats
        emit bit-identical streams for the same records."""
        out = {}
        for k, v in batch.items():
            if k.startswith("label"):
                out[k] = np.asarray(v, np.float32)
            elif k.startswith("I") and v.ndim == 1 and \
                    np.issubdtype(np.asarray(v).dtype, np.number):
                out[k] = np.asarray(v, np.float32).reshape(-1, 1)
            else:
                out[k] = v
        return out

    def _pack(self, cols: Dict[str, np.ndarray], r0: int, r1: int):
        """Final fixed-shape arrays for one unit. Copies the slice (the
        shard's parse buffer must not be pinned by emitted batches) and
        does the K-stack reshape worker-side."""
        if not self.stacked:
            return {k: np.ascontiguousarray(v[r0:r1]) for k, v in
                    cols.items()}
        # [K*B, ...] -> [K, B, ...] — equivalent to stack_batches over the
        # K consecutive B-slices, done with one reshape per column.
        return {
            k: np.ascontiguousarray(v[r0:r1]).reshape(
                (self.k, self.B) + v.shape[1:])
            for k, v in cols.items()
        }

    def _emit(self, seq: int, item) -> bool:
        with self._cond:
            while not self._stopped and seq >= self._next_emit + self.window:
                self._cond.wait(0.1)
            if self._stopped:
                return False
            self._buf[seq] = item
            self._cond.notify_all()
            return True

    # ------------------------------------------------------------ consumer

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        self._start()
        waited = 0.0
        with self._cond:
            while True:
                if self._error is not None:
                    raise self._error
                if self._stopped or self._next_emit >= self._total:
                    raise StopIteration
                got = self._buf.pop(self._next_emit, None)
                if got is not None:
                    break
                t0 = time.perf_counter()
                self._cond.wait(0.1)
                waited += time.perf_counter() - t0
            unit = self._next_emit
            self._next_emit += 1
            self._cond.notify_all()
        item, sid, end_off = got
        if waited:
            self._acct(stall_s=waited)
            record_stall("pipeline", waited)
        with self._consume_lock:
            self._pending.append((unit, sid, end_off))
            if not self._consumer_attached:
                self._apply_pending_locked()
        if self._metrics:
            self._count_emit(item)
        return item

    def _count_emit(self, item) -> None:
        from deeprec_tpu_torch.obs import metrics as obs_metrics

        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.default_registry()
        n = int(np.prod(item["label"].shape))
        reg.counter("deeprec_input_batches",
                    "batches emitted by the parallel input pipeline"
                    ).inc(self.k)
        reg.counter("deeprec_input_records",
                    "records emitted by the parallel input pipeline").inc(n)

    # ----------------------------------------------- exactly-once contract

    def attach_consumer(self) -> None:
        """Declare that a staging ring decouples production from
        consumption (CriteoStats contract): from here on save() reports
        the consumed position, advanced only by mark_consumed()."""
        with self._consume_lock:
            self._consumer_attached = True

    def mark_consumed(self) -> None:
        """One unit DELIVERED to the train loop (wire to
        Prefetcher(on_consume=...); Trainer.stage does this
        automatically)."""
        with self._consume_lock:
            self._consumer_attached = True
            if self._pending:
                unit, sid, end_off = self._pending.popleft()
                self._consumed = unit + 1
                self._shard_consumed[sid] = end_off

    def _apply_pending_locked(self) -> None:
        while self._pending:
            unit, sid, end_off = self._pending.popleft()
            self._consumed = unit + 1
            self._shard_consumed[sid] = end_off

    def save(self) -> Dict:
        """Resumable position: consumed unit count + per-shard consumed
        offsets (byte offsets for csv shards; consumed in-file units for
        parquet). Under a staging ring (attach_consumer/mark_consumed)
        this is the DELIVERED position, so in-flight ring batches replay
        after a crash — exactly once, never skipped."""
        with self._consume_lock:
            if not self._consumer_attached:
                self._apply_pending_locked()
            return {
                "consumed": self._consumed,
                "offsets": {str(sid): off for sid, off in
                            sorted(self._shard_consumed.items())},
            }

    def restore(self, state: Dict) -> None:
        """Seek the (not yet started) pipeline to a save() position: fully
        consumed shards are skipped, the partial shard's worker resumes at
        its consumed offset, and unit sequence numbers continue from the
        saved count — the emitted stream is the exact suffix of the
        uninterrupted run's."""
        if self._threads:
            raise RuntimeError("restore() must precede iteration")
        consumed = int(state.get("consumed", 0))
        offsets = {int(k): v for k, v in state.get("offsets", {}).items()}
        self._next_emit = consumed
        self._consumed = consumed
        self._shard_consumed = dict(offsets)
        keep: List[Shard] = []
        for s in self._shards:
            if s.first_unit + s.units <= consumed:
                continue  # fully consumed
            if s.first_unit < consumed:
                done_units = consumed - s.first_unit
                if s.sid in offsets:
                    off = offsets[s.sid]
                else:  # no saved offset: re-derive by scanning records
                    off = self._skip_offset(s, done_units * self.B * self.k)
                if self.format == "parquet":
                    self._resume[s.sid] = (done_units, consumed)
                else:
                    self._resume[s.sid] = (int(off), consumed)
            keep.append(s)
        self._shards = keep

    def _skip_offset(self, s: Shard, records: int) -> int:
        with open(s.path, "rb") as f:
            f.seek(s.lo)
            data = f.read(s.hi - s.lo)
        ends = np.flatnonzero(np.frombuffer(data, np.uint8) == 10) + 1
        return s.lo + int(ends[records - 1])

    # ------------------------------------------------------------- plumbing

    def stats(self) -> Dict[str, float]:
        """Per-stage accounting snapshot (worker-seconds, not wall time):
        read_s/parse_s/pack_s, consumer stall_s, bytes/records/units."""
        with self._stats_lock:
            return dict(self._stage)

    def close(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
