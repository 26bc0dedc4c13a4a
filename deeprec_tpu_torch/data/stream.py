"""Streaming input: record streams with resumable consumer offsets — the
port's copy of `deeprec_tpu/data/stream.py`.

The Kafka-analog (reference core/kernels/data/kafka_dataset_op.cc): DeepRec
consumes record streams with consumer offsets so training resumes where it
stopped. Two transports, one offset contract:

  * `FileTailReader` — tail an append-only file on a shared FS (the common
    multi-host deployment: a log shipper lands records on GCS/NFS).
  * `TCPStreamReader` — consume a newline-framed TCP stream from a broker
    (`FileStreamServer` is the bundled broker: it serves a file from any
    requested offset and follows appends, so crash/resume is testable with
    real sockets).

Offset semantics (both): the offset only advances past rows that have been
YIELDED, so a checkpoint/crash/restore cycle is exactly-once with respect
to delivered batches. Records must be '\n'-terminated; an incomplete
trailing line is left unconsumed until its newline arrives.
"""
from __future__ import annotations

import os
import random
import socket
import socketserver
import threading
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from deeprec_tpu_torch.utils import backoff


def criteo_line_parser(num_dense: int = 13, num_cat: int = 26,
                       errors=None) -> Callable:
    """Default record parser shared by the stream readers: Criteo TSV lines
    -> batch dict, with the same id hashing as data/readers.py.

    Garbage-tolerant by contract (the firewall's first line): an
    unparseable label/float clamps to 0, a non-finite value clamps to 0,
    and every clamp counts into `errors` (data/readers.py RecordErrors)
    by kind — one bad field must never kill the reader thread that
    feeds a live training loop."""

    def parse(lines):
        from deeprec_tpu_torch.data.readers import _hash_strings

        n = len(lines)
        labels = np.zeros(n, np.float32)
        dense = np.zeros((n, num_dense), np.float32)
        cat_cols = [np.empty(n, object) for _ in range(num_cat)]
        for r, line in enumerate(lines):
            parts = line.split("\t")
            try:
                labels[r] = float(parts[0] or 0)
            except (TypeError, ValueError):
                labels[r] = 0.0
                if errors is not None:
                    errors.count("bad_label")
            for i in range(num_dense):
                v = parts[1 + i] if len(parts) > 1 + i else ""
                try:
                    dense[r, i] = float(v) if v else 0.0
                except (TypeError, ValueError):
                    dense[r, i] = 0.0
                    if errors is not None:
                        errors.count("bad_float")
            for i in range(num_cat):
                j = 1 + num_dense + i
                cat_cols[i][r] = parts[j] if len(parts) > j else ""
        bad_label = ~np.isfinite(labels)
        if bad_label.any():
            labels[bad_label] = 0.0
            if errors is not None:
                errors.count("nonfinite_float", int(bad_label.sum()))
        bad = ~np.isfinite(dense)
        if bad.any():
            dense[bad] = 0.0
            if errors is not None:
                errors.count("nonfinite_float", int(bad.sum()))
        out: Dict[str, np.ndarray] = {"label": labels}
        for i in range(num_dense):
            out[f"I{i+1}"] = dense[:, i : i + 1]
        for i in range(num_cat):
            out[f"C{i+1}"] = _hash_strings(
                cat_cols[i], salt=(i + 1) * 0x9E3779B9 & 0x7FFFFFFF
            )
        return out

    return parse


class FileTailReader:
    """Tail `path`, yielding batches of parsed lines.

    parser(lines: list[str]) -> batch dict (defaults to Criteo TSV with the
    same id hashing as data/readers.py). `poll_secs` controls the wait when
    caught up; `stop_at_eof` makes it behave like a bounded dataset."""

    def __init__(
        self,
        path: str,
        batch_size: int = 2048,
        parser: Optional[Callable] = None,
        poll_secs: float = 0.5,
        stop_at_eof: bool = False,
        num_dense: int = 13,
        num_cat: int = 26,
    ):
        self.path = path
        self.B = batch_size
        self.parser = parser or criteo_line_parser(num_dense, num_cat)
        self.poll_secs = poll_secs
        self.stop_at_eof = stop_at_eof
        self.num_dense = num_dense
        self.num_cat = num_cat
        self.offset = 0  # byte offset of the next un-YIELDED record

    # ------------------------------------------------------------- offsets

    def save(self) -> dict:
        """Checkpointable consumer position (Kafka offset analog)."""
        return {"path": self.path, "offset": self.offset}

    def restore(self, state: dict, allow_path_mismatch: bool = False) -> None:
        if not allow_path_mismatch and state.get("path") not in (None, self.path):
            raise ValueError(
                f"offset checkpoint is for {state['path']!r}, reader tails "
                f"{self.path!r}; a byte offset is meaningless across files "
                "(pass allow_path_mismatch=True to force)"
            )
        self.offset = int(state["offset"])

    # ------------------------------------------------------------- iterate

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        CHUNK = max(1 << 20, self.B * 512)
        chunk = CHUNK
        while True:
            size = os.path.getsize(self.path) if os.path.exists(self.path) else 0
            made_progress = False
            if size > self.offset:
                with open(self.path, "rb") as f:
                    f.seek(self.offset)
                    data = f.read(min(chunk, size - self.offset))
                last_nl = data.rfind(b"\n")
                if last_nl >= 0:
                    rows = data[: last_nl + 1].split(b"\n")[:-1]
                    at_end = self.offset + len(data) >= size
                    i = 0
                    while i < len(rows):
                        batch_rows = rows[i : i + self.B]
                        full = len(batch_rows) == self.B
                        final_flush = (
                            self.stop_at_eof and at_end and i + self.B >= len(rows)
                        )
                        if not full and not final_flush:
                            break  # wait for more data; offset stays put
                        nbytes = sum(len(r) + 1 for r in batch_rows)
                        # Advance BEFORE yielding (generator suspension would
                        # otherwise leave save() not covering a batch the
                        # consumer already holds): offsets mean "everything
                        # handed out so far", Kafka consumer semantics.
                        self.offset += nbytes
                        made_progress = True
                        i += len(batch_rows)
                        yield self.parser(
                            [r.decode(errors="replace") for r in batch_rows]
                        )
                if made_progress:
                    chunk = CHUNK
                elif self.offset + len(data) < size:
                    # Window exhausted without yielding a batch while more
                    # bytes already sit on disk — a record (or whole batch)
                    # longer than the window. Widen and retry instead of
                    # re-reading the same bytes forever.
                    chunk *= 2
                    continue
            if self.stop_at_eof and not made_progress:
                # nothing (more) consumable: either fully drained or only an
                # unterminated partial line remains — stop either way.
                return
            if not made_progress:
                time.sleep(self.poll_secs)  # no busy loop on partial lines

# --------------------------------------------------------------- TCP stream


class TCPStreamReader:
    """Consume a newline-framed record stream over TCP with offset resume.

    Protocol (see FileStreamServer): on connect the consumer sends one
    header line ``OFFSET <n>\\n``; the broker replies with the stream from
    byte offset n onward and keeps the connection open for appended
    records. Offsets advance only past YIELDED rows (the FileTailReader
    contract), so `save()`/`restore()` give exactly-once delivery across
    reconnects and process restarts — the consumer-group-offset semantics
    of the reference's KafkaDataset (kafka_dataset_op.cc), over a socket
    this environment can actually open.

    Broker outages are survived, not raised (unless `stop_at_eof`):
    reconnects use jittered exponential backoff from `reconnect_secs` up
    to `reconnect_max_secs`, and `connect_attempts` / `reconnects` /
    `consecutive_connect_failures` surface the churn to supervisors.

    Frame hygiene (the firewall's first line, docs/fault-tolerance.md
    "Semantic faults"): a frame larger than `max_record_bytes` with no
    newline is a wedged/garbage stream segment — it is SKIPPED up to the
    next newline (bounded resync, counted in `oversized_frames` +
    `record_errors`) instead of growing the buffer without bound or
    killing the reader thread; an undecodable record clamps field-wise
    inside the default parser (`criteo_line_parser(errors=...)`), also
    counted — one poisoned frame must cost one frame, never a reconnect
    cycle or the reader.
    """

    def __init__(
        self,
        host: str,
        port: int,
        batch_size: int = 2048,
        parser: Optional[Callable] = None,
        stop_at_eof: bool = False,
        reconnect_secs: float = 1.0,
        reconnect_max_secs: float = 30.0,
        num_dense: int = 13,
        num_cat: int = 26,
        max_record_bytes: int = 1 << 20,
    ):
        from deeprec_tpu_torch.data.readers import RecordErrors

        self.host = host
        self.port = port
        self.B = batch_size
        self.record_errors = RecordErrors()
        self.max_record_bytes = int(max_record_bytes)
        self.oversized_frames = 0
        self._skipping = False  # inside an oversized frame, seeking \n
        self.parser = parser or criteo_line_parser(
            num_dense, num_cat, errors=self.record_errors)
        self.stop_at_eof = stop_at_eof
        # Reconnect policy: jittered exponential backoff from
        # `reconnect_secs` (the base, kept for back-compat) capped at
        # `reconnect_max_secs` — a dead broker costs O(cap) polling, a
        # flapping one isn't hammered by every consumer in lockstep.
        self.reconnect_secs = reconnect_secs
        self.reconnect_max_secs = reconnect_max_secs
        self.offset = 0
        # Attempt counters (surfaced by TrainLoop heartbeats and the
        # freshness bench): consecutive_connect_failures resets on a
        # successful connect; reconnects counts broker-initiated drops;
        # connect_attempts counts every dial.
        self.connect_attempts = 0
        self.reconnects = 0
        self.consecutive_connect_failures = 0
        self._rng = random.Random(
            (hash((host, port)) ^ os.getpid()) & 0xFFFFFFFF
        )

    def save(self) -> dict:
        return {"host": self.host, "port": self.port, "offset": self.offset}

    def restore(self, state: dict) -> None:
        self.offset = int(state["offset"])

    def backoff_delay(self, attempt: int) -> float:
        """Capped exponential reconnect delay BEFORE jitter: the k-th
        consecutive failure waits base * 2^(k-1), never above
        reconnect_max_secs. Pure — pinned by tests without sleeping
        (the shared `utils/backoff.py` policy)."""
        return backoff.backoff_delay(
            attempt, self.reconnect_secs, self.reconnect_max_secs)

    def _backoff_sleep(self) -> None:
        d = self.backoff_delay(self.consecutive_connect_failures)
        time.sleep(backoff.jittered(d, self._rng))

    def _connect(self) -> socket.socket:
        self.connect_attempts += 1
        s = socket.create_connection((self.host, self.port), timeout=30)
        s.settimeout(None)  # the 30s budget is for CONNECT only: a quiet
        s.sendall(f"OFFSET {self.offset}\n".encode())  # follow-mode broker
        self.consecutive_connect_failures = 0
        return s  # must not look like an EOF after a lull

    def _pop_batch(self, entries, count: int):
        """Pop `count` real rows off the entry queue, folding EVERY
        popped entry's bytes (skip markers included) into the offset —
        skipped frames are consumed stream positions, or a reconnect
        would replay them forever."""
        batch_rows = []
        nbytes = 0
        while len(batch_rows) < count and entries:
            payload, nb = entries.pop(0)
            nbytes += nb
            if payload is not None:
                batch_rows.append(payload)
        self.offset += nbytes
        return batch_rows

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf = b""
        # [(payload | None, nbytes)] — None marks a skipped (oversized)
        # frame whose bytes still advance the offset in stream order.
        entries: list = []
        nreal = 0
        sock = None
        try:
            while True:
                if sock is None:
                    try:
                        sock = self._connect()
                    except OSError:
                        if self.stop_at_eof:
                            # a bounded consume expects the broker to be
                            # there: an empty iterator would masquerade as
                            # an empty stream
                            raise
                        self.consecutive_connect_failures += 1
                        self._backoff_sleep()
                        continue
                try:
                    data = sock.recv(1 << 20)
                except OSError:
                    data = b""
                if not data:  # broker closed: flush or reconnect
                    sock.close()
                    sock = None
                    if self.stop_at_eof:
                        break  # keep entries: the final drain yields them
                    # Drop un-yielded partials: the reconnect replays from
                    # self.offset, which covers exactly the yielded rows —
                    # keeping buf/entries would deliver them twice and
                    # splice a corrupt record out of the old partial line.
                    buf = b""
                    entries = []
                    nreal = 0
                    self._skipping = False
                    self.reconnects += 1
                    self.consecutive_connect_failures += 1
                    self._backoff_sleep()
                    continue
                if self._skipping:
                    # bounded resync: discard until the oversized frame's
                    # terminating newline, counting the bytes (the frame
                    # itself was counted when the skip began — it may
                    # never see its newline before EOF)
                    nl = data.find(b"\n")
                    if nl < 0:
                        entries.append((None, len(data)))
                        continue
                    entries.append((None, nl + 1))
                    self._skipping = False
                    data = data[nl + 1:]
                buf += data
                nl = buf.rfind(b"\n")
                if nl >= 0:
                    for r in buf[: nl + 1].split(b"\n")[:-1]:
                        if len(r) > self.max_record_bytes:
                            # a complete-but-absurd frame: skip it whole
                            entries.append((None, len(r) + 1))
                            self.oversized_frames += 1
                            self.record_errors.count("oversized_frame")
                            continue
                        entries.append((r, len(r) + 1))
                        nreal += 1
                    buf = buf[nl + 1:]
                if len(buf) > self.max_record_bytes:
                    # an unterminated frame larger than any legal record:
                    # consume what's buffered and skip to the next newline
                    # (counted NOW — at EOF it may never get one)
                    entries.append((None, len(buf)))
                    buf = b""
                    self._skipping = True
                    self.oversized_frames += 1
                    self.record_errors.count("oversized_frame")
                while nreal >= self.B:
                    batch_rows = self._pop_batch(entries, self.B)
                    nreal -= len(batch_rows)
                    yield self.parser(
                        [r.decode(errors="replace") for r in batch_rows]
                    )
            # drain the final partial batch at EOF
            if nreal:
                batch_rows = self._pop_batch(entries, nreal)
                yield self.parser(
                    [r.decode(errors="replace") for r in batch_rows]
                )
            # trailing skip markers are consumed stream positions even at
            # EOF: fold them into the offset so a checkpointed position
            # never points back into skipped garbage
            for _, nb in entries:
                self.offset += nb
            entries = []
        finally:
            if sock is not None:
                sock.close()


class FileStreamServer:
    """Minimal broker: serve a file's records over TCP from any offset.

    Speaks the TCPStreamReader protocol. `follow=True` keeps connections
    open and streams appended bytes (the log-broker behavior);
    `follow=False` closes after the current contents (bounded replay).
    Test/demo-grade by design — production pods read through a real broker
    or the shared-FS FileTailReader.
    """

    def __init__(self, path: str, host: str = "127.0.0.1", port: int = 0,
                 follow: bool = False, poll_secs: float = 0.05):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                header = self.rfile.readline().decode().split()
                offset = int(header[1]) if header[:1] == ["OFFSET"] else 0
                try:
                    with open(outer.path, "rb") as f:
                        f.seek(offset)
                        while not outer._stop.is_set():
                            chunk = f.read(1 << 20)
                            if chunk:
                                self.wfile.write(chunk)
                                self.wfile.flush()
                            elif outer.follow:
                                time.sleep(outer.poll_secs)
                            else:
                                return
                except (BrokenPipeError, ConnectionResetError):
                    return  # consumer went away; it will resume by offset

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.path = path
        self.follow = follow
        self.poll_secs = poll_secs
        self._stop = threading.Event()
        self._srv = Server((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FileStreamServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=2)
