"""Kafka wire-protocol consumer (no librdkafka, no external deps) — the
port's copy of `deeprec_tpu/data/kafka.py`; host-only.

The reference trains from Kafka through librdkafka
(core/kernels/data/kafka_dataset_op.cc — KafkaDataset with
"topic:partition:offset[:limit]" strings, consumer-group offsets, eof /
timeout semantics; contrib/kafka wraps the same). This module speaks the
actual Kafka protocol over a plain socket so the framework can consume
from a real broker: big-endian framed requests, ApiVersions(18) /
Metadata(3) / ListOffsets(2) / Fetch(1) / OffsetCommit(8) /
OffsetFetch(9), with both on-wire record encodings parsed — the legacy
MessageSet (message format v0/v1, what brokers down-convert to for old
fetch versions) and the v2 RecordBatch (varint records). Compression is
not supported (attributes must be 0) — DeepRec's training pipelines run
uncompressed topics; a compressed batch raises rather than corrupting.

Offset semantics match the rest of data/stream.py: `save()` returns the
offset of the next UN-yielded record, so checkpoint/crash/restore is
exactly-once with respect to delivered batches. `commit()` additionally
stores the position broker-side under a consumer group (OffsetCommit),
and a reader constructed with offset -1 resumes from the group's stored
offset (OffsetFetch), mirroring the reference's group semantics.

Protocol versions are pinned low on purpose: v0/v1 requests have stable,
simple encodings, every broker since 0.10 answers them, and ApiVersions
is consulted only to fail loudly when a future broker drops one.
"""
from __future__ import annotations

import logging
import socket
import struct
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# api keys
API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_VERSIONS = 18

# error codes we special-case
ERR_NONE = 0
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_NOT_LEADER = 6

_ERR_NAMES = {
    1: "OFFSET_OUT_OF_RANGE",
    3: "UNKNOWN_TOPIC_OR_PARTITION",
    6: "NOT_LEADER_FOR_PARTITION",
    7: "REQUEST_TIMED_OUT",
    15: "COORDINATOR_NOT_AVAILABLE",
    16: "NOT_COORDINATOR",
}


class KafkaError(RuntimeError):
    def __init__(self, code: int, where: str):
        self.code = code
        super().__init__(
            f"{where}: kafka error {code} ({_ERR_NAMES.get(code, 'unknown')})"
        )


class KafkaOffsetGapError(RuntimeError):
    """A restored/requested offset no longer exists on the broker — the
    topic's retention (or compaction) outran the checkpoint. Restart with
    offset_reset="earliest" to accept the data loss and resume from the
    oldest retained record, or re-point the reader at a fresh offset."""


# ------------------------------------------------------------ primitives


class _Writer:
    __slots__ = ("buf",)

    def __init__(self):
        self.buf = bytearray()

    def i8(self, v):
        self.buf += struct.pack(">b", v)
        return self

    def i16(self, v):
        self.buf += struct.pack(">h", v)
        return self

    def i32(self, v):
        self.buf += struct.pack(">i", v)
        return self

    def i64(self, v):
        self.buf += struct.pack(">q", v)
        return self

    def string(self, s: Optional[str]):
        if s is None:
            return self.i16(-1)
        b = s.encode()
        self.i16(len(b))
        self.buf += b
        return self

    def bytes_(self, b: Optional[bytes]):
        if b is None:
            return self.i32(-1)
        self.i32(len(b))
        self.buf += b
        return self

    def array(self, items, fn):
        self.i32(len(items))
        for it in items:
            fn(self, it)
        return self


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated kafka frame")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def i8(self):
        return struct.unpack(">b", self._take(1))[0]

    def i16(self):
        return struct.unpack(">h", self._take(2))[0]

    def i32(self):
        return struct.unpack(">i", self._take(4))[0]

    def i64(self):
        return struct.unpack(">q", self._take(8))[0]

    def u32(self):
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        return None if n < 0 else self._take(n).decode("utf-8", "replace")

    def bytes_(self) -> Optional[bytes]:
        n = self.i32()
        return None if n < 0 else bytes(self._take(n))

    def varint(self) -> int:
        """Zigzag varint (record batch v2 encoding)."""
        result = 0
        shift = 0
        while True:
            b = self._take(1)[0]
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift >= 70:
                raise ValueError("varint too long")
        return (result >> 1) ^ -(result & 1)

    def varbytes(self) -> Optional[bytes]:
        n = self.varint()
        return None if n < 0 else bytes(self._take(n))


# --------------------------------------------------------- record parsing


def _parse_message_set(r: _Reader, end: int) -> List[Tuple[int, bytes, bytes]]:
    """Legacy MessageSet (magic 0/1): [(offset, key, value)].

    A fetch response may end with a partial message (the broker truncates
    at max_bytes) — stop cleanly there.
    """
    out = []
    while r.pos + 12 <= end:
        offset = r.i64()
        size = r.i32()
        if r.pos + size > end:
            break  # trailing partial message
        body = _Reader(r.buf, r.pos)
        r.pos += size
        body.u32()  # crc (not verified; TCP already checksums)
        magic = body.i8()
        attrs = body.i8()
        if attrs & 0x07:
            raise ValueError(
                "compressed kafka message (attrs=%d): compression is not "
                "supported, produce uncompressed" % attrs
            )
        if magic >= 1:
            body.i64()  # timestamp
        key = body.bytes_()
        value = body.bytes_()
        out.append((offset, key or b"", value or b""))
    return out


def _parse_record_batch(r: _Reader, end: int) -> List[Tuple[int, bytes, bytes]]:
    """Record batch v2: [(offset, key, value)]."""
    out = []
    while r.pos + 61 <= end:  # batch header is 61 bytes
        base_offset = r.i64()
        batch_len = r.i32()
        batch_end = r.pos + batch_len
        if batch_end > end:
            break  # partial trailing batch
        r.i32()  # partition leader epoch
        magic = r.i8()
        if magic != 2:
            raise ValueError(f"unexpected magic {magic} in record batch")
        r.u32()  # crc32c (not verified)
        attrs = r.i16()
        if attrs & 0x07:
            raise ValueError(
                "compressed kafka record batch (attrs=%d): compression is "
                "not supported, produce uncompressed" % attrs
            )
        if attrs & 0x20:  # control batch (transaction markers): no data
            r.pos = batch_end
            continue
        r.i32()  # last offset delta
        r.i64()  # first timestamp
        r.i64()  # max timestamp
        r.i64()  # producer id
        r.i16()  # producer epoch
        r.i32()  # base sequence
        n_records = r.i32()
        for _ in range(n_records):
            rec_len = r.varint()
            rec_end = r.pos + rec_len
            r.i8()  # record attributes
            r.varint()  # timestamp delta
            off_delta = r.varint()
            key = r.varbytes()
            value = r.varbytes()
            n_headers = r.varint()
            for _ in range(n_headers):
                r.varbytes()  # header key
                r.varbytes()  # header value
            r.pos = rec_end  # defensive: trust the record length
            out.append((base_offset + off_delta, key or b"", value or b""))
        r.pos = batch_end
    return out


def parse_records(buf: bytes) -> List[Tuple[int, bytes, bytes]]:
    """Parse a fetch-response record blob in either on-wire encoding."""
    if not buf:
        return []
    # magic byte sits at offset 16 in both encodings
    if len(buf) > 16 and buf[16] >= 2:
        return _parse_record_batch(_Reader(buf), len(buf))
    return _parse_message_set(_Reader(buf), len(buf))


# --------------------------------------------------------------- client


class KafkaClient:
    """One broker connection, correlation-id matched request/response."""

    def __init__(self, host: str, port: int, client_id: str = "deeprec-tpu",
                 timeout: float = 30.0):
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout = timeout
        self._corr = 0
        self._sock: Optional[socket.socket] = None

    # -- framing

    def _ensure(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _roundtrip(self, api_key: int, api_version: int,
                   payload: bytes) -> _Reader:
        self._ensure()
        self._corr += 1
        hdr = _Writer()
        hdr.i16(api_key).i16(api_version).i32(self._corr).string(self.client_id)
        frame = bytes(hdr.buf) + payload
        msg = struct.pack(">i", len(frame)) + frame
        try:
            self._sock.sendall(msg)
            raw = self._recv_frame()
        except OSError:
            self.close()
            raise
        r = _Reader(raw)
        corr = r.i32()
        if corr != self._corr:
            self.close()
            raise ValueError(
                f"correlation id mismatch: sent {self._corr}, got {corr}"
            )
        return r

    def _recv_frame(self) -> bytes:
        size_b = self._recv_exact(4)
        (size,) = struct.unpack(">i", size_b)
        if size < 0 or size > 1 << 30:
            raise ValueError(f"bad kafka frame size {size}")
        return self._recv_exact(size)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        got = 0
        while got < n:
            c = self._sock.recv(n - got)
            if not c:
                raise OSError("broker closed connection")
            chunks.append(c)
            got += len(c)
        return b"".join(chunks)

    # -- apis (versions pinned; see module docstring)

    def api_versions(self) -> Dict[int, Tuple[int, int]]:
        r = self._roundtrip(API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaError(err, "ApiVersions")
        out = {}
        for _ in range(r.i32()):
            k, lo, hi = r.i16(), r.i16(), r.i16()
            out[k] = (lo, hi)
        return out

    def metadata(self, topics: List[str]):
        w = _Writer()
        w.array(topics, lambda w, t: w.string(t))
        r = self._roundtrip(API_METADATA, 0, bytes(w.buf))
        brokers = {}
        for _ in range(r.i32()):
            node, host, port = r.i32(), r.string(), r.i32()
            brokers[node] = (host, port)
        topics_out = {}
        for _ in range(r.i32()):
            terr = r.i16()
            tname = r.string()
            parts = {}
            for _ in range(r.i32()):
                perr = r.i16()
                pid = r.i32()
                leader = r.i32()
                for _ in range(r.i32()):
                    r.i32()  # replicas
                for _ in range(r.i32()):
                    r.i32()  # isr
                parts[pid] = {"error": perr, "leader": leader}
            topics_out[tname] = {"error": terr, "partitions": parts}
        return brokers, topics_out

    def list_offsets(self, topic: str, partition: int, when: int) -> int:
        """when: -1 latest, -2 earliest (ListOffsets v0 semantics)."""
        w = _Writer()
        w.i32(-1)  # replica_id
        w.array([None], lambda w, _: (
            w.string(topic),
            w.array([None], lambda w2, _2: (
                w2.i32(partition), w2.i64(when), w2.i32(1)))))
        r = self._roundtrip(API_LIST_OFFSETS, 0, bytes(w.buf))
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition id
                err = r.i16()
                n = r.i32()
                offs = [r.i64() for _ in range(n)]
                if err:
                    raise KafkaError(err, "ListOffsets")
                return offs[0] if offs else 0
        raise ValueError("empty ListOffsets response")

    def fetch(self, topic: str, partition: int, offset: int,
              max_wait_ms: int = 500, min_bytes: int = 1,
              max_bytes: int = 1 << 22) -> Tuple[int, List[Tuple[int, bytes, bytes]]]:
        """Returns (high_watermark, [(offset, key, value), ...])."""
        w = _Writer()
        w.i32(-1)  # replica_id
        w.i32(max_wait_ms)
        w.i32(min_bytes)
        w.array([None], lambda w, _: (
            w.string(topic),
            w.array([None], lambda w2, _2: (
                w2.i32(partition), w2.i64(offset), w2.i32(max_bytes)))))
        r = self._roundtrip(API_FETCH, 0, bytes(w.buf))
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()  # partition id
                err = r.i16()
                hw = r.i64()
                blob = r.bytes_() or b""
                if err:
                    raise KafkaError(err, "Fetch")
                return hw, parse_records(blob)
        raise ValueError("empty Fetch response")

    def offset_commit(self, group: str, topic: str, partition: int,
                      offset: int, metadata: str = "") -> None:
        """OffsetCommit v2 — the Kafka-side (__consumer_offsets) store,
        the SAME store OffsetFetch v1+ reads (v0 would write the
        ZooKeeper-era store and a later offset_fetch would miss it).
        Simple-consumer path: generation -1, empty member, no retention."""
        w = _Writer()
        w.string(group)
        w.i32(-1)       # generation id (simple consumer)
        w.string("")    # member id
        w.i64(-1)       # retention time (broker default)
        w.array([None], lambda w, _: (
            w.string(topic),
            w.array([None], lambda w2, _2: (
                w2.i32(partition), w2.i64(offset), w2.string(metadata)))))
        r = self._roundtrip(API_OFFSET_COMMIT, 2, bytes(w.buf))
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                err = r.i16()
                if err:
                    raise KafkaError(err, "OffsetCommit")

    def offset_fetch(self, group: str, topic: str, partition: int) -> int:
        """OffsetFetch v1 (broker-stored group offset; -1 = none)."""
        w = _Writer()
        w.string(group)
        w.array([None], lambda w, _: (
            w.string(topic),
            w.array([None], lambda w2, _2: w2.i32(partition))))
        r = self._roundtrip(API_OFFSET_FETCH, 1, bytes(w.buf))
        for _ in range(r.i32()):
            r.string()
            for _ in range(r.i32()):
                r.i32()
                off = r.i64()
                r.string()  # metadata
                err = r.i16()
                if err:
                    raise KafkaError(err, "OffsetFetch")
                return off
        raise ValueError("empty OffsetFetch response")


# ---------------------------------------------------------------- reader


class KafkaStreamReader:
    """Batch reader over one topic:partition via the real Kafka protocol.

    The KafkaDataset analog (kafka_dataset_op.cc): construct from a
    reference-style ``"topic:partition:offset[:limit]"`` string or
    explicit args. Offsets are Kafka record offsets; `save()`/`restore()`
    carry the next UN-yielded offset (exactly-once across restarts), and
    `commit()` stores it broker-side under `group` like the reference's
    consumer group. offset -1 means resume from the group's stored
    offset, falling back to earliest.

    `stop_at_eof=True` mirrors the reference's eof attr: drain up to the
    high watermark (or `limit`) and stop; otherwise follow forever.
    """

    def __init__(
        self,
        servers: str,
        topic_spec: str = None,
        *,
        topic: str = None,
        partition: int = 0,
        offset: int = -2,
        limit: int = -1,
        group: str = "deeprec",
        batch_size: int = 2048,
        parser: Optional[Callable] = None,
        stop_at_eof: bool = False,
        max_wait_ms: int = 500,
        reconnect_secs: float = 1.0,
        num_dense: int = 13,
        num_cat: int = 26,
        offset_reset: str = "error",
    ):
        if topic_spec is not None:
            parts = topic_spec.split(":")
            topic = parts[0]
            if len(parts) > 1 and parts[1]:
                partition = int(parts[1])
            if len(parts) > 2 and parts[2]:
                offset = int(parts[2])
            if len(parts) > 3 and parts[3]:
                limit = int(parts[3])
        if topic is None:
            raise ValueError("topic required (topic_spec or topic=)")
        if offset_reset not in ("error", "earliest"):
            raise ValueError(
                f"offset_reset must be 'error' or 'earliest', got "
                f"{offset_reset!r}"
            )
        self.servers = [s.strip() for s in servers.split(",") if s.strip()]
        if not self.servers:
            raise ValueError("at least one bootstrap server required")
        self.client: Optional[KafkaClient] = None  # leader, connected lazily
        self.offset_reset = offset_reset
        self.topic = topic
        self.partition = partition
        self.group = group
        self.B = batch_size
        self.limit = limit
        self.stop_at_eof = stop_at_eof
        self.max_wait_ms = max_wait_ms
        self.reconnect_secs = reconnect_secs
        from deeprec_tpu_torch.data.stream import criteo_line_parser

        self.parser = parser or criteo_line_parser(num_dense, num_cat)
        self._start = offset
        self.offset: Optional[int] = None  # resolved lazily

    # -- broker connection (leader-aware)

    def _ensure_client(self) -> KafkaClient:
        if self.client is None:
            self.client = self._connect_leader()
        return self.client

    def _connect_leader(self) -> KafkaClient:
        """Locate the partition leader via Metadata — what the reference
        gets for free from librdkafka (kafka_dataset_op.cc's consumer
        follows leader redirects). Falls back to the bootstrap connection
        itself when metadata is unhelpful (single-broker/dev setups)."""
        last: Optional[Exception] = None
        for srv in self.servers:
            host, _, port = srv.partition(":")
            cand = KafkaClient(host, int(port or 9092))
            try:
                brokers, topics = cand.metadata([self.topic])
            except (OSError, ValueError, KafkaError) as e:
                cand.close()
                last = e
                continue
            info = (
                topics.get(self.topic, {})
                .get("partitions", {})
                .get(self.partition)
            )
            if info and not info.get("error") and info.get("leader") in brokers:
                lh, lp = brokers[info["leader"]]
                if (lh, int(lp)) != (cand.host, cand.port):
                    cand.close()
                    return KafkaClient(lh, int(lp))
            return cand
        assert last is not None
        raise last

    # -- offsets

    def _resolve_start(self) -> int:
        if self._start >= 0:
            return self._start
        client = self._ensure_client()
        if self._start == -1:  # group offset, else earliest
            stored = client.offset_fetch(
                self.group, self.topic, self.partition
            )
            if stored >= 0:
                return stored
            return client.list_offsets(self.topic, self.partition, -2)
        return client.list_offsets(self.topic, self.partition, -2)

    def save(self) -> dict:
        return {
            "topic": self.topic,
            "partition": self.partition,
            "offset": self.offset if self.offset is not None else self._start,
        }

    def restore(self, state: dict) -> None:
        if state.get("topic") not in (None, self.topic) or int(
            state.get("partition", self.partition)
        ) != self.partition:
            raise ValueError(
                f"offset checkpoint is for "
                f"{state.get('topic')}:{state.get('partition')}, reader "
                f"consumes {self.topic}:{self.partition}"
            )
        self._start = int(state["offset"])
        self.offset = None

    def commit(self) -> None:
        """Store the next-unyielded offset broker-side (consumer group)."""
        off = self.offset if self.offset is not None else self._start
        if off >= 0:
            self._ensure_client().offset_commit(
                self.group, self.topic, self.partition, off
            )

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
            self.client = None

    # -- iterate

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.offset is None:
            self.offset = self._resolve_start()
        rows: List[Tuple[int, bytes]] = []  # (offset, value) not yet yielded
        # Two positions: `fetch_pos` walks ahead as records are buffered;
        # `self.offset` (the save()/commit() contract) advances only when
        # a batch is HANDED OUT, so a crash re-fetches buffered rows
        # instead of dropping them.
        fetch_pos = self.offset
        leader_retries = 0
        while True:
            try:
                hw, records = self._ensure_client().fetch(
                    self.topic, self.partition, fetch_pos,
                    max_wait_ms=self.max_wait_ms,
                )
                leader_retries = 0
            except ValueError:
                # Permanent (unparseable/compressed data): retrying the
                # same offset would stall training silently. Always raise.
                self.close()
                raise
            except KafkaError as e:
                self.close()
                if e.code == ERR_NOT_LEADER and leader_retries < 8:
                    # Leadership moved (rebalance/broker restart): re-resolve
                    # via Metadata and retry the same position — librdkafka's
                    # automatic leader redirect, bounded so a sick cluster
                    # surfaces instead of spinning forever.
                    leader_retries += 1
                    time.sleep(self.reconnect_secs)
                    continue
                if e.code == ERR_OFFSET_OUT_OF_RANGE:
                    if self.offset_reset == "earliest":
                        earliest = self._ensure_client().list_offsets(
                            self.topic, self.partition, -2
                        )
                        logging.getLogger(__name__).warning(
                            "kafka %s:%d: offset %d is outside the broker's "
                            "retained range; resetting to earliest=%d "
                            "(offset_reset='earliest') — records in between "
                            "are lost",
                            self.topic, self.partition, fetch_pos, earliest,
                        )
                        fetch_pos = earliest
                        self.offset = max(self.offset, earliest)
                        continue
                    raise KafkaOffsetGapError(
                        f"kafka {self.topic}:{self.partition}: offset "
                        f"{fetch_pos} no longer exists on the broker (topic "
                        "retention or compaction outran this checkpoint). "
                        "Pass offset_reset='earliest' to resume from the "
                        "oldest retained record, accepting the gap."
                    ) from e
                raise
            except OSError:
                self.close()
                if self.stop_at_eof:
                    raise
                time.sleep(self.reconnect_secs)
                continue
            for off, _key, value in records:
                if off < fetch_pos:
                    continue  # broker resent below our position
                if self.limit >= 0 and off >= self.limit:
                    fetch_pos = self.limit  # done even on a sparse topic
                    break
                rows.append((off, value))
                fetch_pos = off + 1
            # Checkpoint offsets come from the RECORDS (last yielded + 1),
            # not a dense counter — compacted topics and transaction
            # markers leave holes a counter would re-deliver through.
            while len(rows) >= self.B:
                batch, rows = rows[: self.B], rows[self.B:]
                self.offset = batch[-1][0] + 1
                yield self.parser(
                    [v.decode(errors="replace") for _, v in batch]
                )
            done = (self.limit >= 0 and fetch_pos >= self.limit) or (
                self.stop_at_eof and not records and fetch_pos >= hw
            )
            if done:
                if rows:  # final partial batch (bounded-dataset flush)
                    self.offset = rows[-1][0] + 1
                    yield self.parser(
                        [v.decode(errors="replace") for _, v in rows]
                    )
                return
