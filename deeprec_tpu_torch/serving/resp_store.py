"""RESP (Redis protocol) feature store client — the port of
`deeprec_tpu/serving/resp_store.py`, a drop-in against a real Redis
deployment of the reference's feature store.

The reference serves sparse embedding rows out of Redis
(serving/processor/storage/redis_feature_store.h:18,85 — LocalRedis /
ClusterRedis over hiredis). This module speaks the same wire scheme with
zero dependencies, so a Redis instance populated by a reference deployment
(or by the JAX package's client) serves either package:

  * row key   = LE u64 model_version ++ LE u64 feature2id ++ LE i64 id
    (redis_feature_store.cc BatchGet: memcpy of model_version, feature2id,
    then the raw 8-byte key — binary keys, not strings)
  * row value = raw little-endian f32 bytes of the embedding row
  * batch read  = MGET (one command, N binary keys; nil => missing)
  * batch write = MSET (chunked)
  * metadata  = "GET/SET model_version" ("full,latest"), "GET/SET active",
    "SET model_lock <v> EX <t> NX" (GetStorageLock) — the same literal
    commands GetRedisMeta/SetModelVersion/SetActiveStatus issue.

``RedisFeatureStore`` exposes the HostKV ``get(keys) -> (values, freqs,
versions, found)`` signature, so it plugs into
``Predictor(stores={table: store})`` exactly like RemoteKVClient — the
bespoke-protocol store stays available as the no-Redis fallback. Redis
holds only values (the reference stores no freq/version per row); freqs
and versions come back zero with an exact found mask.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_CRLF = b"\r\n"


class RespError(RuntimeError):
    """A Redis `-ERR ...` reply."""


def encode_command(*args: bytes | str | int) -> bytes:
    """RESP array of bulk strings — the one request shape Redis accepts."""
    out = [b"*%d\r\n" % len(args)]
    for a in args:
        if isinstance(a, int):
            a = str(a).encode()
        elif isinstance(a, str):
            a = a.encode()
        out.append(b"$%d\r\n" % len(a))
        out.append(a)
        out.append(_CRLF)
    return b"".join(out)


class RespConnection:
    """One Redis connection: pipelined command send + reply parse.

    Thread-safe at the call level (a lock spans each send+receive), one
    persistent socket with lazy (re)connect — the RemoteKVClient pattern.
    """

    def __init__(self, host: str, port: int = 6379, *,
                 password: Optional[str] = None, db: int = 0,
                 timeout: float = 10.0):
        self.host, self.port = host, port
        self.password = password
        self.db = db
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._lock = threading.Lock()

    # -- socket plumbing

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self._buf = b""
            hello: List[Tuple[bytes, ...]] = []
            if self.password is not None:
                hello.append((b"AUTH", self.password.encode()))
            if self.db:
                hello.append((b"SELECT", str(self.db).encode()))
            for cmd in hello:
                self._sock.sendall(encode_command(*cmd))
                self._read_reply()  # raises RespError on AUTH/SELECT failure
        return self._sock

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._buf = b""

    def close(self) -> None:
        with self._lock:
            self._drop()

    # -- RESP parsing

    def _read_line(self) -> bytes:
        while _CRLF not in self._buf:
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("redis closed the connection")
            self._buf += chunk
        line, self._buf = self._buf.split(_CRLF, 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("redis closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _read_reply(self):
        line = self._read_line()
        kind, rest = line[:1], line[1:]
        if kind == b"+":
            return rest  # simple string (e.g. b"OK")
        if kind == b"-":
            raise RespError(rest.decode(errors="replace"))
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n == -1:
                return None  # nil bulk
            data = self._read_exact(n)
            self._read_exact(2)  # trailing CRLF
            return data
        if kind == b"*":
            n = int(rest)
            if n == -1:
                return None  # nil array
            return [self._read_reply() for _ in range(n)]
        raise ConnectionError(f"bad RESP type byte {kind!r}")

    # -- public

    def command(self, *args):
        """One command, one reply. RespError for -ERR, reconnect on IO
        failure (next call redials)."""
        with self._lock:
            try:
                s = self._conn()
                s.sendall(encode_command(*args))
                return self._read_reply()
            except (OSError, ConnectionError):
                self._drop()
                raise

    def pipeline(self, commands: Sequence[Tuple]) -> list:
        """Send every command in one write, read every reply in order —
        what redisAppendCommand/redisGetReply do for the reference's
        async batches. Per-command `-ERR` replies are drained (the
        connection stays in sync — an unread reply would be handed to the
        NEXT command) and the first one raises after the full read."""
        if not commands:
            return []
        with self._lock:
            try:
                s = self._conn()
                s.sendall(b"".join(encode_command(*c) for c in commands))
                replies, first_err = [], None
                for _ in commands:
                    try:
                        replies.append(self._read_reply())
                    except RespError as e:
                        replies.append(e)
                        first_err = first_err or e
                if first_err is not None:
                    raise first_err
                return replies
            except (OSError, ConnectionError):
                self._drop()
                raise


class RedisFeatureStore:
    """HostKV-shaped view of a (reference-scheme) Redis feature store.

    Key/value encoding per redis_feature_store.cc (see module docstring).
    `feature2id` is the per-table integer the reference's graph optimizer
    assigns (graph_optimizer.cc:1792, sequential per EV node) — match the
    deployment's assignment when reading a reference-populated store.
    """

    # Bound keys per MGET/MSET command: a 4M-row promote burst must not
    # become one giant command buffer on either end.
    CHUNK = 8192

    def __init__(self, host: str, port: int = 6379, dim: int = None, *,
                 model_version: int = 0, feature2id: int = 0,
                 password: Optional[str] = None, db: int = 0,
                 timeout: float = 10.0,
                 conn: Optional[RespConnection] = None):
        if dim is None:
            raise ValueError("dim is required (embedding row width)")
        self.dim = dim
        self.model_version = model_version
        self.feature2id = feature2id
        self.conn = conn or RespConnection(
            host, port, password=password, db=db, timeout=timeout
        )

    # -- key scheme

    def _key(self, k: int) -> bytes:
        return struct.pack("<QQq", self.model_version, self.feature2id,
                           int(k))

    # -- HostKV surface (what Predictor's read-through fallback calls)

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        vals = np.zeros((n, self.dim), np.float32)
        found = np.zeros(n, bool)
        for lo in range(0, n, self.CHUNK):
            chunk = keys[lo:lo + self.CHUNK]
            reply = self.conn.command(
                b"MGET", *[self._key(k) for k in chunk]
            )
            if not isinstance(reply, list) or len(reply) != len(chunk):
                raise ConnectionError(
                    f"MGET returned {type(reply).__name__} of "
                    f"{len(reply) if isinstance(reply, list) else '?'}, "
                    f"expected {len(chunk)} rows"
                )
            for i, item in enumerate(reply):
                if item is None:
                    continue
                if len(item) != 4 * self.dim:
                    raise ConnectionError(
                        f"row for key {int(chunk[i])} is {len(item)} bytes, "
                        f"expected {4 * self.dim} (dim mismatch?)"
                    )
                vals[lo + i] = np.frombuffer(item, "<f4")
                found[lo + i] = True
        zeros = np.zeros(n, np.int32)
        return vals, zeros.copy(), zeros.copy(), found

    def put(self, keys, values, freqs=None, versions=None) -> None:
        """MSET the rows (freq/version are accepted for HostKV-signature
        compatibility and dropped — the reference scheme stores values
        only)."""
        del freqs, versions
        keys = np.asarray(keys, np.int64)
        values = np.asarray(values, np.float32).reshape(len(keys), self.dim)
        for lo in range(0, len(keys), self.CHUNK):
            args: List[bytes] = [b"MSET"]
            for k, row in zip(keys[lo:lo + self.CHUNK],
                              values[lo:lo + self.CHUNK]):
                args.append(self._key(k))
                args.append(row.astype("<f4").tobytes())
            reply = self.conn.command(*args)
            if reply != b"OK":
                raise ConnectionError(f"MSET returned {reply!r}")

    def delete(self, keys) -> int:
        """DEL rows (the reference's Cleanup path eval-scans and deletes
        stale versions; per-key delete is the building block)."""
        keys = np.asarray(keys, np.int64)
        removed = 0
        for lo in range(0, len(keys), self.CHUNK):
            removed += int(self.conn.command(
                b"DEL", *[self._key(k) for k in keys[lo:lo + self.CHUNK]]
            ))
        return removed

    # -- metadata parity (GetRedisMeta / SetModelVersion / SetActiveStatus
    #    / GetStorageLock literal command strings)

    def get_model_version(self) -> Tuple[int, int]:
        reply = self.conn.command(b"GET", b"model_version")
        if reply is None:
            return -1, -1
        text = reply.decode()
        if "," not in text:
            raise RespError(f"unparseable model_version {text!r}")
        full, latest = text.split(",", 1)
        return int(full), int(latest)

    def set_model_version(self, full_version: int,
                          latest_version: int) -> None:
        self.conn.command(
            b"SET", b"model_version", f"{full_version},{latest_version}"
        )

    def get_active(self) -> bool:
        reply = self.conn.command(b"GET", b"active")
        return reply is not None and reply != b"0"

    def set_active(self, active: bool) -> None:
        self.conn.command(b"SET", b"active", b"1" if active else b"0")

    def acquire_lock(self, value: int, timeout_secs: int) -> bool:
        """SET model_lock <v> EX <t> NX — the reference's distributed
        update lock; True when this caller won it."""
        reply = self.conn.command(
            b"SET", b"model_lock", str(value), b"ex", str(timeout_secs),
            b"nx",
        )
        return reply is not None

    def release_lock(self) -> None:
        self.conn.command(b"DEL", b"model_lock")

    def close(self) -> None:
        self.conn.close()
