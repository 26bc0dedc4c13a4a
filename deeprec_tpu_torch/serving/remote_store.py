"""Remote feature store — the port of `deeprec_tpu/serving/remote_store.py`:
a network KV service and its client for serving-time embedding fallback.

Serving hosts read embedding rows they do not hold locally from a native
`HostKV` (`native/host_kv.cpp`) served over a compact length-prefixed TCP
protocol, byte for byte the JAX package's, so either package's client
talks to either package's server. The client exposes the
HostKV ``get(keys) -> (values, freqs, versions, found)`` signature, so it
plugs straight into ``Predictor(stores={table: client})`` — read-through
works the same whether the store is in-process or remote.

Wire protocol (all little-endian):
  request : b"GETB" | u32 n | n * i64 keys
  response: u32 n | u32 dim | n * u8 found | n*dim f32 values
            | n * i32 freqs | n * i32 versions
  request : b"PUTB" | u32 n | u32 dim | payload (same layout as response)
  response: b"OK\\n\\n"
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

import numpy as np

from deeprec_tpu_torch.native import HostKV

_MAX_BATCH = 1 << 22  # sanity bound on n


def _recv_exact(rfile, n: int) -> bytes:
    data = rfile.read(n)
    if len(data) != n:
        raise ConnectionError("short read")
    return data


class RemoteKVServer:
    """Serve one HostKV (one table's rows) on a TCP port."""

    def __init__(self, kv: HostKV, dim: int, host: str = "127.0.0.1",
                 port: int = 0):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    op = self.rfile.read(4)
                    if len(op) < 4:
                        return
                    if op == b"GETB":
                        (n,) = struct.unpack("<I", _recv_exact(self.rfile, 4))
                        if n > _MAX_BATCH:
                            return
                        keys = np.frombuffer(
                            _recv_exact(self.rfile, 8 * n), "<i8"
                        )
                        with outer._lock:
                            vals, freqs, vers, found = outer.kv.get(keys)
                        out = struct.pack("<II", n, outer.dim)
                        out += found.astype(np.uint8).tobytes()
                        out += vals.astype("<f4").tobytes()
                        out += freqs.astype("<i4").tobytes()
                        out += vers.astype("<i4").tobytes()
                        self.wfile.write(out)
                        self.wfile.flush()
                    elif op == b"PUTB":
                        n, dim = struct.unpack(
                            "<II", _recv_exact(self.rfile, 8)
                        )
                        if n > _MAX_BATCH or dim != outer.dim:
                            return
                        keys = np.frombuffer(
                            _recv_exact(self.rfile, 8 * n), "<i8"
                        )
                        vals = np.frombuffer(
                            _recv_exact(self.rfile, 4 * n * dim), "<f4"
                        ).reshape(n, dim)
                        freqs = np.frombuffer(
                            _recv_exact(self.rfile, 4 * n), "<i4"
                        )
                        vers = np.frombuffer(
                            _recv_exact(self.rfile, 4 * n), "<i4"
                        )
                        with outer._lock:
                            outer.kv.put(keys, vals, freqs, vers)
                        self.wfile.write(b"OK\n\n")
                        self.wfile.flush()
                    else:
                        return  # unknown op: drop the connection

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.kv = kv
        self.dim = dim
        self._lock = threading.Lock()
        self._srv = Server((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "RemoteKVServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread:
            self._thread.join(timeout=2)


class RemoteKVClient:
    """HostKV-shaped client for a RemoteKVServer (or anything speaking the
    protocol). One persistent connection, reconnects on failure."""

    def __init__(self, host: str, port: int, dim: int,
                 timeout: float = 10.0):
        self.host = host
        self.port = port
        self.dim = dim
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
        return self._sock

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _recv(self, sock, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("server closed")
            out += chunk
        return out

    def get(self, keys) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        with self._lock:
            try:
                s = self._conn()
                s.sendall(b"GETB" + struct.pack("<I", n) +
                          keys.astype("<i8").tobytes())
                rn, dim = struct.unpack("<II", self._recv(s, 8))
                if rn != n or dim != self.dim:
                    # explicit (not assert: -O must not strip it) — a
                    # mismatched header means the byte stream would be
                    # misinterpreted as embedding rows
                    raise ConnectionError(
                        f"protocol mismatch: got n={rn} dim={dim}, "
                        f"expected n={n} dim={self.dim}"
                    )
                found = np.frombuffer(self._recv(s, n), np.uint8).astype(bool)
                vals = np.frombuffer(
                    self._recv(s, 4 * n * dim), "<f4"
                ).reshape(n, dim).copy()
                freqs = np.frombuffer(self._recv(s, 4 * n), "<i4").copy()
                vers = np.frombuffer(self._recv(s, 4 * n), "<i4").copy()
                return vals, freqs, vers, found
            except (OSError, ConnectionError):
                self._drop()
                raise

    def put(self, keys, values, freqs=None, versions=None) -> None:
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        values = np.asarray(values, np.float32).reshape(n, self.dim)
        freqs = (np.zeros(n, np.int32) if freqs is None
                 else np.asarray(freqs, np.int32))
        versions = (np.zeros(n, np.int32) if versions is None
                    else np.asarray(versions, np.int32))
        with self._lock:
            try:
                s = self._conn()
                s.sendall(
                    b"PUTB" + struct.pack("<II", n, self.dim)
                    + keys.astype("<i8").tobytes()
                    + values.astype("<f4").tobytes()
                    + freqs.astype("<i4").tobytes()
                    + versions.astype("<i4").tobytes()
                )
                ack = self._recv(s, 4)
                if ack != b"OK\n\n":
                    raise ConnectionError(f"bad ack {ack!r}")
            except (OSError, ConnectionError):
                self._drop()
                raise

    def close(self) -> None:
        with self._lock:
            self._drop()
