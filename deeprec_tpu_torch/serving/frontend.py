"""Socket-tier serving scale-out — the port of
`deeprec_tpu/serving/frontend.py`: a front tier dispatching requests
across N backend serving processes.

Each **backend** is a full serving process (Predictor + micro-batching
ModelServer + its own delta-chain poller, so model updates stay zero-stall
per process; on the card each holds its own CUDA context), and the
**frontend** is a thin routing tier that speaks a compact length-prefixed
TCP protocol (the `remote_store.py` idiom) to whichever backends are
healthy. The frontend holds no tables and does no device work: it parses
features from the model's declarations alone.

Responsibilities split:
  * Backend — owns a model replica: restore (optionally into an int8 or
    bf16 residency), micro-batch coalescing, `poll_updates` against the
    shared checkpoint dir, per-process `/v1/stats`-shaped accounting, and
    optionally a corpus shard of full-corpus retrieval.
  * Frontend — owns the client edge: feature parsing, request routing
    (round-robin for plain requests; a consistent-hash ring on the user
    features for `group_users` requests, so one user's `<user, N items>`
    traffic keeps landing on one backend), sibling retry on member failure
    (a SIGKILLed backend mid-batch costs a retry, never a failed request),
    member health and backoff, registry membership (`serving/fleet.py`),
    the retrieval fan-out and edge merge, and the merged stats and health
    surfaces: `/healthz` is the WORST member plus the frontend's own
    availability view, `/v1/stats` spans every member.

Wire protocol (little-endian, one frame per message; byte for byte the JAX
package's, so either package's frontend drives either package's backend):
  frame    : 4-byte op | u32 body length | body
  PRED     : body = u8 flags (bit0 group_users, bit1 trace, bit2 no_cache)
             [+ 16-byte trace context] + npz(features)
             reply body = npz('__version__', 'predictions' | 'task:<t>'*)
  RETR     : body = u8 flags + u32 k + npz(user features)
             reply body = npz('ids', 'scores', '__version__', 'scanned')
  RITM     : body = npz('__ids__' + item features) -> JSON {accepted, ...}
  HLTH/STAT/INFO/POLL/METR : empty body; reply body = JSON
  replies  : b"OK  " frame, or b"ERR " frame with JSON
             {"error": ..., "kind": "bad_request" | "server"}

Run a backend:  python -m deeprec_tpu_torch.serving.frontend --backend \
                    --model wdl --ckpt DIR --port 0 [--quantize int8] \
                    [--device cuda|cpu]
Run the tier :  python -m deeprec_tpu_torch.serving.frontend --frontend \
                    --model wdl --backends host:p1,host:p2 --http-port 8500
"""
from __future__ import annotations

import io
import itertools
import json
import os
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch.analysis.annotations import guarded_by
from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.obs import schema as obs_schema
from deeprec_tpu_torch.obs import trace as obs_trace
from deeprec_tpu_torch.serving.predictor import BadRequest, _run_poll_loop
from deeprec_tpu_torch.serving.stats import ServingStats
from deeprec_tpu_torch.utils import backoff

_MAX_FRAME = 256 << 20  # sanity bound on one frame's body

OP_PRED = b"PRED"
OP_HLTH = b"HLTH"
OP_STAT = b"STAT"
OP_POLL = b"POLL"
OP_INFO = b"INFO"
OP_METR = b"METR"  # obs metrics snapshot (JSON) — the /metrics merge op
# Full-corpus retrieval (serving/retrieval.py): RETR sweeps this
# backend's corpus SHARD (body = u8 flags + u32 k + npz user features;
# reply npz ids/scores/version/scanned), RITM ingests items (body =
# npz '__ids__' + item features; every member receives the broadcast
# and keeps only the rows that hash to its shard).
OP_RETR = b"RETR"
OP_RITM = b"RITM"
_OK = b"OK  "
_ERR = b"ERR "

_FLAG_GROUP_USERS = 1
# bit1: the npz body is prefixed by obs_trace.WIRE_BYTES of trace
# context (two LE u64s: trace id, parent span id) — how a sampled
# request's trace id crosses the frontend->backend socket hop
_FLAG_TRACE = 2
# bit2 (PRED flags byte and the RETR leading flags byte alike): force a
# real evaluation through a warm compute-reuse cache — no cache read,
# no write, no in-window memo sharing. The canary/quality-gate probe
# and parity-test contract (serving/reuse.py, docs/serving.md).
_FLAG_NO_CACHE = 4

# The slow-joiner fault, subprocess form: a backend delays its FIRST lease
# stamp by this many seconds (it binds and serves, but stays unannounced;
# nobody may route to it until the stamp lands). The JAX package's
# `online/faults.py` names the same variable.
SLOW_JOIN_ENV = "DEEPREC_FAULT_SLOW_JOIN_SECS"


def _slow_join_secs() -> float:
    v = os.environ.get(SLOW_JOIN_ENV)
    return float(v) if v else 0.0


# ------------------------------------------------------------ frame helpers


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("peer closed")
        out += chunk
    return out


def _send_frame(wfile, op: bytes, body: bytes) -> None:
    wfile.write(op + struct.pack("<I", len(body)) + body)
    wfile.flush()


def _pack_arrays(arrays: Dict[str, np.ndarray]) -> bytes:
    """Dict of numpy arrays -> npz bytes (dtype/shape preserving, no
    pickle — array payloads only, so a hostile peer can't smuggle
    objects through the wire format)."""
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
    return buf.getvalue()


def _unpack_arrays(body: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(body), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ----------------------------------------------------------------- backend


@guarded_by("_conn_lock")
class BackendServer:
    """Serve one ModelServer (or ServerGroup) over the socket protocol —
    the per-process half of the tier. Connections are handled by
    stdlib threads; every PRED blocks on the model server's coalescing
    queue, so concurrent frontend connections batch into full device
    batches exactly like local callers (the socket adds transport, not a
    second batching policy). `_conns` (the live-connection registry
    stop() severs) is the only cross-thread field, guarded by
    `_conn_lock`."""

    def __init__(self, model_server, host: str = "127.0.0.1", port: int = 0,
                 *, registry=None, capacity: int = 1, member_name: str = "",
                 lease_delay_secs: float = 0.0):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                super().setup()
                with outer._conn_lock:
                    outer._conns.add(self.connection)

            def finish(self):
                with outer._conn_lock:
                    outer._conns.discard(self.connection)
                super().finish()

            def handle(self):
                while True:
                    hdr = self.rfile.read(8)
                    if len(hdr) < 8:
                        return
                    op, n = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                    if n > _MAX_FRAME:
                        return
                    body = self.rfile.read(n)
                    if len(body) < n:
                        return
                    try:
                        out = outer._dispatch(op, body)
                    except BadRequest as e:
                        out = (_ERR, json.dumps(
                            {**e.details, "kind": "bad_request"}).encode())
                    except Exception as e:  # request-level: keep serving
                        out = (_ERR, json.dumps(
                            {"error": str(e), "kind": "server"}).encode())
                    _send_frame(self.wfile, out[0], out[1])

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            request_queue_size = 128  # bursts of connects must not be refused

            def handle_error(self, request, client_address):
                # A frontend dropping a pooled connection (its own
                # shutdown, a member backoff) is normal churn, not a
                # stack-trace event; real request errors were already
                # answered with an ERR frame by the handler.
                import logging

                logging.getLogger(__name__).debug(
                    "connection error from %s", client_address,
                    exc_info=True)

        self.server = model_server
        self._t0 = time.monotonic()
        self._conns: set = set()
        self._conn_lock = threading.Lock()
        self._inflight = 0  # live PRED frames (guarded by _conn_lock)
        self._srv = Server((host, port), Handler)
        self.port = self._srv.server_address[1]
        self._thread: Optional[threading.Thread] = None
        # Fleet membership (serving/fleet.py): with a registry, this
        # backend announces itself by stamping a lease (addr, capacity,
        # model_version, started_at) — frontends admit it at runtime; a
        # SIGKILL leaves the lease to go stale (eviction), a drain exits
        # politely. `lease_delay_secs` defers the FIRST stamp (the
        # slow-joiner fault: reachable but unannounced — the fleet must
        # not route to it until the lease lands).
        self.addr = f"{host}:{self.port}"
        self.stamper = None
        self._lease_delay = lease_delay_secs
        self._lease_timer: Optional[threading.Timer] = None
        if registry is not None:
            from deeprec_tpu_torch.serving import fleet as _fleet

            if isinstance(registry, str):
                registry = _fleet.FleetRegistry(registry)
            self.stamper = _fleet.LeaseStamper(
                registry, self.addr, role=_fleet.ROLE_BACKEND,
                capacity=capacity, name=member_name,
                version_fn=lambda: self.server.predictor.version)

    def _dispatch(self, op: bytes, body: bytes) -> Tuple[bytes, bytes]:
        if op == OP_PRED:
            if not body:
                raise BadRequest("empty PRED body")
            grouped = bool(body[0] & _FLAG_GROUP_USERS)
            no_cache = bool(body[0] & _FLAG_NO_CACHE)
            off = 1
            ctx = None
            if body[0] & _FLAG_TRACE:
                ctx = obs_trace.unpack_wire(body[1:1 + obs_trace.WIRE_BYTES])
                off = 1 + obs_trace.WIRE_BYTES
            batch = _unpack_arrays(body[off:])
            if not batch:
                raise BadRequest("missing 'features' object")
            with self._conn_lock:
                self._inflight += 1
            try:
                probs, version = self.server.request_versioned(
                    batch, group_users=grouped, trace_ctx=ctx,
                    no_cache=no_cache)
            finally:
                with self._conn_lock:
                    self._inflight -= 1
            out = {"__version__": np.int64(version)}
            if isinstance(probs, dict):
                for k, v in probs.items():
                    out["task:" + k] = np.asarray(v)
            else:
                out["predictions"] = np.asarray(probs)
            return _OK, _pack_arrays(out)
        if op == OP_HLTH:
            return _OK, json.dumps(self.server.predictor.health()).encode()
        if op == OP_STAT:
            snap = self.server.stats_snapshot()
            # True backend-process CPU seconds ride along: the frontend's
            # scale-out model needs the serial-per-request CPU split
            # between tiers, which wall-clock histograms can't give.
            snap["process_cpu_seconds"] = time.process_time()
            snap["uptime_seconds"] = round(time.monotonic() - self._t0, 3)
            return _OK, json.dumps(snap).encode()
        if op == OP_POLL:
            updated = bool(self.server.predictor.poll_updates())
            return _OK, json.dumps({"updated": updated}).encode()
        if op == OP_INFO:
            return _OK, json.dumps(self.server.predictor.model_info()).encode()
        if op == OP_METR:
            # obs-plane snapshot (mergeable JSON, obs/metrics.py): the
            # frontend relabels it per member for the tier /metrics.
            fn = getattr(self.server, "metrics_snapshot", None)
            snap = fn() if fn is not None else {"metrics": {}}
            return _OK, json.dumps(snap).encode()
        if op == OP_RETR:
            if len(body) < 5:
                raise BadRequest("short RETR body")
            if getattr(self.server, "retrieval", None) is None:
                raise BadRequest("retrieval not enabled on this backend")
            no_cache = bool(body[0] & _FLAG_NO_CACHE)
            k = struct.unpack("<I", body[1:5])[0]
            batch = _unpack_arrays(body[5:])
            if not batch:
                raise BadRequest("missing retrieval features")
            with self._conn_lock:
                self._inflight += 1
            try:
                res = self.server.retrieve_versioned(batch, int(k),
                                                     no_cache=no_cache)
            finally:
                with self._conn_lock:
                    self._inflight -= 1
            return _OK, _pack_arrays({
                "ids": res.ids, "scores": res.scores,
                "__version__": np.int64(res.version),
                "scanned": np.int64(res.scanned),
            })
        if op == OP_RITM:
            rs = getattr(self.server, "retrieval", None)
            if rs is None:
                raise BadRequest("retrieval not enabled on this backend")
            arrays = _unpack_arrays(body)
            ids = arrays.pop("__ids__", None)
            if ids is None:
                raise BadRequest("RITM body missing '__ids__'")
            accepted = rs.engine.upsert_items(ids, arrays)
            return _OK, json.dumps({
                "accepted": int(accepted),
                "corpus_rows": rs.engine.corpus_rows(),
                "shard": [rs.engine.shard_index, rs.engine.num_shards],
            }).encode()
        raise BadRequest(f"unknown op {op!r}")

    def inflight(self) -> int:
        with self._conn_lock:
            return self._inflight

    def start(self) -> "BackendServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        if self.stamper is not None:
            if self._lease_delay > 0:
                # slow joiner: serve but don't announce yet — the first
                # stamp (and with it fleet admission) lands later
                self._lease_timer = threading.Timer(
                    self._lease_delay, lambda: self.stamper.start())
                self._lease_timer.daemon = True
                self._lease_timer.start()
            else:
                self.stamper.start()
        return self

    def drain(self, timeout: float = 30.0, respawn: bool = False,
              quiet_rounds: int = 3, poll_secs: float = 0.05) -> int:
        """The leaving half of the EXIT_RESCALE choreography applied to
        serving: stamp the lease ``draining`` (frontends stop NEW
        assignments within one membership sweep), let in-flight grouped
        streams finish (`quiet_rounds` consecutive polls with zero live
        PRED frames and an idle coalescing queue — one empty poll can be
        a gap between a stream's requests), then stop and unregister.
        Returns the exit code to leave with: EXIT_RESCALE when
        `respawn` (a supervisor respawns the member for free — rolling
        restart), else 0 (retirement)."""
        if self.stamper is not None:
            self.stamper.begin_drain(respawn=respawn)
        deadline = time.monotonic() + timeout
        quiet = 0
        while time.monotonic() < deadline and quiet < quiet_rounds:
            qsize_fn = getattr(getattr(self.server, "_q", None),
                               "qsize", lambda: 0)
            quiet = (quiet + 1
                     if self.inflight() == 0 and qsize_fn() == 0 else 0)
            time.sleep(poll_secs)
        self.stop()
        if self.stamper is not None:
            return self.stamper.exit_code()
        from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE

        return EXIT_RESCALE if respawn else 0

    def stop(self, unregister: bool = True) -> None:
        """Stop listening AND sever live connections — so an in-process
        stop is a faithful stand-in for backend-process death (a real
        SIGKILL drops every established socket, and the fault tests rely
        on the frontend observing exactly that). `unregister=False`
        additionally leaves the lease behind to go STALE, which is what
        a real SIGKILL does — the eviction-path tests want exactly
        that."""
        if self._lease_timer is not None:
            # a slow joiner stopped BEFORE its deferred first stamp must
            # never announce a dead server afterwards
            self._lease_timer.cancel()
            self._lease_timer = None
        if self.stamper is not None:
            self.stamper.stop(unregister=unregister)
        self._srv.shutdown()
        self._srv.server_close()
        with self._conn_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        if self._thread:
            self._thread.join(timeout=2)


# ---------------------------------------------------------------- frontend


@guarded_by("_lock")
class _Member:
    """One backend endpoint: a small socket pool plus health/backoff
    state. Pool checkout/checkin and all state transitions go through
    the methods (which take `_lock`); `call()` holds no lock while
    waiting on the wire, so N request threads fan out to N backends
    concurrently."""

    def __init__(self, host: str, port: int, connect_timeout: float,
                 backoff_base: float, backoff_max: float):
        self.host, self.port = host, port
        self.connect_timeout = connect_timeout
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._lock = threading.Lock()
        self._pool: List[socket.socket] = []
        self.fails = 0
        self.down_until = 0.0
        self.requests = 0
        self.errors = 0
        self.health: Dict = {}
        # Fleet-membership view (set by the frontend's membership sweep
        # under ITS lock; plain attribute reads elsewhere — a stale read
        # is one routing round behind, which churn tolerates by design):
        # a draining member takes no NEW assignments but finishes
        # in-flight grouped streams; lease carries capacity/version.
        self.draining = False
        self.lease: Optional[object] = None
        # Last obs snapshot this member answered with: a DOWN member's
        # series re-render from it stale-marked — visible absence, not
        # silent disappearance (guarded by _lock like the rest).
        self.last_metrics: Optional[Dict] = None
        self._rng = random.Random((host, port).__hash__() & 0xFFFFFFFF)

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def available(self, now: float) -> bool:
        with self._lock:
            return now >= self.down_until

    def _checkout(self, connect_timeout: float) -> socket.socket:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return socket.create_connection(
            (self.host, self.port), timeout=connect_timeout)

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            self._pool.append(sock)

    def call(self, op: bytes, body: bytes,
             timeout: float) -> Tuple[bytes, bytes]:
        """One framed round trip. Socket-level failures close the
        connection and re-raise (the frontend marks the member down and
        retries a sibling). The retry after a failed POOLED socket dials
        FRESH — a backend restart strands every idle pooled socket, and
        popping a second stale one would fail a request against a
        perfectly healthy member."""
        # Dialing is bounded by BOTH the member's connect budget and the
        # caller's own timeout — a 1 s health probe must not pay a 5 s
        # connect to a partitioned host.
        dial = min(self.connect_timeout, timeout)
        attempts = 2
        for i in range(attempts):
            sock = (self._checkout(dial) if i == 0 else
                    socket.create_connection((self.host, self.port),
                                             timeout=dial))
            try:
                sock.settimeout(timeout)
                sock.sendall(op + struct.pack("<I", len(body)) + body)
                hdr = _recv_exact(sock, 8)
                status, n = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if n > _MAX_FRAME:
                    raise ConnectionError(f"oversized reply frame ({n}B)")
                resp = _recv_exact(sock, n)
            except (OSError, ConnectionError):
                try:
                    sock.close()
                except OSError:
                    pass
                if i + 1 == attempts:
                    raise
                continue
            self._checkin(sock)
            with self._lock:
                self.requests += 1
            return status, resp
        raise ConnectionError("unreachable")  # pragma: no cover

    def mark_down(self) -> float:
        """Record a failure; returns the backoff deadline. Capped
        exponential with jitter (the shared `utils/backoff.py` policy),
        so N frontend threads hitting one dead backend don't re-probe in
        lockstep."""
        with self._lock:
            self.fails += 1
            self.errors += 1
            delay = backoff.jittered_backoff(
                self.fails, self.backoff_base, self.backoff_max,
                self._rng, max_exponent=8)
            self.down_until = time.monotonic() + delay
            # A dead backend's pooled sockets are dead too.
            pool, self._pool = self._pool, []
        for s in pool:
            try:
                s.close()
            except OSError:
                pass
        return delay

    def mark_up(self, health: Optional[Dict] = None) -> None:
        with self._lock:
            self.fails = 0
            self.down_until = 0.0
            if health is not None:
                self.health = health

    def snapshot(self) -> Dict:
        with self._lock:
            out = {
                "addr": self.addr,
                "up": time.monotonic() >= self.down_until,
                "fails": self.fails,
                "requests": self.requests,
                "errors": self.errors,
                "draining": self.draining,
            }
        lease = self.lease
        if lease is not None:
            out["lease"] = {
                "capacity": lease.capacity,
                "model_version": lease.model_version,
                "age_seconds": round(lease.age, 3),
                "started_at": lease.started_at,
            }
        return out

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, []
        for s in pool:
            try:
                s.close()
            except OSError:
                pass


class _Specs:
    """What feature parsing reads of a Trainer (`sparse_specs`,
    `dense_specs`), taken from the model's feature declarations alone: the
    edge allocates no table and needs no device."""

    def __init__(self, model):
        self.sparse_specs = fcol.sparse_features(model.features)
        self.dense_specs = fcol.dense_features(model.features)
        self.table_cfgs = fcol.table_configs(model.features)


class _FrontendPredictor:
    """Predictor facade for the frontend tier, so `HttpServer` binds a
    Frontend exactly like a ModelServer: feature parsing comes from the
    model's declarations (no checkpoint, no tables, no device), health is
    the WORST member merged with the frontend's own availability view,
    model_info and poll fan out over the wire."""

    def __init__(self, fe: "Frontend", model):
        self._fe = fe
        self.model = model
        # parse_features clamp accounting (negative ids, oversized bags,
        # non-finite dense): the edge parses BEFORE routing, so it keeps
        # its own counters
        self.record_errors: Dict[str, int] = {}
        self._trainer = _Specs(model) if model is not None else None

    @property
    def feature_dtypes(self) -> Dict[str, "np.dtype"]:
        """Expected numpy dtype per input feature (ids take their table's
        key dtype, dense features float32), as `Predictor.feature_dtypes`."""
        if self._trainer is None:
            raise RuntimeError(
                "Frontend(model=None) cannot parse wire features — pass "
                "the model to Frontend() for HTTP serving")
        cfgs = self._trainer.table_cfgs
        out = {}
        for f in self._trainer.sparse_specs:
            out[f.name] = np.dtype(cfgs[fcol.resolve_table_name(f)].key_dtype)
        for f in self._trainer.dense_specs:
            out[f.name] = np.dtype(np.float32)
        return out

    def count_record_error(self, kind: str, n: int = 1) -> None:
        """Same contract as Predictor.count_record_error (the parser
        calls it on every clamp) — counted into this edge's own series."""
        self.record_errors[kind] = self.record_errors.get(kind, 0) + n
        if obs_metrics.metrics_enabled():
            obs_metrics.default_registry().counter(
                "deeprec_record_errors",
                "malformed input records rejected/clamped by kind",
                {"kind": kind},
            ).inc(n)

    def health(self) -> Dict:
        """Worst-member health + the frontend's availability view: 'ok'
        only when every member is reachable and healthy. A member that is
        down (socket-level) contributes a synthetic degraded entry — a
        dead process can't speak for itself."""
        return self._fe._health_sweep()

    def model_info(self) -> Dict:
        status, body = self._fe._call_any(OP_INFO, b"")
        if status != _OK:
            raise RuntimeError(
                f"backend model_info failed: {body.decode('utf-8', 'replace')}")
        info = json.loads(body)
        info["members"] = len(self._fe._members)
        return info

    def poll_updates(self) -> bool:
        """The frontend's poll round: refresh member health (marking
        recovered members back up) and, when the frontend drives updates
        (`poll_backends=True`), broadcast POLL so every backend replays
        the delta chain. Backends normally self-poll (poll_secs on the
        backend CLI) — delta replay stays per-process and zero-stall
        either way."""
        h = self._fe._health_sweep()
        if h.get("reachable", 0) == 0:
            raise RuntimeError(
                f"no reachable backends among {[m.addr for m in self._fe._members]}")
        updated = False
        if self._fe.poll_backends:
            for m in list(self._fe._members):
                if not m.available(time.monotonic()):
                    continue
                try:
                    status, body = m.call(OP_POLL, b"", self._fe.timeout)
                except (OSError, ConnectionError):
                    m.mark_down()
                    continue
                if status == _OK:
                    updated = json.loads(body).get("updated") or updated
        return updated


class Frontend:
    """Route requests across N backend serving processes.

    Duck-type compatible with ModelServer where it matters
    (`request_versioned` / `request` / `warmup` / `stats_snapshot` /
    `.predictor` / `close`), so `HttpServer(Frontend(...))` is the
    multi-process serving tier.

    Routing: plain requests round-robin over available members; grouped
    (`group_users=True`) requests route on a consistent-hash ring
    (virtual nodes over the member set, `serving/fleet.py`) keyed by a
    hash of the USER feature payload, so one user's candidate batches
    keep hitting one backend and its sample-aware coalescing (user
    tower once per distinct user per device batch) survives the socket
    split AND survives membership churn — a join/leave remaps only
    ~1/N of users instead of reshuffling everyone. On a member failure
    the request retries along the ring's preference order (which is
    exactly where those users will land if the member really left) —
    a killed backend costs latency, never a failed request, as long as
    one member lives.

    Membership is either a static `backends` list, a
    `registry` (a `fleet.FleetRegistry` or its directory path: lease-
    file discovery — members admit themselves by stamping a lease and
    retire by draining or going stale), or both (static seeds are
    permanent, leased members come and go at runtime).
    """

    def __init__(self,
                 backends: Optional[
                     Sequence[Union[str, Tuple[str, int]]]] = None,
                 model=None, *, registry=None, timeout: float = 30.0,
                 connect_timeout: float = 5.0,
                 backoff_base: float = 0.2, backoff_max: float = 5.0,
                 health_secs: float = 0.0, poll_backends: bool = False,
                 membership_secs: float = 1.0, reprobe_secs: float = 2.0,
                 vnodes: int = 64, lease_secs: Optional[float] = None):
        from deeprec_tpu_torch.serving import fleet as _fleet

        self._fleet_mod = _fleet
        # lease_secs must match the fleet's --lease-secs: a frontend
        # sweeping with a SHORTER bound than the members' stamp cadence
        # (lease_secs/3) would flap them in and out of membership.
        self.registry = (
            _fleet.FleetRegistry(
                registry, **({"lease_secs": lease_secs}
                             if lease_secs is not None else {}))
            if isinstance(registry, str) else registry)
        if not backends and self.registry is None:
            raise ValueError(
                "need at least one backend address or a fleet registry")
        self._member_kwargs = dict(connect_timeout=connect_timeout,
                                   backoff_base=backoff_base,
                                   backoff_max=backoff_max)
        self.vnodes = vnodes
        self._static_addrs = ["%s:%d" % self._parse_addr(b)
                              for b in (backends or [])]
        # Membership state: mutated ONLY under _mlock by whole-object
        # replacement (new list/dict/ring assigned atomically), so
        # request paths read a coherent snapshot lock-free.
        self._mlock = threading.Lock()
        self._by_addr: Dict[str, _Member] = {}
        self._members: List[_Member] = []
        self._ring = _fleet.HashRing([], vnodes=vnodes)
        self._routing_view: Dict[str, bool] = {}  # addr -> draining
        self.membership_rounds = 0
        with self._mlock:
            self._apply_membership(self._membership_view())
        self.timeout = timeout
        self.poll_backends = poll_backends
        self.stats = ServingStats()
        r = self.stats.registry
        if r is not None:
            r.register_callback(
                "deeprec_frontend_members", lambda: len(self._members),
                "admitted backend members")
            r.register_callback(
                "deeprec_frontend_members_up",
                lambda: sum(1 for m in self._members
                            if m.available(time.monotonic())),
                "members currently routable (not backed off)")
            r.register_callback(
                "deeprec_frontend_members_draining",
                lambda: sum(1 for m in self._members if m.draining),
                "members draining (in-flight only, no new assignments)")
        self.update_failures = 0  # _run_poll_loop accounting
        # Retrieval fan-out accounting: requests through the merge and
        # how many were served PARTIAL (one or more shards missing —
        # degraded-not-failed; surfaced through health()).
        self._retr_requests = 0
        self._retr_partials = 0
        self._m_retr_partials = (
            r.counter("deeprec_retrieval_partial_responses",
                      "fleet retrievals served with one or more shards "
                      "missing")
            if r is not None else None)
        self.predictor = _FrontendPredictor(self, model)
        self._rr = itertools.count()
        self._stop = threading.Event()
        self._poller = None
        if health_secs > 0:
            self._poller = threading.Thread(
                target=_run_poll_loop, args=(self, self._stop, health_secs),
                daemon=True)
            self._poller.start()
        self._membership_thread = None
        if self.registry is not None and membership_secs > 0:
            self._membership_thread = threading.Thread(
                target=self._membership_loop, args=(membership_secs,),
                daemon=True, name="fleet-membership")
            self._membership_thread.start()
        self.reprobe_secs = reprobe_secs
        self._reprober = None
        if reprobe_secs > 0:
            self._reprober = threading.Thread(
                target=self._reprobe_loop, daemon=True,
                name="member-reprobe")
            self._reprober.start()

    @staticmethod
    def _parse_addr(b) -> Tuple[str, int]:
        if isinstance(b, str):
            host, port = b.rsplit(":", 1)
            return host, int(port)
        host, port = b
        return host, int(port)

    # ---------------------------------------------------------- membership

    def _membership_view(self) -> Dict[str, Optional[object]]:
        """Desired membership right now: static seeds (always, with no
        lease) plus every live backend lease in the registry. One
        registry sweep — stale leases are already evicted and duplicate
        addrs already arbitrated by `FleetRegistry.members`."""
        desired: Dict[str, Optional[object]] = {
            a: None for a in self._static_addrs}
        if self.registry is not None:
            for lease in self.registry.members(self._fleet_mod.ROLE_BACKEND):
                desired[lease.addr] = lease
        return desired

    def _apply_membership(self, desired: Dict[str, Optional[object]]
                          ) -> Tuple[List[str], List[str]]:
        """Reconcile the member set (caller holds `_mlock`): admit new
        addrs, retire vanished ones (evicted/unregistered — their socket
        pools close), update drain flags, and rebuild the routing ring
        over non-draining members. Returns (admitted, retired) addrs."""
        by_addr = dict(self._by_addr)
        admitted, retired = [], []
        for addr, lease in desired.items():
            m = by_addr.get(addr)
            if m is None:
                host, port = addr.rsplit(":", 1)
                m = _Member(host, int(port), **self._member_kwargs)
                by_addr[addr] = m
                admitted.append(addr)
            m.lease = lease  # refresh age/version view even when routing
            # is unchanged (member snapshots report it)
            m.draining = bool(lease is not None and lease.draining)
        for addr in set(by_addr) - set(desired):
            retired.append(addr)
            by_addr.pop(addr).close()
        self._by_addr = by_addr
        # Rebuild the routing view (ordered list + hash ring: N*vnodes
        # hashes + a sort) only when the (membership, drain) view
        # actually changed — sweeps run every membership_secs AND on
        # every /healthz and /v1/stats call, and steady state is
        # no-change ~always. membership_rounds therefore counts CHURN
        # events, not sweeps.
        view = {a: by_addr[a].draining for a in by_addr}
        if admitted or retired or view != self._routing_view:
            self._routing_view = view
            # static seeds keep their GIVEN order (callers index
            # fe._members against the list they constructed with);
            # leased members follow, sorted so every
            # frontend replica agrees
            static = [a for a in self._static_addrs if a in by_addr]
            dynamic = sorted(a for a in by_addr if a not in set(static))
            self._members = [by_addr[a] for a in static + dynamic]
            self._ring = self._fleet_mod.HashRing(
                [a for a, m in by_addr.items() if not m.draining],
                vnodes=self.vnodes)
            self.membership_rounds += 1
        return admitted, retired

    def refresh_membership(self) -> Tuple[List[str], List[str]]:
        """One reconcile round against the registry (the membership
        thread's body; callable directly for deterministic tests and
        for lazy refresh when routing finds nobody)."""
        if self.registry is None:
            return [], []
        desired = self._membership_view()
        with self._mlock:
            return self._apply_membership(desired)

    def _membership_loop(self, secs: float) -> None:
        while not self._stop.wait(secs):
            try:
                self.refresh_membership()
            except Exception:
                # a failed sweep (FS blip) keeps the previous view; the
                # next round retries — discovery must never kill routing
                pass

    def _reprobe_loop(self) -> None:
        """Periodic re-probe of members in failure backoff: a backend
        that died and came back at the SAME addr (process restart under
        an external supervisor — no membership churn, static lists
        included) is readmitted to routing without waiting for live
        traffic to risk a request on it or for an operator to restart
        the frontend."""
        while not self._stop.wait(self.reprobe_secs):
            now = time.monotonic()
            for m in list(self._members):
                if self._stop.is_set():
                    return
                if m.available(now) and m.fails == 0:
                    continue  # healthy: nothing to re-probe
                try:
                    self._probe_member(m)  # marks up/down itself
                except Exception:
                    pass  # probing must never kill the loop

    # ------------------------------------------------------------- routing

    def _order(self, key: Optional[int] = None) -> List[_Member]:
        """Members in attempt order for ONE request.

        Plain requests (`key=None`): round-robin over non-draining
        members. Grouped requests: the ring's preference order for
        `key` — the owner first, then the members those users would
        land on if the owner left, so failover and post-churn routing
        agree.

        Within the chosen order, available members come first and
        backed-off ones ride along as a last resort (with every sibling
        dead, trying a 'down' member beats failing the request — it may
        just have restarted). Draining members are last of all: they
        take no new assignments unless nobody else exists."""
        members = self._members  # atomic snapshot (replaced, not mutated)
        if not members:
            raise RuntimeError("no fleet members admitted")
        if key is not None:
            ring = self._ring
            by_addr = self._by_addr
            pref = [by_addr[a] for a in ring.preference(key)
                    if a in by_addr]
            chosen = set(id(m) for m in pref)
            order = pref + [m for m in members if id(m) not in chosen]
        else:
            routable = [m for m in members if not m.draining]
            pool = routable or members  # everyone draining: serve anyway
            n = len(pool)
            s = next(self._rr) % n
            order = [pool[(s + i) % n] for i in range(n)]
            order += [m for m in members if m.draining] if routable else []
        now = time.monotonic()
        up = [m for m in order if m.available(now)]
        down = [m for m in order if not m.available(now)]
        return up + down

    def _group_key(self, batch: Dict[str, np.ndarray]) -> int:
        """Stable routing hash of the request's user-feature payload.
        crc32, not builtin hash(): bytes hashing is salted per process,
        which would re-shuffle user→backend affinity on every frontend
        restart (and make routing unreproducible across a tier of
        frontends)."""
        import zlib

        feats = getattr(self.predictor.model, "user_feats", None)
        h = 0
        if feats:
            for name in feats:
                v = batch.get(name)
                if v is not None:
                    # first row identifies the user for <user, N items>
                    h ^= zlib.crc32(np.asarray(v)[:1].tobytes())
        return h & 0x7FFFFFFF

    def _call_any(self, op: bytes, body: bytes,
                  key: Optional[int] = None,
                  timeout: Optional[float] = None) -> Tuple[bytes, bytes]:
        """Send one frame to the first member that answers, in routing
        order (`key` = grouped ring routing); marks failed members down
        along the way. With a registry and an empty member set, one
        forced membership sweep runs first — a frontend that started
        before its backends admits them the moment their leases land."""
        if not self._members and self.registry is not None:
            self.refresh_membership()
        last: Optional[Exception] = None
        for m in self._order(key):
            try:
                status, resp = m.call(op, body,
                                      timeout if timeout is not None
                                      else self.timeout)
            except (OSError, ConnectionError) as e:
                m.mark_down()
                last = e
                continue
            m.mark_up()
            return status, resp
        raise RuntimeError(
            f"all {len(self._members)} backends unreachable "
            f"({[m.addr for m in self._members]})"
        ) from last

    # ------------------------------------------------------------ requests

    def request(self, features: Dict[str, np.ndarray],
                timeout: Optional[float] = None,
                group_users: bool = False):
        return self.request_versioned(features, timeout, group_users)[0]

    def request_versioned(self, features: Dict[str, np.ndarray],
                          timeout: Optional[float] = None,
                          group_users: bool = False,
                          trace_ctx: Optional[Tuple[int, int]] = None,
                          no_cache: bool = False):
        """(result, model_version) through whichever backend answered.
        The version stamps the BACKEND snapshot that served the whole
        request (coalesced neighbors on that backend share it).

        A sampled trace context (`trace_ctx`, or the calling thread's
        open span — the HTTP edge's) crosses the socket hop as a
        16-byte prefix on the PRED frame (_FLAG_TRACE), so the backend's
        dispatch + stage spans land under the same trace id."""
        t0 = time.monotonic()
        rows = (int(np.asarray(next(iter(features.values()))).shape[0])
                if features else 0)
        sp = obs_trace.span("frontend_dispatch", "serving", ctx=trace_ctx)
        flags = _FLAG_GROUP_USERS if group_users else 0
        if no_cache:
            flags |= _FLAG_NO_CACHE
        prefix = b""
        if sp.ctx is not None:
            flags |= _FLAG_TRACE
            prefix = obs_trace.pack_wire(sp.ctx)
        body = bytes([flags]) + prefix + _pack_arrays(features)
        # Grouped requests route on the consistent-hash ring (stickiness
        # survives churn: ~1/N of users remap per join/leave); plain
        # requests round-robin.
        key = self._group_key(features) if group_users else None
        try:
            with sp:
                status, resp = self._call_any(OP_PRED, body, key=key,
                                              timeout=timeout)
        except Exception:
            self.stats.record_error()
            raise
        if status == _ERR:
            err = json.loads(resp)
            self.stats.record_error()
            if err.get("kind") == "bad_request":
                err.pop("kind", None)
                raise BadRequest(err.pop("error", "bad request"), **err)
            raise RuntimeError(err.get("error", "backend error"))
        out = _unpack_arrays(resp)
        version = int(out.pop("__version__"))
        if "predictions" in out:
            probs = out["predictions"]
        else:
            probs = {k[len("task:"):]: v for k, v in out.items()}
        self.stats.record_batch(1, rows)
        self.stats.record_stage("e2e", time.monotonic() - t0)
        return probs, version

    # ----------------------------------------------------------- retrieval

    def retrieve_versioned(self, features: Dict[str, np.ndarray], k: int,
                           timeout: Optional[float] = None,
                           no_cache: bool = False):
        """Full-corpus top-k across the fleet: fan one RETR frame to
        EVERY routable member in parallel (each owns a corpus shard) and
        lexsort-merge the per-shard answers at the edge (score desc, item
        id asc — deterministic regardless of shard count or answer
        order).

        Degraded-not-failed: a member that dies mid-query is marked down
        and its shard's candidates are simply missing from the merge —
        the reply is served from the surviving shards with
        ``partial=True``, counted in `retrieval_partials`, and visible in
        `health()` (the down member degrades the sweep). Only a fleet
        with ZERO answering members fails the request.

        DRAINING members stay in the fan-out: corpus shards are
        disjoint, so excluding a drainer would silently drop 1/N of the
        catalog for the whole drain window — drain means "no new STICKY
        assignments", and a stateless sweep of the shard it still holds
        is exactly the in-flight work the drain protocol finishes."""
        from deeprec_tpu_torch.serving.retrieval import (
            RetrievalResult,
            merge_shard_topk,
        )

        t0 = time.monotonic()
        if not self._members and self.registry is not None:
            self.refresh_membership()
        members = list(self._members)
        if not members:
            raise RuntimeError("no fleet members admitted")
        # Honor failure backoff like every other routing path: a
        # blackholed member would stall the whole merge for a connect
        # timeout on EVERY request — skipping it yields the same
        # partial answer without the latency cliff. With everyone
        # backed off, try them all anyway (last resort beats failing).
        now = time.monotonic()
        routable = [m for m in members if m.available(now)] or members
        body = bytes([_FLAG_NO_CACHE if no_cache else 0]) + \
            struct.pack("<I", int(k)) + _pack_arrays(features)
        slots: List[Optional[Dict]] = [None] * len(routable)

        def sweep(i, m):
            try:
                status, resp = m.call(
                    OP_RETR, body,
                    timeout if timeout is not None else self.timeout)
            except (OSError, ConnectionError):
                m.mark_down()
                return
            if status != _OK:
                err = json.loads(resp)
                slots[i] = {"error": err}
                return
            m.mark_up()
            slots[i] = {"arrays": _unpack_arrays(resp)}

        if len(routable) == 1:
            sweep(0, routable[0])
        else:
            threads = [threading.Thread(target=sweep, args=(i, m),
                                        daemon=True)
                       for i, m in enumerate(routable)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        answers = [s["arrays"] for s in slots if s and "arrays" in s]
        errors = [s["error"] for s in slots if s and "error" in s]
        self._retr_requests += 1
        if not answers:
            self.stats.record_error()
            if errors and errors[0].get("kind") == "bad_request":
                e = dict(errors[0])
                e.pop("kind", None)
                raise BadRequest(e.pop("error", "bad request"), **e)
            raise RuntimeError(
                f"retrieval failed on all {len(routable)} members "
                f"({errors or 'unreachable'})")
        # partial is judged against the FULL member set: a member skipped
        # for backoff is exactly as missing from the merge as one that
        # failed mid-call — its shard's coverage is absent either way
        partial = len(answers) < len(members)
        if partial:
            self._retr_partials += 1
            if self._m_retr_partials is not None:
                self._m_retr_partials.inc()
        ids, scores = merge_shard_topk(
            [a["ids"] for a in answers],
            [a["scores"] for a in answers], int(k))
        version = max(int(a["__version__"]) for a in answers)
        scanned = sum(int(a.get("scanned", 0)) for a in answers)
        self.stats.record_retrieval(1, scanned)
        self.stats.record_stage("retrieval", time.monotonic() - t0)
        return RetrievalResult(ids=ids, scores=scores, version=version,
                               partial=partial, scanned=scanned)

    def ingest_items(self, ids, features: Dict[str, np.ndarray],
                     timeout: Optional[float] = None) -> Dict[str, int]:
        """Broadcast one item batch to EVERY member (draining included —
        ingest is data plane, not load): each backend keeps the rows that
        hash to its corpus shard, so the broadcast partitions itself.
        Returns {addr: accepted} for the members that answered; a member
        that is down simply misses the batch (its shard serves stale
        coverage until re-ingest — the degraded contract)."""
        body = _pack_arrays({"__ids__": np.asarray(ids, np.int64),
                             **features})
        members = list(self._members)
        out: Dict[str, int] = {}
        lock = threading.Lock()

        def push(m):
            try:
                status, resp = m.call(
                    OP_RITM, body,
                    timeout if timeout is not None else self.timeout)
            except (OSError, ConnectionError):
                m.mark_down()
                return
            if status == _OK:
                with lock:
                    out[m.addr] = json.loads(resp).get("accepted", 0)

        if len(members) == 1:
            push(members[0])
        else:
            # parallel like the RETR fan-out: each member's upload +
            # chunked re-encode overlaps, so fleet ingest costs
            # max(member time), not the serial sum
            threads = [threading.Thread(target=push, args=(m,),
                                        daemon=True) for m in members]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return out

    def warmup(self, example: Dict[str, np.ndarray],
               group_users: bool = False,
               ladder: Optional[Sequence[int]] = None) -> int:
        """Send warmup predicts to EVERY member — routing is bypassed on
        purpose: each backend must load its kernels and grow its
        allocator's pools for its own batch buckets before live traffic, or
        the first production burst pays that per process. `ladder` warms one batch per row count (built by
        repeating the example's first row — matching what the backend's
        bucket padding produces); default is the example as-is."""
        n = 0
        flags = _FLAG_GROUP_USERS if group_users else 0
        one = {k: np.asarray(v)[:1] for k, v in example.items()}
        batches = ([example] if not ladder else
                   [{k: np.repeat(v, size, axis=0) for k, v in one.items()}
                    for size in ladder])
        for m in list(self._members):
            ok = True
            for batch in batches:
                body = bytes([flags]) + _pack_arrays(batch)
                try:
                    status, _ = m.call(OP_PRED, body, self.timeout)
                except (OSError, ConnectionError):
                    m.mark_down()
                    ok = False
                    break
                ok = ok and status == _OK
            if ok:
                m.mark_up()
                n += 1
        return n

    # ------------------------------------------------------ health & stats

    # Health probes run with a SHORT timeout and in parallel across
    # members: /healthz is a watchdog surface — one network-partitioned
    # backend must cost the sweep ~1 s total, not connect_timeout × N
    # serial (a liveness prober timing out on /healthz would restart a
    # frontend whose request routing is perfectly healthy).
    HEALTH_PROBE_SECS = 1.0

    def _probe_member(self, m: _Member) -> Dict:
        try:
            status, body = m.call(OP_HLTH, b"", self.HEALTH_PROBE_SECS)
            h = (json.loads(body) if status == _OK
                 else obs_schema.health_payload(
                     "degraded", error=body.decode("utf-8", "replace")))
            m.mark_up(h)
        except (OSError, ConnectionError) as e:
            m.mark_down()
            # synthetic entry for a dead process — same unified schema
            # (obs/schema.py) as a live member's own health payload
            h = obs_schema.health_payload(
                "down", staleness_seconds=float("inf"),
                member=m.addr, error=str(e))
        h["member"] = m.addr
        return h

    def _health_sweep(self) -> Dict:
        """Live HLTH probe of every member (parallel, bounded); returns
        the merged /healthz body: the WORST member's health dict (the
        `_GroupPredictor` selection, spanning processes) + frontend
        availability counters. Down members contribute a synthetic
        degraded entry. In registry mode the sweep reconciles
        membership first, so /healthz always describes the CURRENT
        fleet, never a retired one."""
        if self.registry is not None:
            self.refresh_membership()
        members = list(self._members)
        if not members:
            out = obs_schema.health_payload(
                "down", error="no fleet members admitted")
            out["members"] = 0
            out["reachable"] = 0
            out["draining"] = 0
            return out
        if len(members) == 1:
            healths = [self._probe_member(members[0])]
        else:
            slots: List[Optional[Dict]] = [None] * len(members)

            def probe(i, m):
                slots[i] = self._probe_member(m)

            threads = [threading.Thread(target=probe, args=(i, m),
                                        daemon=True)
                       for i, m in enumerate(members)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            healths = [h for h in slots if h is not None]
        reachable = sum(1 for h in healths if h["status"] != "down")
        worst = healths[0]
        for h in healths:
            if h["status"] != "ok" and worst["status"] == "ok":
                worst = h
            elif (h["status"] != "ok") == (worst["status"] != "ok") and (
                (h.get("staleness_seconds") or 0) > (
                    worst.get("staleness_seconds") or 0)):
                worst = h
        out = dict(worst)
        if out.get("staleness_seconds") == float("inf"):
            out["staleness_seconds"] = None
        out["members"] = len(members)
        out["reachable"] = reachable
        out["draining"] = sum(1 for m in members if m.draining)
        # Quality-firewall rollup: gate rejections SUM across the fleet
        # (the worst-member dict above already carries that member's own
        # degraded_reason when its gate is holding freshness back).
        qg = [h.get("quality_gate_rejections") for h in healths]
        if any(v is not None for v in qg):
            out["quality_gate_rejections"] = sum(int(v or 0) for v in qg)
        if reachable < len(members):
            out["status"] = "degraded" if reachable else "down"
        if self._retr_requests:
            # Retrieval coverage view: a dead member already degrades the
            # status above; the partial counter says how many sweeps
            # actually served with shards missing (degraded-not-failed).
            out["retrieval_requests"] = self._retr_requests
            out["retrieval_partials"] = self._retr_partials
        # Empty-shard detection: a retrieval backend that restarted lost
        # its in-process corpus and answers sweeps with nothing — which
        # no per-request signal catches (it IS a successful answer). One
        # shard at 0 rows while a sibling holds items = silently missing
        # catalog coverage, surfaced here as degraded.
        shard_rows = [h.get("retrieval_corpus_rows") for h in healths
                      if h["status"] != "down"
                      and h.get("retrieval_corpus_rows") is not None]
        if shard_rows and max(shard_rows) > 0 and min(shard_rows) == 0:
            out["retrieval_empty_shards"] = sum(
                1 for r in shard_rows if r == 0)
            if out["status"] == "ok":
                out["status"] = "degraded"
                out["degraded_reason"] = "retrieval_shard_empty"
        return out

    def stats_snapshot(self) -> Dict:
        """Merged `/v1/stats` spanning the tier: the frontend's own edge
        accounting (client-visible e2e, routed requests, retries) plus
        every reachable member's full per-process snapshot and summed
        totals — one surface shows the whole tier's load balance."""
        out = self.stats.snapshot()
        members = []
        totals = {"requests": 0, "batches": 0, "rows": 0, "errors": 0}
        model = {}
        queue_depth = 0
        backend_p99 = None
        for m in list(self._members):
            entry = m.snapshot()
            if m.available(time.monotonic()):
                try:
                    status, body = m.call(OP_STAT, b"",
                                          min(self.timeout, 5.0))
                    if status == _OK:
                        snap = json.loads(body)
                        entry["stats"] = snap
                        for k in totals:
                            totals[k] += snap.get(k, 0)
                        win = snap.get("window") or {}
                        queue_depth += int(win.get("queue_depth") or 0)
                        p99 = win.get("e2e_p99_ms")
                        if p99 is not None:
                            backend_p99 = (p99 if backend_p99 is None
                                           else max(backend_p99, p99))
                        mv = snap.get("model", {})
                        if not model or mv.get("version", -1) > model.get(
                                "version", -1):
                            model = mv
                except (OSError, ConnectionError):
                    m.mark_down()
            members.append(entry)
        out["frontend"] = {"routed": out.pop("requests"),
                           "errors": out["errors"],
                           "retrieval_requests": self._retr_requests,
                           "retrieval_partials": self._retr_partials}
        out["members"] = members
        out["backend_totals"] = totals
        out["model"] = model
        # The autoscaler's observation (fleet.load_from_stats): windowed
        # edge-visible e2e p99 (the frontend's own obs ring buffers; the
        # worst member's window when the edge plane is off) + queue depth
        # summed over members — trailing-window ring buffers, not
        # lifetime aggregates, so a past spike that scrolled out of the
        # window never triggers a scale event.
        edge_p99 = self.stats.window_p99_ms("e2e")
        out["fleet_load"] = {
            "e2e_p99_ms": edge_p99 if edge_p99 is not None else backend_p99,
            "backend_p99_ms": backend_p99,
            "queue_depth": queue_depth,
            "members": len(members),
            "draining": sum(1 for e in members if e.get("draining")),
            "window_seconds": 60,
        }
        out["health"] = self._health_sweep()
        return out

    # ------------------------------------------------------------- metrics

    # Scrape budget per member: /metrics is a watchdog-adjacent surface —
    # one wedged backend must cost the scrape ~2 s, not timeout × N, and
    # members are probed in PARALLEL (the _health_sweep discipline).
    METRICS_PROBE_SECS = 2.0

    def _member_metrics(self, m: _Member) -> Tuple[Optional[Dict], bool]:
        """(snapshot, stale): a live member answers METR and refreshes
        its cache; a down (or just-failed) member serves its LAST known
        snapshot with stale=True — a killed backend's series must stay
        visible in the merge, marked, never silently vanish. A failed
        scrape deliberately does NOT mark the member down: observability
        traffic must never mutate request-routing state (an external
        scraper's cadence would otherwise drive serving availability)."""
        if m.available(time.monotonic()):
            try:
                status, body = m.call(OP_METR, b"",
                                      min(self.timeout,
                                          self.METRICS_PROBE_SECS))
                if status == _OK:
                    snap = json.loads(body)
                    with m._lock:
                        m.last_metrics = snap
                    return snap, False
            except (OSError, ConnectionError):
                pass
        with m._lock:
            return m.last_metrics, True

    def metrics_text(self) -> str:
        """The tier's `GET /metrics`: the frontend's own edge series +
        the process-wide plane + every member's snapshot relabeled with
        member="host:port" (down members stale="1"), plus a
        deeprec_member_up gauge per member — one scrape shows the whole
        tier's load balance and who is missing from it. Duplicate
        family headers across the per-member blocks are collapsed
        (concat_prometheus) so real Prometheus parsers accept the body."""
        parts = []
        if self.stats.registry is not None:
            parts.append(obs_metrics.render_snapshot(
                self.stats.registry.snapshot(),
                extra_labels={"tier": "frontend"}))
        if obs_metrics.metrics_enabled():
            parts.append(
                obs_metrics.default_registry().render_prometheus())
        mlist = list(self._members)
        slots: List[Optional[Tuple[Optional[Dict], bool]]] = \
            [None] * len(mlist)
        if len(mlist) == 1:
            slots[0] = self._member_metrics(mlist[0])
        else:
            def probe(i, m):
                slots[i] = self._member_metrics(m)

            threads = [threading.Thread(target=probe, args=(i, m),
                                        daemon=True)
                       for i, m in enumerate(mlist)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        up_lines = ["# TYPE deeprec_member_up gauge"]
        for m, got in zip(mlist, slots):
            snap, stale = got if got is not None else (None, True)
            up_lines.append(
                'deeprec_member_up{member="%s"} %d'
                % (m.addr, 0 if stale else 1))
            if snap:
                parts.append(obs_metrics.render_snapshot(
                    snap, extra_labels={"member": m.addr}, stale=stale))
        parts.append("\n".join(up_lines) + "\n")
        return obs_metrics.concat_prometheus(parts)

    def close(self) -> None:
        self._stop.set()
        for t in (self._poller, self._membership_thread, self._reprober):
            if t is not None:
                t.join(timeout=2)
        for m in list(self._members):
            m.close()


# ------------------------------------------------------- process management


def backend_argv(
    *, ckpt: str, model: str = "wdl", model_json: Optional[str] = None,
    quantize: Optional[str] = None, poll_secs: float = 0.0,
    max_batch: int = 256, max_wait_ms: float = 1.0,
    registry: Optional[str] = None, lease_secs: Optional[float] = None,
    capacity: int = 1, member_name: str = "", port: int = 0,
    retrieval_shard: Optional[str] = None,
    retrieval_quantize: str = "int8",
    reuse_mb: float = 0.0, device: Optional[str] = None,
) -> List[str]:
    """The backend CLI argv for one serving process — shared by
    `spawn_backends`, the Supervisor-driven fleet specs (a respawn with
    ``port=0`` binds a FRESH port and announces it by lease, which is how a
    rolling restart re-admits the new generation), and the autoscaler's
    scale_up. `device` ("cuda" or "cpu") is passed on as ``--device``; the
    backend serves on the card without it."""
    import sys

    argv = [
        sys.executable, "-m", "deeprec_tpu_torch.serving.frontend",
        "--backend", "--ckpt", ckpt, "--model", model, "--port", str(port),
        "--max_batch", str(max_batch), "--max_wait_ms", str(max_wait_ms),
        "--poll_secs", str(poll_secs),
    ]
    if device:
        argv += ["--device", str(device)]
    if model_json:
        argv += ["--model-json", model_json]
    if quantize:
        argv += ["--quantize", quantize]
    if retrieval_shard:
        argv += ["--retrieval", "--retrieval-shard", retrieval_shard,
                 "--retrieval-quantize", retrieval_quantize]
    if reuse_mb:
        argv += ["--reuse-mb", str(reuse_mb)]
    if registry:
        argv += ["--registry", registry]
        if lease_secs is not None:
            argv += ["--lease-secs", str(lease_secs)]
        if capacity != 1:
            argv += ["--capacity", str(capacity)]
        if member_name:
            argv += ["--member-name", member_name]
    return argv


def _wait_ready(procs, marker: str, ready_timeout: float):
    """Collect `marker` ports from each child's stdout (select-bounded: a
    wedged child that prints NOTHING fails after ready_timeout instead of
    blocking readline() forever). Kills the whole set on any miss."""
    import select

    ports = []
    deadline = time.monotonic() + ready_timeout
    for p in procs:
        port = None
        buf = ""
        while time.monotonic() < deadline:
            ready, _, _ = select.select(
                [p.stdout], [], [],
                max(0.1, min(1.0, deadline - time.monotonic())))
            if not ready:
                if p.poll() is not None:
                    break  # the child died without a READY line
                continue
            chunk = os.read(p.stdout.fileno(), 4096).decode("utf-8", "replace")
            if not chunk:
                break  # EOF
            buf += chunk
            # only COMPLETE lines parse: a READY line split across two pipe
            # reads must not yield a truncated port number
            for line in buf.split("\n")[:-1]:
                if line.startswith(marker) and "port=" in line:
                    port = int(line.split("port=")[1].split()[0].strip())
                    break
            if port is not None:
                break
        if port is None:
            for q in procs:
                q.kill()
            raise RuntimeError(
                f"worker pid {p.pid} never reported {marker} "
                f"(rc={p.poll()}, output tail: {buf[-500:]!r})")
        ports.append(port)
    return ports


def spawn_backends(
    n: int, *, ckpt: str, model: str = "wdl", model_json: Optional[str] = None,
    quantize: Optional[str] = None, poll_secs: float = 0.0,
    max_batch: int = 256, max_wait_ms: float = 1.0,
    registry: Optional[str] = None, lease_secs: Optional[float] = None,
    capacity: int = 1, member_name: str = "",
    env: Optional[Dict[str, str]] = None, ready_timeout: float = 180.0,
    retrieval: bool = False, retrieval_quantize: str = "int8",
    reuse_mb: float = 0.0, device: Optional[str] = None,
):
    """Launch `n` backend serving processes on this host and wait for their
    READY lines. Returns (procs, addrs) — pass `addrs` to `Frontend`, or
    pass `registry` and let the frontend discover them by lease instead.
    `retrieval=True` also enables the full-corpus retrieval lane with
    backend i owning corpus shard i of n. Each process holds its own
    Predictor (on one card: its own CUDA context); `device` reaches every
    backend's argv."""
    import subprocess

    procs = []
    for i in range(n):
        argv = backend_argv(
            ckpt=ckpt, model=model, model_json=model_json,
            quantize=quantize, poll_secs=poll_secs, max_batch=max_batch,
            max_wait_ms=max_wait_ms, registry=registry,
            lease_secs=lease_secs, capacity=capacity,
            member_name=(f"{member_name}-{i}" if member_name else ""),
            retrieval_shard=(f"{i}/{n}" if retrieval else None),
            retrieval_quantize=retrieval_quantize, reuse_mb=reuse_mb,
            device=device)
        p = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, **(env or {})},
        )
        procs.append(p)
    ports = _wait_ready(procs, "DEEPREC_BACKEND_READY", ready_timeout)
    return procs, [("127.0.0.1", port) for port in ports]


def spawn_frontends(
    n: int, *, registry: str, model: str = "wdl",
    model_json: Optional[str] = None, lease_secs: Optional[float] = None,
    health_secs: float = 2.0, env: Optional[Dict[str, str]] = None,
    ready_timeout: float = 180.0,
):
    """Launch `n` replicated frontend edge processes sharing one lease
    registry (each discovers backends independently — no single edge).
    Returns (procs, addrs) with addrs the HTTP endpoints; hand them (or the
    registry) to a `fleet.FleetClient`. An edge does no device work."""
    import subprocess
    import sys

    procs = []
    for i in range(n):
        argv = [
            sys.executable, "-m", "deeprec_tpu_torch.serving.frontend",
            "--frontend", "--registry", registry, "--model", model,
            "--http-port", "0", "--health_secs", str(health_secs),
            "--member-name", f"edge-{i}",
        ]
        if model_json:
            argv += ["--model-json", model_json]
        if lease_secs is not None:
            argv += ["--lease-secs", str(lease_secs)]
        p = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, **(env or {})},
        )
        procs.append(p)
    ports = _wait_ready(procs, "DEEPREC_FRONTEND_READY", ready_timeout)
    return procs, [f"127.0.0.1:{port}" for port in ports]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("--backend", action="store_true",
                      help="run one backend serving process")
    mode.add_argument("--frontend", action="store_true",
                      help="run the routing tier + HTTP server")
    p.add_argument("--ckpt", help="checkpoint directory (backend mode)")
    p.add_argument("--model", default="wdl")
    p.add_argument("--model-json", default=None,
                   help="JSON kwargs for the model constructor")
    p.add_argument("--quantize", default=None,
                   choices=["fp32", "bf16", "int8"],
                   help="serving-side row residency (train f32, serve "
                        "quantized)")
    p.add_argument("--device", default=None,
                   help="backend mode: cuda (the default) or cpu; without a "
                        "CUDA card the backend raises unless cpu is asked "
                        "for (a frontend does no device work)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max_batch", type=int, default=256)
    p.add_argument("--max_wait_ms", type=float, default=1.0)
    p.add_argument("--poll_secs", type=float, default=10.0,
                   help="backend delta-chain poll cadence (0 = off)")
    p.add_argument("--backends", default="",
                   help="frontend mode: comma-separated host:port list")
    p.add_argument("--http-port", type=int, default=8500)
    p.add_argument("--health_secs", type=float, default=2.0)
    p.add_argument("--registry", default=None,
                   help="fleet lease-registry directory (serving/fleet.py):"
                        " backends announce themselves by lease, frontends"
                        " discover/admit/retire members at runtime")
    p.add_argument("--lease-secs", type=float, default=10.0,
                   help="lease staleness bound (stale = evicted)")
    p.add_argument("--capacity", type=int, default=1,
                   help="advertised serving capacity (lease field)")
    p.add_argument("--member-name", default="",
                   help="supervisor spec name stamped into the lease (the"
                        " autoscaler's retire handle)")
    p.add_argument("--drain-timeout", type=float, default=30.0)
    p.add_argument("--retrieval", action="store_true",
                   help="backend mode: enable the full-corpus retrieval "
                        "lane (two-tower models only; this backend owns "
                        "the corpus shard of --retrieval-shard)")
    p.add_argument("--retrieval-quantize", default="int8",
                   choices=["fp32", "bf16", "int8"],
                   help="corpus matrix residency (serving/retrieval.py)")
    p.add_argument("--retrieval-block", type=int, default=4096,
                   help="pow2 rows per corpus sweep block")
    p.add_argument("--retrieval-chunk", type=int, default=1024,
                   help="fixed item-encode chunk rows")
    p.add_argument("--retrieval-shard", default="0/1",
                   help="'i/n': this backend owns corpus shard i of n "
                        "(items hash-partition across the fleet)")
    p.add_argument("--reuse-mb", type=float, default=0.0,
                   help="backend mode: compute-reuse cache budget in MiB "
                        "(serving/reuse.py; 0 = caches off). Sizes the "
                        "predict answer cache, the user-tower cache and "
                        "the retrieval candidate cache alike")
    args = p.parse_args(argv)

    kwargs = json.loads(args.model_json) if args.model_json else {}
    from deeprec_tpu_torch.models.registry import build_model

    model = build_model(args.model, **kwargs)

    registry = None
    if args.registry:
        from deeprec_tpu_torch.serving import fleet as _fleet

        registry = _fleet.FleetRegistry(args.registry,
                                        lease_secs=args.lease_secs)

    if args.backend:
        if not args.ckpt:
            p.error("--ckpt is required in --backend mode")
        import signal as _signal
        import sys as _sys

        from deeprec_tpu_torch.serving.predictor import ModelServer, Predictor

        pred = Predictor(model, args.ckpt, quantize=args.quantize,
                         device=args.device)
        reuse_bytes = int(args.reuse_mb * (1 << 20))
        server = ModelServer(pred, max_batch=args.max_batch,
                             max_wait_ms=args.max_wait_ms,
                             poll_updates_secs=args.poll_secs,
                             reuse_cache_bytes=reuse_bytes)
        if args.retrieval:
            from deeprec_tpu_torch.serving.retrieval import RetrievalEngine

            si, sn = args.retrieval_shard.split("/")
            engine = RetrievalEngine(
                pred, quantize=args.retrieval_quantize,
                block_rows=args.retrieval_block,
                chunk=args.retrieval_chunk,
                shard_index=int(si), num_shards=int(sn))
            server.attach_retrieval(engine, reuse_cache_bytes=reuse_bytes)
        backend = BackendServer(
            server, host=args.host, port=args.port, registry=registry,
            capacity=args.capacity, member_name=args.member_name,
            lease_delay_secs=_slow_join_secs()).start()
        print(f"DEEPREC_BACKEND_READY port={backend.port}", flush=True)
        if backend.stamper is not None:
            # Fleet member: wait for a drain (drain-request file via the
            # lease loop, or SIGTERM — the k8s preStop shape), finish
            # in-flight work, exit with the EXIT_RESCALE choreography's
            # code so a supervisor respawns rolling restarts for free.
            _signal.signal(
                _signal.SIGTERM,
                lambda sig, frm: backend.stamper.begin_drain(respawn=True))
            try:
                backend.stamper.draining.wait()
            except KeyboardInterrupt:
                backend.stop()
                return
            rc = backend.drain(timeout=args.drain_timeout)
            print(f"DEEPREC_BACKEND_DRAINED rc={rc}", flush=True)
            _sys.exit(rc)
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            backend.stop()
        return

    import sys as _sys

    from deeprec_tpu_torch.serving.http_server import HttpServer

    addrs = [a for a in args.backends.split(",") if a]
    if not addrs and registry is None:
        p.error("--frontend needs --backends host:port[,...] and/or "
                "--registry DIR")
    fe = Frontend(addrs or None, model, registry=registry,
                  health_secs=args.health_secs)
    http = HttpServer(fe, port=args.http_port, host=args.host).start()
    stamper = None
    if registry is not None:
        from deeprec_tpu_torch.serving import fleet as _fleet

        # The edge announces itself too (role="frontend"): replicated
        # frontends are discovered by FleetClient the same way backends are
        # discovered by frontends — no single edge process.
        stamper = _fleet.LeaseStamper(
            registry, f"{args.host}:{http.port}",
            role=_fleet.ROLE_FRONTEND, name=args.member_name).start()
    print(f"DEEPREC_FRONTEND_READY port={http.port} backends={addrs}",
          flush=True)
    try:
        if stamper is not None:
            stamper.draining.wait()
        else:
            threading.Event().wait()
    except KeyboardInterrupt:
        pass
    http.stop()
    fe.close()
    if stamper is not None:
        rc = stamper.exit_code()
        stamper.stop(unregister=True)
        print(f"DEEPREC_FRONTEND_DRAINED rc={rc}", flush=True)
        _sys.exit(rc)


if __name__ == "__main__":
    main()
