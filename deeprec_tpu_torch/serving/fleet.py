"""Elastic serving fleet — the port of `deeprec_tpu/serving/fleet.py`:
lease-file discovery, membership churn, and rolling restarts with zero
failed requests. Host code only: the fleet's control plane touches no
device.

  * **Lease-file registry** (`FleetRegistry`) — discovery over a shared
    directory, reusing the Supervisor's `Heartbeat` atomic tmp+rename
    stamps: every backend re-stamps ``addr, capacity, model_version,
    started_at`` each interval; a lease older than ``lease_secs`` EVICTS
    the member from routing (it rejoins the moment it stamps again).
    Two leases claiming one addr resolve last-writer-wins; the loser is
    quarantined (renamed ``*.quarantined``) so the conflict is visible.
  * **Consistent-hash routing** (`HashRing`) — a virtual-node ring keyed
    by the frontend's user hash, so `group_users` stickiness survives
    join/leave with only ~1/N of users remapping.
  * **Drain protocol** (`LeaseStamper` + `FleetRegistry.request_drain`)
    — a leaving backend stamps its lease ``draining``; frontends stop
    NEW assignments, in-flight grouped streams finish, then the backend
    exits with `parallel/elastic.py`'s ``EXIT_RESCALE`` (a supervisor
    respawns it for free) or 0 (a retirement).
  * **Replicated frontends** (`FleetClient`) — N edge processes share
    the registry (each stamps a ``role="frontend"`` lease); predictions
    are idempotent, so a SIGKILLed frontend costs the client a reconnect
    to a sibling edge, never a failed request.
  * **Load-driven autoscaling** (`FleetAutoscaler`) — consumes the
    windowed e2e p99 and queue depth (``fleet_load`` in the frontend's
    ``/v1/stats``) and spawns or retires backends between
    ``min_members`` and ``max_members`` with hysteresis (N consecutive
    breaches) and a cooldown.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from deeprec_tpu_torch.online.supervisor import Heartbeat
from deeprec_tpu_torch.utils import backoff as _backoff

#: lease roles — backends serve PRED traffic, frontends are HTTP edges
ROLE_BACKEND = "backend"
ROLE_FRONTEND = "frontend"

#: lease statuses — "up" routes, "draining" finishes in-flight only
STATUS_UP = "up"
STATUS_DRAINING = "draining"


def _sanitize(addr: str) -> str:
    return addr.replace(":", "_").replace("/", "_")


@dataclass
class MemberLease:
    """One member's view in the registry: the decoded lease payload plus
    where it came from. ``age`` is seconds since the stamp at scan time
    (the eviction clock)."""

    addr: str
    role: str
    status: str
    capacity: int
    model_version: int
    started_at: float
    pid: int
    time: float
    age: float
    name: str
    path: str

    @property
    def draining(self) -> bool:
        return self.status == STATUS_DRAINING


class FleetRegistry:
    """Lease-file membership over a shared directory.

    One file per member PROCESS (`lease-<role>-<addr>-<pid>.lease`), so
    two processes claiming the same addr are two files the sweep can
    arbitrate (last writer wins, older quarantined) instead of one file
    silently flip-flopping. Writes go through `Heartbeat` (atomic
    tmp+rename), so a reader never sees a torn lease — and a torn file
    planted by anything else (fault injection, FS corruption) reads as
    'no lease' and is skipped, never trusted.

    Drain requests are separate small files (`drain-<addr>.json`): the
    CONTROLLER writes them (autoscaler, rolling-restart choreography,
    an operator), the member's `LeaseStamper` picks them up on its next
    beat. The member always owns its own lease; nothing else ever
    writes it.
    """

    def __init__(self, directory: str, lease_secs: float = 10.0):
        self.dir = directory
        self.lease_secs = lease_secs
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------- paths

    def lease_path(self, addr: str, role: str = ROLE_BACKEND,
                   pid: Optional[int] = None) -> str:
        pid = os.getpid() if pid is None else pid
        return os.path.join(
            self.dir, f"lease-{role}-{_sanitize(addr)}-{pid}.lease")

    def _drain_path(self, addr: str) -> str:
        return os.path.join(self.dir, f"drain-{_sanitize(addr)}.json")

    # ------------------------------------------------------- sweeping

    def members(self, role: Optional[str] = ROLE_BACKEND,
                now: Optional[float] = None,
                include_draining: bool = True) -> List[MemberLease]:
        """Current membership: every live lease of `role` (None = all),
        stale leases excluded (evicted), duplicate-addr claims resolved
        last-writer-wins with the older lease quarantined. Sorted by
        addr so every frontend replica sees the same order."""
        now = time.time() if now is None else now
        by_addr: Dict[str, MemberLease] = {}
        losers: List[MemberLease] = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        for fn in names:
            if not fn.endswith(".lease"):
                continue
            path = os.path.join(self.dir, fn)
            payload = Heartbeat.read(path)
            if payload is None:
                continue  # torn/unreadable: not a lease (fault-injected
                # tears land here — never trusted, never fatal)
            try:
                lease = MemberLease(
                    addr=str(payload["addr"]),
                    role=str(payload.get("role", ROLE_BACKEND)),
                    status=str(payload.get("status", STATUS_UP)),
                    capacity=int(payload.get("capacity", 1)),
                    model_version=int(payload.get("model_version", -1)),
                    started_at=float(payload.get("started_at", 0.0)),
                    pid=int(payload.get("pid", 0)),
                    time=float(payload["time"]),
                    age=max(0.0, now - float(payload["time"])),
                    name=str(payload.get("name", "")),
                    path=path,
                )
            except (KeyError, TypeError, ValueError):
                continue  # schema-garbage lease: skip, don't crash a sweep
            if role is not None and lease.role != role:
                continue
            if lease.age > self.lease_secs:
                continue  # stale = evicted from routing (file kept: the
                # member rejoins by stamping again; gc() reaps the dead)
            if not include_draining and lease.draining:
                continue
            prev = by_addr.get(lease.addr)
            if prev is None:
                by_addr[lease.addr] = lease
            elif lease.time > prev.time:
                losers.append(prev)
                by_addr[lease.addr] = lease
            else:
                losers.append(lease)
        for lost in losers:
            # Last-writer-wins: the older claimant's lease is quarantined
            # (rename, not unlink — visible conflict, the checkpoint-
            # chain discipline). Its process may still be alive and will
            # recreate the file on its next beat; it loses again until it
            # stops claiming the addr.
            try:
                os.replace(lost.path, lost.path + ".quarantined")
            except OSError:
                pass
        return sorted(by_addr.values(), key=lambda m: m.addr)

    def gc(self, evict_secs: Optional[float] = None) -> int:
        """Reap lease files dead for much longer than the lease (default
        10×): eviction itself never unlinks (a slow-but-live member must
        be able to rejoin by re-stamping — unlinking would race its
        beat), so long-dead files are reaped on this separate, much
        longer clock. Returns the number reaped."""
        evict_secs = (10 * self.lease_secs if evict_secs is None
                      else evict_secs)
        now = time.time()
        n = 0
        try:
            names = os.listdir(self.dir)
        except OSError:
            return 0
        for fn in names:
            if not (fn.endswith(".lease") or fn.endswith(".quarantined")):
                continue
            path = os.path.join(self.dir, fn)
            payload = Heartbeat.read(path)
            stamp = (payload or {}).get("time")
            if stamp is not None and now - float(stamp) <= evict_secs:
                continue
            if stamp is None:
                # unreadable: age by mtime so torn junk is reaped too
                try:
                    if now - os.path.getmtime(path) <= evict_secs:
                        continue
                except OSError:
                    continue
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        return n

    # -------------------------------------------------------- draining

    def request_drain(self, addr: str, respawn: bool = False) -> None:
        """Ask the member at `addr` to leave: its LeaseStamper sees this
        on the next beat, stamps its lease ``draining`` (frontends stop
        new assignments), finishes in-flight work, and exits —
        EXIT_RESCALE when ``respawn`` (rolling restart: the supervisor
        respawns for free) or 0 (retirement). Atomic tmp+rename like
        every other control file here."""
        path = self._drain_path(addr)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump({"respawn": bool(respawn), "time": time.time()}, f)
        os.replace(tmp, path)

    def drain_requested(self, addr: str) -> Optional[dict]:
        try:
            with open(self._drain_path(addr)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear_drain(self, addr: str) -> None:
        try:
            os.unlink(self._drain_path(addr))
        except OSError:
            pass

    def unregister(self, addr: str, role: str = ROLE_BACKEND,
                   pid: Optional[int] = None) -> None:
        """Remove this process's lease (planned exit). A SIGKILLed member
        never gets here — its lease goes stale and eviction handles it."""
        try:
            os.unlink(self.lease_path(addr, role, pid))
        except OSError:
            pass


class LeaseStamper:
    """One member's lease heartbeat: stamps every ``interval`` (default
    lease_secs/3 — three missed beats = evicted) and picks up drain
    requests. Runs on a daemon thread; `stamp()` is also callable
    directly for tests and for a final synchronous stamp.

    ``draining`` (a threading.Event) is the member-side drain signal:
    set when a drain request is observed (or `begin_drain` is called);
    the owner (backend CLI, BackendServer) watches it, finishes
    in-flight work, and exits with `exit_code()`.
    """

    def __init__(self, registry: FleetRegistry, addr: str, *,
                 role: str = ROLE_BACKEND, capacity: int = 1,
                 name: str = "",
                 version_fn: Optional[Callable[[], int]] = None,
                 interval: Optional[float] = None):
        self.registry = registry
        self.addr = addr
        self.role = role
        self.capacity = capacity
        self.name = name
        self.version_fn = version_fn
        self.interval = (registry.lease_secs / 3.0 if interval is None
                         else interval)
        self.started_at = time.time()
        self.draining = threading.Event()
        self.drain_respawn = False
        self.beats = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # stamp() can be entered from two threads at once (the loop vs a
        # SIGTERM handler's begin_drain on the main thread); Heartbeat's
        # tmp path is per-PID, not per-thread, so unserialized writers
        # could rename each other's half-written tmp into the live lease
        # — exactly the torn lease the atomic write exists to prevent.
        self._stamp_lock = threading.RLock()

    def stamp(self, status: Optional[str] = None) -> None:
        """One atomic lease write (serialized — see _stamp_lock). Never
        raises (Heartbeat.beat already swallows FS errors: a missed
        stamp surfaces as a stale lease on the sweep side, which is the
        correct signal). A stamp AFTER stop() is a no-op — checked
        under the same lock stop()'s unregister takes, so a racing
        deferred first stamp (the slow-join Timer firing as its server
        shuts down) can never re-announce a dead member."""
        version = -1
        if self.version_fn is not None:
            try:
                version = int(self.version_fn())
            except Exception:
                version = -1  # a wedged model must not kill the lease
        with self._stamp_lock:
            if self._stop.is_set():
                return
            hb = Heartbeat(self.registry.lease_path(self.addr, self.role))
            hb.beat(
                status=(status if status is not None else
                        (STATUS_DRAINING if self.draining.is_set()
                         else STATUS_UP)),
                addr=self.addr, role=self.role, capacity=self.capacity,
                model_version=version, started_at=self.started_at,
                name=self.name,
            )
            self.beats += 1

    def begin_drain(self, respawn: bool = False) -> None:
        """Member-side drain entry (drain file, SIGTERM handler, or a
        direct call): stamp ``draining`` immediately so frontends stop
        new assignments within one sweep, then let the owner finish
        in-flight work."""
        self.drain_respawn = self.drain_respawn or bool(respawn)
        # the lease is stamped before the event is set, so whoever wakes on
        # `draining` reads "draining" (the JAX twin sets the event first);
        # under the stamp lock, so no other thread's stamp of "up" lands
        # between the two
        with self._stamp_lock:
            self.stamp(STATUS_DRAINING)
            self.draining.set()

    def exit_code(self) -> int:
        """The drain exit contract: EXIT_RESCALE for a rolling restart
        (supervisor respawns for free — the parallel/elastic.py planned-
        exit choreography applied to serving), 0 for a retirement."""
        from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE

        return EXIT_RESCALE if self.drain_respawn else 0

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if not self.draining.is_set():
                req = self.registry.drain_requested(self.addr)
                if req is not None:
                    self.begin_drain(respawn=bool(req.get("respawn")))
                    continue  # begin_drain already stamped
            self.stamp()

    def start(self) -> "LeaseStamper":
        if self._stop.is_set():
            return self  # stopped before the (possibly deferred) start
        self.stamp()  # register before the first interval elapses
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"lease-{_sanitize(self.addr)}")
        self._thread.start()
        return self

    def stop(self, unregister: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        # Under _stamp_lock: any in-flight stamp finishes first, any
        # later stamp sees _stop and no-ops — the unregister below is
        # therefore FINAL (no racing writer can resurrect the lease).
        with self._stamp_lock:
            if unregister:
                self.registry.unregister(self.addr, self.role)
                self.registry.clear_drain(self.addr)


# ---------------------------------------------------------------- hashing


class HashRing:
    """Consistent-hash ring with virtual nodes.

    Each member owns ``vnodes`` points on a 64-bit ring (blake2b — an
    UNSALTED hash, so every frontend replica and every restart builds
    the identical ring; builtin hash() would reshuffle user affinity
    per process, the same trap `_group_key` documents for crc32).
    ``lookup(key)`` walks clockwise to the next point; when a member
    joins, it captures only the arcs its new points land on (~1/N of
    keys), and when it leaves, its keys fall to each arc's NEXT distinct
    member — which is exactly `preference()`'s retry order, so failover
    routing and post-churn routing agree."""

    def __init__(self, members: Sequence[str], vnodes: int = 64):
        self.members = sorted(set(members))
        self.vnodes = vnodes
        points: List[Tuple[int, str]] = []
        for m in self.members:
            for i in range(vnodes):
                points.append((self._hash(f"{m}#{i}"), m))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]

    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.blake2b(s.encode(), digest_size=8).digest(), "little")

    def lookup(self, key: int) -> str:
        """The member owning `key` (any int — e.g. the frontend's
        `_group_key` crc32)."""
        if not self._points:
            raise RuntimeError("empty hash ring (no fleet members)")
        i = bisect.bisect_right(self._hashes, self._hash(str(key)))
        return self._points[i % len(self._points)][1]

    def preference(self, key: int, k: Optional[int] = None) -> List[str]:
        """Ordered distinct members for `key`: the owner first, then each
        successive distinct member clockwise — the retry order that keeps
        failover consistent with what routing will do if the owner
        actually leaves."""
        if not self._points:
            return []
        k = len(self.members) if k is None else min(k, len(self.members))
        i = bisect.bisect_right(self._hashes, self._hash(str(key)))
        out: List[str] = []
        seen = set()
        n = len(self._points)
        for j in range(n):
            m = self._points[(i + j) % n][1]
            if m not in seen:
                seen.add(m)
                out.append(m)
                if len(out) >= k:
                    break
        return out


# ----------------------------------------------------------- fleet client


class FleetClient:
    """Client half of the replicated-frontend contract: POST
    ``/v1/predict`` against any of N edge processes, reconnecting to a
    sibling on socket-level failure. Predictions are idempotent (no
    server-side state advances per request), so a retry after a killed
    frontend is ALWAYS safe — the contract the fleet bench pins: a
    SIGKILLed frontend costs a reconnect, never a failed request.

    Frontend addresses come from a static list, a `FleetRegistry`
    (``role="frontend"`` leases), or both; the registry view refreshes
    whenever every known edge failed (membership may have moved under
    us) and on a cadence."""

    def __init__(self, frontends: Optional[Sequence[str]] = None,
                 registry: Optional[FleetRegistry] = None, *,
                 timeout: float = 30.0, deadline: float = 60.0,
                 backoff_base: float = 0.05, backoff_max: float = 1.0,
                 refresh_secs: float = 2.0, rng=None):
        if not frontends and registry is None:
            raise ValueError("need frontend addrs and/or a registry")
        self._static = list(frontends or [])
        self.registry = registry
        self.timeout = timeout
        self.deadline = deadline
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.refresh_secs = refresh_secs
        self._rng = rng or _backoff.seeded_rng(
            "fleet-client", pid=os.getpid())
        self._edges: List[str] = list(self._static)
        self._refreshed = 0.0
        self._i = 0
        self.reconnects = 0  # socket-level failovers (the pinned count)
        self.requests = 0
        self._refresh(force=True)

    def _refresh(self, force: bool = False) -> None:
        if self.registry is None:
            return
        now = time.monotonic()
        if not force and now - self._refreshed < self.refresh_secs:
            return
        self._refreshed = now
        leased = [m.addr for m in self.registry.members(ROLE_FRONTEND)
                  if not m.draining]
        merged = leased + [a for a in self._static if a not in leased]
        if merged:
            self._edges = merged

    def edges(self) -> List[str]:
        self._refresh()
        return list(self._edges)

    def predict(self, features: Dict, group_users: bool = False) -> Dict:
        """One prediction through whichever edge answers. Retries socket
        failures and 5xx on sibling edges with jittered backoff until
        `deadline`; 4xx (a bad request is bad on every edge) raises
        immediately."""
        import urllib.error
        import urllib.request

        body = json.dumps({
            "features": {k: (v.tolist() if hasattr(v, "tolist") else v)
                         for k, v in features.items()},
            **({"group_users": True} if group_users else {}),
        }).encode()
        stop = time.monotonic() + self.deadline
        attempt = 0
        last: Optional[Exception] = None
        while time.monotonic() < stop:
            self._refresh()
            edges = self._edges
            if not edges:
                time.sleep(_backoff.jittered(self.backoff_base, self._rng))
                continue
            addr = edges[self._i % len(edges)]
            self._i += 1
            try:
                r = urllib.request.urlopen(urllib.request.Request(
                    f"http://{addr}/v1/predict", data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST"), timeout=self.timeout)
                out = json.loads(r.read())
                self.requests += 1
                return out
            except urllib.error.HTTPError as e:
                if e.code < 500:
                    raise  # bad request: no sibling will disagree
                last = e
            except (OSError, urllib.error.URLError) as e:
                last = e
            # socket-level failure or 5xx: reconnect to a sibling edge
            attempt += 1
            self.reconnects += 1
            self._refresh(force=True)
            time.sleep(_backoff.jittered_backoff(
                attempt, self.backoff_base, self.backoff_max, self._rng))
        raise RuntimeError(
            f"no frontend answered within {self.deadline}s "
            f"(edges {self._edges})") from last


# ------------------------------------------------------------- autoscaler


@dataclass
class FleetLoad:
    """One load observation: the ``fleet_load`` section of the
    frontend's ``/v1/stats`` (windowed e2e p99 over the obs ring
    buffers, queue depth summed over members)."""

    p99_ms: Optional[float]
    queue_depth: int
    members: int


class FleetAutoscaler:
    """Scale the backend count from observed load, between hard bounds,
    without flapping.

    Pure decision core: `observe(load)` is one tick — callable from a
    thread (`start(interval)`), from the bench loop, or from tests with
    a fake clock. Actions go through two injected callables:

      * ``scale_up()``   — spawn one backend (Supervisor.add_spec +
        the backend CLI with ``--registry``; the new member admits
        itself by stamping a lease).
      * ``scale_down(n)`` — retire one backend given the current count
        (pick a victim, `registry.request_drain(addr)`; the member
        drains and exits 0).

    Policy: a breach (windowed p99 above ``p99_high_ms`` OR queue depth
    above ``queue_high``) must persist for ``sustain`` consecutive
    observations before scaling up (hysteresis); calm (p99 below
    ``p99_low_ms`` AND queue below ``queue_low``) must persist equally
    before scaling down. Every action arms a ``cooldown_secs`` window in
    which no further action fires — a spawn takes seconds to absorb
    load, and acting again off the same stale signal is how autoscalers
    oscillate. ``set_target`` overrides load entirely (rolling
    operations and the bench's deterministic 2→4→2 event), still one
    member per tick and still respecting the cooldown."""

    def __init__(self, *, members_fn: Callable[[], int],
                 scale_up: Callable[[], None],
                 scale_down: Callable[[int], None],
                 min_members: int = 1, max_members: int = 8,
                 p99_high_ms: float = 100.0, p99_low_ms: float = 20.0,
                 queue_high: int = 64, queue_low: int = 4,
                 sustain: int = 3, cooldown_secs: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if min_members < 1 or max_members < min_members:
            raise ValueError("need 1 <= min_members <= max_members")
        self.members_fn = members_fn
        self.scale_up = scale_up
        self.scale_down = scale_down
        self.min_members = min_members
        self.max_members = max_members
        self.p99_high_ms = p99_high_ms
        self.p99_low_ms = p99_low_ms
        self.queue_high = queue_high
        self.queue_low = queue_low
        self.sustain = sustain
        self.cooldown_secs = cooldown_secs
        self.clock = clock
        self._breach_up = 0
        self._breach_down = 0
        self._cooldown_until = -float("inf")
        self._target: Optional[int] = None
        self.actions: List[Dict] = []  # decision log (bench + tests)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # --------------------------------------------------------- control

    def set_target(self, n: Optional[int]) -> None:
        """Manual override: scale toward `n` (clamped to the bounds)
        regardless of load; None returns control to the load policy."""
        with self._lock:
            self._target = (None if n is None else
                            max(self.min_members,
                                min(self.max_members, int(n))))
            self._breach_up = self._breach_down = 0

    def at_target(self) -> bool:
        with self._lock:
            t = self._target
        return t is None or self.members_fn() == t

    # -------------------------------------------------------- decision

    def _act(self, kind: str, n: int, why: str) -> Optional[str]:
        # The callable runs FIRST and may decline with an explicit False
        # (deployment backpressure: a join/retirement already in flight —
        # see attach_autoscaler). A declined action arms no cooldown and
        # logs nothing; the next tick simply retries.
        acted = (self.scale_up() if kind == "up" else self.scale_down(n))
        if acted is False:
            return None
        now = self.clock()
        self._cooldown_until = now + self.cooldown_secs
        self._breach_up = self._breach_down = 0
        self.actions.append(
            {"action": kind, "members_before": n, "why": why, "t": now})
        return kind

    def observe(self, load: Optional[FleetLoad] = None) -> Optional[str]:
        """One tick: returns "up"/"down" when an action fired, else
        None. `load=None` (no signal yet — obs plane off, no traffic)
        never breaches in either direction but still serves a manual
        target."""
        with self._lock:
            n = self.members_fn()
            now = self.clock()
            cooling = now < self._cooldown_until
            if self._target is not None:
                if n < self._target and not cooling:
                    return self._act("up", n, f"target {self._target}")
                if n > self._target and not cooling:
                    return self._act("down", n, f"target {self._target}")
                if n == self._target:
                    self._target = None  # reached: hand back to load
                return None
            if load is None or load.p99_ms is None:
                return None
            if load.p99_ms > self.p99_high_ms or \
                    load.queue_depth > self.queue_high:
                self._breach_up += 1
                self._breach_down = 0
            elif load.p99_ms < self.p99_low_ms and \
                    load.queue_depth < self.queue_low:
                self._breach_down += 1
                self._breach_up = 0
            else:
                self._breach_up = self._breach_down = 0
            if cooling:
                return None
            if self._breach_up >= self.sustain and n < self.max_members:
                return self._act(
                    "up", n,
                    f"p99={load.p99_ms:.1f}ms q={load.queue_depth} "
                    f"over ({self.p99_high_ms}, {self.queue_high}) "
                    f"x{self._breach_up}")
            if self._breach_down >= self.sustain and n > self.min_members:
                return self._act(
                    "down", n,
                    f"p99={load.p99_ms:.1f}ms q={load.queue_depth} "
                    f"under ({self.p99_low_ms}, {self.queue_low}) "
                    f"x{self._breach_down}")
            return None

    # --------------------------------------------------------- threading

    def start(self, interval: float,
              load_fn: Callable[[], Optional[FleetLoad]]) -> "FleetAutoscaler":
        """Poll `load_fn` every `interval` on a daemon thread (the
        Supervisor-resident deployment shape; `observe` stays callable
        directly for deterministic tests/benches)."""

        import logging

        log = logging.getLogger(__name__)

        def loop():
            while not self._stop.wait(interval):
                try:
                    self.observe(load_fn())
                except Exception:
                    # The loop survives (scaling must never die mid-
                    # deployment; the next tick retries) but the failure
                    # is LOGGED — a config error like attach_autoscaler's
                    # missing --member-name ValueError raising every tick
                    # must be visible, not a silent never-scales wedge.
                    log.warning("autoscaler tick failed", exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def attach_autoscaler(supervisor, registry: FleetRegistry,
                      argv_fn: Callable[[str], Sequence[str]], *,
                      name_prefix: str = "backend",
                      env: Optional[Dict[str, str]] = None,
                      **knobs) -> FleetAutoscaler:
    """Wire a `FleetAutoscaler` into an online `Supervisor` (the
    Supervisor-resident deployment the ROADMAP names):

      * scale UP   — `supervisor.add_spec` of a fresh backend spec built
        by ``argv_fn(member_name)`` (the serving CLI with ``--registry``
        and ``--member-name``; ``--port 0`` means each generation binds
        a fresh port and announces it by lease — discovery IS the
        spawn-ack).
      * scale DOWN — pick the youngest live member the supervisor owns,
        `registry.request_drain(addr)` (retirement: the member stamps
        ``draining``, finishes in-flight, exits 0), and reap its spec
        once the supervisor saw the clean exit.
      * member count — live backend leases in the registry (NOT the
        spec count: a spawned-but-not-yet-serving member shouldn't
        suppress further scale-ups forever; the cooldown paces those).

    Death/wedge handling stays the Supervisor's: a SIGKILLed member is
    respawned on budget and rejoins by lease; a drained member exits 0
    and is released. Returns the autoscaler (call ``observe``/
    ``start`` yourself — pacing belongs to the deployment)."""
    from deeprec_tpu_torch.online.supervisor import ProcessSpec

    counter = {"n": 0}
    draining: Dict[str, str] = {}   # member name -> addr
    pending: Dict[str, float] = {}  # spawned, lease not yet seen -> t0
    join_timeout = knobs.pop("join_timeout_secs", 180.0)

    def members_fn() -> int:
        return len(registry.members(ROLE_BACKEND, include_draining=False))

    def _settle_pending() -> None:
        leased = {m.name for m in registry.members(ROLE_BACKEND)}
        now = time.monotonic()
        for name in list(pending):
            st = supervisor.state(name)
            if (name in leased or st is None or st.gave_up
                    or now - pending[name] > join_timeout):
                # joined, abandoned, or never coming — either way, stop
                # gating scale-ups on it (a silent forever-pending entry
                # would wedge the autoscaler for the process lifetime)
                pending.pop(name)

    def scale_up() -> None:
        # Joining takes seconds (process start + model restore) while
        # autoscaler ticks take fractions of one: without this gate a
        # sustained breach spawns a NEW member every post-cooldown tick
        # until the first one finally leases — the runaway the cooldown
        # alone cannot prevent because it paces ticks, not joins. One
        # join in flight at a time; the next tick retries.
        _settle_pending()
        if pending:
            return False
        counter["n"] += 1
        name = f"{name_prefix}-as{counter['n']}"
        argv = [str(x) for x in argv_fn(name)]
        if "--member-name" not in argv:
            # the join gate matches leases BY NAME: an unnamed member
            # would lease fine yet never settle pending — fail loud at
            # spawn time instead of wedging silently
            raise ValueError(
                "attach_autoscaler: argv_fn(name) must pass --member-name "
                f"(got {argv})")
        pending[name] = time.monotonic()
        supervisor.add_spec(ProcessSpec(
            name=name, argv=argv, lease_secs=None,
            env=env, stdout=None))
        return True

    def reap() -> None:
        """Release the specs of drained members whose processes exited
        cleanly (called before every scale-down and directly by
        deployments at settle points)."""
        for name in list(draining):
            st = supervisor.state(name)
            if st is None or st.done:
                supervisor.remove_spec(name, kill=False)
                registry.clear_drain(draining.pop(name))

    def scale_down(n: int) -> None:
        reap()
        live = {m.name: m for m in registry.members(ROLE_BACKEND)}
        for name in draining:
            m = live.get(name)
            if m is not None and not m.draining:
                # a requested drain hasn't reached its lease yet: the
                # member count still includes it, and acting again off
                # that stale count would over-retire (the join-gate's
                # mirror image). One retirement in flight at a time.
                return False
        owned = {s.name for s in list(supervisor.specs)}
        victims = [m for m in live.values()
                   if not m.draining and m.name in owned
                   and m.name not in draining]
        if not victims:
            return False  # nothing the supervisor owns is retirable now
        victim = max(victims, key=lambda m: m.started_at)  # youngest
        registry.request_drain(victim.addr, respawn=False)
        draining[victim.name] = victim.addr
        return True

    scaler = FleetAutoscaler(members_fn=members_fn, scale_up=scale_up,
                             scale_down=scale_down, **knobs)
    scaler.reap = reap  # spec cleanup handle (no scaling side effects)
    return scaler


def load_from_stats(stats: Dict) -> Optional[FleetLoad]:
    """Decode a frontend ``/v1/stats`` body into the autoscaler's
    observation (None when the snapshot carries no ``fleet_load`` —
    pre-fleet frontends, obs plane off)."""
    fl = stats.get("fleet_load")
    if not fl:
        return None
    return FleetLoad(p99_ms=fl.get("e2e_p99_ms"),
                     queue_depth=int(fl.get("queue_depth") or 0),
                     members=int(fl.get("members") or 0))
