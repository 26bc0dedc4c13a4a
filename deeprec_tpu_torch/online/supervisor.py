"""Process supervision — the port of `deeprec_tpu/online/supervisor.py`:
heartbeat leases, wedge detection, and restarts under an
exponential-backoff budget.

  * every worker stamps `<name>.hb` once per unit of progress (train
    step, serve poll round) via `Heartbeat.beat` — an atomic tmp+rename
    JSON write, so a reader never sees a torn lease;
  * the supervisor declares a worker WEDGED when its lease is older than
    `lease_secs` (live process, no progress — a hung collective, a
    deadlocked writer) and kills it; a dead process is detected by
    `Popen.poll` directly;
  * either way the worker is restarted with capped exponential backoff,
    against a `max_restarts` consecutive-failure budget (reset by any
    healthy stretch), so a crash-looping worker ends in a loud terminal
    failure instead of a fork bomb;
  * exit code `parallel.elastic.EXIT_RESCALE` is the planned-exit
    contract: the worker left on purpose (a draining serving member, a
    rescale), so the supervisor respawns it at once (optionally with new
    argv from `on_rescale`) without charging the failure budget.

The fleet (`serving/fleet.py`) reuses `Heartbeat` for its member leases
and `ProcessSpec` for the autoscaler's backend specs.
"""
from __future__ import annotations

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE
from deeprec_tpu_torch.utils import backoff as _backoff

_log_lock = threading.Lock()


def _now() -> float:
    return time.time()


class Heartbeat:
    """Lease-style liveness file: one atomic JSON stamp per progress unit.

    Format: ``{"pid": int, "time": unix_seconds, "step": int|null,
    "status": str, ...extra}``. Writes go through a tempfile in the same
    directory + ``os.replace`` so a reader (the supervisor, possibly on
    another host via shared FS) sees either the previous or the new
    stamp, never a torn one — the same commit discipline as the
    checkpoint manifest and the WorkQueue cursor."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def beat(self, step: Optional[int] = None, status: str = "ok",
             **extra) -> None:
        payload = {"pid": os.getpid(), "time": _now(), "step": step,
                   "status": status, **extra}
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            # A heartbeat must never take its worker down with it (full
            # disk, vanished dir): missing beats surface as a stale lease
            # on the supervisor side, which is the correct signal anyway.
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @staticmethod
    def read(path: str) -> Optional[dict]:
        """Last stamp, or None when missing/unreadable (a torn stamp is
        impossible by construction, so unreadable means 'no lease')."""
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    @staticmethod
    def age(path: str, now: Optional[float] = None) -> Optional[float]:
        """Seconds since the last stamp, or None when there is none."""
        hb = Heartbeat.read(path)
        if hb is None or "time" not in hb:
            return None
        return max(0.0, (now if now is not None else _now()) - hb["time"])


@dataclass
class ProcessSpec:
    """One supervised worker.

    argv may be a list or a zero-arg callable returning one (re-evaluated
    on every (re)spawn, so restarts can pick up new ports/paths).
    `lease_secs=None` disables wedge detection (processes that only make
    coarse progress). `grace_secs` is how long after a (re)spawn the
    lease clock is suspended — imports, the CUDA context and the first
    kernel builds produce no steps for tens of seconds and must not read
    as a wedge."""

    name: str
    argv: Union[Sequence[str], Callable[[], Sequence[str]]]
    heartbeat_path: Optional[str] = None
    lease_secs: Optional[float] = 15.0
    grace_secs: float = 60.0
    max_restarts: int = 5
    backoff_base_secs: float = 0.5
    backoff_max_secs: float = 30.0
    # dict, or a zero-arg callable returning one (re-evaluated per spawn:
    # fresh coordinator ports and the like)
    env: Optional[Union[dict, Callable[[], dict]]] = None
    cwd: Optional[str] = None
    # EXIT_RESCALE hook: called with this spec; may return replacement
    # argv for the next generation (None keeps the current argv).
    on_rescale: Optional[Callable[["ProcessSpec"], Optional[Sequence]]] = None
    stdout: Optional[str] = None  # path; worker stderr is merged into it


@dataclass
class _ProcState:
    proc: Optional[subprocess.Popen] = None
    spawned_at: float = 0.0
    consecutive_failures: int = 0
    restarts: int = 0
    wedge_kills: int = 0
    rescales: int = 0
    last_exit: Optional[int] = None
    gave_up: bool = False
    done: bool = False  # clean zero exit: not restarted
    next_spawn_at: float = 0.0  # backoff gate
    log: List[str] = field(default_factory=list)


class Supervisor:
    """Watch a set of ProcessSpecs: restart the dead, kill-and-restart
    the wedged, respawn EXIT_RESCALE exits for free, and give up loudly
    when a worker exhausts its consecutive-failure budget.

    Use either as a foreground loop (`run(stop_event)`) or started on a
    thread (`start()` / `stop()`). `stats()` returns per-worker restart
    accounting."""

    def __init__(self, specs: Sequence[ProcessSpec], poll_secs: float = 0.25,
                 on_event: Optional[Callable[[str], None]] = None,
                 keep_alive: bool = False):
        self.specs = list(specs)
        self.poll_secs = poll_secs
        self._states: Dict[str, _ProcState] = {
            s.name: _ProcState() for s in self.specs
        }
        self._on_event = on_event
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._rng = random.Random(0xFA117)
        # Elastic fleets add/remove specs at runtime (the serving
        # autoscaler): mutations serialize on _speclock, and keep_alive
        # stops run() from returning in the window where every CURRENT
        # worker happens to be done (more may be added next tick).
        self.keep_alive = keep_alive
        self._speclock = threading.Lock()

    # ------------------------------------------------------------- events

    def _event(self, spec_name: str, msg: str) -> None:
        line = f"supervisor[{spec_name}]: {msg}"
        st = self._states.get(spec_name)
        if st is not None:  # spec may have been removed mid-event
            st.log.append(line)
        if self._on_event is not None:
            self._on_event(line)
        else:
            with _log_lock:
                print(line, file=sys.stderr, flush=True)

    # -------------------------------------------------------------- spawn

    def _argv(self, spec: ProcessSpec) -> List[str]:
        a = spec.argv() if callable(spec.argv) else spec.argv
        return [str(x) for x in a]

    def _spawn(self, spec: ProcessSpec) -> None:
        st = self._states.get(spec.name)
        if st is None:
            return  # spec removed (fleet retire) between check and spawn
        env = dict(os.environ)
        if spec.env:
            extra = spec.env() if callable(spec.env) else spec.env
            env.update({k: str(v) for k, v in extra.items()})
        out = None
        if spec.stdout:
            out = open(spec.stdout, "ab")
        st.proc = subprocess.Popen(
            self._argv(spec), env=env, cwd=spec.cwd,
            stdout=out, stderr=subprocess.STDOUT if out else None,
        )
        if out is not None:
            out.close()  # child holds its own descriptor
        st.spawned_at = time.monotonic()
        self._event(spec.name, f"spawned pid {st.proc.pid}")

    def start(self) -> "Supervisor":
        # Same guard as run()'s startup loop: a spec added via add_spec
        # before start() already has a live proc (and add_spec holds the
        # next_spawn_at=inf gate while ITS spawn runs) — spawning again
        # would double-fork and orphan the first PID.
        now = time.monotonic()
        for spec in list(self.specs):
            st = self._states.get(spec.name)
            if st is not None and st.proc is None and now >= st.next_spawn_at:
                self._spawn(spec)
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="online-supervisor")
        self._thread.start()
        return self

    # -------------------------------------------------------------- watch

    def run(self, stop: Optional[threading.Event] = None) -> None:
        stop = stop or self._stop
        # Foreground use: spawn anything start() didn't. Honors the
        # next_spawn_at gate (add_spec publishes inf while IT spawns —
        # spawning here too would double-fork and orphan one PID) and
        # tolerates specs removed concurrently.
        now = time.monotonic()
        for spec in list(self.specs):
            st = self._states.get(spec.name)
            if st is not None and st.proc is None and now >= st.next_spawn_at:
                self._spawn(spec)
        while not stop.wait(self.poll_secs):
            for spec in list(self.specs):
                self._check(spec)
            if not self.keep_alive and all(
                    s.done or s.gave_up
                    for s in list(self._states.values())):
                return

    def _check(self, spec: ProcessSpec) -> None:
        st = self._states.get(spec.name)
        if st is None or st.done or st.gave_up:
            return  # removed mid-round (fleet retire) or settled
        now = time.monotonic()
        if st.proc is None:
            if now >= st.next_spawn_at:
                self._spawn(spec)
            return
        rc = st.proc.poll()
        if rc is None:
            # A healthy stretch (alive past the startup grace) repays the
            # consecutive-failure budget: only back-to-back crashes with
            # no real work in between exhaust it.
            if (st.consecutive_failures
                    and now - st.spawned_at > spec.grace_secs):
                st.consecutive_failures = 0
            self._check_lease(spec, st, now)
            return
        st.last_exit = rc
        st.proc = None
        if rc == 0:
            st.done = True
            self._event(spec.name, "exited cleanly")
            return
        if rc == EXIT_RESCALE:
            # Planned exit (elastic contract): checkpointed + acked, so a
            # respawn is free — no backoff, budget untouched, and the
            # hook may hand back resized argv.
            st.rescales += 1
            st.consecutive_failures = 0
            if spec.on_rescale is not None:
                new_argv = spec.on_rescale(spec)
                if new_argv is not None:
                    spec.argv = list(new_argv)
            self._event(spec.name, f"EXIT_RESCALE -> respawn (#{st.rescales})")
            self._spawn(spec)
            return
        self._restart(spec, st, f"died rc={rc}")

    def _check_lease(self, spec: ProcessSpec, st: _ProcState,
                     now: float) -> None:
        if spec.lease_secs is None or spec.heartbeat_path is None:
            return
        if now - st.spawned_at < spec.grace_secs:
            return  # startup grace: imports and kernel builds beat no leases
        age = Heartbeat.age(spec.heartbeat_path)
        # A missing lease after grace counts as wedged too (the worker
        # never reached its loop), with the spawn moment as its "stamp".
        if age is None:
            age = now - st.spawned_at
        if age <= spec.lease_secs:
            return
        self._event(
            spec.name,
            f"wedged (lease {age:.1f}s > {spec.lease_secs}s) -> SIGKILL",
        )
        try:
            st.proc.kill()
            st.proc.wait(timeout=10)
        except (OSError, subprocess.TimeoutExpired):
            pass
        st.last_exit = -signal.SIGKILL
        st.proc = None
        # Incremented LAST: stats() readers gating on wedge_kills (tests,
        # the freshness bench) must observe the kill's outcome fields.
        st.wedge_kills += 1
        self._restart(spec, st, "wedged")

    def _restart(self, spec: ProcessSpec, st: _ProcState, why: str) -> None:
        st.consecutive_failures += 1
        if st.consecutive_failures > spec.max_restarts:
            st.gave_up = True
            self._event(
                spec.name,
                f"{why}; restart budget exhausted "
                f"({spec.max_restarts}) — giving up",
            )
            return
        delay = _backoff.jittered_backoff(
            st.consecutive_failures, spec.backoff_base_secs,
            spec.backoff_max_secs, self._rng)
        st.restarts += 1
        st.next_spawn_at = time.monotonic() + delay
        self._event(
            spec.name,
            f"{why}; restart {st.consecutive_failures}/{spec.max_restarts} "
            f"in {delay:.2f}s",
        )

    # ------------------------------------------------------------ control

    def add_spec(self, spec: ProcessSpec, spawn: bool = True) -> None:
        """Adopt a NEW worker at runtime (the serving autoscaler's
        scale-up path): the spec joins the watch set and is spawned
        immediately (or on the next poll round when `spawn=False`).

        The spec is published with its spawn gate CLOSED
        (next_spawn_at=inf) until our own _spawn below finishes —
        otherwise the poll loop's _check can race us in the window
        between publish and spawn and fork a SECOND process that the
        state record then orphans (untracked, unkilled at stop())."""
        st = _ProcState()
        if spawn:
            st.next_spawn_at = float("inf")
        with self._speclock:
            if spec.name in self._states:
                raise ValueError(f"duplicate spec name {spec.name!r}")
            self._states[spec.name] = st
            self.specs.append(spec)
        if spawn:
            try:
                self._spawn(spec)
            finally:
                st.next_spawn_at = 0.0

    def remove_spec(self, name: str, kill: bool = True) -> bool:
        """Stop watching a worker (the scale-down path). The polite
        retirement is: request a drain, wait for the worker's clean
        exit (state.done), THEN remove — `kill=False` leaves a
        still-running process alone (it is expected to exit on its
        own); `kill=True` reaps it. Returns whether the spec existed."""
        with self._speclock:
            st = self._states.pop(name, None)
            self.specs = [s for s in self.specs if s.name != name]
        if st is None:
            return False
        if kill and st.proc is not None:
            try:
                st.proc.kill()
                st.proc.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired):
                pass
        return True

    def state(self, name: str) -> Optional[_ProcState]:
        """The live accounting record for one worker (None when
        unknown) — the autoscaler polls `.done` to confirm a retired
        member's clean exit before removing its spec."""
        return self._states.get(name)

    def note_progress(self, name: str) -> None:
        """External progress signal (e.g. the bench saw fresh steps
        served): resets the worker's consecutive-failure budget, so only
        back-to-back failures with no useful work in between exhaust it."""
        self._states[name].consecutive_failures = 0

    def pid(self, name: str) -> Optional[int]:
        p = self._states[name].proc
        return p.pid if p is not None else None

    def kill(self, name: str, sig: int = signal.SIGKILL) -> bool:
        """Fault-injection surface: signal a supervised worker (the
        supervisor then notices the death and restarts it on budget)."""
        p = self._states[name].proc
        if p is None:
            return False
        try:
            os.kill(p.pid, sig)
            return True
        except OSError:
            return False

    def stats(self) -> Dict[str, Dict]:
        """Per-worker restart accounting, extended
        with the lease view — heartbeat age and remaining restart
        budget — and mirrored into the obs plane as per-worker gauges
        (deeprec_supervisor_*, worker=<spec name>: bounded label set)."""
        from deeprec_tpu_torch.obs import metrics as obs_metrics

        reg = (obs_metrics.default_registry()
               if obs_metrics.metrics_enabled() else None)
        specs = {s.name: s for s in list(self.specs)}
        out = {}
        for name, st in list(self._states.items()):
            spec = specs.get(name)
            hb = (Heartbeat.read(spec.heartbeat_path)
                  if spec is not None and spec.heartbeat_path else None)
            hb_age = (max(0.0, _now() - hb["time"])
                      if hb and "time" in hb else None)
            out[name] = {
                "restarts": st.restarts,
                "wedge_kills": st.wedge_kills,
                "rescales": st.rescales,
                "consecutive_failures": st.consecutive_failures,
                "last_exit": st.last_exit,
                "gave_up": st.gave_up,
                "done": st.done,
                "alive": st.proc is not None and st.proc.poll() is None,
                "heartbeat_age_seconds": (
                    round(hb_age, 3) if hb_age is not None else None),
                "restart_budget_remaining": (
                    max(0, spec.max_restarts - st.consecutive_failures)
                    if spec is not None else None),
            }
            if hb is not None and "guard_trips" in hb:
                # Quality-firewall view (TrainLoop guard heartbeat
                # fields): a worker with restarts AND rising guard_trips
                # is poisoned by its DATA — a restart budget cannot fix
                # that; the permanent batch quarantine does.
                out[name]["guard_trips"] = hb.get("guard_trips")
                out[name]["rollbacks"] = hb.get("rollbacks")
                out[name]["batches_quarantined"] = hb.get(
                    "batches_quarantined")
                out[name]["last_verified_step"] = hb.get(
                    "last_verified_step")
            if reg is not None:
                lab = {"worker": name}
                reg.gauge("deeprec_supervisor_restarts",
                          "worker restarts", lab).set(st.restarts)
                reg.gauge("deeprec_supervisor_wedge_kills",
                          "wedge-detected kills", lab).set(st.wedge_kills)
                reg.gauge("deeprec_supervisor_restart_budget_remaining",
                          "consecutive failures left before give-up",
                          lab).set(out[name]["restart_budget_remaining"]
                                   or 0)
                reg.gauge("deeprec_supervisor_alive",
                          "worker process liveness",
                          lab).set(1 if out[name]["alive"] else 0)
                if hb_age is not None:
                    reg.gauge("deeprec_supervisor_heartbeat_age_seconds",
                              "age of the worker's lease stamp",
                              lab).set(hb_age)
        return out

    def stop(self, kill_workers: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if kill_workers:
            for st in list(self._states.values()):
                if st.proc is not None:
                    try:
                        st.proc.kill()
                        st.proc.wait(timeout=10)
                    except (OSError, subprocess.TimeoutExpired):
                        pass
                    st.proc = None
