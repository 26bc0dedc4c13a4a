"""Deterministic fault injectors for the online-learning loop — the port
of `deeprec_tpu/online/faults.py`. The checkpoint-corruption matrix, the
poll-survivability tests, the guard tests and `chip_smoke.py` phase 20
drive the SAME failure modes:

  * `kill_self_at_step` / `env_kill_step` — SIGKILL the current process
    the moment a given train step completes (a real kill -9, not a
    polite exception), wired through `TrainLoop` via the
    DEEPREC_FAULT_KILL_STEP env var for subprocess workers.
  * `install_torn_write` — arm the CheckpointManager's `on_write` seam
    (PR 4) to leave a half-written dir: real table file, no manifest —
    exactly what a writer killed between two np.savez calls leaves.
  * `corrupt_latest_delta` / `flip_bit` — flip one bit in a COMMITTED
    checkpoint's payload, the post-commit corruption class (disk rot,
    truncating copy) that manifests digests + quarantine exist for.
  * `truncate_file` — tear a committed npz (partial copy / torn fsync).
  * `BrokerOutage` — stop a FileStreamServer and later revive it on the
    same port, the broker-disconnect class TCPStreamReader's backoff
    reconnect handles.
  * subprocess helpers (`spawn_worker`, `worker_argv`, `wait_for_line`,
    `sigkill`) for tests that need a real process to murder; a worker runs
    `python -m deeprec_tpu_torch.online.loop`.
  * fleet injectors (`torn_lease_write`, `env_slow_join_secs`,
    `sigkill_fleet_member`) — the serving-fleet failure modes
    (serving/fleet.py): a torn lease file a reader must skip (never
    trust), a slow joiner that is reachable but unannounced, and member
    / frontend SIGKILL mid-stream, driven by the fleet tests.
  * data poison (`poison_batch`, `PoisonInjector`, `exploding_lr`) — the
    semantic faults the step sentinel (guard/) must catch.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Callable, List, Optional, Tuple

KILL_STEP_ENV = "DEEPREC_FAULT_KILL_STEP"
SLOW_JOIN_ENV = "DEEPREC_FAULT_SLOW_JOIN_SECS"


# ------------------------------------------------------------ kill at step


def kill_self_at_step(kill_step: int) -> Callable[[int], None]:
    """Hook for TrainLoop(on_step=...): SIGKILL this process right after
    `kill_step` completes. SIGKILL, not sys.exit — the point is that no
    finally-block, atexit, or writer drain gets to run."""

    def hook(step: int) -> None:
        if step >= kill_step:
            os.kill(os.getpid(), signal.SIGKILL)

    return hook


def env_kill_step() -> Optional[Callable[[int], None]]:
    """The subprocess form: DEEPREC_FAULT_KILL_STEP=N arms
    kill_self_at_step(N) in a worker started by the supervisor/bench."""
    v = os.environ.get(KILL_STEP_ENV)
    if not v:
        return None
    return kill_self_at_step(int(v))


# ---------------------------------------------------------- torn writes


def install_torn_write(ck, junk_file: str = "table_junk_t0.npz") -> None:
    """Arm `ck.on_write` to die mid-save ONCE: the dir exists and holds a
    real (junk) table file, but no manifest — the state a SIGKILL between
    npz writes leaves behind. Restore must treat the dir as absent."""
    import numpy as np

    def seam(path):
        ck.on_write = None  # one-shot
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, junk_file), junk=np.zeros(3))
        raise KeyboardInterrupt("injected torn write")

    ck.on_write = seam


# ------------------------------------------------------ bit flips / tears


def flip_bit(path: str, offset: Optional[int] = None, bit: int = 4) -> int:
    """Flip one bit of `path` in place; returns the byte offset flipped.
    Default offset is mid-file — inside some array's payload, past the
    zip headers, so the tear is in DATA (the manifests' digest/zip-CRC
    checks must catch it; a header flip would fail earlier and cheaper)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"{path} is empty")
    off = len(data) // 2 if offset is None else offset
    data[off] ^= 1 << bit
    with open(path, "wb") as f:
        f.write(bytes(data))
    return off


def truncate_file(path: str, keep_fraction: float = 0.5) -> int:
    """Truncate a committed file to a fraction of its size (torn copy /
    partial replication). Returns the new size."""
    size = os.path.getsize(path)
    new = max(1, int(size * keep_fraction))
    with open(path, "rb+") as f:
        f.truncate(new)
    return new


def corrupt_latest_delta(ckpt_dir: str, mode: str = "bitflip",
                         kind: str = "incr") -> Optional[str]:
    """Corrupt the newest COMMITTED `kind-*` dir's first table file
    (bitflip | truncate). Returns the corrupted file's path, or None when
    no committed dir of that kind exists yet. Only dirs with a manifest
    count — corrupting an in-flight save would test the torn-write path,
    not the post-commit one."""
    import re

    pat = re.compile(rf"^{kind}-(\d+)$")
    steps = sorted(
        int(m.group(1))
        for d in os.listdir(ckpt_dir)
        if (m := pat.match(d))
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    )
    if not steps:
        return None
    path = os.path.join(ckpt_dir, f"{kind}-{steps[-1]}")
    tables = sorted(
        f for f in os.listdir(path) if f.startswith("table_")
    )
    if not tables:
        return None
    target = os.path.join(path, tables[0])
    if mode == "truncate":
        truncate_file(target)
    else:
        flip_bit(target)
    return target


# ----------------------------------------------------------- fleet faults


def torn_lease_write(registry, addr: str, role: str = "backend",
                     pid: Optional[int] = None) -> str:
    """Plant a TORN lease file (truncated mid-JSON) at the path the
    member at `addr` would stamp — what a non-atomic writer or FS
    corruption leaves. The registry's own writes are atomic tmp+rename
    (Heartbeat), so this deliberately bypasses them; a sweep must read
    it as 'no lease' (skip), never trust it and never crash. Returns
    the planted path."""
    path = registry.lease_path(addr, role, pid=pid)
    with open(path, "w") as f:
        f.write('{"pid": 1234, "time": 17')  # cut mid-value
    return path


def env_slow_join_secs() -> float:
    """The slow-joiner fault, subprocess form: DEEPREC_FAULT_SLOW_JOIN_SECS
    delays a fleet backend's FIRST lease stamp — the process binds its
    socket and serves, but stays unannounced. The fleet must keep full
    service meanwhile (nobody routes to an unleased member) and admit it
    when the stamp finally lands."""
    v = os.environ.get(SLOW_JOIN_ENV)
    return float(v) if v else 0.0


def sigkill_fleet_member(proc: subprocess.Popen, wait: float = 30.0) -> int:
    """SIGKILL a fleet member (backend or frontend) mid-stream: sockets
    drop, the lease goes stale and eviction retires it — no drain, no
    unregister, the exact opposite of the polite exit. Alias of
    `sigkill` with the fleet contract spelled out: the tier must retry
    in-flight requests on siblings with zero failed requests."""
    return sigkill(proc, wait=wait)


# --------------------------------------------------------- data poison
#
# The semantic-fault injector set (the guard/ firewall): unlike every fault
# above, nothing crashes — the process stays healthy while the DATA (or the
# optimizer schedule) poisons the model.


def poison_batch(batch, mode: str, magnitude: float = 1e30,
                 seed: int = 0) -> dict:
    """Return a poisoned copy of `batch`:

      * ``nan``        — every dense feature value becomes NaN (a
        corrupt upstream join / log-shipper bug);
      * ``extreme``    — dense features take ±`magnitude` (unit bugs,
        overflowed counters);
      * ``label_flip`` — labels invert (a polarity bug in the label
        pipeline: gradients are confidently wrong, loss spikes while
        every value stays finite — the case only the loss-spike EMA
        catches).
    """
    import numpy as np

    out = {k: np.array(v, copy=True) for k, v in batch.items()}
    rng = np.random.default_rng(seed)
    if mode == "nan":
        for k, v in out.items():
            if not k.startswith("label") and np.issubdtype(
                    v.dtype, np.floating):
                out[k] = np.full_like(v, np.nan)
    elif mode == "extreme":
        for k, v in out.items():
            if not k.startswith("label") and np.issubdtype(
                    v.dtype, np.floating):
                out[k] = np.where(rng.random(v.shape) < 0.5,
                                  magnitude, -magnitude).astype(v.dtype)
    elif mode == "label_flip":
        for k, v in out.items():
            if k.startswith("label"):
                out[k] = (1.0 - v).astype(v.dtype)
    else:
        raise ValueError(f"unknown poison mode {mode!r}")
    return out


class PoisonInjector:
    """Wrap a batch iterable, poisoning chosen deliveries.

    ``plan`` maps 1-based delivery index -> poison mode; ``repeat_from``
    (optional) replays the LAST poisoned batch verbatim on every later
    delivery whose index is in ``repeat_at`` — the stream-replay shape
    that drives a batch across R rollbacks into permanent quarantine.
    ``injected`` records (index, mode, fingerprint) for the bench's
    detection-latency ledger."""

    def __init__(self, source, plan: dict, repeat_at=()):
        from deeprec_tpu_torch.guard.quarantine import batch_fingerprint

        self._fp = batch_fingerprint
        self.source = source
        self.plan = dict(plan)
        self.repeat_at = set(repeat_at)
        self.injected = []  # [(delivery index, mode, fingerprint)]
        self._last_poisoned = None

    def __iter__(self):
        i = 0
        for batch in self.source:
            i += 1
            if i in self.repeat_at and self._last_poisoned is not None:
                out = self._last_poisoned
                self.injected.append((i, "repeat", self._fp(out)))
                yield out
                continue
            mode = self.plan.get(i)
            if mode is not None:
                out = poison_batch(batch, mode, seed=i)
                self._last_poisoned = out
                self.injected.append((i, mode, self._fp(out)))
                yield out
            else:
                yield batch


def exploding_lr(base_lr: float, start: int, length: int,
                 factor: float = 1e6) -> Callable[[int], float]:
    """TrainLoop(lr_fn=...) injector: a runaway learning-rate window —
    steps in [start, start+length) train at ``base_lr * factor`` (a bad
    schedule push / config typo). The data is clean; only the sentinel's
    grad/row-norm and non-finite checks can see the damage."""

    def lr_fn(step: int) -> float:
        if start <= step < start + length:
            return base_lr * factor
        return base_lr

    return lr_fn


# --------------------------------------------------------- broker outage


class BrokerOutage:
    """Take a FileStreamServer down and bring it back on the SAME port —
    the disconnect/reconnect cycle TCPStreamReader's jittered backoff is
    specified against. The revived broker serves the same file, and the
    reader's OFFSET header makes the resume exactly-once."""

    def __init__(self, server):
        self.server = server
        self.port = server.port
        self.path = server.path
        self.follow = server.follow
        self.poll_secs = server.poll_secs
        self.down_at: Optional[float] = None
        self.outages = 0

    def down(self) -> None:
        self.server.stop()
        self.down_at = time.monotonic()
        self.outages += 1

    def up(self):
        """Revive on the same port (allow_reuse_address makes the rebind
        race-free against lingering TIME_WAIT sockets)."""
        from deeprec_tpu_torch.data.stream import FileStreamServer

        self.server = FileStreamServer(
            self.path, port=self.port, follow=self.follow,
            poll_secs=self.poll_secs,
        ).start()
        self.down_at = None
        return self.server


# ------------------------------------------------- subprocess machinery


def spawn_worker(argv: List[str], env: Optional[dict] = None,
                 cwd: Optional[str] = None) -> subprocess.Popen:
    """Start a worker with line-buffered captured stdout (stderr merged),
    in this process's environment plus `env`."""
    e = dict(os.environ)
    if env:
        e.update({k: str(v) for k, v in env.items()})
    return subprocess.Popen(
        argv, env=e, cwd=cwd, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, bufsize=1,
    )


def wait_for_line(proc: subprocess.Popen, pred: Callable[[str], bool],
                  timeout: float = 240.0) -> Tuple[Optional[str], List[str]]:
    """Read the worker's stdout until `pred(line)` matches (returns that
    line) or the stream ends / times out (returns None). All consumed
    lines ride along for assertion messages."""
    lines: List[str] = []
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            return None, lines
        line = line.rstrip("\n")
        lines.append(line)
        if pred(line):
            return line, lines
    return None, lines


def sigkill(proc: subprocess.Popen, wait: float = 30.0) -> int:
    """kill -9 and reap; returns the exit code (negative signal)."""
    os.kill(proc.pid, signal.SIGKILL)
    return proc.wait(timeout=wait)


def python_argv(script_path: str) -> List[str]:
    return [sys.executable, script_path]


def worker_argv(*args: str) -> List[str]:
    """argv of an online training worker: `python -m
    deeprec_tpu_torch.online.loop <args>` (pass `--device cpu` off CUDA)."""
    return [sys.executable, "-m", "deeprec_tpu_torch.online.loop", *map(str, args)]
