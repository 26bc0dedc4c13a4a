"""The online-learning loop: streaming train -> delta chain -> serve — the
port of `deeprec_tpu/online/loop.py`.

`TrainLoop` is the trainer half: consume batches from any iterable (a
TCPStreamReader following a broker, a FileTailReader, a WorkQueue
dataset, a synthetic generator), run `Trainer.train_step`, and emit
`save_incremental_async` on a cadence with periodic full re-anchors.
Every step stamps a lease-style heartbeat (online/supervisor.py) and the
loop honors the elastic EXIT_RESCALE contract: a posted scaling plan
checkpoints, acks, and returns the rescale exit code for the supervisor
to respawn at the new size. Save failures NEVER kill training — they are
logged, surfaced through the heartbeat, and self-heal via the
CheckpointManager's force-full escalation.

`ServeLoop` is the serving half: a Predictor + ModelServer (+ optional
HTTP front) whose poll thread survives any failure with capped jittered
backoff, quarantines corrupt deltas (serving through from the last good
snapshot), and stamps its health — staleness_seconds,
consecutive_poll_failures, last_good_version — into a heartbeat the
supervisor's wedge detection reads.

With a `GuardPolicy` the loop reads the step sentinel's flags one
dispatch late: each step's int32 flags scalar is copied with
`non_blocking=True` into a pinned host buffer behind a CUDA event, and the
next step waits on that event (long retired by then) before it reads the
buffer, so the sentinel adds no host synchronisation of its own. A tripped
step rolls the model back to the last verified checkpoint and replays the
window minus the poisoned batch (`guard/quarantine.py`).

Run a trainer worker as a process (what the supervisor spawns; on the CUDA
card unless `--device cpu`):

    python -m deeprec_tpu_torch.online.loop --ckpt DIR --steps 200 \
        --source tcp://127.0.0.1:9000 --batch-size 256 --save-every 10 \
        --heartbeat DIR/trainer.hb

It prints the line protocol tests assert on: FRESH | RESUMED <step>,
STEP <n> <loss>, SAVED <kind> <step>, DONE.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import torch

from deeprec_tpu_torch.data.pipeline import record_stall
from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.obs import trace as obs_trace
from deeprec_tpu_torch.online.supervisor import Heartbeat
from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE, ElasticCoordinator
from deeprec_tpu_torch.training.checkpoint import CheckpointManager

_log = logging.getLogger(__name__)


class TrainLoop:
    """Supervised continuous training over a batch stream.

    save cadence: every `save_every` steps; the first save and every
    `full_every`-th after it are FULL (chain anchors), the rest are
    incremental deltas — both on the async writer so the npz IO overlaps
    training. `on_step(step)` is the fault-injection seam (kill-at-step
    runs there, AFTER the step's save cadence fired, so a kill at a save
    step tests the async writer dying with the save in flight)."""

    def __init__(
        self,
        trainer,
        ckpt: CheckpointManager,
        batches: Iterable[Dict],
        save_every: int = 50,
        full_every: int = 10,
        heartbeat: Optional[Heartbeat] = None,
        coordinator: Optional[ElasticCoordinator] = None,
        elastic_every: int = 10,
        max_steps: Optional[int] = None,
        on_step: Optional[Callable[[int], None]] = None,
        log_every: int = 0,
        reader=None,
        guard=None,
        lr_fn: Optional[Callable[[int], float]] = None,
    ):
        self.trainer = trainer
        self.ckpt = ckpt
        self.batches = batches
        # Model-quality firewall (guard/): `guard` is a GuardPolicy and
        # requires the trainer to carry a step sentinel — the loop reads
        # the sentinel's one-dispatch-old flags scalar each step, rolls
        # back to the last verified checkpoint on a trip, dead-letters
        # the poisoned batch, and permanently quarantines repeat
        # offenders. `lr_fn(step)` optionally overrides the lr per step
        # (schedules, and the exploding-LR fault injector).
        self.guard = guard
        self.lr_fn = lr_fn
        self.dead_letter = None
        if guard is not None:
            if trainer is not None and getattr(trainer, "sentinel",
                                               None) is None:
                raise ValueError(
                    "TrainLoop(guard=) requires Trainer(sentinel="
                    "SentinelConfig(...)) — the rollback policy consumes "
                    "the on-device sentinel's flags"
                )
            from deeprec_tpu_torch.guard.quarantine import DeadLetter

            self.dead_letter = DeadLetter(
                guard.dead_letter_dir, guard.max_batch_trips
            )
        self.guard_trips = 0
        self.rollbacks = 0
        self.batches_skipped = 0
        self.replay_gaps = 0
        # Input-stall ledger: how long the training thread waited for a
        # batch (total + last dispatch). With a staged source this is a
        # queue pop — nonzero values mean the HOST pipeline is the
        # bottleneck (docs/data.md; deeprec_input_stall_seconds).
        self.input_stall_s = 0.0
        self.last_input_stall_s = 0.0
        # [(bad_step, detect_step, flags, kinds, fingerprint)] — the
        # detection ledger `chip_smoke.py` phase 20 matches injections
        # against (detect_step - bad_step is the latency in dispatches;
        # ≤ 1 by construction of the deferred flags read).
        self.trip_log: list = []
        self.last_rollback_ms: Optional[float] = None
        self.last_verified_step: Optional[int] = None
        self._guard_carry = None
        # (step, batch, fingerprint, parked flags): the parked flags are a
        # pinned host buffer and the event recorded after the copy into it
        self._pending = None
        self._flag_bufs = None  # two pinned int32 scalars, used in turn
        self._flag_turn = 0
        self._replay_buf: deque = deque()
        if heartbeat is None:
            # Supervisor contract (online/supervisor.py): a spawned
            # worker finds its lease file in DEEPREC_HEARTBEAT_FILE —
            # without this fallback a supervised worker that didn't
            # thread --heartbeat through would never stamp the lease and
            # be killed as wedged while perfectly healthy.
            hb_path = os.environ.get("DEEPREC_HEARTBEAT_FILE")
            if hb_path:
                heartbeat = Heartbeat(hb_path)
        self.save_every = max(1, int(save_every))
        self.full_every = max(1, int(full_every))
        self.heartbeat = heartbeat
        self.coordinator = coordinator
        self.elastic_every = max(1, int(elastic_every))
        self.max_steps = max_steps
        self.on_step = on_step
        self.log_every = log_every
        self.reader = reader  # optional: stream health rides the heartbeat
        self.saves = 0
        self.save_failures = 0
        self.last_save_step: Optional[int] = None
        self.last_save_error: Optional[str] = None
        # obs plane (process-wide registry; no-op singletons when off):
        # one counter inc per step is the whole per-step cost — the
        # counter's own ring answers steps/sec over any window, and the
        # gauge is refreshed at save cadence so scrapes between saves
        # stay free.
        reg = obs_metrics.default_registry()
        self._m_steps = reg.counter(
            "deeprec_train_steps", "training steps completed")
        self._m_step = reg.gauge(
            "deeprec_train_step", "current train step")
        self._m_steps_per_sec = reg.gauge(
            "deeprec_train_steps_per_sec",
            "training throughput over the trailing 30 s window")
        self._m_saves = reg.counter(
            "deeprec_train_saves", "cadence checkpoint saves")
        self._m_save_failures = reg.counter(
            "deeprec_train_save_failures", "cadence saves that failed")
        self._reg = reg
        if guard is not None:
            self._m_rollbacks = reg.counter(
                "deeprec_guard_rollbacks",
                "sentinel-tripped rollbacks to the last verified "
                "checkpoint")
            self._m_quarantined = reg.counter(
                "deeprec_guard_batches_quarantined",
                "batches permanently quarantined after repeated trips")
            self._m_last_verified = reg.gauge(
                "deeprec_guard_last_verified_step",
                "newest step whose sentinel flags read clean")
        # Whether the chain has (or will durably have — an async full may
        # still be in flight) an anchor; checking latest_full() alone
        # would race the background writer and over-anchor.
        self._anchored = ckpt.latest_full() is not None

    # ------------------------------------------------------------ helpers

    def _print(self, line: str) -> None:
        if self.log_every:
            print(line, flush=True)

    def _beat(self, step: int, status: str = "ok") -> None:
        if self.heartbeat is None:
            return
        extra = {
            "saves": self.saves,
            "save_failures": self.save_failures,
        }
        if self.guard is not None:
            # The guard-trip field the Supervisor reads to distinguish
            # "restart fixes it" from "the data poisons it" (a restart
            # budget cannot — replay hits the same poison forever).
            extra["guard_trips"] = self.guard_trips
            extra["rollbacks"] = self.rollbacks
            extra["batches_quarantined"] = self.dead_letter.permanent_count
            extra["last_verified_step"] = self.last_verified_step
        if self.reader is not None:
            extra["stream_connect_failures"] = getattr(
                self.reader, "consecutive_connect_failures", 0
            )
            extra["stream_reconnects"] = getattr(self.reader, "reconnects", 0)
        extra["input_stall_s"] = round(self.input_stall_s, 6)
        self.heartbeat.beat(step=step, status=status, **extra)

    def restore_or_init(self):
        """Resume from the (verified) chain, or start fresh — the worker
        restart entry point.

        FileNotFoundError means "fresh start" ONLY when no anchor exists
        on disk: a concurrent serving process can quarantine-rename a
        link between this process's chain verification and the np.load
        that reads it, which also surfaces as FileNotFoundError. That
        race retries (re-verification no longer lists the renamed dir);
        if the chain is still unreadable after retries we raise — a
        supervised restart beats silently training from step 0 over a
        live chain."""
        last_err = None
        for _ in range(3):
            try:
                state = self.ckpt.restore()
                self._print(f"RESUMED {int(state.step)}")
                return state
            except FileNotFoundError as e:
                if self.ckpt.latest_full() is None:
                    state = self.trainer.init(0)
                    self._print("FRESH")
                    return state
                last_err = e
                time.sleep(0.05)
        raise last_err

    def _save(self, state, step: int):
        """One cadence save; failures degrade (log + heartbeat), never
        raise into the train loop — the manager escalates the next save
        to full on a lost delta, so the chain self-heals."""
        # Full when the chain has no anchor yet (fresh dir, or everything
        # quarantined), else every full_every-th save of THIS process —
        # a restarted worker resumes on deltas, it doesn't re-anchor.
        want_full = (
            not self._anchored or (self.saves + 1) % self.full_every == 0
        )
        t0w = time.time()
        try:
            if want_full:
                state, path = self.ckpt.save_async(state)
                self._anchored = True
            else:
                state, path = self.ckpt.save_incremental_async(state)
            self.saves += 1
            self.last_save_step = step
            self.last_save_error = None
            self._m_saves.inc()
            self._m_step.set(step)
            self._m_steps_per_sec.set(self._m_steps.window_rate(30.0))
            obs_trace.phase_span(
                "ckpt_save_" + ("full" if want_full else "delta"),
                t0w, time.time(), cat="train")
            self._print(f"SAVED {os.path.basename(path).split('-')[0]} {step}")
        except Exception as e:
            self.save_failures += 1
            self.last_save_error = str(e)
            self._m_save_failures.inc()
            # A failed writer may have taken the would-be anchor with it;
            # re-derive from disk so the next cadence re-anchors if needed.
            self._anchored = self.ckpt.latest_full() is not None
            _log.warning("save at step %d failed (training continues): %s",
                         step, e)
            self._print(f"SAVE_FAILED {step}")
        return state

    # ----------------------------------------------- model-quality firewall

    def _train_one(self, state, batch, next_step: int):
        """One dispatched train step, with the lr schedule and the
        sentinel carry threaded through (device references only)."""
        kw = {}
        if self.lr_fn is not None:
            kw["lr"] = self.lr_fn(next_step)
        if self.guard is not None:
            kw["guard"] = self._guard_carry
        state, mets = self.trainer.train_step(state, batch, **kw)
        if self.guard is not None:
            from deeprec_tpu_torch.guard.sentinel import guard_carry

            self._guard_carry = guard_carry(mets)
        return state, mets

    def _park(self, flags: torch.Tensor):
        """Start the copy of a step's flags scalar to the host: on CUDA into
        one of two pinned buffers (the pending read holds the other) with
        `non_blocking=True`, then an event on the current stream. Returns
        (host tensor, event or None)."""
        if flags.device.type != "cuda":
            return flags, None
        if self._flag_bufs is None:
            self._flag_bufs = [torch.empty((), dtype=torch.int32, pin_memory=True)
                               for _ in range(2)]
        buf = self._flag_bufs[self._flag_turn]
        self._flag_turn ^= 1
        buf.copy_(flags, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    @staticmethod
    def _read_parked(parked) -> int:
        """The host value of parked flags: waits on their event (the copy
        was queued one dispatch ago, so it has landed), then reads."""
        buf, ev = parked
        if ev is not None:
            ev.synchronize()
        return int(buf)

    def _remember(self, step: int, batch, fp: str) -> None:
        """Append to the bounded replay buffer rollbacks resume from."""
        self._replay_buf.append((step, batch, fp))
        while len(self._replay_buf) > self.guard.replay_window:
            self._replay_buf.popleft()

    def _guard_check(self, state, step: int, batch, fp: str, mets):
        """Deferred sentinel read: park THIS step's flags, read the
        PREVIOUS dispatch's — by now materialized on the host side of an
        already-retired dispatch, so the read never stalls the pipeline
        (detection latency: exactly one dispatch). Returns the possibly
        rolled-back (state, step)."""
        prev, self._pending = (
            self._pending, (step, batch, fp, self._park(mets["guard_flags"]))
        )
        if prev is None:
            return state, step
        t, b_t, fp_t, fl = prev
        flags = self._read_parked(fl)
        if flags == 0:
            self.last_verified_step = t
            if self.guard is not None:
                self._m_last_verified.set(t)
            return state, step
        return self._guard_rollback(state, step, t, b_t, fp_t, flags)

    def _guard_flush(self, state, step: int):
        """Drain the deferred check at a loop boundary (end of stream,
        max_steps): the final dispatch's flags must be read before the
        final save can be trusted."""
        prev, self._pending = self._pending, None
        if prev is None:
            return state, step
        t, b_t, fp_t, fl = prev
        flags = self._read_parked(fl)
        if flags == 0:
            self.last_verified_step = t
            self._m_last_verified.set(t)
            return state, step
        return self._guard_rollback(state, step, t, b_t, fp_t, flags)

    def _record_trip(self, fp: str, step: int, flags: int, batch,
                     detect_step: Optional[int] = None) -> None:
        from deeprec_tpu_torch.guard.sentinel import flag_kinds

        kinds = flag_kinds(flags)
        self.trip_log.append(
            (step, detect_step if detect_step is not None else step,
             flags, kinds, fp)
        )
        self.guard_trips += 1
        for kind in kinds:  # bounded label set: the five sentinel bits
            self._reg.counter(
                "deeprec_guard_trips",
                "step-sentinel trips by tripped check", {"kind": kind},
            ).inc()
        permanent = self.dead_letter.record_trip(fp, step, flags, kinds,
                                                 batch)
        self._print(f"GUARD_TRIP {step} {flags} {','.join(kinds)}")
        if permanent:
            self._m_quarantined.inc()
            self._print(f"GUARD_QUARANTINE {fp}")
        _log.warning("guard: sentinel tripped at step %d (%s)%s", step,
                     ",".join(kinds),
                     " — batch permanently quarantined" if permanent else "")

    def _restore_verified(self):
        """Restore the chain tip (valid_chain semantics); a chain with
        nothing left restarts from step 0 — loud, never wedged.

        MODEL state only: `CheckpointManager.restore` also rewinds any
        registered dataset readers to the checkpoint's positions, but the
        rollback replays its window from the in-memory buffer — a
        rewound reader would re-deliver the same batches and the window
        would train TWICE (and a TCP reader's offset would undercount,
        replaying trained data across the next reconnect). Reader
        positions are pinned across the restore so the live stream
        resumes exactly where it was."""
        self.rollbacks += 1
        self._m_rollbacks.inc()
        # Detach registered readers for the duration: restore() must not
        # touch their positions at all (not even transiently — a reader
        # polling from another thread could read the rewound offset).
        readers = self.ckpt.datasets
        self.ckpt.datasets = {}
        try:
            return self.ckpt.restore()
        except FileNotFoundError:
            _log.warning("guard: no intact checkpoint predates the poison "
                         "— restarting from a fresh init")
            return self.trainer.init(0)
        finally:
            self.ckpt.datasets = readers

    def _guard_rollback(self, state, step: int, bad_step: int, bad_batch,
                        bad_fp: str, flags: int):
        """The semantic-fault recovery: dead-letter the batch, drop every
        chain link that may carry its update, restore the last verified
        checkpoint, and replay the buffered non-poisoned window — the
        result is bit-identical to a clean run minus the skipped batch
        (tests/test_torch_guard.py pins it on table contents)."""
        t0 = time.perf_counter()
        self._record_trip(bad_fp, bad_step, flags, bad_batch,
                          detect_step=step)
        self._pending = None
        self._guard_carry = None
        # Saves at or past the poisoned step captured poisoned state —
        # quarantine them (PR 7 rename discipline; _effective_kind then
        # escalates the next save to full, re-anchoring the chain).
        try:
            self.ckpt.wait()
        except RuntimeError:
            pass  # a lost async save is already escalated to full
        for kind in ("full", "incr"):
            for s in self.ckpt._list(kind):
                if s >= bad_step:
                    self.ckpt.quarantine(
                        os.path.join(self.ckpt.dir, f"{kind}-{s}"),
                        f"guard rollback past poisoned step {bad_step}",
                    )
        self._anchored = self.ckpt.latest_full() is not None
        state = self._restore_verified()
        s0 = int(state.step)
        # Replay the buffered window minus the poisoned batch. A tripped
        # REPLAYED batch is dead-lettered, dropped from the queue, and
        # the pass restarts from the same restored anchor (no saves run
        # during replay, so the anchor is stable); the queue shrinks by
        # one per trip, so this terminates.
        queue = [(b, f) for (s, b, f) in self._replay_buf
                 if s0 < s <= step and s != bad_step]
        expect = max(
            0, step - s0 - (1 if s0 < bad_step <= step else 0)
        )
        if len(queue) < expect:
            self.replay_gaps += 1
            _log.warning(
                "guard: replay buffer covers %d of %d rolled-back steps "
                "(GuardPolicy.replay_window too small for the save "
                "cadence) — resuming with a gap", len(queue), expect)
        while True:
            tripped = False
            cur = int(state.step)
            self._guard_carry = None
            for qi, (b, f) in enumerate(queue):
                state, mets = self._train_one(state, b, cur + 1)
                cur += 1
                # replay is the cold recovery path: a synchronous read
                fl = int(mets["guard_flags"])
                if fl:
                    self._record_trip(f, cur, fl, b)
                    queue = queue[:qi] + queue[qi + 1:]
                    state = self._restore_verified()
                    tripped = True
                    break
            if not tripped:
                break
        new_step = int(state.step)
        self._replay_buf = deque(
            (s0 + i + 1, b, f) for i, (b, f) in enumerate(queue)
        )
        self.last_rollback_ms = round((time.perf_counter() - t0) * 1e3, 3)
        self.last_verified_step = new_step
        self._m_last_verified.set(new_step)
        self._print(f"GUARD_ROLLBACK {bad_step} -> {new_step}")
        self._beat(new_step, status="degraded")
        return state, new_step

    # ---------------------------------------------------------------- run

    def run(self, state=None):
        """Returns (final_state, exit_code): 0 done, EXIT_RESCALE when a
        scaling plan was acked (caller exits with it; the supervisor
        respawns the new generation)."""
        if state is None:
            state = self.restore_or_init()
        # host-side step mirror (the port's TrainState.step is a host int)
        step = int(state.step)
        self._beat(step, status="running")
        guard_on = self.guard is not None
        batches = iter(self.batches)
        while True:
            # Batch acquisition is timed: with a staged source this is a
            # queue pop, so the wait IS the host-input stall — exported
            # per dispatch as deeprec_input_stall_seconds{site=train_loop}
            # and totalled into the heartbeat (input_stall_s).
            t0_in = time.perf_counter()
            try:
                batch = next(batches)
            except StopIteration:
                break
            wait = time.perf_counter() - t0_in
            self.input_stall_s += wait
            self.last_input_stall_s = wait
            record_stall("train_loop", wait)
            if self.max_steps is not None and step >= self.max_steps:
                break  # a resumed worker may already be at the target
            fp = None
            if guard_on:
                from deeprec_tpu_torch.guard.quarantine import batch_fingerprint

                fp = batch_fingerprint(batch)
                if self.dead_letter.is_quarantined(fp):
                    # The crash-loop breaker: a permanently quarantined
                    # batch never reaches the trainer again, across any
                    # number of restarts and stream replays.
                    self.batches_skipped += 1
                    self._print(f"GUARD_SKIP {fp}")
                    continue
            state, mets = self._train_one(state, batch, step + 1)
            step += 1
            self._m_steps.inc()
            if guard_on:
                self._remember(step, batch, fp)
                state, step = self._guard_check(state, step, batch, fp,
                                                mets)
            if self.log_every and step % self.log_every == 0:
                self._print(f"STEP {step} {float(mets['loss']):.5f}")  # log cadence
            if step % self.save_every == 0:
                state = self._save(state, step)
            self._beat(
                step,
                status="ok" if self.last_save_error is None else "degraded",
            )
            if self.coordinator is not None and step % self.elastic_every == 0:
                target = self.coordinator.should_scale()
                if target is not None:
                    # Elastic contract: durable checkpoint, ack, planned
                    # exit — the supervisor respawns at the new size.
                    try:
                        self.ckpt.wait()
                    except RuntimeError:
                        pass  # lost async delta: the sync full below re-anchors
                    state, _ = self.ckpt.save(state)
                    self.coordinator.ack_rescale()
                    self._print(f"RESCALE {step} -> {target}")
                    return state, EXIT_RESCALE
            if self.on_step is not None:
                self.on_step(step)
            if self.max_steps is not None and step >= self.max_steps:
                break
        if guard_on:
            # The final dispatch's flags are still pending — read them
            # before trusting the final save with its state.
            state, step = self._guard_flush(state, step)
        # Drain the writer and flush rows dirtied since the last cadence
        # save, so a clean exit leaves a chain as fresh as training got.
        try:
            self.ckpt.wait()
            if self.last_save_step != step:
                state = self._save(state, step)
                self.ckpt.wait()
        except Exception as e:
            self.save_failures += 1
            self.last_save_error = str(e)
            _log.warning("final save failed: %s", e)
        self._beat(step, status="done")
        self._print("DONE")
        return state, 0


def wait_for_full_checkpoint(ckpt_dir: str, timeout: float = 120.0,
                             poll_secs: float = 0.25) -> None:
    """Block until some full checkpoint is committed under `ckpt_dir` —
    serving can only boot from an anchor. Raises TimeoutError."""
    import re

    deadline = time.monotonic() + timeout
    pat = re.compile(r"^full-(\d+)$")
    while True:
        try:
            names = os.listdir(ckpt_dir)
        except OSError:
            names = []
        for d in names:
            if pat.match(d) and os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")
            ):
                return
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no full checkpoint appeared under {ckpt_dir} "
                f"within {timeout}s"
            )
        time.sleep(poll_secs)


class ServeLoop:
    """Serving half of the loop: poll the delta chain under live load.

    Wraps Predictor + ModelServer (+ HttpServer when `http_port` is not
    None; 0 picks a free port) with a poll thread that:
      * NEVER dies — failures back off (capped, jittered) and retry;
      * quarantines corrupt deltas via the manager and keeps serving the
        last good snapshot (degraded-serving contract);
      * stamps every round's health into `heartbeat` for the
        supervisor's wedge detection (a wedged poller stops beating; a
        failing one beats with status="degraded" — distinguishable).
    `pause()`/`resume()` gate the polling for deterministic fault tests
    (corrupt a delta BEFORE the poller can apply it)."""

    def __init__(
        self,
        model,
        ckpt_dir: str,
        poll_secs: float = 0.5,
        heartbeat: Optional[Heartbeat] = None,
        http_port: Optional[int] = None,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        device=None,
        stores: Optional[Dict] = None,
        max_backoff_secs: float = 10.0,
        wait_for_checkpoint_secs: float = 0.0,
        quality_gate=None,
    ):
        from deeprec_tpu_torch.serving.http_server import HttpServer
        from deeprec_tpu_torch.serving.predictor import ModelServer, Predictor

        if wait_for_checkpoint_secs > 0:
            wait_for_full_checkpoint(ckpt_dir, wait_for_checkpoint_secs)
        self.predictor = Predictor(model, ckpt_dir, stores=stores,
                                   device=device, quality_gate=quality_gate)
        self.server = ModelServer(self.predictor, max_batch=max_batch,
                                  max_wait_ms=max_wait_ms)
        self.http = None
        if http_port is not None:
            self.http = HttpServer(self.server, port=http_port).start()
        self.heartbeat = heartbeat
        self.poll_secs = poll_secs
        self.max_backoff_secs = max_backoff_secs
        self.poll_rounds = 0
        self.update_failures = 0
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread = threading.Thread(
            target=self._poll_loop, daemon=True, name="serve-poll"
        )
        self._thread.start()

    # ------------------------------------------------------------ polling

    def _poll_loop(self) -> None:
        # The shared survivability loop (predictor._run_poll_loop: never
        # dies, capped jittered backoff); this class only adds the pause
        # gate and the per-round heartbeat stamp.
        from deeprec_tpu_torch.serving.predictor import _run_poll_loop

        _run_poll_loop(self, self._stop, self.poll_secs,
                       max_backoff_secs=self.max_backoff_secs,
                       pause=self._paused, on_round=self._on_round)

    def _on_round(self, status: str) -> None:
        self.poll_rounds += 1
        if self.heartbeat is None:
            return
        # The heartbeat payload IS the unified health schema
        # (obs/schema.py — the predictor emits it), re-stamped with the
        # poll round's own status; historical keys ride along as
        # canonical members, so existing readers keep working.
        h = self.predictor.health()
        h["status"] = status if status != "ok" else h["status"]
        self.heartbeat.beat(**h)

    def pause(self) -> None:
        self._paused.set()

    def resume(self) -> None:
        self._paused.clear()

    def poll_now(self) -> bool:
        """Synchronous poll (test/bench convenience; same lock as the
        background thread, so it composes)."""
        return self.predictor.poll_updates()

    # ------------------------------------------------------------ facade

    def request_versioned(self, features, timeout: float = 30.0):
        return self.server.request_versioned(features, timeout=timeout)

    def warmup(self, example) -> int:
        return self.server.warmup(example)

    def health(self) -> Dict:
        return self.predictor.health()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self.http is not None:
            self.http.stop()
        self.server.close()


# -------------------------------------------------------- worker entry


def _build_reader(source: str, batch_size: int, num_dense: int,
                  num_cat: int):
    """'synthetic' | 'tcp://host:port' | 'tail:path' -> (iterable, reader
    or None). The tcp reader is returned for offset checkpointing."""
    if source.startswith("tcp://"):
        from deeprec_tpu_torch.data.stream import TCPStreamReader

        host, port = source[len("tcp://"):].rsplit(":", 1)
        r = TCPStreamReader(host, int(port), batch_size=batch_size,
                            num_dense=num_dense, num_cat=num_cat,
                            reconnect_secs=0.2)
        return iter(r), r
    if source.startswith("tail:"):
        from deeprec_tpu_torch.data.stream import FileTailReader

        r = FileTailReader(source[len("tail:"):], batch_size=batch_size,
                           num_dense=num_dense, num_cat=num_cat,
                           poll_secs=0.1)
        return iter(r), r
    from deeprec_tpu_torch.data import SyntheticCriteo

    gen = SyntheticCriteo(batch_size=batch_size, num_cat=num_cat,
                          num_dense=num_dense, vocab=500, seed=0)

    def batches():
        while True:
            yield gen.batch()

    return batches(), None


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="online training worker")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--source", default="synthetic",
                   help="synthetic | tcp://host:port | tail:path")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--save-every", type=int, default=10)
    p.add_argument("--full-every", type=int, default=10)
    p.add_argument("--heartbeat",
                   default=os.environ.get("DEEPREC_HEARTBEAT_FILE"))
    p.add_argument("--elastic-dir",
                   default=os.environ.get("DEEPREC_ELASTIC_DIR"))
    p.add_argument("--num-cat", type=int, default=2)
    p.add_argument("--num-dense", type=int, default=2)
    p.add_argument("--emb-dim", type=int, default=4)
    p.add_argument("--capacity", type=int, default=1 << 12)
    p.add_argument("--lr", type=float, default=0.2)
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) | cpu: without CUDA, pass --device cpu")
    args = p.parse_args(argv)

    from deeprec_tpu_torch import resolve_device
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.online import faults
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    device = resolve_device(args.device)  # raises without CUDA unless cpu
    hb = Heartbeat(args.heartbeat) if args.heartbeat else None
    if hb is not None:
        hb.beat(status="booting")  # leases start before the first kernel build

    model = WDL(emb_dim=args.emb_dim, capacity=args.capacity, hidden=(16,),
                num_cat=args.num_cat, num_dense=args.num_dense)
    tr = Trainer(model, Adagrad(lr=args.lr), adam(5e-3), device=device)
    batches, reader = _build_reader(args.source, args.batch_size,
                                    args.num_dense, args.num_cat)
    datasets = {"stream": reader} if reader is not None else None
    ck = CheckpointManager(args.ckpt, tr, datasets=datasets)
    coord = (
        ElasticCoordinator(args.elastic_dir) if args.elastic_dir else None
    )
    loop = TrainLoop(
        tr, ck, batches, save_every=args.save_every,
        full_every=args.full_every, heartbeat=hb, coordinator=coord,
        max_steps=args.steps, on_step=faults.env_kill_step(),
        log_every=args.log_every, reader=reader,
    )
    _, code = loop.run()
    return code


if __name__ == "__main__":
    raise SystemExit(main())
