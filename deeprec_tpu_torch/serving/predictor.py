"""Serving: a predictor with zero-stall full and delta model updates, and
the micro-batching server in front of it — the port of
`deeprec_tpu/serving/predictor.py`.

  * `Predictor(model, ckpt_dir)` restores the verified checkpoint chain
    onto the device and answers `predict(batch)`: the read-only lookup of
    every bundle (dedup, probe, the row-gather kernel #3 — #1 on a bf16
    residency — or plain indexing and a dequantize on an int8 one), the
    pooled bags through kernel #4, the model forward and a sigmoid.
    `quantize=` picks the residency (f32, bf16, int8 rows with a per-row
    scale); `stores=` reads missing keys through a feature store;
    `group_users=True` runs a two-tower model's user tower once per
    distinct user.
  * `poll_updates()` applies what is new in the checkpoint directory: a
    newer full save is a full reload, new deltas replay through
    `CheckpointManager.restore_into` onto a SHADOW state (the live one is
    never written), a quality gate (`guard.canary.QualityGate`) may
    reject the result, and one reference swap publishes it. The predict
    path takes no lock: it reads one immutable `_Snapshot` (version,
    state), so a request is served from one model version. On the card an
    update runs on a CUDA stream of its own, so the requests' kernels do
    not queue behind it; they still share the card's time with it.
  * `ModelServer` coalesces single requests into device batches: a batch
    flushes when its bucket (a power of two up to `max_batch` rows) is
    full or an arrival-rate-tuned deadline passes. On the card the
    Predictor runs its dense model at `READ_ROWS` rows per call, so a row's
    answer does not depend on its batch; the server's ladder is then
    `max_batch` alone and the Predictor's padding the only one. `ServerGroup` puts one
    member per distinct device behind one shared queue; on one card it is
    one member.

Retrieval (`attach_retrieval`) is a later slice of the port (ROADMAP
queue A item 7).
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import os
import queue
import random
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.embedding.table import EmbeddingTable
from deeprec_tpu_torch.obs import metrics as obs_metrics
from deeprec_tpu_torch.obs import schema as obs_schema
from deeprec_tpu_torch.obs import trace as obs_trace
from deeprec_tpu_torch.ops import traffic
from deeprec_tpu_torch.serving.stats import ServingStats
from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer, TrainState
from deeprec_tpu_torch.utils import backoff as _backoff
# Re-export: the serving API surface of the vectorised pad.
from deeprec_tpu_torch.utils.ragged import pad_ragged  # noqa: F401

_log = logging.getLogger(__name__)

# On the card a Predictor runs its dense model at this many rows per call
# (`nn.fixed_rows`: rows padded by repeating the last one, larger batches in
# slices). cuBLAS picks its GEMM algorithm by the row count, and one flipped
# last bit before a bf16 operand rounding moves a probability by about
# 1e-4, so otherwise a served row's answer would depend on what it was
# batched with. On the CPU the answers agree within 1e-6 as they are.
READ_ROWS = 2048

_RETRIEVAL_SLICE = (
    "retrieval (serving/retrieval.py with ops/topk.py) is the next slice of "
    "the port's serving breadth, ROADMAP queue A item 7")


class BadRequest(ValueError):
    """Client-side request error, with a structured payload for frontends
    that return machine-readable error bodies (HTTP, C ABI)."""

    def __init__(self, message: str, **details):
        super().__init__(message)
        self.details = {"error": message, **details}


def parse_features(predictor: "Predictor", feats: Dict) -> Dict[str, np.ndarray]:
    """Validate and coerce a wire-format feature dict (JSON-shaped lists or
    arrays) into a model batch, before the coalescing queue, so one bad
    request cannot poison the requests batched with it. Raises BadRequest.

    Id features pad or trim ragged bags to the feature's `max_len` with its
    pad value; dense features become [B, W] float32; every feature must
    have the same row count. The firewall: non-finite dense values REJECT
    the request, negative ids other than the pad value CLAMP to the pad;
    both are counted per kind into `predictor.record_errors`."""
    if not isinstance(feats, dict) or not feats:
        raise BadRequest("missing 'features' object")
    dtypes = predictor.feature_dtypes
    unknown = sorted(set(feats) - set(dtypes))
    missing = sorted(set(dtypes) - set(feats))
    if unknown or missing:
        raise BadRequest("feature-name mismatch", unknown=unknown,
                         missing=missing)
    specs = {f.name: f for f in predictor._trainer.sparse_specs}
    batch = {}
    for k, v in feats.items():
        want = dtypes[k]
        try:
            if want.kind in "iu":
                f = specs[k]
                L = f.max_len
                if L and isinstance(v, list) and v and isinstance(v[0], list):
                    over = sum(max(0, len(r) - L) for r in v)
                    if over:  # bag ids past max_len are dropped, counted
                        predictor.count_record_error("oversized_bag", over)
                    arr = pad_ragged(v, L, f.pad_value, want)
                else:
                    arr = np.asarray(v).astype(want)
                    if L:
                        if arr.ndim == 1:
                            arr = arr[:, None]
                        if arr.shape[1] < L:
                            pad = np.full((arr.shape[0], L - arr.shape[1]),
                                          f.pad_value, want)
                            arr = np.concatenate([arr, pad], axis=1)
                        else:
                            arr = arr[:, :L]
            else:
                arr = np.asarray(v).astype(np.float32)
                if arr.ndim == 1:
                    arr = arr[:, None]  # dense features are [B, W]
        except (TypeError, ValueError) as e:
            # numpy coercion of garbage values: the client's fault
            raise BadRequest(f"feature {k!r}: cannot coerce to {want}: {e}",
                             feature=k) from e
        if want.kind in "iu":
            f = specs[k]
            bad = (arr < 0) & (arr != f.pad_value)
            if bad.any():
                predictor.count_record_error("bad_id", int(bad.sum()))
                arr = np.where(bad, np.asarray(f.pad_value, arr.dtype), arr)
        else:
            nf = ~np.isfinite(arr)
            if nf.any():
                predictor.count_record_error("nonfinite_float", int(nf.sum()))
                raise BadRequest(
                    f"feature {k!r}: {int(nf.sum())} non-finite value(s)",
                    feature=k)
        batch[k] = arr
    rows = {k: a.shape[0] for k, a in batch.items()}
    if len(set(rows.values())) > 1:
        raise BadRequest("inconsistent feature row counts", rows=rows)
    return batch


class _Snapshot(NamedTuple):
    """The unit of atomicity of the serving hot path: readers grab ONE
    reference to this immutable pair and serve the whole request from it,
    so a concurrent update never produces a torn read. `version` bumps on
    every published update."""

    version: int
    state: TrainState


class _ArrivalEWMA:
    """EWMA of request inter-arrival time and rows per request — what the
    adaptive batcher tunes its coalescing deadline from. One instance may
    be shared by every member of a ServerGroup."""

    ALPHA = 0.1

    def __init__(self):
        self._lock = threading.Lock()
        self._last = None
        self._tau = None
        self._rows = None

    def note(self, t: float, rows: int) -> None:
        with self._lock:
            if self._last is not None:
                dt = max(t - self._last, 0.0)
                self._tau = (dt if self._tau is None
                             else (1 - self.ALPHA) * self._tau + self.ALPHA * dt)
            self._last = t
            self._rows = (float(rows) if self._rows is None
                          else (1 - self.ALPHA) * self._rows + self.ALPHA * rows)

    def estimate(self) -> Tuple[Optional[float], float]:
        """(mean inter-arrival seconds or None, mean rows per request)."""
        with self._lock:
            return self._tau, self._rows or 1.0


def _pow2(n: int) -> int:
    """The power of two at or above n (1 for n <= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _pad_rows(v: np.ndarray, rows: int) -> np.ndarray:
    """v padded to `rows` rows by repeating its last row (a grouped batch's
    distinct-user count is unchanged: the padding user already exists)."""
    v = np.asarray(v)
    if rows > v.shape[0]:
        v = np.concatenate([v, np.repeat(v[-1:], rows - v.shape[0], axis=0)])
    return v


def _to_host(probs, rows: Optional[int] = None):
    """Probabilities (a tensor or {task: tensor}) as numpy, the first
    `rows` rows: the device-to-host copy that ends a request."""
    if isinstance(probs, dict):
        return {t: _to_host(p, rows) for t, p in probs.items()}
    out = probs.cpu().numpy()
    return out if rows is None else out[:rows]


class Predictor:
    """Load-latest-and-serve on one device (`cuda` unless `device="cpu"`;
    raises without CUDA when no device is given). Thread-safe; updates
    swap atomically.

    The hot path is lock-free: `predict` reads one `_Snapshot` reference
    and never blocks on an in-flight update. `poll_updates` / `reload`
    serialise among THEMSELVES with `_lock`, build the next state to the
    side (`CheckpointManager.restore_into` / `restore(chunk=)`, at a fixed
    import chunk), run the registered warm batches against it, then
    publish the new snapshot.

    `stores` optionally maps table names to a feature store with
    ``get(keys) -> (values, freq, version, found)`` (the `native.HostKV`
    signature): keys missing from the device table serve the store's row
    instead of the table's default.
    """

    QUANTIZE_MODES = {
        None: "float32", "fp32": "float32", "float32": "float32",
        "bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8",
    }

    def __init__(self, model, ckpt_dir: str, stores: Optional[Dict] = None,
                 device=None, restore_chunk="auto", quantize=None,
                 quality_gate=None):
        self.model = model
        # No sparse optimizer: a serving trainer restores no slot arrays.
        self._trainer = Trainer(model, device=device)
        self.device = self._trainer.device
        # the rows per dense-model call (None: the batch's own), and with it
        # the one padding layer: ModelServer does not pad when this is set
        self.read_rows = READ_ROWS if self.device.type == "cuda" else None
        # Quantized residency (train f32, serve bf16 or int8 + per-row
        # scale): this predictor's PRIVATE bundles are rebuilt with the
        # residency dtype before anything restores. The checkpoint stays f32
        # on disk, import_rows quantizes on the way in, every gather
        # dequantizes; the model object is untouched.
        if quantize not in self.QUANTIZE_MODES:
            raise ValueError(
                f"quantize must be one of "
                f"{sorted(k or 'None' for k in self.QUANTIZE_MODES)}, got {quantize!r}")
        self.quantize = self.QUANTIZE_MODES[quantize]
        if self.quantize != "float32":
            for b in self._trainer.bundles.values():
                b.table = EmbeddingTable(
                    dataclasses.replace(b.table.cfg, value_dtype=self.quantize))
        self._ck = CheckpointManager(ckpt_dir, self._trainer)
        if restore_chunk == "auto":
            # every import slice pads to the chunk: a floor of 4096, scaled
            # up for big tables so a full reload stays about 16 slices
            cap = max((t.cfg.capacity for t in self._trainer.tables.values()),
                      default=4096)
            restore_chunk = max(4096, _pow2(max(cap // 16, 1)))
        self._snap: Optional[_Snapshot] = None
        self._restore_chunk = int(restore_chunk)
        self._applied: set = set()
        # serialises UPDATERS only (poll_updates, reload, /v1/reload); the
        # predict path never takes it
        self._lock = threading.RLock()
        self.stores = dict(stores or {})
        self.update_count = 0
        self.last_update_ms = 0.0
        # Poll health (/v1/stats, /healthz): consecutive_poll_failures
        # counts poll_updates calls that raised since the last success;
        # last_poll_ok_time is the last moment a poll round CONFIRMED the
        # served model is as fresh as the checkpoint directory;
        # last_good_version is the version that confirmation served.
        self.consecutive_poll_failures = 0
        self.last_good_version = 0
        self.last_poll_ok_time = time.monotonic()
        self.last_update_time = time.monotonic()
        # Train-to-serve lag of the LAST applied update: the wall-clock age
        # of the newest applied checkpoint's manifest at swap time. None
        # until the first update after boot.
        self.last_apply_lag_seconds: Optional[float] = None
        # parse_features firewall counters, mirrored into
        # deeprec_record_errors{kind}
        self.record_errors: Dict[str, int] = {}
        # Test seam: called after the next state is built and warmed, just
        # before the snapshot swap.
        self._pre_swap: Optional[Callable[[], None]] = None
        self._warm_batches: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._local = threading.local()  # each thread's model replica
        self._stream = None  # the updates' CUDA stream, made at first use
        # Pre-swap canary: every update evaluates the gate's probe batch on
        # the SHADOW state before the swap; a failing update is quarantined
        # and the old snapshot keeps serving (health() degraded).
        self.quality_gate = quality_gate
        self._gate_blocked = False
        # compute-reuse caches (serving/reuse.py): every publish drops
        # their stale-version entries inside the same updater round
        self._reuse_caches: List = []
        self._m_gate_rejections = None
        if quality_gate is not None and obs_metrics.metrics_enabled():
            self._m_gate_rejections = obs_metrics.default_registry().counter(
                "deeprec_quality_gate_rejections",
                "model updates rejected by the pre-swap canary")
        self.reload()
        # Run the delta replay's pieces once now (a chunked import that
        # places nowhere, a prune rebuild), so the first poll under live
        # traffic pays no first-use cost.
        self._ck.warm_replay(self._snap.state, self._restore_chunk)
        if quality_gate is not None:
            # the boot snapshot's probe predictions are the first reference
            quality_gate.set_reference(self._gate_probs(self._snap.state))

    # ------------------------------------------------------------- updates

    @property
    def _state(self) -> TrainState:
        """The live state (tests, tooling)."""
        return self._snap.state

    @property
    def version(self) -> int:
        """Monotonic model version: bumps on every published update."""
        return self._snap.version

    @property
    def step(self) -> int:
        return int(self._snap.state.step)

    def reload(self) -> bool:
        """Full reload from the latest checkpoint chain, built off the
        serving path, gated by the canary, then swapped in. Returns whether
        a new snapshot published (False: the quality gate rejected it and
        the old snapshot keeps serving)."""
        with self._lock, self._update_stream():
            # List BEFORE restoring: a delta landing mid-restore stays
            # unapplied and the next poll picks it up.
            dirs = set(self._dirs())
            state = self._ck.restore(chunk=self._restore_chunk)
            reason = self._gate_reason(state)
            if reason is not None:
                self._gate_reject(sorted(dirs - self._applied), reason)
                return False
            self._publish(state, dirs)
            self._gate_blocked = False
            return True

    def attach_retrieval(self, engine) -> None:
        raise NotImplementedError(_RETRIEVAL_SLICE)

    def attach_reuse_cache(self, cache) -> None:
        """Register a ReuseCache for publish-edge invalidation: every
        snapshot swap drops its stale-version entries."""
        self._reuse_caches.append(cache)

    # ----------------------------------------------- pre-swap quality gate

    def _gate_probs(self, state: TrainState):
        """Probe-batch predictions (numpy) on any state, at one fixed shape;
        no store read-through (the canary judges the MODEL)."""
        return _to_host(self._predict_impl(state, self.quality_gate.probe))

    def _gate_reason(self, state: TrainState) -> Optional[str]:
        """None when the shadow state passes the canary (its probe
        predictions then become the next reference); else the rejection
        reason. The gate arms once a snapshot serves: at boot there is
        nothing older to keep serving."""
        from deeprec_tpu_torch.guard.canary import QualityGateRejected

        gate = self.quality_gate
        if gate is None or self._snap is None:
            return None
        probs = self._gate_probs(state)
        try:
            gate.check(probs)
        except QualityGateRejected as e:
            return e.reason
        gate.set_reference(probs)
        return None

    def _gate_reject(self, dirnames, reason: str) -> None:
        """Quarantine the update's directories (the trainer's next save
        re-anchors past them) and report the degraded-by-choice state: the
        old snapshot serves and health() says why."""
        for d in dirnames:
            self._ck.quarantine(os.path.join(self._ck.dir, d),
                                f"quality gate: {reason}")
        self._gate_blocked = True
        if self._m_gate_rejections is not None:
            self._m_gate_rejections.inc()
        _log.warning("quality gate rejected update (%s): quarantined %s — "
                     "serving the previous snapshot", reason, list(dirnames))

    def _publish(self, state: TrainState, applied: set) -> None:
        """Warm-then-swap: run every registered warm batch against the
        INCOMING state on the updater thread, then replace the snapshot
        reference — the only write the serving path ever sees."""
        self._warm_state(state)
        if self.device.type == "cuda":
            # the next state's writes (an update's side stream) land before
            # any request can read it
            torch.cuda.current_stream(self.device).synchronize()
        if self._pre_swap is not None:
            self._pre_swap()
        prev = self._snap
        self._snap = _Snapshot(prev.version + 1 if prev else 0, state)
        self._applied = set(applied)
        # the swap made every cached answer un-hittable (keys carry the
        # version); this reclaims the bytes on the publish edge
        for c in self._reuse_caches:
            c.invalidate_stale()

    def _update_stream(self):
        """On the card, a CUDA stream of the updater's own: a replay's
        copies, imports, warm and gate passes queue behind neither the
        requests' kernels nor a trainer's in the same process, and its host
        syncs wait for its own work only. The next state is read by
        requests only after `_publish` has synchronised this stream, and
        every request ends in a synchronous device-to-host copy while it
        holds the snapshot it read, so no request still reads a state when
        its memory returns to this stream's pool."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _warm_state(self, state: TrainState) -> None:
        # list(): a concurrent warmup() may register new buckets mid-walk
        for b in list(self._warm_batches.values()):
            if self.stores:
                _to_host(self._predict_with_stores(state, self._device_batch(b)))
            else:
                _to_host(self._predict_impl(state, b))

    def register_warm_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """Remember one example batch per shape signature; every future
        update runs these against the incoming state before the swap
        (ModelServer.warmup registers its whole bucket ladder)."""
        sig = tuple(sorted((k, np.asarray(v).shape, str(np.asarray(v).dtype))
                           for k, v in batch.items()))
        with self._lock:
            if sig not in self._warm_batches:
                self._warm_batches[sig] = {k: np.asarray(v) for k, v in batch.items()}

    def _dirs(self) -> List[str]:
        """Basenames of the VERIFIED checkpoint chain (corrupt links are
        quarantined on the way and never returned)."""
        return self._ck.chain_dirs()

    def poll_updates(self) -> bool:
        """Apply anything new: a newer full save triggers a full reload;
        new deltas replay onto a SHADOW copy of the live state. Returns
        True if the model changed. The whole check-then-act runs under the
        updater lock, so a stale delta never replays over a newer reload.

        Only verified directories are considered (a corrupt delta is
        quarantined and skipped); a verified delta whose replay fails is
        quarantined too and the chain stops there. An exception bumps
        `consecutive_poll_failures` and re-raises; `_run_poll_loop`
        retries with capped backoff."""
        t0 = time.perf_counter()
        t0w = time.time()
        try:
            with self._lock, self._update_stream():
                changed = self._poll_locked(t0)
        except BaseException:
            self.consecutive_poll_failures += 1
            raise
        self.consecutive_poll_failures = 0
        self.last_poll_ok_time = time.monotonic()
        self.last_good_version = self._snap.version
        if changed:
            obs_trace.phase_span("delta_poll", t0w, time.time(), cat="online")
        return changed

    def _stamp_apply_lag(self, dirnames) -> None:
        """The wall-clock age of the freshest checkpoint this round applied
        (manifest mtime: the trainer's commit); a failed stat never fails
        the update."""
        newest = None
        for d in dirnames:
            try:
                m = os.path.getmtime(os.path.join(self._ck.dir, d, "manifest.json"))
            except OSError:
                continue
            if newest is None or m > newest:
                newest = m
        if newest is not None:
            self.last_apply_lag_seconds = round(max(0.0, time.time() - newest), 3)

    def _poll_locked(self, t0: float) -> bool:
        new = [d for d in self._dirs() if d not in self._applied]
        if not new:
            return False
        if any(d.startswith("full-") for d in new):
            if not self.reload():
                return False  # gate-rejected: the old snapshot keeps serving
            self._stamp_apply_lag(new)
        else:
            state = self._snap.state
            applied = set(self._applied)
            replayed: List[str] = []
            for d in sorted(new, key=lambda s: int(s.split("-")[1])):
                path = os.path.join(self._ck.dir, d)
                try:
                    state = self._ck.restore_into(state, path,
                                                  chunk=self._restore_chunk)
                except Exception as e:
                    # verified yet failed to replay: quarantine it and stop
                    # at the gap; what already replayed still publishes
                    self._ck.quarantine(path, f"delta replay failed: {e}")
                    break
                applied.add(d)
                replayed.append(d)
            if not replayed:
                return False
            reason = self._gate_reason(state)
            if reason is not None:
                # the shadow state is dropped, the replayed dirs leave the
                # chain, the live snapshot is untouched
                self._gate_reject(replayed, reason)
                return False
            self._publish(state, applied)
            self._gate_blocked = False
            self._stamp_apply_lag(replayed)
        self.update_count += 1
        self.last_update_time = time.monotonic()
        self.last_update_ms = round((time.perf_counter() - t0) * 1e3, 3)
        return True

    def count_record_error(self, kind: str, n: int = 1) -> None:
        """Account one parse_features clamp or reject (a bounded set of
        kinds)."""
        self.record_errors[kind] = self.record_errors.get(kind, 0) + n
        if obs_metrics.metrics_enabled():
            obs_metrics.default_registry().counter(
                "deeprec_record_errors",
                "malformed input records rejected/clamped by kind",
                {"kind": kind}).inc(n)

    def health(self) -> Dict:
        """Liveness and freshness for watchdogs — the `/healthz` body, in
        the one obs schema (obs/schema.py). `staleness_seconds` is the age
        of the last successful poll round, not of the last model change. A
        quality-gate rejection still holding freshness back reports
        ``degraded`` with ``degraded_reason: quality_gate``."""
        now = time.monotonic()
        status = "ok" if self.consecutive_poll_failures == 0 else "degraded"
        extra = {}
        if self.quality_gate is not None:
            extra["quality_gate_rejections"] = self.quality_gate.rejections
            if self.quality_gate.last_rejection is not None:
                extra["last_quality_rejection"] = self.quality_gate.last_rejection
            if self._gate_blocked and status == "ok":
                status = "degraded"
                extra["degraded_reason"] = "quality_gate"
        return obs_schema.health_payload(
            status,
            model_version=self.version,
            step=self.step,
            staleness_seconds=round(now - self.last_poll_ok_time, 3),
            last_update_age_seconds=round(now - self.last_update_time, 3),
            consecutive_poll_failures=self.consecutive_poll_failures,
            last_good_version=self.last_good_version,
            quarantined=self._ck.quarantine_count,
            train_to_serve_lag_seconds=self.last_apply_lag_seconds,
            **extra,
        )

    # ------------------------------------------------------------- predict

    def _module(self):
        """This thread's replica of the model. `functional_call` swaps a
        module's parameters while it runs, so two threads must never run
        one module object at once: the batcher, the updater's warm and gate
        passes, and a trainer that shares the model object each run their
        own. The replica's parameters sit on the meta device (no memory):
        every call swaps a state's `dense` in."""
        m = getattr(self._local, "module", None)
        if m is None:
            memo = {id(p): torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                              requires_grad=p.requires_grad)
                    for p in self.model.parameters()}
            m = self._local.module = copy.deepcopy(self.model, memo)
        return m

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The model's input features as tensors on the device (labels and
        other keys are not read)."""
        return {k: (batch[k] if torch.is_tensor(batch[k])
                    else torch.as_tensor(np.asarray(batch[k]))).to(self.device)
                for k in self._trainer.input_keys()}

    def predict(self, batch: Dict[str, np.ndarray], group_users: bool = False):
        """Probabilities [B] (numpy) for one batch; a {task: probabilities}
        dict for a multi-task model."""
        return self.predict_versioned(batch, group_users)[0]

    def predict_versioned(self, batch: Dict[str, np.ndarray],
                          group_users: bool = False):
        """(probabilities, model_version): the version is read WITH the
        state, so the pair certifies which model produced the answer.

        group_users=True is sample-aware compression for tower models
        (`user_feats` / `user_vector` / `apply_with_user`, as DSSM): rows of
        a ``<user, N items>`` batch that share their user-feature values run
        the user tower once per distinct user. Groups are padded to a power
        of two, and so are rows (the padding repeats the last row) where
        the dense model runs at the batch's own rows; on the card it runs
        at `read_rows` rows per call instead. So the shapes a later CUDA
        graph would see are few. Ignores feature stores."""
        snap = self._snap  # ONE read; the whole request uses it
        if group_users:
            self._check_towers()
            jb, b, g = self._grouped_batch(batch)
            probs = self._predict_grouped_impl(snap.state, jb, g)
            return _to_host(probs, b), snap.version
        jb = self._device_batch(batch)
        if self.stores:
            probs = self._predict_with_stores(snap.state, jb)
        else:
            probs = self._predict_impl(snap.state, jb)
        return _to_host(probs), snap.version

    def _check_towers(self) -> None:
        if not hasattr(self.model, "apply_with_user"):
            raise ValueError(
                f"{type(self.model).__name__} has no user/item tower split "
                "(needs user_feats/user_vector/apply_with_user)")

    def _grouped_batch(self, batch):
        """(device batch padded to the row bucket, true rows, group bucket):
        the distinct-user count is taken on the host before dispatch."""
        cols = np.concatenate(
            [np.asarray(batch[n]).reshape(len(np.asarray(batch[n])), -1)
             for n in self.model.user_feats], axis=1)
        b = cols.shape[0]
        bp = self._row_bucket(b)
        g = min(_pow2(len(np.unique(cols, axis=0))), bp)
        return self._device_batch({k: _pad_rows(v, bp) for k, v in batch.items()}), b, g

    def _row_bucket(self, rows: int) -> int:
        """The rows a grouped or candidate-only batch is padded to: a power
        of two, or on the card its own rows (the dense model's `fixed_rows`
        pads it once)."""
        return rows if self.read_rows else _pow2(rows)

    def _dense_call(self, fn, inputs):
        """fn(inputs) at `read_rows` rows per call where it is set."""
        if self.read_rows is None:
            return fn(inputs)
        return dnn.fixed_rows(fn, inputs, self.read_rows)

    @staticmethod
    def _sigmoid(out):
        if isinstance(out, dict):
            return {k: torch.sigmoid(v) for k, v in out.items()}
        return torch.sigmoid(out)

    @torch.no_grad()
    def _predict_impl(self, state: TrainState, batch):
        """The read-only forward: lookups, pooled bags through #4, the
        model, a sigmoid (probabilities on the device)."""
        if not isinstance(next(iter(batch.values())), torch.Tensor):
            batch = self._device_batch(batch)
        views, _ = self._trainer.forward_views(state, batch)
        return self._forward(state, views, batch)

    def _forward(self, state: TrainState, views, batch):
        """The model over the read-only views and a sigmoid (the Trainer's
        `probs_from_views`, run on this thread's replica and at `read_rows`
        rows per call where that is set)."""
        embs = {n: v[0] for n, v in views.items()}
        inputs = self._trainer._build_inputs(embs, views, batch, read_only=True)
        m = self._module()
        return self._sigmoid(self._dense_call(
            lambda x: functional_call(m, state.dense, (x,)), inputs))

    def _inputs(self, state: TrainState, batch):
        views, _ = self._trainer.forward_views(state, batch)
        embs = {n: v[0] for n, v in views.items()}
        return self._trainer._build_inputs(embs, views, batch, read_only=True)

    def _group_ids(self, batch, num_groups: int) -> torch.Tensor:
        ucols = torch.cat([batch[n].reshape(batch[n].shape[0], -1)
                           for n in self.model.user_feats], dim=1)
        _, gids = torch.unique(ucols, dim=0, return_inverse=True)
        return gids.reshape(-1)

    @torch.no_grad()
    def _predict_grouped_impl(self, state: TrainState, batch, num_groups: int,
                              with_uvec: bool = False):
        """Sample-aware compressed forward: the user tower on G deduplicated
        rows, the item tower and scoring on all B rows. Group identity is
        exact (id columns compared row-wise, as `torch.unique(dim=0)`
        sorts rows like `jnp.unique(axis=0)`), so the outputs equal the
        plain path's rows."""
        m = self._module()
        inputs = self._inputs(state, batch)
        # the user tower at its G rows, unpadded on the card too: a user
        # vector's bits may then depend on G, never on the rows
        uvec = dnn.apply_grouped(
            lambda ins: dnn.method_call(m, state.dense, "user_vector", ins),
            inputs, self._group_ids(batch, num_groups), num_groups)
        probs = self._sigmoid(self._dense_call(
            lambda x: dnn.method_call(m, state.dense, "apply_with_user", *x), (uvec, inputs)))
        return (probs, uvec) if with_uvec else probs

    @torch.no_grad()
    def _predict_with_user_impl(self, state: TrainState, batch, uvec):
        """The candidate-only lane: the user tower never runs; `uvec` (one
        cached user vector per row) is applied directly."""
        inputs = self._inputs(state, batch)
        m = self._module()
        return self._sigmoid(self._dense_call(
            lambda x: dnn.method_call(m, state.dense, "apply_with_user", *x), (uvec, inputs)))

    def predict_grouped_uvec_versioned(self, batch: Dict[str, np.ndarray]):
        """(probabilities, per-row user vectors, model_version): the grouped
        path that also returns the user vectors (the user-tower cache's
        population path)."""
        snap = self._snap
        jb, b, g = self._grouped_batch(batch)
        probs, uvec = self._predict_grouped_impl(snap.state, jb, g, with_uvec=True)
        return _to_host(probs, b), uvec.cpu().numpy()[:b], snap.version

    def predict_with_user_versioned(self, batch: Dict[str, np.ndarray],
                                    uvec: np.ndarray):
        """(probabilities, model_version) with the user tower skipped: `uvec`
        carries one user vector per row. Rows pad to powers of two as the
        grouped path does (the last row AND its vector repeat). The caller
        re-checks that the returned version is the one the vectors were
        cached at."""
        b = int(np.asarray(next(iter(batch.values()))).shape[0])
        bp = self._row_bucket(b)
        snap = self._snap
        jb = self._device_batch({k: _pad_rows(v, bp) for k, v in batch.items()})
        juv = torch.as_tensor(_pad_rows(np.asarray(uvec, np.float32), bp)).to(self.device)
        probs = self._predict_with_user_impl(snap.state, jb, juv)
        return _to_host(probs, b), snap.version

    @torch.no_grad()
    def _predict_with_stores(self, state: TrainState, batch):
        """Read-through: the lookup, a host-side store correction of the
        keys the device table misses, the forward."""
        views, bundle_res = self._trainer.forward_views(state, batch)
        views = dict(views)
        for bname, b in self._trainer.bundles.items():
            res = bundle_res[bname]
            for k, f in enumerate(b.features):
                store = self.stores.get(fcol.resolve_table_name(f))
                if store is None:
                    continue
                r, j = (res, k) if b.stacked else (res[f.name], 0)
                emb, inverse, mask = views[f.name]
                missing = ((r.slot_ix[j] < 0) & r.valid[j]).cpu().numpy()
                if not missing.any():
                    continue
                keys = r.uids[j].cpu().numpy()[missing].astype(np.int64)
                rows, _, _, found = store.get(keys)
                if not found.any():
                    continue
                mix = torch.as_tensor(np.nonzero(missing)[0][found], device=emb.device)
                emb = emb.clone()
                emb[mix] = torch.as_tensor(np.asarray(rows)[found]).to(emb.device, emb.dtype)
                views[f.name] = (emb, inverse, mask)
        return self._forward(state, views, batch)

    @property
    def feature_dtypes(self) -> Dict[str, np.dtype]:
        """Expected numpy dtype per input feature (ids take their table's
        key dtype, dense features float32): lets frontends coerce JSON
        payloads without truncating 64-bit ids."""
        cfgs = {n: t.cfg for n, t in self._trainer.tables.items()}
        out = {}
        for f in self._trainer.sparse_specs:
            out[f.name] = np.dtype(cfgs[fcol.resolve_table_name(f)].key_dtype)
        for f in self._trainer.dense_specs:
            out[f.name] = np.dtype(np.float32)
        return out

    def model_info(self) -> Dict:
        """get_serving_model_info: the step, live keys per table and the
        version, from one snapshot."""
        snap = self._snap
        sizes = {name: int(t.size(self._trainer.table_state(snap.state, name)).sum())
                 for name, t in self._trainer.tables.items()}
        return {"step": int(snap.state.step), "table_sizes": sizes,
                "model_version": snap.version}

    def residency_info(self) -> Dict:
        """Residency per table: the measured value-storage bytes (values
        plus the per-row scale, from the tensors' shapes — no sync) against
        `ops/traffic.serving_residency_bytes`, and the f32 baseline."""
        snap = self._snap
        tables = {}
        totals = {"measured_bytes": 0, "modeled_bytes": 0.0, "fp32_bytes": 0.0}
        for name, t in self._trainer.tables.items():
            ts = self._trainer.table_state(snap.state, name)
            vb = ts.values.numel() * ts.values.element_size()
            sb = 0 if ts.qscale is None else ts.qscale.numel() * ts.qscale.element_size()
            modeled = traffic.serving_residency_bytes(
                capacity=t.cfg.capacity, dim=t.cfg.dim, value_dtype=t.cfg.value_dtype)
            fp32 = traffic.serving_residency_bytes(
                capacity=t.cfg.capacity, dim=t.cfg.dim, value_dtype="float32")
            tables[name] = {"value_dtype": t.cfg.value_dtype,
                            "measured_bytes": vb + sb, "modeled_bytes": modeled,
                            "fp32_bytes": fp32}
            totals["measured_bytes"] += vb + sb
            totals["modeled_bytes"] += modeled
            totals["fp32_bytes"] += fp32
        return {"quantize": self.quantize, "tables": tables, **totals}


def _run_poll_loop(owner, stop: threading.Event, secs: float,
                   max_backoff_secs: float = 30.0,
                   pause: Optional[threading.Event] = None,
                   on_round=None) -> None:
    """The shared checkpoint-watch loop (ModelServer, ServerGroup): poll
    `owner.predictor` for updates every `secs`. It never exits on an
    exception: a failed poll is counted (`owner.update_failures`, the
    predictor's `consecutive_poll_failures`), logged and retried with
    capped, jittered exponential backoff (`utils/backoff.py`); the old
    snapshot keeps serving. `pause` (when set) skips rounds; `on_round
    (status)` runs after each round and may not kill the poller."""
    rng = random.Random(id(owner) & 0xFFFFFFFF)
    delay = secs
    while not stop.wait(delay):
        if pause is not None and pause.is_set():
            delay = secs
            continue
        status = "ok"
        try:
            owner.predictor.poll_updates()
            owner.update_failures = 0
            delay = secs
        except Exception as e:
            status = "degraded"
            try:
                n = getattr(owner, "update_failures", 0) + 1
                owner.update_failures = n
                delay = _backoff.jittered_backoff(n + 1, secs, max_backoff_secs,
                                                  rng, max_exponent=10)
                _log.warning("model update poll failed (%d consecutive, retry "
                             "in %.1fs): %s", n, delay, e)
            except Exception:  # accounting must never kill the poller
                delay = max_backoff_secs
        if on_round is not None:
            try:
                on_round(status)
            except Exception:
                pass  # accounting must never kill the poller


def _server_metrics_snapshot(stats: ServingStats) -> Dict:
    """One mergeable snapshot for a serving front: its own series plus the
    process-wide registry — the body of `GET /metrics`."""
    snaps = [stats.metrics_snapshot()]
    if obs_metrics.metrics_enabled():
        snaps.append(obs_metrics.default_registry().snapshot())
    return obs_metrics.merge_snapshots([s for s in snaps if s])


class ModelServer:
    """Micro-batching front: coalesce single requests into device batches.

    A batch flushes when its bucket fills (`max_batch` ROWS) or its deadline
    passes. With `adaptive=True` the deadline follows an EWMA of the
    arrival rate: sparse traffic dispatches at once, heavy traffic waits
    just long enough to fill the bucket, at most `max_wait_ms`.
    `request_queue` / `stats` / `arrivals` let ServerGroup members share
    one front.
    """

    def __init__(self, predictor: Predictor, max_batch: int = 256,
                 max_wait_ms: float = 2.0, poll_updates_secs: float = 0.0,
                 adaptive: bool = True,
                 request_queue: Optional["queue.Queue"] = None,
                 stats: Optional[ServingStats] = None,
                 arrivals: Optional[_ArrivalEWMA] = None,
                 reuse_cache_bytes: int = 0,
                 user_cache_bytes: Optional[int] = None):
        self.predictor = predictor
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.adaptive = adaptive
        self.stats = stats if stats is not None else ServingStats()
        self._arrivals = arrivals if arrivals is not None else _ArrivalEWMA()
        self._q: "queue.Queue" = request_queue if request_queue is not None else queue.Queue()
        self._carry = None  # the request deferred to lead the next batch
        self._stop = threading.Event()
        self.update_failures = 0
        # obs collectors, evaluated at scrape time against live objects
        r = self.stats.registry
        if r is not None:
            r.register_callback("deeprec_serving_queue_depth", self._q.qsize,
                                "requests waiting in the coalescing queue")
            r.register_callback("deeprec_serving_model_version",
                                lambda: self.predictor.version,
                                "live snapshot version")
            r.register_callback(
                "deeprec_serving_staleness_seconds",
                lambda: time.monotonic() - self.predictor.last_poll_ok_time,
                "age of the last successful update poll round")
            r.register_callback(
                "deeprec_train_to_serve_lag_seconds",
                lambda: self.predictor.last_apply_lag_seconds,
                "trainer-commit to serving-swap age of the last applied "
                "checkpoint")
        # Compute reuse (serving/reuse.py), opt-in: an answer cache keyed
        # (request fingerprint, model version) and, for tower models, a
        # user-tower cache that routes hits onto the candidate-only lane.
        self.reuse = None
        self.user_reuse = None
        self.memo_shared = 0  # requests served off a coalesced twin
        self._m_memo = None
        if reuse_cache_bytes > 0:
            from deeprec_tpu_torch.serving.reuse import ReuseCache

            ub = user_cache_bytes if user_cache_bytes is not None else reuse_cache_bytes
            self.reuse = ReuseCache(reuse_cache_bytes, "predict", registry=r,
                                    version_fn=lambda: self.predictor.version)
            predictor.attach_reuse_cache(self.reuse)
            if ub > 0 and hasattr(predictor.model, "apply_with_user"):
                self.user_reuse = ReuseCache(ub, "user_tower", registry=r,
                                             version_fn=lambda: self.predictor.version)
                predictor.attach_reuse_cache(self.user_reuse)
            if r is not None:
                self._m_memo = r.counter(
                    "deeprec_reuse_memo_shared",
                    "in-flight requests that shared a coalesced twin's "
                    "computation inside one micro-batch window",
                    {"cache": "predict"})
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="model-server-batcher")
        self._worker.start()
        self._poller = None
        if poll_updates_secs > 0:
            self._poller = threading.Thread(target=self._poll_loop,
                                            args=(poll_updates_secs,), daemon=True,
                                            name="model-server-poller")
            self._poller.start()

    def _poll_loop(self, secs):
        _run_poll_loop(self, self._stop, secs)

    # Sparse-traffic cutoff: once the mean inter-arrival is this many
    # windows long, waiting only adds latency.
    SPARSE_FACTOR = 8.0

    def _pick_wait(self, rows: int) -> float:
        """The coalescing deadline for a batch holding `rows` rows."""
        if rows >= self.max_batch:
            return 0.0
        if not self.adaptive:
            return self.max_wait
        tau, rows_per_req = self._arrivals.estimate()
        if tau is None:
            return self.max_wait  # no history yet: behave like fixed
        if tau >= self.SPARSE_FACTOR * self.max_wait:
            return 0.0  # sparse traffic: waiting cannot fill the bucket
        need = (self.max_batch - rows) / max(rows_per_req, 1.0)
        return min(self.max_wait, tau * need)

    def _take(self, pending, rows, nxt) -> int:
        """Admit `nxt` into the forming batch unless it would push the row
        count past max_batch (off the bucket ladder) or it is on another
        lane (plain, grouped, grouped with a cached user vector: different
        forwards cannot share a dispatch); a refused request leads the NEXT
        batch. Returns the new row count (max_batch: dispatch now)."""
        if pending and (rows + nxt[1] > self.max_batch or nxt[4] != pending[0][4]):
            self._carry = nxt
            return self.max_batch
        pending.append(nxt)
        return rows + nxt[1]

    def _run(self):
        while not self._stop.is_set():
            if self._carry is not None:
                first, self._carry = self._carry, None
            else:
                try:
                    first = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
            pending = [first]
            rows = first[1]
            # whatever is ALREADY queued rides along for free
            while rows < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                rows = self._take(pending, rows, nxt)
            wait = self._pick_wait(rows)
            if wait > 0 and rows < self.max_batch:
                deadline = time.monotonic() + wait
                while rows < self.max_batch:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=left)
                    except queue.Empty:
                        break
                    rows = self._take(pending, rows, nxt)
            self._serve(pending)

    def _serve(self, pending: List[tuple]):
        t0 = time.monotonic()
        lane = pending[0][4]  # homogeneous by _take's admission rule
        for p in pending:
            self.stats.record_stage("queue", t0 - p[3])
        # In-window memoisation: identical in-flight requests (the same
        # answer fingerprint) share ONE computation; no_cache requests
        # carry fp=None and never share.
        leaders = pending
        dups: Dict[bytes, List] = {}
        if self.reuse is not None:
            seen: Dict[bytes, bool] = {}
            leaders = []
            for p in pending:
                fp = p[6]
                if fp is not None and fp in seen:
                    dups.setdefault(fp, []).append(p)
                    continue
                if fp is not None:
                    seen[fp] = True
                leaders.append(p)
        reqs = [p[0] for p in leaders]
        sizes = [p[1] for p in leaders]
        batch = {k: np.concatenate([np.asarray(r[k]) for r in reqs]) for k in reqs[0]}
        # pad to a bucket of the fixed ladder (repeating the LAST row keeps
        # a grouped batch's distinct-user count)
        total = sum(sizes)
        bucket = self._bucket_for(total)
        if bucket > total:
            batch = {k: _pad_rows(v, bucket) for k, v in batch.items()}
        self.stats.record_stage("pad", time.monotonic() - t0)
        try:
            t1 = time.monotonic()
            probs, version, uvec_rows = self._dispatch(batch, lane, leaders,
                                                       sizes, total, bucket)
            t2 = time.monotonic()
            self.stats.record_stage("device", t2 - t1)
            off = 0
            for p, n in zip(leaders, sizes):
                sl = ({k: v[off:off + n] for k, v in probs.items()}
                      if isinstance(probs, dict) else probs[off:off + n])
                p[2].put((sl, version))
                if p[6] is not None:
                    for d in dups.get(p[6], ()):
                        d[2].put((sl, version))
                    # a COPY: a view would pin the whole padded output
                    self.reuse.put(
                        p[6], version,
                        {k: np.ascontiguousarray(v) for k, v in sl.items()}
                        if isinstance(sl, dict) else np.ascontiguousarray(sl))
                if (p[7] is not None and uvec_rows is not None
                        and self.user_reuse is not None):
                    # the lead row's user vector: one user per grouped request
                    self.user_reuse.put(p[7], version,
                                        np.ascontiguousarray(uvec_rows[off]))
                off += n
            shared = len(pending) - len(leaders)
            if shared:
                self.memo_shared += shared
                if self._m_memo is not None:
                    self._m_memo.inc(shared)
            t3 = time.monotonic()
            self.stats.record_stage("post", t3 - t2)
            self.stats.record_batch(len(pending), total)
            if obs_trace.tracing_enabled():
                # per-request stage spans from the timings above
                wall = time.time() - t3
                for p in pending:
                    t_enq, ctx = p[3], p[5]
                    if ctx is None:
                        continue
                    for nm, a, b in (("stage_queue", t_enq, t0),
                                     ("stage_pad", t0, t1),
                                     ("stage_device", t1, t2),
                                     ("stage_post", t2, t3)):
                        obs_trace.emit(nm, "serving", wall + a, wall + b,
                                       ctx=obs_trace.child(ctx), parent=ctx[1])
        except Exception as e:
            self.stats.record_error(len(pending))
            for p in pending:
                p[2].put(e)

    def _dispatch(self, batch, lane: int, leaders, sizes, total: int, bucket: int):
        """One device dispatch of the assembled batch per lane: the plain
        forward, the grouped forward (with per-row user vectors when the
        user-tower cache wants them), or the candidate-only forward fed by
        cached user vectors — which falls back to the grouped forward when
        the vectors' version is no longer the snapshot's. Returns (probs,
        version, per-row user vectors or None)."""
        if lane == 0:
            probs, version = self.predictor.predict_versioned(batch)
            return probs, version, None
        if lane == 2:
            uvers = {p[8][1] for p in leaders}
            if len(uvers) == 1:
                urows = np.concatenate([
                    np.broadcast_to(np.asarray(p[8][0], np.float32).reshape(1, -1),
                                    (n, np.asarray(p[8][0]).size))
                    for p, n in zip(leaders, sizes)])
                if bucket > total:
                    urows = _pad_rows(urows, bucket)
                probs, version = self.predictor.predict_with_user_versioned(batch, urows)
                if version == next(iter(uvers)):
                    return probs, version, None
            probs, version = self.predictor.predict_versioned(batch, group_users=True)
            return probs, version, None
        if self.user_reuse is not None and any(p[7] is not None for p in leaders):
            probs, uvec_rows, version = self.predictor.predict_grouped_uvec_versioned(batch)
            return probs, version, uvec_rows
        probs, version = self.predictor.predict_versioned(batch, group_users=True)
        return probs, version, None

    def _buckets(self) -> List[int]:
        """The ONE bucket ladder (shared by _serve and warmup): powers of
        two from 8, capped by max_batch, which is always the last. Where the
        predictor runs its dense model at fixed rows (`read_rows`, on the
        card) it pads each batch itself: the ladder is max_batch alone and
        a batch is not padded here."""
        if self.predictor.read_rows:
            return [self.max_batch]
        sizes = []
        b = 8
        while b < self.max_batch:
            sizes.append(b)
            b <<= 1
        sizes.append(self.max_batch)
        return sizes

    def _bucket_for(self, total: int) -> int:
        if self.predictor.read_rows:
            return total
        for b in self._buckets():
            if total <= b:
                return b
        return total  # > max_batch: a single request larger than the cap

    def warmup(self, example: Dict[str, np.ndarray], group_users: bool = False) -> int:
        """Run every batch bucket once from one example row: in eager
        PyTorch this loads the kernels and grows the allocator's pools, so
        the first production burst waits on neither. Each bucket batch is
        also registered with the predictor, so every later update runs the
        same ladder against the incoming state BEFORE the swap. Returns the
        number of buckets."""
        one = {k: np.asarray(v)[:1] for k, v in example.items()}
        sizes = self._buckets()
        for size in sizes:
            batch = {k: np.concatenate([v] * size, axis=0) for k, v in one.items()}
            self.predictor.predict(batch)
            if group_users:
                self.predictor.predict(batch, group_users=True)
                if self.user_reuse is not None:
                    _, uv, _ = self.predictor.predict_grouped_uvec_versioned(batch)
                    self.predictor.predict_with_user_versioned(batch, uv)
            self.predictor.register_warm_batch(batch)
        return len(sizes)

    def submit(self, features: Dict[str, np.ndarray], group_users: bool = False,
               trace_ctx: Optional[tuple] = None,
               no_cache: bool = False) -> "queue.Queue":
        """Enqueue one request and return its reply queue (a one-shot
        future: `.get()` yields `(result, model_version)` or an Exception).

        `group_users=True` coalesces the request only with other grouped
        requests. With compute reuse on, an answer-cache hit at the live
        version replies at once; a grouped request whose user vector is
        cached rides the candidate-only lane. `no_cache=True` bypasses
        reads, writes and in-window sharing."""
        if group_users and not hasattr(self.predictor.model, "apply_with_user"):
            raise BadRequest(
                f"{type(self.predictor.model).__name__} has no user/item "
                "tower split (needs user_feats/user_vector/apply_with_user)")
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        rows = (int(np.asarray(next(iter(features.values()))).shape[0])
                if features else 0)
        # queue items: (features, rows, reply, t_enqueue, lane, trace ctx,
        # answer fp, user fp to populate, cached (user vector, version));
        # lanes: 0 plain, 1 grouped, 2 grouped with a cached user vector
        lane = 1 if group_users else 0
        fp = ufp = uaux = None
        if self.reuse is not None and not no_cache:
            from deeprec_tpu_torch.serving import reuse as _reuse

            fp = _reuse.request_fingerprint(features, extra=b"g" if group_users else b"")
            hit = self.reuse.get_current(fp)
            if hit is not None:
                reply.put(hit)  # (answer, version), read together
                return reply
            if group_users and self.user_reuse is not None:
                ufp = _reuse.request_fingerprint(
                    features, names=list(self.predictor.model.user_feats))
                uhit = self.user_reuse.get_current(ufp)
                if uhit is not None:
                    uaux, ufp, lane = uhit, None, 2
        t0 = time.monotonic()
        self._arrivals.note(t0, rows)
        self._q.put((features, rows, reply, t0, lane, trace_ctx, fp, ufp, uaux))
        return reply

    def attach_retrieval(self, engine, **kwargs):
        raise NotImplementedError(_RETRIEVAL_SLICE)

    def retrieve_versioned(self, features, k: int, timeout: float = 30.0,
                           no_cache: bool = False):
        """No retrieval lane is attached: the answer the JAX server gives
        when no engine is attached."""
        raise BadRequest("retrieval not enabled on this server")

    def request(self, features: Dict[str, np.ndarray], timeout: float = 30.0,
                group_users: bool = False):
        """Blocking predict of one request (the process() call)."""
        return self.request_versioned(features, timeout, group_users)[0]

    def request_versioned(self, features: Dict[str, np.ndarray],
                          timeout: float = 30.0, group_users: bool = False,
                          trace_ctx: Optional[tuple] = None, no_cache: bool = False):
        """(result, model_version): the version the whole request was
        served from (coalesced neighbours share one). `trace_ctx` (or the
        calling thread's open span) makes this a sampled trace."""
        t0 = time.monotonic()
        sp = obs_trace.span("dispatch", "serving", ctx=trace_ctx)
        with sp:
            reply = self.submit(features, group_users=group_users,
                                trace_ctx=sp.ctx, no_cache=no_cache)
            out = reply.get(timeout=timeout)
        self.stats.record_stage("e2e", time.monotonic() - t0)
        if isinstance(out, Exception):
            raise out
        return out

    def stats_snapshot(self) -> Dict:
        """Live serving stats and the model's identity — the `/v1/stats`
        body; ``window`` is the e2e p99 over the trailing 60 s and the
        queue's depth."""
        out = self.stats.snapshot()
        p = self.predictor
        out["model"] = {"version": p.version, "step": p.step,
                        "updates": p.update_count, "last_update_ms": p.last_update_ms}
        out["window"] = {"e2e_p99_ms": self.stats.window_p99_ms("e2e"),
                         "queue_depth": self._q.qsize(), "window_seconds": 60}
        out["health"] = p.health()
        out["residency"] = p.residency_info()
        reuse = {}
        if self.reuse is not None:
            reuse["predict"] = self.reuse.snapshot()
        if self.user_reuse is not None:
            reuse["user_tower"] = self.user_reuse.snapshot()
        if reuse:
            reuse["memo_shared"] = self.memo_shared
            out["reuse"] = reuse
        return out

    def metrics_snapshot(self) -> Dict:
        return _server_metrics_snapshot(self.stats)

    def metrics_text(self) -> str:
        """Prometheus text for `GET /metrics` on this server."""
        return obs_metrics.render_snapshot(self.metrics_snapshot())

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)
        if self._poller is not None:
            self._poller.join(timeout=2)


class _GroupPredictor:
    """Predictor facade over a replica group: reads go to replica 0,
    `poll_updates` rolls across EVERY replica."""

    def __init__(self, members: List[Predictor]):
        self._members = members

    def __getattr__(self, name):
        return getattr(self._members[0], name)

    def poll_updates(self) -> bool:
        # Rolling update: replicas refresh one at a time, the others keep
        # serving the previous version; each refresh is itself a shadow
        # build and a swap.
        changed = False
        for m in self._members:
            changed = bool(m.poll_updates()) or changed
        return changed

    def reload(self) -> None:
        for m in self._members:
            m.reload()

    def model_info(self) -> Dict:
        info = self._members[0].model_info()
        info["replicas"] = len(self._members)
        return info

    def health(self) -> Dict:
        """The worst member's health: a wedged replica is the group's
        status."""
        healths = [m.health() for m in self._members]
        worst = max(healths, key=lambda h: h["staleness_seconds"])
        if any(h["status"] != "ok" for h in healths):
            worst = next(h for h in healths if h["status"] != "ok")
        worst["replicas"] = len(self._members)
        return worst


def _local_devices(device=None) -> List[torch.device]:
    """The devices a ServerGroup may pin members to: every CUDA card, or
    the CPU when asked for (`device="cpu"`)."""
    from deeprec_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class ServerGroup:
    """N serving replicas behind ONE shared request queue. One member is
    pinned per DISTINCT device, so on one card the group degrades to one
    member (requested replicas are capped at the device count): N members
    time-slicing one card would be slower than one member batching for
    it. Work is pulled by whichever member is free, and every member
    accounts into one ServingStats. `devices=None` takes the local cards
    (the CPU with `device="cpu"`)."""

    def __init__(self, model, ckpt_dir: str, *, replicas: int = 2, devices=None,
                 stores: Optional[Dict] = None, max_batch: int = 256,
                 max_wait_ms: float = 2.0, poll_updates_secs: float = 0.0,
                 adaptive: bool = True, quantize=None, device=None):
        if devices is None:
            avail = _local_devices(device)
            devices = avail[: max(1, min(replicas, len(avail)))]
        else:
            # one member per DISTINCT device, order kept
            devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self.stats = ServingStats()
        self._arrivals = _ArrivalEWMA()
        self._q: "queue.Queue" = queue.Queue()
        self.members = [
            ModelServer(
                Predictor(model, ckpt_dir, stores=stores, device=d, quantize=quantize),
                max_batch=max_batch, max_wait_ms=max_wait_ms, adaptive=adaptive,
                request_queue=self._q, stats=self.stats, arrivals=self._arrivals)
            for d in devices
        ]
        self.predictor = _GroupPredictor([s.predictor for s in self.members])
        self.update_failures = 0
        self._stop = threading.Event()
        self._poller = None
        if poll_updates_secs > 0:
            self._poller = threading.Thread(target=self._poll_loop,
                                            args=(poll_updates_secs,), daemon=True)
            self._poller.start()

    def _poll_loop(self, secs: float):
        _run_poll_loop(self, self._stop, secs)

    def request(self, features: Dict[str, np.ndarray], timeout: float = 30.0,
                group_users: bool = False):
        # any member enqueues onto the SHARED queue; a free member serves it
        return self.members[0].request(features, timeout=timeout,
                                       group_users=group_users)

    def request_versioned(self, features: Dict[str, np.ndarray], timeout: float = 30.0,
                          group_users: bool = False, trace_ctx: Optional[tuple] = None,
                          no_cache: bool = False):
        return self.members[0].request_versioned(
            features, timeout=timeout, group_users=group_users,
            trace_ctx=trace_ctx, no_cache=no_cache)

    def submit(self, features: Dict[str, np.ndarray], group_users: bool = False,
               trace_ctx: Optional[tuple] = None, no_cache: bool = False) -> "queue.Queue":
        return self.members[0].submit(features, group_users=group_users,
                                      trace_ctx=trace_ctx, no_cache=no_cache)

    def warmup(self, example: Dict[str, np.ndarray], group_users: bool = False) -> int:
        return sum(s.warmup(example, group_users=group_users) for s in self.members)

    def stats_snapshot(self) -> Dict:
        out = self.stats.snapshot()
        ps = [s.predictor for s in self.members]
        out["replicas"] = len(self.members)
        out["model"] = {"version": ps[0].version, "step": ps[0].step,
                        "updates": sum(p.update_count for p in ps),
                        "last_update_ms": max(p.last_update_ms for p in ps)}
        # the worst member speaks for the group, as /healthz does
        out["health"] = self.predictor.health()
        out["residency"] = ps[0].residency_info()
        return out

    def metrics_snapshot(self) -> Dict:
        return _server_metrics_snapshot(self.stats)

    def metrics_text(self) -> str:
        return obs_metrics.render_snapshot(self.metrics_snapshot())

    def close(self):
        self._stop.set()
        for s in self.members:
            s.close()
