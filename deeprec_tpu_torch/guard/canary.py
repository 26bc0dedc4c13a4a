"""Pre-swap canary: the quality gate of the delta-publish path.

The zero-stall serving update assembles the next model on a
shadow state and swaps one reference — which also means a semantically
poisoned delta (NaN rows, garbage embeddings) ships to traffic with
zero stall and zero error. The canary closes that gap: BEFORE the swap,
``Predictor`` evaluates a fixed probe batch on the shadow state and
rejects the update when

  * any probe prediction is non-finite (always checked),
  * the prediction distribution shifted more than ``max_shift`` mean
    |Δp| against the probe predictions of the CURRENTLY served
    snapshot (a poisoned table drags scores violently; an honest delta
    at serving cadence moves them a little), or
  * labels are attached and the probe AUC fell under ``auc_floor``.

A rejected delta is quarantined with the checkpoint rename discipline (the
trainer's next save then re-anchors the chain), the old snapshot keeps
serving, and ``health()`` reports ``degraded`` with
``degraded_reason: quality_gate`` — freshness sacrificed BY CHOICE,
visibly, never silently.

Host-side and update-cadence only; the probe forward reuses the
predictor's read-only forward at one fixed probe shape, so the gate adds
nothing to the request path.

The port's copy of `deeprec_tpu/guard/canary.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


class QualityGateRejected(Exception):
    """A shadow state failed the pre-swap canary; the update must not
    publish. Carries the structured reason for health/metrics."""

    def __init__(self, reason: str, **details):
        super().__init__(reason)
        self.reason = reason
        self.details = details


def np_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank AUC on host arrays (probe batches are small; ties averaged).
    Returns 0.5 when only one class is present."""
    probs = np.asarray(probs, np.float64).reshape(-1)
    labels = np.asarray(labels, np.float64).reshape(-1)
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = probs.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty(probs.size, np.float64)
    ranks[order] = np.arange(1, probs.size + 1)
    # average tied ranks so identical scores split the credit
    sorted_p = probs[order]
    i = 0
    while i < probs.size:
        j = i
        while j + 1 < probs.size and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


@dataclass
class QualityGate:
    """Configuration + reference state of the pre-swap canary.

    ``probe`` is a label-free feature batch (one fixed shape — it
    compiles once and every later gate pass is cache-hit dispatch).
    ``labels`` + ``auc_floor`` add the absolute quality bound;
    ``max_shift`` is the relative prediction-distribution bound against
    the currently served snapshot. ``rejections``/``last_rejection``
    are the observability surface the predictor exports."""

    probe: Dict[str, np.ndarray]
    labels: Optional[np.ndarray] = None
    auc_floor: Optional[float] = None
    max_shift: float = 0.25
    rejections: int = 0
    last_rejection: Optional[Dict] = None
    _ref_probs: Optional[np.ndarray] = field(default=None, repr=False)

    @staticmethod
    def _flat(probs) -> np.ndarray:
        if isinstance(probs, dict):  # multi-task: concatenate all heads
            return np.concatenate(
                [np.asarray(v).reshape(-1) for _, v in sorted(probs.items())]
            )
        return np.asarray(probs).reshape(-1)

    def set_reference(self, probs) -> None:
        """Stamp the served snapshot's probe predictions — the baseline
        the next shadow state's shift is measured against."""
        self._ref_probs = self._flat(probs)

    def check(self, probs) -> None:
        """Raise QualityGateRejected when the shadow state's probe
        predictions fail the gate; otherwise return (the caller then
        publishes and calls ``set_reference`` with these probs)."""
        p = self._flat(probs)
        if not np.all(np.isfinite(p)):
            self._reject("nonfinite_predictions",
                         nonfinite=int((~np.isfinite(p)).sum()))
        if self._ref_probs is not None and self._ref_probs.shape == p.shape:
            shift = float(np.mean(np.abs(p - self._ref_probs)))
            if shift > self.max_shift:
                self._reject("prediction_shift", shift=round(shift, 4),
                             bound=self.max_shift)
        if self.labels is not None and self.auc_floor is not None:
            auc = np_auc(p[: np.asarray(self.labels).size], self.labels)
            if auc < self.auc_floor:
                self._reject("auc_floor", auc=round(auc, 4),
                             floor=self.auc_floor)

    def _reject(self, reason: str, **details) -> None:
        self.rejections += 1
        self.last_rejection = {"reason": reason, **details}
        raise QualityGateRejected(reason, **details)
