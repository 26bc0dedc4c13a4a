"""Learned placement cost model — the port of
`deeprec_tpu/parallel/costmodel.py`, a copy of its numpy so that the same
observations give the same coefficients and predictions bit for bit.

A small feature-based regressor (ridge by normal equations, nothing
stochastic) that learns a member table's MEASURED per-shard tail exchange
bytes (hot-routed keys excluded: `build_plans` queries it with tail-only
rotation candidates) from the analytic model's prediction and per-table
shape features:

    measured_tail_bytes[shard] ~ f(modeled_tail_bytes[shard], row_bytes,
                                   arrival mass, unique fraction,
                                   hot-mass concentration)

Its training data is the placer's own history: every
`ShardedTrainer.update_placement` records, per member, the active plan's
modeled per-shard load beside the window's measured per-shard exchange
bytes (`dedup_stats()['per_shard']`, per step). The placer consults it only
where the analytic rotation costs tie (`build_plans(cost_model=)`); until
`min_rows` observations have accumulated it is untrained and the placer's
choice is the analytic one, bit for bit.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

# Feature vector per (member, shard) row — see _features():
#   0  modeled bytes/step the analytic model assigns this shard
#   1  log1p(row_bytes)          (table dim, via the wire-bytes weight)
#   2  log1p(mass * row_bytes)   (the member's total bytes/step)
#   3  unique fraction           (live keys per modeled arrival)
#   4  hot-mass concentration    (share of mass in the multi-source head)
N_FEATURES = 5


class PlacementCostModel:
    """Ridge regressor over per-(member, shard) load observations.

    Deterministic by construction: history is a bounded FIFO, fitting is
    closed-form normal equations, prediction is a dot product. The model
    never *proposes* placements — it only re-ranks candidates the
    analytic placer already considers equivalent, so a wrong model can at
    worst pick a different member of the analytic tie set."""

    def __init__(self, ridge: float = 1e-3, min_rows: int = 32,
                 max_rows: int = 4096):
        self.ridge = float(ridge)
        self.min_rows = int(min_rows)
        self._rows: deque = deque(maxlen=int(max_rows))
        self._coef: Optional[np.ndarray] = None  # [F + 1] incl. intercept
        self._mean: Optional[np.ndarray] = None
        self._scale: Optional[np.ndarray] = None
        self.observations = 0  # windows recorded (telemetry)

    # ------------------------------------------------------------ features

    @staticmethod
    def member_stats(member) -> Dict[str, float]:
        """Shard-independent features of one MemberTraffic: arrival mass,
        unique fraction and hot-mass concentration — the per-table shape
        the regressor conditions on."""
        w = np.asarray(member.weight, np.float64)
        mass = float(w.sum())
        n = int(len(member.keys))
        hot_mass = float(w[w > 1.0].sum()) / mass if mass > 0 else 0.0
        return {
            "row_bytes": float(member.row_bytes),
            "mass": mass,
            "unique_fraction": (n / mass) if mass > 0 else 0.0,
            "hot_mass": hot_mass,
        }

    @staticmethod
    def _features(stats: Dict[str, float], modeled: np.ndarray) -> np.ndarray:
        """[N, F] feature rows for one member's per-shard modeled loads."""
        modeled = np.asarray(modeled, np.float64)
        n = modeled.shape[0]
        out = np.empty((n, N_FEATURES), np.float64)
        out[:, 0] = modeled
        out[:, 1] = np.log1p(stats["row_bytes"])
        out[:, 2] = np.log1p(stats["mass"] * stats["row_bytes"])
        out[:, 3] = stats["unique_fraction"]
        out[:, 4] = stats["hot_mass"]
        return out

    # ------------------------------------------------------------ training

    def record_window(self, stats: Dict[str, float], modeled,
                      measured) -> None:
        """One observation window for one member: the analytic model's
        per-shard bytes/step under the ACTIVE plan next to the measured
        per-shard bytes/step the window actually produced. Windows with
        no traffic are skipped (an empty window teaches only noise)."""
        modeled = np.asarray(modeled, np.float64)
        measured = np.asarray(measured, np.float64)
        if modeled.shape != measured.shape:
            raise ValueError(
                f"modeled {modeled.shape} vs measured {measured.shape}"
            )
        if float(measured.sum()) <= 0.0:
            return
        X = self._features(stats, modeled)
        for i in range(X.shape[0]):
            self._rows.append((X[i], float(measured[i])))
        self.observations += 1
        self._fit()

    def _fit(self) -> None:
        if len(self._rows) < self.min_rows:
            return
        X = np.stack([r[0] for r in self._rows])
        y = np.asarray([r[1] for r in self._rows], np.float64)
        mean = X.mean(axis=0)
        scale = X.std(axis=0)
        scale[scale <= 0] = 1.0
        Xs = (X - mean) / scale
        A = np.concatenate([np.ones((Xs.shape[0], 1)), Xs], axis=1)
        reg = self.ridge * np.eye(A.shape[1])
        reg[0, 0] = 0.0  # never shrink the intercept
        try:
            coef = np.linalg.solve(A.T @ A + reg, A.T @ y)
        except np.linalg.LinAlgError:
            return  # keep the previous fit (or stay untrained)
        self._coef, self._mean, self._scale = coef, mean, scale

    @property
    def trained(self) -> bool:
        return self._coef is not None

    # ---------------------------------------------------------- prediction

    def predict_loads(self, stats: Dict[str, float],
                      modeled) -> np.ndarray:
        """Calibrated per-shard bytes/step for one member under a
        candidate assignment (`modeled` = the analytic per-shard vector).
        Predictions clamp at 0 — a calibration cannot un-send bytes."""
        if not self.trained:
            return np.asarray(modeled, np.float64)
        Xs = (self._features(stats, modeled) - self._mean) / self._scale
        pred = self._coef[0] + Xs @ self._coef[1:]
        return np.maximum(pred, 0.0)

    # ----------------------------------------------------------- telemetry

    def info(self) -> Dict[str, object]:
        return {
            "trained": self.trained,
            "rows": len(self._rows),
            "observations": self.observations,
        }
