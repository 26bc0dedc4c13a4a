"""Serving: load the latest checkpoint chain and answer predictions — the
port of `deeprec_tpu/serving/predictor.py`, label-free predict path.

`Predictor(model, ckpt_dir)` restores the verified chain (the newest intact
full save and the deltas after it, `CheckpointManager.restore`) onto the
device and serves `predict(batch)`: the read-only lookup of every bundle
(dedup, probe, the hand-written row-gather kernel, combine), the model
forward and a sigmoid. The live model is one immutable (version, state) snapshot:
`reload()` builds the next state to the side and publishes it with one
reference swap, so a request is served from one model version.

Quantized residency, feature stores, group_users, delta polling
(`poll_updates`, `restore_chunk`) and the quality gate wait for a later
slice (ROADMAP queue A item 7).
"""
from __future__ import annotations

import threading
from typing import Dict, NamedTuple

import numpy as np
import torch

from deeprec_tpu_torch.training.checkpoint import CheckpointManager
from deeprec_tpu_torch.training.trainer import Trainer, TrainState


class _Snapshot(NamedTuple):
    version: int
    state: TrainState


class Predictor:
    """Load-latest-and-serve on one device (`cuda` unless `device="cpu"`;
    raises without CUDA when no device is given)."""

    def __init__(self, model, ckpt_dir: str, device=None):
        self.model = model
        self._trainer = Trainer(model, device=device)
        self.device = self._trainer.device
        self._ck = CheckpointManager(ckpt_dir, self._trainer)
        self._snap = None
        self._lock = threading.Lock()  # serializes reloads, never predict
        self.reload()

    @property
    def version(self) -> int:
        """Monotonic model version: bumps on every published reload."""
        return self._snap.version

    @property
    def step(self) -> int:
        return self._snap.state.step

    def reload(self) -> bool:
        """Restore the latest verified chain (a corrupt link is quarantined
        and the longest valid prefix served) and publish it."""
        with self._lock:
            state = self._ck.restore()
            prev = self._snap
            self._snap = _Snapshot(prev.version + 1 if prev else 0, state)
            return True

    def _device_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The model's input features as tensors on the device (labels and
        other keys are not read)."""
        return {
            k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
            for k in self._trainer.input_keys()
        }

    def predict(self, batch: Dict[str, np.ndarray]):
        """Probabilities [B] for one batch (numpy, on the host); a {task:
        probabilities} dict for a multi-task model."""
        return self.predict_versioned(batch)[0]

    def predict_versioned(self, batch: Dict[str, np.ndarray]):
        """(probabilities, model_version): the version is read with the
        state, so the pair certifies which model produced the answer."""
        snap = self._snap
        batch = self._device_batch(batch)
        views, _ = self._trainer.forward_views(snap.state, batch)
        probs = self._trainer.probs_from_views(snap.state, views, batch)[1]
        if isinstance(probs, dict):
            return {t: p.cpu().numpy() for t, p in probs.items()}, snap.version
        return probs.cpu().numpy(), snap.version
