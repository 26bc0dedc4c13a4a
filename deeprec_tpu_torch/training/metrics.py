"""Streaming metrics — the port of `deeprec_tpu/training/metrics.py`.
AUC is computed online from fixed-bin histograms of the predicted
probability (the approach tf.metrics.auc takes), so evaluation never holds
all predictions."""
from __future__ import annotations

import dataclasses

import torch

NUM_BINS = 512


@dataclasses.dataclass
class AucState:
    pos: torch.Tensor  # [NUM_BINS] float32: positive-label prob histogram
    neg: torch.Tensor  # [NUM_BINS]

    @classmethod
    def create(cls, device=None) -> "AucState":
        z = torch.zeros((NUM_BINS,), dtype=torch.float32, device=device)
        return cls(pos=z, neg=z.clone())


def auc_update(state: AucState, probs: torch.Tensor,
               labels: torch.Tensor) -> AucState:
    probs = probs.reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    bins = torch.clamp((probs * NUM_BINS).to(torch.int32), 0, NUM_BINS - 1).long()
    return AucState(pos=state.pos.index_add(0, bins, labels),
                    neg=state.neg.index_add(0, bins, 1.0 - labels))


def auc_compute(state: AucState) -> torch.Tensor:
    """Probability a random positive outranks a random negative, from the
    histograms (ties get half credit)."""
    P = torch.sum(state.pos)
    N = torch.sum(state.neg)
    neg_below = torch.cumsum(state.neg, 0) - state.neg
    wins = torch.sum(state.pos * neg_below) + 0.5 * torch.sum(state.pos * state.neg)
    return torch.where((P > 0) & (N > 0), wins / (P * N), 0.5)


def accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    pred = (probs.reshape(-1) >= 0.5).to(torch.float32)
    return torch.mean((pred == labels.reshape(-1).to(torch.float32)).to(torch.float32))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(torch.float32)
    return torch.mean(
        torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
