"""The step sentinel: per-dispatch model-quality flags — the port of
`deeprec_tpu/guard/sentinel.py`.

The checks run inside the train step, after its sparse applies and before
its dense update, on device tensors only: the result is ONE int32 bitmask
scalar per step on the device. The online loop copies it to pinned host
memory behind an event and reads it one dispatch later (by then the copy
has landed), which is where the "detected within one dispatch" contract
comes from. No check changes the update math: with the sentinel on and
untripped, training is bit for bit the sentinel-off run.

The loss EMA that the spike check compares against rides outside the
TrainState in a guard carry `{"ema": f32[]}` threaded through
`Trainer.train_step(..., guard=)` (and the K-step window); the updated EMA
returns in the metrics (`mets["guard_ema"]`) so the caller hands it to the
next dispatch without reading it on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# Flag bits of the packed int32 sentinel scalar. Bounded set: these names
# are also the `kind=` label values of deeprec_guard_trips.
FLAG_NONFINITE_LOSS = 1
FLAG_NONFINITE_GRAD = 2
FLAG_GRAD_NORM = 4
FLAG_LOSS_SPIKE = 8
FLAG_ROW_NORM = 16

FLAG_KINDS = (
    (FLAG_NONFINITE_LOSS, "nonfinite_loss"),
    (FLAG_NONFINITE_GRAD, "nonfinite_grad"),
    (FLAG_GRAD_NORM, "grad_norm"),
    (FLAG_LOSS_SPIKE, "loss_spike"),
    (FLAG_ROW_NORM, "row_norm"),
)


def flag_kinds(flags: int) -> List[str]:
    """Decode a host-read flags scalar into its tripped kind names."""
    return [name for bit, name in FLAG_KINDS if flags & bit]


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Thresholds of the step sentinel (the JAX package's fields and
    defaults).

    Non-finite loss/grad checks are always on. `spike_ratio` trips when the
    step loss exceeds `spike_ratio x` the running EMA of clean-step losses
    (the EMA never learns from a tripped step). `grad_norm_max` bounds the
    global L2 norm over dense AND embedding grads. `row_norm_max` bounds the
    largest L2 norm of the table rows this step updated (only touched rows
    are gathered). `row_clamp_norm` rescales updated rows down to that norm
    (changes the math; off by default). `row_evict_quantile` /
    `row_evict_factor` configure maintain()'s anomaly eviction: occupied
    rows whose norm exceeds `factor x` the occupied-norm quantile are
    re-initialized. Pick a mid quantile (0.9): an extreme one is dominated
    by the anomalous rows themselves."""

    spike_ratio: float = 4.0
    ema_decay: float = 0.9
    grad_norm_max: Optional[float] = None
    row_norm_max: Optional[float] = None
    row_clamp_norm: Optional[float] = None
    row_evict_quantile: Optional[float] = None
    row_evict_factor: float = 8.0


def guard_init(device=None) -> Dict[str, torch.Tensor]:
    """Fresh guard carry: EMA < 0 means unseeded (the first clean step seeds
    it with its own loss; the spike check stays off until then)."""
    return {"ema": torch.full((), -1.0, dtype=torch.float32, device=device)}


def _f32(x: float) -> float:
    """`x` rounded to float32, as a Python scalar: an operand the kernels
    take by value (a device tensor made from it would be a host-to-device
    copy, and with it a host synchronisation, every step)."""
    return float(np.float32(x))


def grad_observations(g_dense: Dict[str, torch.Tensor], g_embs
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grads_finite bool[], grad_norm_sq f32[]) over the dense gradients
    and the embedding gradients, as device scalars. One multi-tensor max-abs
    launch decides finiteness (the max of |g| is NaN or inf exactly when
    some element is), one multi-tensor L2 norm per leaf gives the sum of
    squares. The sum runs in another order than XLA's tree order:
    `grad_norm_sq` agrees within f32 rounding."""
    leaves = [g.to(torch.float32) for g in (*g_dense.values(), *g_embs)
              if g.is_floating_point() and g.numel()]
    finite = torch.isfinite(torch.stack(torch._foreach_norm(leaves, float("inf")))).all()
    sq = torch.stack(torch._foreach_norm(leaves, 2.0)).square().sum()
    return finite, sq


def step_flags(cfg: SentinelConfig, loss: torch.Tensor, grads_finite: torch.Tensor,
               grad_norm_sq: torch.Tensor, row_norm_max: Optional[torch.Tensor],
               guard: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fold one step's observations into (flags int32[], new guard), on the
    device. The EMA only advances on untripped steps; flags is the OR of
    every tripped check."""
    loss = loss.to(torch.float32)
    ema = guard["ema"]
    loss_ok = torch.isfinite(loss)
    bits = [(~loss_ok, FLAG_NONFINITE_LOSS), (~grads_finite, FLAG_NONFINITE_GRAD)]
    if cfg.grad_norm_max is not None:
        # the bound squared in float32, as JAX computes it; a non-finite
        # norm compares False here (the nonfinite-grad bit fires for it)
        bound = _f32(np.float32(cfg.grad_norm_max) * np.float32(cfg.grad_norm_max))
        bits.append((grad_norm_sq > bound, FLAG_GRAD_NORM))
    bits.append(((ema > 0) & loss_ok & (loss > ema * _f32(cfg.spike_ratio)),
                 FLAG_LOSS_SPIKE))
    if row_norm_max is not None and cfg.row_norm_max is not None:
        bits.append((~torch.isfinite(row_norm_max)
                     | (row_norm_max > _f32(cfg.row_norm_max)), FLAG_ROW_NORM))
    flags = torch.zeros((), dtype=torch.int32, device=loss.device)
    for cond, bit in bits:
        flags = flags | torch.where(cond, bit, 0).to(torch.int32)
    decay = _f32(cfg.ema_decay)
    rest = _f32(np.float32(1.0) - np.float32(cfg.ema_decay))  # 1 - decay in float32
    new_ema = torch.where(flags == 0,
                          torch.where(ema < 0, loss, ema * decay + loss * rest),
                          ema)
    return flags, {"ema": new_ema}


def guard_carry(mets: Dict) -> Optional[Dict[str, torch.Tensor]]:
    """The guard carry for the NEXT dispatch from a step's metrics (device
    references only). K-step windows stack metric leaves [K]; the last
    entry is the carry."""
    ema = mets.get("guard_ema")
    if ema is None:
        return None
    if ema.dim():
        ema = ema[-1]
    return {"ema": ema}
