"""Sparse optimizers for hash-embedding tables — the port of
`deeprec_tpu/optim/sparse.py`.

Each optimizer is a row function: it receives the gathered value and slot
rows of the unique touched keys and the per-key batch counts, and returns
updated rows that the apply scatters back. Rows carry the port's leading
table axis: value, grad and per-row slots are [T, U, D] (or [T, U, 1]),
counts [T, U], per-table scalar slots [T, 1, 1]. `step` is the global step
(an int), `lr` a float. Scalar factors are computed in float32, as the JAX
package computes them, and the arithmetic follows its operation order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Slots = Dict[str, torch.Tensor]

# Slot names with this prefix are per-table scalars, not per-key rows.
SCALAR_PREFIX = "scalar/"


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """x as a 0-d float32 tensor on `like`'s device; a Python number is
    filled on the device, with no host-to-device copy."""
    if torch.is_tensor(x):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _rsqrt_guarded(acc: torch.Tensor) -> torch.Tensor:
    # guard acc == 0 (possible after external slot resets + zero grad):
    # rsqrt(0) would turn a zero update into NaN
    return torch.rsqrt(torch.clamp(acc, min=1e-30))


def _bias_corrected_lr(lr, beta1, beta2, t, like):
    """lr * sqrt(1 - b2^t) / (1 - b1^t), every factor in float32."""
    t = _f32(t, like)
    return _f32(lr, like) * torch.sqrt(1.0 - torch.pow(_f32(beta2, like), t)) / (
        1.0 - torch.pow(_f32(beta1, like), t))


@dataclasses.dataclass(frozen=True)
class SparseOptimizer:
    """Base: hyperparameters are static floats; `lr` may be overridden per
    apply call."""

    lr: float = 0.01

    def slot_specs(self, dim: int) -> Dict[str, Tuple[Tuple[int, ...], float]]:
        """name -> (row_shape, init_value). Row shape (dim,) or (1,)."""
        return {}

    def update(self, value, slots: Slots, grad, counts, step, lr
               ) -> Tuple[torch.Tensor, Slots]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class GradientDescent(SparseOptimizer):
    """KvResourceSparseApplyGradientDescent."""

    def update(self, value, slots, grad, counts, step, lr):
        return value - lr * grad, {}


@dataclasses.dataclass(frozen=True)
class Adagrad(SparseOptimizer):
    """KvResourceSparseApplyAdagrad."""

    initial_accumulator_value: float = 0.1

    def slot_specs(self, dim):
        return {"accum": ((dim,), self.initial_accumulator_value)}

    def update(self, value, slots, grad, counts, step, lr):
        acc = slots["accum"] + grad * grad
        return value - lr * grad * _rsqrt_guarded(acc), {"accum": acc}


@dataclasses.dataclass(frozen=True)
class AdagradDecay(SparseOptimizer):
    """KvResourceSparseApplyAdagradDecay: Adagrad whose accumulator is
    scaled by `accumulator_decay_rate` every `accumulator_decay_step`
    global steps (floor `accumulator_baseline`), applied lazily per key
    from a per-key period slot that stores (last applied period + 1)."""

    initial_accumulator_value: float = 0.1
    accumulator_decay_step: int = 100000
    accumulator_decay_rate: float = 0.9
    accumulator_baseline: float = 0.0

    def slot_specs(self, dim):
        return {
            "accum": ((dim,), self.initial_accumulator_value),
            "decay_period": ((1,), 0.0),
        }

    def update(self, value, slots, grad, counts, step, lr):
        period = _f32(int(step) // int(self.accumulator_decay_step), value)
        stored = slots["decay_period"][..., 0]
        # 0 marks a never-updated key, whose fresh accumulator must not be
        # decayed retroactively by the current global period
        elapsed = torch.where(
            stored > 0.0, torch.clamp(period - (stored - 1.0), min=0.0), 0.0)
        scale = torch.pow(_f32(self.accumulator_decay_rate, value), elapsed)[..., None]
        acc = torch.clamp(slots["accum"] * scale, min=self.accumulator_baseline)
        acc = acc + grad * grad
        new_value = value - lr * grad * _rsqrt_guarded(acc)
        new_period = torch.zeros_like(slots["decay_period"]) + period + 1.0
        return new_value, {"accum": acc, "decay_period": new_period}


@dataclasses.dataclass(frozen=True)
class Adam(SparseOptimizer):
    """KvResourceSparseApplyAdam: bias correction from the global step."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def slot_specs(self, dim):
        return {"m": ((dim,), 0.0), "v": ((dim,), 0.0)}

    def update(self, value, slots, grad, counts, step, lr):
        m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grad
        v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grad * grad
        alpha = _bias_corrected_lr(lr, self.beta1, self.beta2, int(step) + 1, value)
        new_value = value - alpha * m / (torch.sqrt(v) + self.epsilon)
        return new_value, {"m": m, "v": v}


@dataclasses.dataclass(frozen=True)
class AdamAsync(SparseOptimizer):
    """KvResourceSparseApplyAdamAsync: beta powers live as per-table scalar
    slots advanced on every apply instead of read from the global step;
    `apply_sparse_rmsprop` takes the RMSProp-style step without momentum
    bias correction."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    apply_sparse_rmsprop: bool = False

    def slot_specs(self, dim):
        return {
            "m": ((dim,), 0.0),
            "v": ((dim,), 0.0),
            SCALAR_PREFIX + "beta1_power": ((1,), self.beta1),
            SCALAR_PREFIX + "beta2_power": ((1,), self.beta2),
        }

    def update(self, value, slots, grad, counts, step, lr):
        b1p = slots[SCALAR_PREFIX + "beta1_power"]  # [T, 1, 1]
        b2p = slots[SCALAR_PREFIX + "beta2_power"]
        if self.apply_sparse_rmsprop:
            v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grad * grad
            m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grad
            new_value = value - lr * m * torch.rsqrt(v + self.epsilon)
        else:
            m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grad
            v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grad * grad
            alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
            new_value = value - alpha * m / (torch.sqrt(v) + self.epsilon)
        return new_value, {
            "m": m,
            "v": v,
            SCALAR_PREFIX + "beta1_power": b1p * self.beta1,
            SCALAR_PREFIX + "beta2_power": b2p * self.beta2,
        }


@dataclasses.dataclass(frozen=True)
class AdamW(SparseOptimizer):
    """KvResourceSparseApplyAdamW: Adam with decoupled weight decay."""

    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 0.01

    def slot_specs(self, dim):
        return {"m": ((dim,), 0.0), "v": ((dim,), 0.0)}

    def update(self, value, slots, grad, counts, step, lr):
        m = self.beta1 * slots["m"] + (1.0 - self.beta1) * grad
        v = self.beta2 * slots["v"] + (1.0 - self.beta2) * grad * grad
        alpha = _bias_corrected_lr(lr, self.beta1, self.beta2, int(step) + 1, value)
        new_value = value - alpha * (
            m / (torch.sqrt(v) + self.epsilon)
        ) - lr * self.weight_decay * value
        return new_value, {"m": m, "v": v}


@dataclasses.dataclass(frozen=True)
class Ftrl(SparseOptimizer):
    """KvResourceSparseApplyFtrl: FTRL-proximal, the classic CTR
    optimizer."""

    learning_rate_power: float = -0.5
    initial_accumulator_value: float = 0.1
    l1: float = 0.0
    l2: float = 0.0

    def slot_specs(self, dim):
        return {
            "accum": ((dim,), self.initial_accumulator_value),
            "linear": ((dim,), 0.0),
        }

    def update(self, value, slots, grad, counts, step, lr):
        accum, linear = slots["accum"], slots["linear"]
        new_accum = accum + grad * grad
        p = -self.learning_rate_power
        sigma = (torch.pow(new_accum, p) - torch.pow(accum, p)) / lr
        linear = linear + grad - sigma * value
        quad = torch.pow(new_accum, p) / lr + 2.0 * self.l2
        l1_reg = self.l1 * torch.sign(linear)
        new_value = torch.where(
            torch.abs(linear) > self.l1, (l1_reg - linear) / quad, 0.0)
        return new_value, {"accum": new_accum, "linear": linear}


REGISTRY = {
    "sgd": GradientDescent,
    "adagrad": Adagrad,
    "adagrad_decay": AdagradDecay,
    "adam": Adam,
    "adam_async": AdamAsync,
    "adamw": AdamW,
    "ftrl": Ftrl,
}


def make(name: str, **kw) -> SparseOptimizer:
    return REGISTRY[name](**kw)
