"""Dense optimizer — the port's counterpart of the `optax.adam` the JAX
Trainer uses by default (`deeprec_tpu/training/trainer.py:212`).

`adam(lr, b1, b2, eps)` follows optax's update math and operation order,
not `torch.optim.Adam`'s (which rounds differently):

    mu    = (1 - b1) * g + b1 * mu
    nu    = (1 - b2) * g * g + b2 * nu
    count = count + 1                               (int32)
    u     = -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    p     = p + u

with eps_root = 0 and the bias terms computed in float32. The state
flattens in optax's leaf order: `count`, then the `mu` leaves, then the `nu`
leaves, each in `nn.jax_leaf_names` order — the layout of `opt.npz`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor  # [] int32: updates applied so far
    mu: Params  # first moments, one per parameter
    nu: Params  # second moments


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Params) -> AdamState:
        any_p = next(iter(params.values()))
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=any_p.device),
            mu={n: torch.zeros_like(p) for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()},
        )

    def update(self, grads: Params, state: AdamState, params: Params = None):
        """(updates, new state) for gradients `grads`; add the updates to
        the parameters (`apply_updates`)."""
        del params
        count = state.count + 1  # int32; 2^31 updates are out of reach
        f32 = dict(dtype=torch.float32, device=count.device)
        c = count.to(torch.float32)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, **f32), c)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, **f32), c)
        mu, nu, updates = {}, {}, {}
        for n, g in grads.items():
            mu[n] = (1.0 - self.b1) * g + self.b1 * state.mu[n]
            nu[n] = (1.0 - self.b2) * (g * g) + self.b2 * state.nu[n]
            u = (mu[n] / bc1) / (torch.sqrt(nu[n] / bc2) + self.eps)
            updates[n] = -self.lr * u
        return updates, AdamState(count=count, mu=mu, nu=nu)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(lr=lr, b1=b1, b2=b2, eps=eps)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> Params:
    """p += u for every parameter, IN PLACE."""
    for n, u in updates.items():
        params[n].add_(u)
    return params


def state_leaves(state: AdamState, names: Sequence[str]) -> List[np.ndarray]:
    """The state as host arrays in optax's flatten order (count, mu..., nu...),
    `names` being the parameters in JAX leaf order."""
    out = [state.count.cpu().numpy()]
    out += [state.mu[n].detach().cpu().numpy() for n in names]
    out += [state.nu[n].detach().cpu().numpy() for n in names]
    return out


def state_from_leaves(leaves: Sequence[np.ndarray], names: Sequence[str],
                      params: Params) -> AdamState:
    """Inverse of `state_leaves`, on the parameters' devices and shapes."""
    if len(leaves) != 1 + 2 * len(names):
        raise ValueError(f"{len(leaves)} optimizer leaves, Adam over "
                         f"{len(names)} parameters has {1 + 2 * len(names)}")

    def put(leaf, n):
        p = params[n]
        leaf = np.asarray(leaf, np.float32)
        if leaf.size != p.numel():
            raise ValueError(f"optimizer leaf of shape {leaf.shape} for "
                             f"parameter {n} of shape {tuple(p.shape)}")
        return torch.tensor(leaf.reshape(tuple(p.shape)), device=p.device)

    k = len(names)
    any_p = next(iter(params.values()))
    return AdamState(
        count=torch.tensor(int(np.asarray(leaves[0])), dtype=torch.int32,
                           device=any_p.device),
        mu={n: put(leaves[1 + i], n) for i, n in enumerate(names)},
        nu={n: put(leaves[1 + k + i], n) for i, n in enumerate(names)},
    )
