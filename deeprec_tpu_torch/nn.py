"""NN layers for the modelzoo — the port of `deeprec_tpu/nn.py` (the layers
DLRM and DLRM-DCN use).

Parameters keep the JAX package's layout (`w` is [in, out]) and names, so a
module's parameter tree is the JAX param tree: `param_tree` rebuilds it and
`jax_leaf_names` lists the leaves in `jax.tree_util` flatten order (dict
keys sorted, lists in order), the order of `dense.npz` in a checkpoint.

Numerics follow the JAX package: `dense_apply` rounds both operands to
bf16 and accumulates in f32 (the MXU's bf16-in / f32-out product). Products
of bf16 values are exact in f32, so rounding the operands and multiplying
in f32 computes the same thing; `torch.matmul` on bf16 tensors would round
the output to bf16 as well, which JAX does not. The cross network
multiplies in plain f32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
from torch import nn


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim


# ----------------------------------------------------------------- dense / MLP


def dense_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = bf16(x) @ bf16(w) accumulated in f32, plus b."""
    return torch.matmul(_bf16(x), _bf16(p["w"])) + p["b"]


def mlp_apply(layers: Sequence, x: torch.Tensor, activation=torch.relu,
              final_activation=None) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = dense_apply(layer, x)
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def crossnet_apply(layers: Sequence, x0: torch.Tensor) -> torch.Tensor:
    """DCNv2 cross layer: x_{l+1} = x0 * (x_l W + b) + x_l, in f32."""
    x = x0
    for layer in layers:
        x = x0 * (torch.matmul(x, layer["w"]) + layer["b"]) + x
    return x


def dot_interaction(emb_stack: torch.Tensor, keep_diag: bool = False) -> torch.Tensor:
    """DLRM pairwise dot interactions over [B, F, D] -> [B, F*(F-1)/2]
    (upper triangle, row-major, as numpy's triu_indices)."""
    F = emb_stack.shape[1]
    z = torch.einsum("bfd,bgd->bfg", emb_stack, emb_stack)
    i, j = torch.triu_indices(F, F, offset=0 if keep_diag else 1,
                              device=emb_stack.device)
    return z[:, i, j]


# --------------------------------------------------------------- modules


class Dense(nn.Module):
    """One dense layer's parameters, JAX layout: w [in, out], b [out]."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(_glorot((in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class MLP(nn.Module):
    """{"layers": [Dense, ...]} — the JAX mlp param tree."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        dims = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            Dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x, activation=torch.relu, final_activation=None):
        return mlp_apply(self.layers, x, activation, final_activation)


class CrossNet(nn.Module):
    """{"layers": [{"w" [dim, dim], "b" [dim]}, ...]} — DCNv2 cross net."""

    def __init__(self, dim: int, depth: int, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(dim, dim, generator) for _ in range(depth)
        )

    def forward(self, x0):
        return crossnet_apply(self.layers, x0)


# ------------------------------------------------------- JAX tree layout


def param_tree(named: Dict[str, torch.Tensor]):
    """Nested dict/list tree of a flat {"a.layers.0.w": tensor} mapping:
    dotted names become dict levels, all-digit levels become lists."""
    tree: dict = {}
    for name, t in named.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)


def _leaf_paths(node, prefix: str) -> List[str]:
    if isinstance(node, dict):
        return [p for k in sorted(node)
                for p in _leaf_paths(node[k], f"{prefix}{k}.")]
    if isinstance(node, list):
        return [p for i, v in enumerate(node)
                for p in _leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def jax_leaf_names(module: nn.Module) -> List[str]:
    """Parameter names of `module` in `jax.tree_util` flatten order of the
    equivalent JAX param tree — leaf i of dense.npz is the parameter named
    jax_leaf_names(module)[i]. `named_parameters()` order differs (it
    follows construction order, `w` before `b`)."""
    return _leaf_paths(param_tree(dict(module.named_parameters())), "")
