"""DLRM and DLRM-DCN on Criteo — the port of `deeprec_tpu/models/dlrm.py`.

Each model is an nn.Module whose parameter tree is the JAX param tree
(`bottom` / `top` MLPs, and `cross` for DLRM-DCN), so a JAX checkpoint's
dense leaves load one to one (nn.jax_leaf_names). Weights are initialised
from `seed` through an explicit torch.Generator; the values differ from
JAX's `init(key)` — parity tests carry the JAX weights across instead.
"""
from __future__ import annotations

from typing import Sequence

import torch

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.criteo import CRITEO_CAT, CRITEO_DENSE, CriteoModel


class DLRM(CriteoModel):
    """Bottom MLP over numerics, dim-d embeddings per categorical field,
    pairwise dot interactions, top MLP."""

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        bottom: Sequence[int] = (512, 256, 64, 16),
        top: Sequence[int] = (512, 256, 1),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        num_cat: int = len(CRITEO_CAT),
        num_dense: int = len(CRITEO_DENSE),
        seed: int = 0,
    ):
        if bottom[-1] != emb_dim:
            raise ValueError("bottom MLP must end at emb_dim")
        super().__init__(emb_dim, capacity, ev, num_cat, num_dense)
        g = torch.Generator().manual_seed(seed)
        self._build(bottom, top, g)

    def _build(self, bottom, top, g):
        F = self.num_cat + 1
        self.bottom = dnn.MLP(self.num_dense, list(bottom), g)
        self.top = dnn.MLP(F * (F - 1) // 2 + self.emb_dim, list(top), g)

    def _bottom(self, inputs) -> torch.Tensor:
        return self.bottom(self._numerics(inputs), final_activation=torch.relu)

    def forward(self, inputs) -> torch.Tensor:
        bottom = self._bottom(inputs)
        embs = torch.stack(self._embs(inputs), dim=1)
        stack = torch.cat([bottom[:, None, :], embs], dim=1)
        inter = dnn.dot_interaction(stack)
        top_in = torch.cat([bottom, inter], dim=-1)
        return self.top(top_in)[:, 0]


class DLRMDCN(DLRM):
    """DLRM_DCN, the MLPerf DLRM-DCNv2 configuration: the dot interaction
    is replaced by a DCNv2 cross network over [bottom | field embeddings]."""

    def __init__(self, *args, cross_depth: int = 3, **kwargs):
        self.cross_depth = cross_depth
        super().__init__(*args, **kwargs)

    def _build(self, bottom, top, g):
        w = (self.num_cat + 1) * self.emb_dim
        self.bottom = dnn.MLP(self.num_dense, list(bottom), g)
        self.cross = dnn.CrossNet(w, self.cross_depth, g)
        self.top = dnn.MLP(w, list(top), g)

    def forward(self, inputs) -> torch.Tensor:
        bottom = self._bottom(inputs)
        x0 = torch.cat([bottom] + self._embs(inputs), dim=-1)
        return self.top(self.cross(x0))[:, 0]
