"""DeepFM on Criteo — the port of `deeprec_tpu/models/deepfm.py`: FM
second-order interactions, a deep MLP over the shared field embeddings,
and a first-order linear term.

Parameter tree: the JAX tree {"deep": MLP, "linear_w" [num_cat +
num_dense], "bias" (0-d)}. Weights come from `seed`; parity tests carry
the JAX weights across.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.criteo import (
    CRITEO_CAT, CRITEO_DENSE, CriteoModel,
)


class DeepFM(CriteoModel):

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        hidden: Sequence[int] = (1024, 512, 256),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        num_cat: int = len(CRITEO_CAT),
        num_dense: int = len(CRITEO_DENSE),
        seed: int = 0,
    ):
        super().__init__(emb_dim, capacity, ev, num_cat, num_dense)
        g = torch.Generator().manual_seed(seed)
        self.deep = dnn.MLP(num_cat * emb_dim + num_dense, [*hidden, 1], g)
        self.linear_w = nn.Parameter(
            torch.randn((num_cat + num_dense,), generator=g) * 0.01)
        self.bias = nn.Parameter(torch.zeros(()))

    def forward(self, inputs) -> torch.Tensor:
        embs = torch.stack(self._embs(inputs), dim=1)  # [B, F, D]
        dense = self._numerics(inputs)
        fm = dnn.fm_apply(embs)[:, 0]
        B = embs.shape[0]
        deep = self.deep(torch.cat([embs.reshape(B, -1), dense], dim=-1))[:, 0]
        first = dnn.matmul(torch.cat([embs[:, :, 0], dense], dim=-1), self.linear_w)
        return fm + deep + first + self.bias
