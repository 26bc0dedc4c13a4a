"""DCN and DCNv2 on Criteo — the port of `deeprec_tpu/models/dcn.py`: a
cross network and a deep tower over [embeddings | numerics], joined by a
dense head on [cross | deep]. DCNv2 crosses with matrix weights, DCN with
the original vector weights: the same model with the cross flavour
swapped.

Parameter tree: the JAX tree {"cross": {"layers": [...]}, "deep": MLP,
"head": Dense}. Weights come from `seed`; parity tests carry the JAX
weights across.
"""
from __future__ import annotations

from typing import Sequence

import torch

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.criteo import (
    CRITEO_CAT, CRITEO_DENSE, CriteoModel,
)


class DCNv2(CriteoModel):
    # the cross-network flavour: DCN below swaps in the vector weights
    _cross = dnn.CrossNet

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        cross_depth: int = 3,
        hidden: Sequence[int] = (1024, 512),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        num_cat: int = len(CRITEO_CAT),
        num_dense: int = len(CRITEO_DENSE),
        seed: int = 0,
    ):
        super().__init__(emb_dim, capacity, ev, num_cat, num_dense)
        g = torch.Generator().manual_seed(seed)
        w = num_cat * emb_dim + num_dense
        self.cross = self._cross(w, cross_depth, g)
        self.deep = dnn.MLP(w, list(hidden), g)
        self.head = dnn.Dense(w + hidden[-1], 1, g)

    def forward(self, inputs) -> torch.Tensor:
        x0 = torch.cat(self._embs(inputs) + [self._numerics(inputs)], dim=-1)
        cross = self.cross(x0)
        deep = self.deep(x0, final_activation=torch.relu)
        return dnn.dense_apply(self.head, torch.cat([cross, deep], dim=-1))[:, 0]


class DCN(DCNv2):
    """Original DCN (vector-weight cross network)."""

    _cross = dnn.CrossNetV1
