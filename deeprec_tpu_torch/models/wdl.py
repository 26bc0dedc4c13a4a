"""Wide & Deep on Criteo — the port of `deeprec_tpu/models/wdl.py`: 13
numeric and 26 categorical features; the wide part is a linear function of
each embedding's first component and the numerics, the deep part an MLP
over the concatenated embeddings and numerics.

The module's parameter tree is the JAX tree {"deep": MLP, "wide_w"
[num_cat + num_dense], "wide_b" (0-d)}, so `nn.jax_leaf_names` gives
`dense.npz`'s flatten order. Weights come from `seed` through an explicit
torch.Generator; the values differ from JAX's `init(key)` — parity tests
carry the JAX weights across.
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


class WDL(CriteoModel):

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
        self.wide_w = nn.Parameter(
            torch.randn((num_cat + num_dense,), generator=g) * 0.01)
        self.wide_b = nn.Parameter(torch.zeros(()))

    def forward(self, inputs) -> torch.Tensor:
        embs, dense = self._embs(inputs), self._numerics(inputs)
        deep_out = self.deep(torch.cat(embs + [dense], dim=-1))[:, 0]
        wide_in = torch.cat([e[:, :1] for e in embs] + [dense], dim=-1)
        return deep_out + (dnn.matmul(wide_in, self.wide_w) + self.wide_b)
