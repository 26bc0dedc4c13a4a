"""MaskNet on Criteo — the port of `deeprec_tpu/models/masknet.py`: serial
instance-guided MaskBlocks, each projecting the raw feature concat into a
multiplicative mask over the running hidden state.

Parameter tree: the JAX tree {"blocks": [{"ln", "mask1", "mask2",
"proj"}, ...], "head": MLP}. The first block's mask2 and proj are as wide
as the feature concat (num_cat * emb_dim + num_dense), the later ones
`block_dim`. Weights come from `seed`; parity tests carry the JAX weights
across.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.criteo import CriteoModel


class MaskBlock(nn.Module):
    """{"mask1": Dense(W, mask_hidden), "mask2": Dense(mask_hidden, d),
    "proj": Dense(d, block_dim), "ln": LayerNorm(block_dim)}."""

    def __init__(self, width: int, mask_hidden: int, d: int, block_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.mask1 = dnn.Dense(width, mask_hidden, generator)
        self.mask2 = dnn.Dense(mask_hidden, d, generator)
        self.proj = dnn.Dense(d, block_dim, generator)
        self.ln = dnn.LayerNorm(block_dim)

    def forward(self, x, h):
        mask = dnn.dense_apply(self.mask2, torch.relu(dnn.dense_apply(self.mask1, x)))
        h = dnn.layernorm_apply(self.ln, dnn.dense_apply(self.proj, mask * h))
        return torch.relu(h)


class MaskNet(CriteoModel):

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        num_blocks: int = 3,
        block_dim: int = 64,
        mask_hidden: int = 64,
        hidden: Sequence[int] = (64,),
        num_cat: int = 26,
        num_dense: int = 13,
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        seed: int = 0,
    ):
        super().__init__(emb_dim, capacity, ev, num_cat, num_dense)
        g = torch.Generator().manual_seed(seed)
        width = num_cat * emb_dim + num_dense
        dims = [width] + [block_dim] * (num_blocks - 1)
        self.blocks = nn.ModuleList(
            MaskBlock(width, mask_hidden, d, block_dim, g) for d in dims)
        self.head = dnn.MLP(block_dim, [*hidden, 1], g)

    def forward(self, inputs) -> torch.Tensor:
        x = torch.cat(self._embs(inputs) + [self._numerics(inputs)], dim=-1)
        h = x
        for blk in self.blocks:
            h = blk(x, h)
        return self.head(h)[:, 0]
