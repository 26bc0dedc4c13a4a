"""BST, the Behavior Sequence Transformer — the port of
`deeprec_tpu/models/bst.py`: the target item is appended to the behavior
sequence, transformer encoder blocks mix them, and the mean-pooled encoding,
the target position's encoding and the user feed the MLP head.

The module's parameter tree is the JAX tree {"pos" [max_len + 1, 2 emb],
"blocks": [TransformerBlock...], "mlp": MLP}, so `nn.jax_leaf_names` gives
`dense.npz`'s flatten order. Weights come from `seed` through an explicit
torch.Generator (`pos` ~ normal * 0.02); the values differ from JAX's
`init(key)` — parity tests carry the JAX weights across.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.taobao import behavior_features


class BST(dnn.SeededModule):
    """use_flash=True runs attention through the flash kernels (#8, #9),
    the sequence padded to a multiple of 128."""

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        heads: int = 4,
        ff: int = 128,
        blocks: int = 1,
        max_len: int = 200,
        use_flash: bool = False,
        hidden: Sequence[int] = (256, 64),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        seed: int = 0,
    ):
        super().__init__()
        self.emb_dim, self.capacity = emb_dim, capacity
        self.heads, self.max_len, self.use_flash = heads, max_len, use_flash
        self.features = behavior_features(emb_dim, capacity, ev)
        g = torch.Generator().manual_seed(seed)
        D = 2 * emb_dim
        self.pos = nn.Parameter(torch.randn((max_len + 1, D), generator=g) * 0.02)
        self.blocks = nn.ModuleList(
            dnn.TransformerBlock(D, ff, g) for _ in range(blocks))
        self.mlp = dnn.MLP(emb_dim + 2 * D, [*hidden, 1], g)

    def forward(self, inputs) -> torch.Tensor:
        hist_i, mask = inputs.seq["hist_items"]
        hist_c, _ = inputs.seq["hist_cats"]
        hist = torch.cat([hist_i, hist_c], dim=-1)  # [B, L, D]
        target = torch.cat(
            [inputs.pooled["target_item"], inputs.pooled["target_cat"]], dim=-1)
        B, L, _ = hist.shape
        seq = torch.cat([hist, target[:, None, :]], dim=1)  # [B, L + 1, D]
        seq = seq + self.pos[None, :L + 1, :]
        m = torch.cat([mask, mask.new_ones((B, 1))], dim=1)
        for blk in self.blocks:
            seq = blk(seq, m, self.heads, flash=self.use_flash)
        denom = m.sum(dim=1, keepdim=True).to(torch.float32)
        # mask before pooling: padded positions carry positional embedding
        # and FF residuals through the encoder
        pooled = (seq * m[..., None]).sum(dim=1) / torch.clamp(denom, min=1.0)
        x = torch.cat([inputs.pooled["user"], pooled, seq[:, L]], dim=-1)
        return self.mlp(x)[:, 0]
