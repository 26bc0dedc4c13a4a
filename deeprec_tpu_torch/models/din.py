"""DIN, the Deep Interest Network — the port of `deeprec_tpu/models/din.py`:
a local activation unit attends over the user's behavior sequence
conditioned on the target item; the attention-pooled history, the target
and the user feed an MLP head with sigmoid hidden activations.

Parameter tree: the JAX tree {"att": {"mlp": MLP}, "mlp": MLP}. The
histories arrive as sequence features (`ModelInputs.seq`) over the tables
they share with the targets (`models/taobao.py`). Weights come from
`seed`; parity tests carry the JAX weights across.
"""
from __future__ import annotations

from typing import Sequence

import torch

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.taobao import behavior_features


class DIN(dnn.SeededModule):

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        att_hidden: Sequence[int] = (36,),
        hidden: Sequence[int] = (200, 80),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        seed: int = 0,
    ):
        super().__init__()
        self.emb_dim, self.capacity = emb_dim, capacity
        self.features = behavior_features(emb_dim, capacity, ev)
        g = torch.Generator().manual_seed(seed)
        D = 2 * emb_dim  # item ++ cat
        self.att = dnn.DINAttention(D, att_hidden, g)
        self.mlp = dnn.MLP(emb_dim + 2 * D, [*hidden, 1], g)

    def forward(self, inputs) -> torch.Tensor:
        hist_i, mask = inputs.seq["hist_items"]
        hist_c, _ = inputs.seq["hist_cats"]
        hist = torch.cat([hist_i, hist_c], dim=-1)  # [B, L, 2d]
        target = torch.cat(
            [inputs.pooled["target_item"], inputs.pooled["target_cat"]], dim=-1)
        attended = self.att(target, hist, mask)
        x = torch.cat([inputs.pooled["user"], target, attended], dim=-1)
        return self.mlp(x, activation=torch.sigmoid)[:, 0]
