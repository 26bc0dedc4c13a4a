"""DIEN, the Deep Interest Evolution Network — the port of
`deeprec_tpu/models/dien.py`: an interest-extraction GRU over the user's
behavior sequence, a bilinear attention of its states against the target
item, then an AUGRU (the attention scales its update gate) whose final
state is the evolved interest; it, the target and the user feed an MLP
head with sigmoid hidden activations.

Parameter tree: the JAX tree {"att_w": Dense(H, 2 emb), "augru": GRU(H, H),
"gru1": GRU(2 emb, H), "mlp": MLP}. The histories arrive as sequence
features (`ModelInputs.seq`) over the tables they share with the targets
(`models/taobao.py`). Both recurrences run as eager loops over the history
(`nn.gru_apply`). Weights come from `seed`; parity tests carry the JAX
weights across.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption
from deeprec_tpu_torch.models.taobao import behavior_features


class DIEN(dnn.SeededModule):

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        gru_hidden: int = 32,
        hidden: Sequence[int] = (200, 80),
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        seed: int = 0,
    ):
        super().__init__()
        self.emb_dim, self.capacity = emb_dim, capacity
        self.features = behavior_features(emb_dim, capacity, ev)
        g = torch.Generator().manual_seed(seed)
        D, H = 2 * emb_dim, gru_hidden  # item ++ cat
        self.gru1 = dnn.GRU(D, H, g)
        self.augru = dnn.GRU(H, H, g)
        self.att_w = dnn.Dense(H, D, g)
        self.mlp = dnn.MLP(emb_dim + D + H, [*hidden, 1], g)

    def forward(self, inputs) -> torch.Tensor:
        hist_i, mask = inputs.seq["hist_items"]
        hist_c, _ = inputs.seq["hist_cats"]
        hist = torch.cat([hist_i, hist_c], dim=-1)  # [B, L, D]
        target = torch.cat(
            [inputs.pooled["target_item"], inputs.pooled["target_cat"]], dim=-1)
        _, states = self.gru1(hist, mask)  # interest extraction [B, L, H]
        proj = dnn.dense_apply(self.att_w, states)  # [B, L, D]
        scores = torch.einsum("bld,bd->bl", proj, target) / math.sqrt(target.shape[-1])
        att = torch.softmax(torch.where(mask, scores, -1e9), dim=1)
        att = torch.where(mask, att, 0.0)
        final, _ = self.augru(states, mask, att)  # interest evolution
        x = torch.cat([inputs.pooled["user"], target, final], dim=-1)
        return self.mlp(x, activation=torch.sigmoid)[:, 0]
