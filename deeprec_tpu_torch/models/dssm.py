"""DSSM two-tower retrieval — the port of `deeprec_tpu/models/dssm.py`: a
user tower and an item tower, each an MLP over its features' pooled
embeddings whose output is normalised to unit length; the logit is their
cosine similarity scaled by a learnable temperature.

Parameter tree: the JAX tree {"item": MLP, "temp": 0-d (5.0), "user": MLP}.
`user_hidden` gives the user tower its own widths (production towers are
asymmetric); its last width must be `hidden`'s, since the towers meet in a
dot product. The tower methods read the module's own parameters: load a
trained state's `dense` with `load_state_dict` first. Weights come from
`seed`; parity tests carry the JAX weights across.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption, TableConfig
from deeprec_tpu_torch.features import SparseFeature


class DSSM(dnn.SeededModule):

    def __init__(
        self,
        emb_dim: int = 16,
        capacity: int = 1 << 16,
        num_user_feats: int = 4,
        num_item_feats: int = 4,
        hidden: Sequence[int] = (256, 128, 64),
        user_hidden: Optional[Sequence[int]] = None,
        ev: EmbeddingVariableOption = EmbeddingVariableOption(),
        seed: int = 0,
    ):
        super().__init__()
        self.emb_dim, self.capacity = emb_dim, capacity
        self.hidden = tuple(hidden)
        self.user_hidden = self.hidden if user_hidden is None else tuple(user_hidden)
        if self.user_hidden[-1:] != self.hidden[-1:]:
            raise ValueError(
                f"user_hidden must end in the shared tower dim "
                f"{self.hidden[-1]}, got {self.user_hidden}")

        def tc(name):
            return TableConfig(name=name, dim=emb_dim, capacity=capacity, ev=ev)

        self.user_feats = [f"U{i}" for i in range(num_user_feats)]
        self.item_feats = [f"V{i}" for i in range(num_item_feats)]
        self.features = [SparseFeature(name=n, table=tc(n))
                         for n in self.user_feats + self.item_feats]
        g = torch.Generator().manual_seed(seed)
        self.user = dnn.MLP(num_user_feats * emb_dim, self.user_hidden, g)
        self.item = dnn.MLP(num_item_feats * emb_dim, self.hidden, g)
        self.temp = nn.Parameter(torch.tensor(5.0))

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                               min=1e-6)

    def towers(self, inputs):
        """(user vectors [B, H], item vectors [B, H]), both unit length."""
        return self.user_vector(inputs), self._item_vectors_of(inputs)

    def forward(self, inputs) -> torch.Tensor:
        u, v = self.towers(inputs)
        return torch.sum(u * v, dim=-1) * self.temp

    def user_vector(self, inputs) -> torch.Tensor:
        """The user tower alone: compute once per user."""
        u = torch.cat([inputs.pooled[n] for n in self.user_feats], dim=-1)
        return self._normalize(self.user(u))

    def item_vectors(self, item_embs: torch.Tensor) -> torch.Tensor:
        """The item tower over [N, F * D] stacked item features."""
        return self._normalize(self.item(item_embs))

    def _item_vectors_of(self, inputs) -> torch.Tensor:
        return self.item_vectors(
            torch.cat([inputs.pooled[n] for n in self.item_feats], dim=-1))

    @staticmethod
    def item_tower_params(dense: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The entries of `dense` ({parameter name: tensor}, a TrainState's)
        that `item_vectors` reads: what decides whether a dense update moves
        the item corpus's vectors. `temp` is left out: it scales every score
        alike and cannot reorder a top-k."""
        return {n: t for n, t in dense.items() if n.startswith("item.")}

    def apply_with_user(self, user_vec: torch.Tensor, inputs) -> torch.Tensor:
        """The logits given precomputed user vectors [B, H]: row for row
        equal to `forward`."""
        return torch.sum(user_vec * self._item_vectors_of(inputs), dim=-1) * self.temp

    def score_items(self, user_vec: torch.Tensor, item_vecs: torch.Tensor
                    ) -> torch.Tensor:
        """Scores of users [B, H] against candidate items [N, H] (-> [B, N])
        or, per user, [B, N, H] (-> [B, N])."""
        if item_vecs.dim() == 2:
            return user_vec @ item_vecs.T * self.temp
        return torch.einsum("bh,bnh->bn", user_vec, item_vecs) * self.temp
