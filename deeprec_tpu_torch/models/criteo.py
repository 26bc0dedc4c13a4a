"""Criteo feature schema (13 numeric I1-I13, 26 categorical C1-C26)."""
from __future__ import annotations

from typing import List

import torch

from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.config import EmbeddingVariableOption, TableConfig
from deeprec_tpu_torch.features import DenseFeature, SparseFeature

CRITEO_DENSE = [f"I{i}" for i in range(1, 14)]
CRITEO_CAT = [f"C{i}" for i in range(1, 27)]


def criteo_features(
    emb_dim: int = 16,
    capacity: int = 1 << 16,
    ev: EmbeddingVariableOption = EmbeddingVariableOption(),
    num_cat: int = 26,
    num_dense: int = 13,
    key_dtype: str = "int32",
) -> List:
    feats: List = [
        SparseFeature(
            name=name,
            table=TableConfig(
                name=name, dim=emb_dim, capacity=capacity, ev=ev,
                key_dtype=key_dtype,
            ),
            pooling="mean",
        )
        for name in CRITEO_CAT[:num_cat]
    ]
    feats += [DenseFeature(name=name, width=1) for name in CRITEO_DENSE[:num_dense]]
    return feats


class CriteoModel(dnn.SeededModule):
    """The Criteo models' shared front: `features` (num_cat pooled tables,
    num_dense numerics), the field embeddings in feature order, and the
    numerics under the Criteo standard transform log1p(max(x, 0))."""

    def __init__(self, emb_dim: int, capacity: int, ev: EmbeddingVariableOption,
                 num_cat: int, num_dense: int):
        super().__init__()
        self.emb_dim, self.capacity = emb_dim, capacity
        self.num_cat, self.num_dense = num_cat, num_dense
        self.features = criteo_features(emb_dim=emb_dim, capacity=capacity, ev=ev,
                                        num_cat=num_cat, num_dense=num_dense)
        self._cats = [f.name for f in self.features if isinstance(f, SparseFeature)]
        self._dense = [f.name for f in self.features if isinstance(f, DenseFeature)]

    def _embs(self, inputs) -> List[torch.Tensor]:
        return [inputs.pooled[c] for c in self._cats]  # each [B, emb_dim]

    def _numerics(self, inputs) -> torch.Tensor:
        dense = torch.cat([inputs.dense[d] for d in self._dense], dim=-1)
        return torch.log1p(torch.clamp(dense, min=0.0))
