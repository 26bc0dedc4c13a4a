"""Criteo feature schema (13 numeric I1-I13, 26 categorical C1-C26)."""
from __future__ import annotations

from typing import List

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
