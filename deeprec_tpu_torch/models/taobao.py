"""Taobao user-behavior feature schema shared by DIN/DIEN/BST — the port's
copy of `deeprec_tpu/models/taobao.py`: user, item and category ids plus a
clicked-item behavior sequence."""
from __future__ import annotations

from typing import List

from deeprec_tpu_torch.config import EmbeddingVariableOption, TableConfig
from deeprec_tpu_torch.features import SparseFeature


def behavior_features(
    emb_dim: int = 16,
    capacity: int = 1 << 16,
    ev: EmbeddingVariableOption = EmbeddingVariableOption(),
    key_dtype: str = "int32",
    max_len: int = 200,
) -> List:
    """target_item/hist_items share one item table; target_cat/hist_cats
    share one category table. `max_len` is the declared history length."""

    def tc(name):
        return TableConfig(name=name, dim=emb_dim, capacity=capacity, ev=ev,
                           key_dtype=key_dtype)

    return [
        SparseFeature(name="user", table=tc("user"), pooling="mean"),
        SparseFeature(name="target_item", table=tc("target_item"), pooling="mean"),
        SparseFeature(name="hist_items", shared_table="target_item",
                      pooling="none", max_len=max_len),
        SparseFeature(name="target_cat", table=tc("target_cat"), pooling="mean"),
        SparseFeature(name="hist_cats", shared_table="target_cat",
                      pooling="none", max_len=max_len),
    ]
