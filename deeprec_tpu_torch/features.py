"""Feature specs — the port's copy of `deeprec_tpu/features.py`.

Batches are plain dicts: sparse features as int id arrays [B] or [B, L]
padded with `pad_value`; dense features as float arrays [B, W].
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from deeprec_tpu_torch.config import TableConfig, validate_unique_budget


@dataclasses.dataclass(frozen=True)
class SparseFeature:
    """A categorical (id/multi-id) feature backed by a hash-embedding table.

    pooling: 'mean' | 'sum' | 'sqrtn' pool the bag to [B, D]; 'none'
    delivers the sequence [B, L, D] plus mask. shared_table names another
    feature whose table this one reuses; max_len keeps differently-shaped
    features in separate groups."""

    name: str
    table: Optional[TableConfig] = None
    pooling: str = "mean"
    pad_value: int = -1
    shared_table: Optional[str] = None
    max_len: Optional[int] = None
    unique_budget: Optional[object] = None  # None | "off" | "auto" | int

    def __post_init__(self):
        if (self.table is None) == (self.shared_table is None):
            raise ValueError(
                f"{self.name}: exactly one of table/shared_table must be set"
            )
        validate_unique_budget(self.unique_budget, f"feature {self.name}")


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A numeric feature column, passed through."""

    name: str
    width: int = 1


def sparse_features(specs) -> list:
    return [f for f in specs if isinstance(f, SparseFeature)]


def dense_features(specs) -> list:
    return [f for f in specs if isinstance(f, DenseFeature)]


def table_configs(specs) -> dict:
    """Unique tables declared by a spec list (shared tables deduped)."""
    return {
        f.name: f.table for f in sparse_features(specs) if f.table is not None
    }


def resolve_table_name(spec: SparseFeature) -> str:
    return spec.shared_table if spec.shared_table is not None else spec.name
