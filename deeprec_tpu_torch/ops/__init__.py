"""Lookup ops: the row-gather, pooled-gather and row-scatter kernel
wrappers (`ops/fused_lookup.py`), as the JAX package's `ops` exports them."""
from deeprec_tpu_torch.ops.fused_lookup import (
    apply_rows_sr,
    fused_gather_combine,
    gather_rows,
)

__all__ = ["apply_rows_sr", "fused_gather_combine", "gather_rows"]
