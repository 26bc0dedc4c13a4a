"""Segment combiners for ragged sparse features (port of
`deeprec_tpu/embedding/combiners.py`): the bag is a dense [B, L] padded id
matrix and the combine is a masked reduction over L."""
from __future__ import annotations

import torch


def combine(
    emb_u: torch.Tensor,  # [U, D] unique embeddings
    inverse: torch.Tensor,  # [B, L] position -> unique index
    mask: torch.Tensor,  # [B, L] bool, True for real (non-pad) ids
    combiner: str = "mean",
) -> torch.Tensor:
    """Gather per-position embeddings from the unique set and reduce each
    bag to [B, D]."""
    e = emb_u[inverse.long()]  # [B, L, D]
    m = mask[..., None].to(e.dtype)
    s = torch.sum(e * m, dim=1)
    n = torch.sum(m, dim=1)
    if combiner == "sum":
        return s
    if combiner == "mean":
        return s / torch.clamp(n, min=1.0)
    if combiner == "sqrtn":
        return s / torch.sqrt(torch.clamp(n, min=1.0))
    raise ValueError(f"unknown combiner: {combiner}")
