"""Scatter-free masked-row compaction at a static budget — the port of
`deeprec_tpu/ops/compact.py` (`next_pow2`, `quantize_rows`,
`rank_compact`).

`rank_compact(mask, size)` returns the indices of the first `size` True
positions of `mask` in ascending order (-1 past the count), built from a
prefix sum and a sorted search, with no sort and no data-dependent shape.
The port's version takes a leading batch of rows ([..., C]), one
compaction per row, as the JAX package vmaps it over a stacked bundle.
"""
from __future__ import annotations

from typing import Tuple

import torch


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def quantize_rows(n: int, capacity: int, floor: int = 64) -> int:
    """Static row budget for a measured count `n`: next power of two, at
    least `floor`, never beyond `capacity` (0 = no cap)."""
    e = max(next_pow2(max(int(n), 1)), floor)
    return min(e, int(capacity)) if capacity else e


def rank_compact(mask: torch.Tensor, size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense indices of `mask`'s True positions ([..., C] bool), at static
    length `size`. Returns (idx [..., size] int32, n [...] int32, rank
    [..., C] int32):
      * idx[..., j] is the index of the (j+1)-th True position, -1 once
        j >= n; positions past `size` are truncated;
      * n is the True count (not clipped to `size`);
      * rank is the inclusive prefix sum (rank[i] = True positions at or
        before i)."""
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int32)
    n = rank[..., -1]
    j = torch.arange(1, size + 1, dtype=torch.int32, device=mask.device)
    j = j.expand(*rank.shape[:-1], size).contiguous()
    sel = torch.searchsorted(rank, j, side="left").to(torch.int32)
    idx = torch.where(j <= n[..., None], sel, -1)
    return idx, n, rank
