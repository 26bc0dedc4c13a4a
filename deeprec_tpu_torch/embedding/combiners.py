"""Segment combiners for ragged sparse features (port of
`deeprec_tpu/embedding/combiners.py`): the bag is a dense [B, L] padded id
matrix and the combine is a masked reduction over L.

`combine` is the differentiable form the train step uses;
`combine_pooled_group` is the read-only form serving and evaluation use,
one launch of the pooled-gather kernel (#4,
`ops.fused_lookup.fused_gather_combine_grouped`) for a group of features."""
from __future__ import annotations

from typing import List, Sequence

import torch

from deeprec_tpu_torch.ops.fused_lookup import (
    _bag_denominator, fused_gather_combine_grouped)


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


def pooled_operands(
    inverse: torch.Tensor,  # [B, L] position -> unique index
    mask: torch.Tensor,  # [B, L] bool, True for real (non-pad) ids
    combiner: str = "mean",
):
    """Kernel #4's (row_ix, w) for the bags of `combine`: row_ix [B, L]
    int32 is inverse where the mask holds, else -1 (skipped); w [B, L] f32
    is the combiner as a per-bag weight, 1, 1/max(n, 1) or 1/sqrt(max(n, 1)),
    and 0 at pads."""
    row_ix = torch.where(mask, inverse.to(torch.int32), -1)
    w = torch.where(mask, torch.reciprocal(_bag_denominator(mask, combiner)), 0.0)
    return row_ix, w


def combine_pooled_group(
    embs: Sequence[torch.Tensor],  # F x [U_f, D] unique embeddings, one dtype
    inverses: Sequence[torch.Tensor],  # F x [B, L_f] position -> unique index
    masks: Sequence[torch.Tensor],  # F x [B, L_f] bool, True for real ids
    combiners: Sequence[str],
) -> List[torch.Tensor]:
    """The bags of `combine` [B, D] f32 of F features, without autograd,
    through one grouped #4 launch on `pooled_operands`. #4 multiplies each
    row by its weight and then sums, where `combine` sums and then divides:
    the two differ by f32 rounding only. Where the features share L and
    combiner, their (row_ix, w) come from one `pooled_operands` over the
    stacked [F, B, L] tensors; otherwise from one per feature."""
    embs, inverses, masks, combiners = (list(x) for x in (embs, inverses, masks,
                                                          combiners))
    if not embs:
        return []
    if len(set(combiners)) == 1 and len({tuple(i.shape) for i in inverses}) == 1:
        row_ix, w = pooled_operands(torch.stack(inverses), torch.stack(masks),
                                    combiners[0])
        row_ix, w = row_ix.unbind(0), w.unbind(0)
    else:
        row_ix, w = zip(*(pooled_operands(i, m, c)
                          for i, m, c in zip(inverses, masks, combiners)))
    return fused_gather_combine_grouped(embs, row_ix, w)
