"""Row hygiene — the port of `deeprec_tpu/guard/rows.py`: the step
sentinel's read of the rows a step updated, the optional row clamp, and
maintain()'s anomaly eviction.

The sentinel bounds the rows a SINGLE step writes: `touched_row_norms`
gathers exactly those rows through the row-gather kernel (#3, #1 on bf16
tables) and `clamp_rows` writes back only the offending ones through the
row-scatter kernel (#5, #2 on bf16 tables). The eviction pass catches slow
contamination: at maintain() cadence every occupied row's L2 norm is held
against `factor x` the occupied-population quantile, and rows past the
bound are dropped by the table's rebuild (optimizer slots restart at their
init value), so the key re-initializes on next sight. Non-finite rows
always count as anomalous. The JAX package's packed small-dim layout has no
counterpart here: every state is [T, C, D].
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows


def nanquantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.nanquantile(x, q)` (linear interpolation) over a 1-D float32
    tensor of any length, by sort and index: the NaNs sort last, the rank is
    q x (n - 1) over the n non-NaN values, computed in float32 as JAX does,
    and the result is low x (1 - w) + high x w. NaN when every value is.
    (`torch.nanquantile` refuses inputs above 2^24 elements and interpolates
    as a lerp.)"""
    vals, _ = torch.sort(x.to(torch.float32))
    n = (~torch.isnan(vals)).sum().to(torch.float32)
    rank = (n - 1.0) * float(np.float32(q))
    low = torch.floor(rank)
    w_high = rank - low
    last = torch.clamp(n - 1.0, min=0.0)
    lo = torch.clamp(low, 0.0, last).long()
    hi = torch.clamp(torch.ceil(rank), 0.0, last).long()
    out = vals[lo] * (1.0 - w_high) + vals[hi] * w_high
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def anomalous_row_mask(table, ts, quantile: float, factor: float) -> torch.Tensor:
    """[T, C] bool: occupied rows whose L2 norm exceeds `factor x` their own
    table's occupied-norm `quantile`, or is non-finite. Device-side; an
    O(C x D) read and one sort per member table, maintain cadence only."""
    vals = ts.values.to(torch.float32)
    norm = vals.square().sum(-1).sqrt()
    occ = table.occupied(ts)
    bad_finite = occ & ~torch.isfinite(norm)
    # the quantile over the occupied population only: empty slots are zero
    # rows and would drag the bound to ~0 on a sparse table
    pop = torch.where(occ, norm, torch.full_like(norm, float("nan")))
    q = torch.stack([nanquantile(p, quantile) for p in pop])[:, None]
    bound = torch.where(torch.isfinite(q), q * float(np.float32(factor)),
                        torch.full_like(q, float("inf")))
    return bad_finite | (occ & torch.isfinite(norm) & (norm > bound))


def anomaly_evict(table, ts, quantile: float, factor: float, slot_fills
                  ) -> Tuple[object, int]:
    """Re-initialize the anomalous rows of one member table state ([1, ...]).
    Returns (new_state, evicted_count); a zero count returns the input state
    untouched (no rebuild paid)."""
    mask = anomalous_row_mask(table, ts, quantile, factor)
    n = int(mask.sum())
    if n == 0:
        return ts, 0
    return table.rebuild(ts, keep=~mask, slot_fills=slot_fills), n


def touched_row_norms(values: torch.Tensor, slot_ix: torch.Tensor) -> torch.Tensor:
    """[T, U] L2 norms of the rows slot_ix [T, U] addresses in values
    [T, C, D] (invalid ix -> 0): the sentinel's post-apply read of exactly
    the rows the step updated, through the row-gather kernel. Reads only."""
    ok = slot_ix >= 0
    rows = gather_rows(values, torch.where(ok, slot_ix, 0)).to(torch.float32)
    return torch.where(ok, rows.square().sum(-1).sqrt(), 0.0)


def clamp_rows(values: torch.Tensor, slot_ix: torch.Tensor, norms: torch.Tensor,
               clamp: float, seed) -> torch.Tensor:
    """Rescale the rows past `clamp` L2 down onto the bound, IN PLACE
    (a non-finite row takes scale 0, as in the JAX package: its finite
    elements become 0, its NaN and inf elements NaN).
    One row-scatter launch whose index is -1 everywhere but at the offending
    rows, so nothing else is written: with nothing over the bound the table
    keeps its bits. Returns `values`."""
    ok = slot_ix >= 0
    rows = gather_rows(values, torch.where(ok, slot_ix, 0)).to(torch.float32)
    finite = torch.isfinite(norms) & torch.isfinite(rows).all(-1)
    bound = float(np.float32(clamp))  # by value: no host-to-device copy
    scale = torch.where(finite, bound / torch.clamp(norms, min=1e-30), 0.0)
    over = ok & (~finite | (norms > bound))
    return apply_rows_sr(values, torch.where(over, slot_ix, -1), rows * scale[..., None],
                         seed=seed)
