"""Id routing for lookups: flatten, collapse padding onto the sentinel and
deduplicate — the port of `deeprec_tpu/ops/dedup.py`: `route_ids`, the
sort-based `sort_unique` at U = N and the hash dedup engine `hash_dedup`
at a static unique budget, with its sizing policy (`resolve_size`,
`scratch_size`, `auto_budget_fraction`).

Every function works on a leading batch of tables ([..., N]), which is how
the port runs the JAX package's vmap over a stacked bundle.

Budget contract (`hash_dedup`), as in the JAX package: `uids[..., 0]` is
reserved for the sentinel; padding positions and ids that did not win a
budget slot point their `inverse` at 0; `overflow` counts the distinct ids
compacted out past the budget plus any positions whose probe never
resolved.
"""
from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import torch

from deeprec_tpu_torch.ops.compact import next_pow2, rank_compact
from deeprec_tpu_torch.utils import hashing

logger = logging.getLogger("deeprec_tpu_torch.dedup")

# Tables that already logged the U = N fallback (once per table name).
_logged_full_fallback: set = set()


def _mult8(n: int) -> int:
    return max(8, ((int(n) + 7) // 8) * 8)


def resolve_size(budget: int, n: int) -> int:
    """uids-array size for a budget of `budget` real ids over `n` flattened
    positions: +1 for the reserved sentinel slot, rounded up to a multiple
    of 8, and never beyond the no-overflow size (`n` ids + the sentinel)."""
    full = _mult8(n + 1)
    return min(_mult8(max(int(budget), 1) + 1), full)


def scratch_size(n: int) -> int:
    """Scratch-table size for an N-position dedup: the next power of two
    >= 4 (N + 1), so an all-distinct batch loads it at <= 25 %."""
    return next_pow2(4 * (int(n) + 1))


def auto_budget_fraction(ema_fraction: float, *, slack: float = 1.5,
                         grid: int = 16) -> float:
    """Quantize an EMA'd measured unique fraction into the budget grid:
    apply the slack, then round UP to the next 1/`grid` bucket."""
    f = min(1.0, max(0.0, ema_fraction) * slack)
    return min(1.0, math.ceil(f * grid - 1e-9) / grid)


def log_full_fallback(name: str, n: int) -> None:
    """Log (once per table) that a lookup fell back to U = N, the
    sort-based dedup whose downstream ops all run at batch size."""
    if name in _logged_full_fallback:
        return
    _logged_full_fallback.add(name)
    logger.info(
        "table %s: no unique budget resolved — dedup falls back to U=N=%d "
        "(sort-based, every downstream op at batch size). Set "
        "TableConfig.unique_budget / SparseFeature.unique_budget or "
        "Trainer(unique_budget=...) to engage the hash dedup engine.",
        name, n,
    )


def hash_dedup(flat: torch.Tensor, size: int, *, sentinel, max_probes: int = 64,
               weights: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Deduplicate each row of `flat` [..., N] (padding already collapsed
    onto `sentinel`) into at most `size - 1` unique ids.

    An open-addressing probe over a scratch table of `scratch_size(N)`
    slots per row: every pending position gathers its candidate slot,
    matches its id or claims the slot if empty. Claimants of one empty
    slot race through `scatter_reduce_(amax)`: the largest id wins, the
    re-gather reveals it, losers advance one offset. Non-claimants write
    into a trash slot past the end, so any sentinel works. One host sync
    per round (`pending.any()`, counted in `hash_dedup.probe_syncs`). Then
    the j-th occupied scratch slot, in slot order, takes unique index j in
    1..size-1 (`rank_compact`); the rest overflow. `weights` [..., N]
    (int) replaces each position's count of 1 (the owner side's dedup sums
    the exchanged counts this way).

    Returns (uids [..., size], inverse [..., N] int32, counts [..., size]
    int32, overflow [...] int32) with `uids[inverse]` rebuilding every
    budgeted position and `inverse == 0` at padding and overflow."""
    lead = flat.shape[:-1]
    N = flat.shape[-1]
    flat = flat.reshape(-1, N)
    R = flat.shape[0]
    device = flat.device
    S = scratch_size(N)
    h = hashing.mix32(hashing.fold64(flat))
    valid = flat != sentinel
    scratch = torch.full((R, S + 1), sentinel, dtype=flat.dtype, device=device)
    trash = torch.full_like(flat, S, dtype=torch.int64)
    slot = torch.full((R, N), -1, dtype=torch.int64, device=device)
    pending = valid
    for step in range(max_probes):
        hash_dedup.probe_syncs += 1
        if not bool(pending.any()):
            break
        pos = (h + step) & (S - 1)
        k = scratch.gather(1, pos)
        hit = pending & (k == flat)
        slot = torch.where(hit, pos, slot)
        pending = pending & ~hit
        want = pending & (k == sentinel)
        scratch.scatter_reduce_(1, torch.where(want, pos, trash), flat,
                                reduce="amax", include_self=False)
        won = want & (scratch.gather(1, pos) == flat)
        slot = torch.where(won, pos, slot)
        pending = pending & ~won
    scratch = scratch[:, :S]

    occ = scratch != sentinel
    sel, n_occ, rank = rank_compact(occ, size - 1)
    tail = torch.where(sel >= 0, scratch.gather(1, sel.clamp(min=0).long()),
                       torch.full_like(sel, sentinel, dtype=flat.dtype))
    uids = torch.cat(
        [torch.full((R, 1), sentinel, dtype=flat.dtype, device=device), tail], 1)

    pos_ok = valid & (slot >= 0)
    r = rank.gather(1, torch.where(pos_ok, slot, 0))
    budgeted = pos_ok & (r < size)
    inverse = torch.where(budgeted, r, 0).to(torch.int32)
    counts = torch.zeros((R, size + 1), dtype=torch.int32, device=device)
    w = (torch.ones_like(inverse) if weights is None
         else weights.reshape(R, N).to(torch.int32))
    counts.scatter_add_(1, torch.where(budgeted, inverse.long(), size), w)
    counts = counts[:, :size].contiguous()
    overflow = (torch.clamp(n_occ - (size - 1), min=0)
                + pending.sum(-1, dtype=torch.int32)).to(torch.int32)
    return (uids.reshape(*lead, size), inverse.reshape(*lead, N),
            counts.reshape(*lead, size), overflow.reshape(lead))


hash_dedup.probe_syncs = 0


def sort_unique(
    flat: torch.Tensor, *, sentinel
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted unique ids of `flat` [..., N] padded to N with the
    sentinel — the same arrays as `jnp.unique(size=N, fill_value=sentinel)`
    with counts zeroed on sentinel entries.

    Static shapes and no host sync (unlike `torch.unique`): sort, mark the
    first element of each run, and the running count of marks is each
    element's unique index. Returns (uids [..., N], inverse [..., N] int32,
    counts [..., N] int32) with uids[inverse] == flat."""
    s, order = torch.sort(flat, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    rank = torch.cumsum(first, dim=-1) - 1  # [..., N] int64
    uids = torch.full_like(flat, sentinel)
    uids.scatter_(-1, rank, s)  # every write to one rank carries one value
    inverse = torch.empty_like(rank)
    inverse.scatter_(-1, order, rank)
    counts = torch.zeros_like(rank).scatter_add_(-1, rank, torch.ones_like(rank))
    counts = torch.where(uids != sentinel, counts, 0)
    return uids, inverse.to(torch.int32), counts.to(torch.int32)


def route_ids(ids: torch.Tensor, *, pad_value, sentinel, lead: int = 0,
              unique_size: Optional[int] = None):
    """The routing half of a lookup: flatten the trailing id dims, collapse
    padding onto the sentinel, dedup — the hash engine at `unique_size`,
    the sort at U = N when it is None. The first `lead` dims are
    independent tables (the stacked bundle's [T] axis).

    Returns (uids [*lead, U], inverse [ids.shape], counts [*lead, U],
    valid [*lead, U], overflow): overflow is None at U = N and an int32
    [*lead] count under a budget."""
    flat = ids.reshape(*ids.shape[:lead], -1)
    flat = torch.where(flat == pad_value, torch.full_like(flat, sentinel), flat)
    if unique_size is None:
        uids, inverse, counts = sort_unique(flat, sentinel=sentinel)
        overflow = None
    else:
        uids, inverse, counts, overflow = hash_dedup(
            flat, unique_size, sentinel=sentinel)
    valid = uids != sentinel
    return uids, inverse.reshape(ids.shape), counts, valid, overflow
