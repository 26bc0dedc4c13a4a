"""Id routing for lookups: flatten, collapse padding onto the sentinel and
deduplicate — the port of `deeprec_tpu/ops/dedup.py` `route_ids` and
`sort_unique` at the static size U = N.

Every function works on a leading batch of tables ([..., N]), which is how
the port runs the JAX package's vmap over a stacked bundle. The unique-id
budget engine (`hash_dedup`) is a training feature and waits for the
training slice.
"""
from __future__ import annotations

from typing import Tuple

import torch


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


def route_ids(ids: torch.Tensor, *, pad_value, sentinel, lead: int = 0):
    """The routing half of a lookup: flatten the trailing id dims, collapse
    padding onto the sentinel, dedup at U = N. The first `lead` dims are
    independent tables (the stacked bundle's [T] axis).

    Returns (uids [*lead, N], inverse [ids.shape], counts [*lead, N],
    valid [*lead, N]); at U = N nothing overflows, so the JAX package's
    fifth element (the overflow count) is left out."""
    flat = ids.reshape(*ids.shape[:lead], -1)
    flat = torch.where(flat == pad_value, torch.full_like(flat, sentinel), flat)
    uids, inverse, counts = sort_unique(flat, sentinel=sentinel)
    valid = uids != sentinel
    return uids, inverse.reshape(ids.shape), counts, valid
