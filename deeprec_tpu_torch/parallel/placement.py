"""Shard placement of keys — the first part of the port of
`deeprec_tpu/parallel/placement.py`: `plan_owner`, the device-side owner of
each id under the uniform hash or a plan's leaves. The plans themselves
(`ShardPlan`, `BundlePlan`, the placer and the drift-driven replanner) wait
for ROADMAP queue A item 6b."""
from __future__ import annotations

from typing import Optional

import torch

from deeprec_tpu_torch.utils import hashing


def plan_owner(ids: torch.Tensor, num_shards: int,
               leaves: Optional[dict] = None) -> torch.Tensor:
    """Owner shard (int32) of each id of `ids` [..., n].

    `leaves` is a plan's constant dict (None / {} = the uniform hash):
      offset     []         int32  owner rotation
      hot_keys   [..., H]   key dtype, sentinel-padded routing table
      hot_owners [..., H]   int32 explicit owners of the hot keys
    Hot keys take their table entry, every other id its rotated hash home,
    as the JAX `plan_owner` (leading dims are the stacked bundle's members,
    which the JAX package vmaps over)."""
    base = hashing.hash_shard(ids, num_shards)
    if not leaves:
        return base
    owner = (base + torch.as_tensor(leaves["offset"], dtype=torch.int32,
                                    device=ids.device)) % num_shards
    hk = torch.as_tensor(leaves["hot_keys"], device=ids.device).to(ids.dtype)
    if hk.shape[-1]:
        eq = ids[..., :, None] == hk[..., None, :]
        hot = eq.any(-1)
        hix = eq.to(torch.int8).argmax(-1)
        ho = torch.as_tensor(leaves["hot_owners"], dtype=torch.int32,
                             device=ids.device)
        hot_owner = torch.gather(ho.expand(*hix.shape[:-1], ho.shape[-1]), -1, hix)
        owner = torch.where(hot, hot_owner, owner)
    return owner.to(torch.int32)
