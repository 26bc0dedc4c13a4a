"""Counting-Bloom-filter admission — the port of
`deeprec_tpu/embedding/filters.py` (`cbf_add`, `cbf_estimate`).

The counter filter needs no code here: it gates on the per-slot freq row
of the table's metadata. The counting-Bloom filter (CBF) keeps a compact
int32 sketch, `TableState.bloom` [T, M], so that keys below the threshold
never take a table slot. K hash functions (`hashing.hash_to_bucket` with
salts 0xB1000001 + k, bit-exact with the JAX package) index K cells per
key; a key's estimate is the minimum of its cells. Each update is K batched
`scatter_add_` calls over the table axis, duplicate cells included, then a
clamp at 2^counter_bits - 1: integer adds, exact in any order.
"""
from __future__ import annotations

import torch

from deeprec_tpu_torch.config import CBFFilter
from deeprec_tpu_torch.utils import hashing

_SALT = 0xB100_0001


def _cells(cbf: CBFFilter, M: int, uids: torch.Tensor) -> torch.Tensor:
    """[K, T, U] int64 sketch cells of uids [T, U]."""
    return torch.stack([
        hashing.hash_to_bucket(uids, M, salt=_SALT + k).long()
        for k in range(cbf.num_hashes())])


def cbf_add(cbf: CBFFilter, bloom: torch.Tensor, uids: torch.Tensor,
            counts: torch.Tensor) -> torch.Tensor:
    """Add `counts` [T, U] occurrences of each id of uids [T, U] to the
    sketch bloom [T, M], IN PLACE, and return the post-update min-estimate
    [T, U] int32. Every entry of uids counts, padding included, as in the
    JAX package."""
    cells = _cells(cbf, bloom.shape[-1], uids)
    add = counts.to(torch.int32)
    for c in cells:
        bloom.scatter_add_(1, c, add)
    bloom.clamp_(max=(1 << cbf.counter_bits) - 1)
    return torch.stack([bloom.gather(1, c) for c in cells]).amin(0)


def cbf_estimate(cbf: CBFFilter, bloom: torch.Tensor,
                 uids: torch.Tensor) -> torch.Tensor:
    """Read-only min-estimate [T, U] int32 of each id's count."""
    cells = _cells(cbf, bloom.shape[-1], uids)
    return torch.stack([bloom.gather(1, c) for c in cells]).amin(0)
