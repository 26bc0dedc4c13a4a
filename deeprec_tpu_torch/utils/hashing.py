"""Integer hashing for hash-embedding tables, bit-exact with
`deeprec_tpu/utils/hashing.py`.

Slot positions carried over from a JAX checkpoint are only found again with
the same hash, and a new key's initializer row is a hash of its id, so every
function here reproduces the JAX uint32 arithmetic exactly. PyTorch's uint32 support is partial, so values are held as int64
in [0, 2^32) and every product is split into 16-bit halves: no intermediate
leaves the signed 64-bit range, and masking with 0xFFFFFFFF gives the
wrapped uint32 result.
"""
from __future__ import annotations

import zlib

import torch

_M32 = 0xFFFFFFFF


def name_salt(name: str) -> int:
    """Stable per-name initializer salt (the same definition as JAX)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def fold64(ids: torch.Tensor) -> torch.Tensor:
    """Fold integer ids to uint32 values (held in int64) for hashing."""
    if ids.dtype == torch.int64:
        lo = ids & _M32
        hi = (ids >> 32) & _M32
        return lo ^ _mul32(hi, 0x9E3779B9)
    return ids.to(torch.int64) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_to_bucket(ids: torch.Tensor, num_buckets: int, salt: int = 0
                   ) -> torch.Tensor:
    """Hash ids into [0, num_buckets) as int32; num_buckets must be a power
    of two."""
    if num_buckets <= 0 or num_buckets & (num_buckets - 1):
        raise ValueError(f"num_buckets must be a power of two, got {num_buckets}")
    h = mix32(fold64(ids) ^ (int(salt) & _M32))
    return (h & (num_buckets - 1)).to(torch.int32)


def hash_shard(ids: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard in [0, num_shards) of each id, int32 (any num_shards):
    the sharded tables' uniform routing, the JAX package's `hash_shard`. On
    int32 ids it equals `hash_shard_np` bit for bit (which narrows 64-bit ids
    to 32 bits first; this folds them, as the device function does)."""
    return (mix32(fold64(ids)) % int(num_shards)).to(torch.int32)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to int32 two's complement, as int32 arithmetic
    overflows in JAX (`uids * D + iota` on int32 keys)."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32)


def stateless_uniform_from_ids(ids: torch.Tensor, salt) -> torch.Tensor:
    """Deterministic per-id uniform in [0, 1) float32, a pure function of
    (id, salt). `salt` is an int or an integer tensor broadcasting against
    `ids` (a stacked bundle passes one salt per table)."""
    salt = torch.as_tensor(salt, dtype=torch.int64, device=ids.device)
    bits = mix32(fold64(ids) ^ mix32(salt & _M32))
    # the 24 high bits, exact in float32
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# Host numpy versions: the fleet computes which corpus shard owns an item on
# the host (`serving/retrieval.py`); every backend and the JAX package must
# agree bit for bit, so these reproduce `deeprec_tpu/utils/hashing.py`'s
# `fold64_np`, `mix32_np` and `hash_shard_np` exactly.

def fold64_np(ids):
    import numpy as np

    ids = np.asarray(ids)
    if ids.dtype in (np.int64, np.uint64):
        with np.errstate(over="ignore"):
            lo = ids.astype(np.uint32)
            hi = (ids >> 32).astype(np.uint32)
            return lo ^ (hi * np.uint32(0x9E3779B9))
    return ids.astype(np.uint32)


def mix32_np(x):
    import numpy as np

    with np.errstate(over="ignore"):
        x = np.asarray(x).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
        return x


def hash_shard_np(ids, num_shards: int):
    """Owner shard in [0, num_shards) of each id (int32). 64-bit ids narrow
    to 32 bits first, as the JAX package's keys do on their way to the
    device under its default 32-bit mode, so both packages place an item on
    the same shard."""
    import numpy as np

    ids = np.asarray(ids)
    if ids.dtype == np.int64:
        ids = ids.astype(np.int32)
    elif ids.dtype == np.uint64:
        ids = ids.astype(np.uint32)
    h = mix32_np(fold64_np(ids))
    return (h % np.uint32(num_shards)).astype(np.int32)
