"""Composite embedding schemes — the port's copy of
`deeprec_tpu/embedding/compose.py`: multi-hash compression and adaptive
static+dynamic lookup.

Parity targets:
  * tf.get_multihash_variable (MultiHashVariable): the quotient–remainder
    trick — two small tables indexed by complementary hashes of the id,
    combined (add/mul/concat) into one embedding. O(sqrt V) memory for a
    V-sized vocabulary at the cost of controlled collisions.
  * tf.nn.adaptive_embedding_lookup_sparse: ids are dynamically partitioned
    between a compact static bucketed table (cheap, collisions allowed — the
    long tail) and the exact hash table (hot, important ids), by observed
    frequency.

The tables here are the port's stacked, in-place `TableState`s: a lookup
result is [T, U, ...], and `DynamicDimEmbedding` / `AdaptiveEmbedding`
wrap `EmbeddingTable.lookup_unique`, so on the card their rows move through
the row kernels (#3 / #5; #1 / #2 for bf16 tables). `MultiHashTable` is two
dense tables read by plain indexing (the JAX version is fused by XLA, outside
any Pallas kernel). Random parameters are drawn from a CPU
`torch.Generator` and then moved to the device, so a seed gives the same
tables on the card and on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.embedding.table import EmbeddingTable, TableState, UniqueLookup
from deeprec_tpu_torch.utils import hashing

_ADAPTIVE_SALT = 0xADA


@dataclasses.dataclass(frozen=True)
class MultiHashConfig:
    name: str
    dim: int
    num_buckets_q: int  # quotient table rows (power of two)
    num_buckets_r: int  # remainder table rows (power of two)
    strategy: str = "add"  # add | mul | concat


class MultiHashTable:
    """Quotient–remainder composed embedding. Both component tables are
    ordinary dense tensors (every bucket always exists — no admission), so
    a lookup is two row reads and one combine, differentiable through
    autograd."""

    def __init__(self, cfg: MultiHashConfig):
        self.cfg = cfg
        if cfg.strategy not in ("add", "mul", "concat"):
            raise ValueError(cfg.strategy)

    @property
    def dim(self) -> int:
        d = self.cfg.dim
        return 2 * d if self.cfg.strategy == "concat" else d

    def create(self, generator: torch.Generator, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(q [Q, D], r [R, D]) drawn N(0, 0.05²) from a CPU `generator`, on
        `device` (the card unless asked for the CPU)."""
        device = resolve_device(device)
        d = self.cfg.dim
        q = torch.randn((self.cfg.num_buckets_q, d), generator=generator) * 0.05
        r = torch.randn((self.cfg.num_buckets_r, d), generator=generator) * 0.05
        return q.to(device), r.to(device)

    def buckets(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(quotient, remainder) bucket of each id, as the JAX lookup
        computes them on the id's uint32 bits."""
        u = ids.to(torch.int64) & 0xFFFFFFFF
        R, Q = self.cfg.num_buckets_r, self.cfg.num_buckets_q
        return (u // R) % Q, u % R

    def lookup(self, params: Tuple[torch.Tensor, torch.Tensor],
               ids: torch.Tensor) -> torch.Tensor:
        q_tab, r_tab = params
        qi, ri = self.buckets(ids)
        eq = q_tab[qi]
        er = r_tab[ri]
        if self.cfg.strategy == "add":
            return eq + er
        if self.cfg.strategy == "mul":
            return eq * er
        return torch.cat([eq, er], dim=-1)


class DynamicDimEmbedding:
    """Frequency-tiered embedding dimension.

    Parity: tf.get_dynamic_dimension_embedding_variable: rare keys train
    only a prefix of the embedding vector; the dimension steps up with
    observed frequency. Storage stays the full [C, D] rows, but lookups
    MASK the tail dims of low-frequency keys to zero — gradients to masked
    dims are zeroed by the same mask, so those dims neither train nor serve
    until the key graduates.
    """

    def __init__(self, table: EmbeddingTable, dim_tiers, freq_tiers):
        """dim_tiers: ascending dims, e.g. (8, 16, 32) with full dim last;
        freq_tiers: thresholds, len = len(dim_tiers) - 1: keys with
        freq < freq_tiers[0] use dim_tiers[0], etc."""
        assert len(dim_tiers) == len(freq_tiers) + 1
        assert dim_tiers[-1] == table.cfg.dim
        self.table = table
        self.dim_tiers = tuple(dim_tiers)
        self.freq_tiers = tuple(freq_tiers)

    def effective_dim(self, state: TableState, res: UniqueLookup) -> torch.Tensor:
        """[T, U] int32 dims: absent or blocked keys read tier 0 (they must
        not inherit slot 0's frequency)."""
        present = res.slot_ix >= 0
        safe_ix = torch.where(present, res.slot_ix, 0).to(torch.int64)
        freq = torch.gather(state.meta[:, 0], 1, safe_ix)
        freq = torch.where(present, freq, 0)
        dim = torch.full(freq.shape, self.dim_tiers[0], dtype=torch.int32,
                         device=freq.device)
        for d, thr in zip(self.dim_tiers[1:], self.freq_tiers):
            dim = torch.where(freq >= thr, d, dim)
        return dim

    def lookup_unique(self, state: TableState, ids: torch.Tensor, *, step=0,
                      train: bool = True, pad_value: int = -1) -> UniqueLookup:
        """`EmbeddingTable.lookup_unique` (in place on `state`) with each
        row's dims past its tier zeroed."""
        res = self.table.lookup_unique(state, ids, step=step, train=train,
                                       pad_value=pad_value)
        eff = self.effective_dim(state, res)  # [T, U]
        col = torch.arange(res.embeddings.shape[-1], device=eff.device)
        keep = col[None, None, :] < eff[..., None]
        masked = torch.where(keep, res.embeddings,
                             torch.zeros((), dtype=res.embeddings.dtype,
                                         device=eff.device))
        return dataclasses.replace(res, embeddings=masked)


class AdaptiveEmbedding:
    """Frequency-adaptive routing between a static bucketed table and the
    exact hash table.

    lookup_unique(): ids admitted by the hash table (frequency >= the
    table's counter-filter threshold, or simply present) read exact
    embeddings; the rest read a hash-bucketed static row. The static table
    absorbs the long tail at fixed memory; the hash table gives head ids
    exact, evictable, checkpointable embeddings — the
    adaptive_embedding_lookup semantics with the dynamic partition replaced
    by a masked select.
    """

    def __init__(self, table: EmbeddingTable, static_buckets: int = 1 << 14):
        assert static_buckets & (static_buckets - 1) == 0
        self.table = table
        self.static_buckets = static_buckets

    def create_static(self, generator: torch.Generator, device=None) -> torch.Tensor:
        """[static_buckets, D] drawn N(0, 0.05²) from a CPU `generator`, on
        `device` (the card unless asked for the CPU)."""
        device = resolve_device(device)
        return (torch.randn((self.static_buckets, self.table.cfg.dim),
                            generator=generator) * 0.05).to(device)

    def bucket(self, uids: torch.Tensor) -> torch.Tensor:
        return hashing.hash_to_bucket(uids, self.static_buckets, salt=_ADAPTIVE_SALT)

    def lookup_unique(self, state: TableState, static_tab: torch.Tensor,
                      ids: torch.Tensor, *, step=0, train: bool = True,
                      pad_value: int = -1):
        """-> (result, use_exact [T, U] bool): admitted keys read their
        exact rows, the rest their static bucket's row."""
        res = self.table.lookup_unique(state, ids, step=step, train=train,
                                       pad_value=pad_value)
        e_static = static_tab[self.bucket(res.uids).to(torch.int64)]
        use_exact = res.admitted
        emb = torch.where(use_exact[..., None], res.embeddings,
                          e_static.to(res.embeddings.dtype))
        return dataclasses.replace(res, embeddings=emb), use_exact

    def grads(self, res: UniqueLookup, use_exact: torch.Tensor,
              grad_u: torch.Tensor):
        """Split upstream grads: exact-path rows go to the hash table's
        sparse apply, static-path rows return (bucket_ix, grads) for a
        dense scatter-add by the caller's optimizer."""
        zero = torch.zeros((), dtype=grad_u.dtype, device=grad_u.device)
        g_exact = torch.where(use_exact[..., None], grad_u, zero)
        g_static = torch.where(use_exact[..., None], zero, grad_u)
        return g_exact, (self.bucket(res.uids), g_static)
