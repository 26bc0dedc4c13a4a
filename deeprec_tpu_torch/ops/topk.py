"""Blocked streaming top-k over a device-resident corpus matrix — the port
of `deeprec_tpu/ops/topk.py`.

Full-corpus retrieval (serving/retrieval.py) scores one user batch against
every resident item vector. The [B, C] score matrix is never materialised:
the sweep walks the corpus in spans of SWEEP_ROWS rows (rounded to a
multiple of the corpus's `block_rows`), scores one [B, span] tile, and merges it into a
[B, k] top-k carry. Peak memory is one tile plus the carry; the corpus is
read once per sweep (`ops/traffic.retrieval_sweep_bytes` models those
bytes).

Ties are deterministic and independent of the block and span sizes: equal
scores resolve to the LOWEST corpus row, as in the JAX function. Each
candidate carries one int64 ordering key — the score's bits mapped to an
order-preserving int32 in the high half, the complement of its row in the
low half — so no two candidates compare equal and `torch.topk` of the keys
is exact: score desc, then row asc. (On float scores alone `torch.topk`
promises no order among equal values.) A -0.0 score is made +0.0 first, so
the two zeros tie as they do in `lax.top_k`. The answer is the same for any
span: the span sets only how many launches a sweep takes.

int8 corpora store codes plus a per-row f32 scale; the score is a dot
product, so the scale is applied after it: score = (u . q_row) * scale[row].
int8 and bf16 rows are widened to f32 span by span and the product runs in
f32 (TF32 stays off on the card). `query_rows` fixes the rows of every
product (the batch is padded by repeating its last row and scored in
groups of that many rows): a BLAS picks its algorithm by the row count, so
this makes a row's scores independent of the rows it was batched with.

The product and the selection are library calls: the JAX sweep is
`lax.dot_general` plus `lax.top_k` in a `lax.scan`, no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# Score of padding and invalid corpus rows: it never wins a merge against a
# finite score, and a surviving -inf marks "fewer than k valid rows" (row
# -1 in the answer).
NEG_INF = float("-inf")

# Rows scored per sweep step (rounded down to a multiple of `block_rows`,
# at most the corpus): each step
# costs a fixed train of launches (the top-k of int64 keys alone is a few
# dozen), so fewer, larger steps are cheaper; a step holds 12 bytes per
# query row and corpus row (the f32 tile and its keys). One span for every
# corpus at least this large also gives every product one shape.
SWEEP_ROWS = 1 << 18

_LOW = (1 << 32) - 1


def _ordered(scores: torch.Tensor) -> torch.Tensor:
    """f32 scores -> int32 with the same order (-0.0 first made +0.0)."""
    i = (scores + 0.0).view(torch.int32)
    return i ^ ((i >> 31) & 0x7FFFFFFF)


def _from_ordered(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def blocked_topk(
    user: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    *,
    block_rows: int,
    scale: Optional[torch.Tensor] = None,
    query_rows: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k rows of `corpus` by dot-product score for each user vector.

    user    [B, H] float32 — query vectors (the user tower's output).
    corpus  [Cp, H] int8/bf16/f32 — resident item matrix, Cp a multiple of
            `block_rows` (padding rows are invalid).
    valid   [Cp] bool — live corpus rows; invalid rows score -inf.
    k       results per user row.
    scale   [Cp] f32 or None — per-row dequant scale (int8 residency):
            score = (user . row) * scale[row].
    query_rows  the rows of every product (None: the batch's own).

    Returns (scores [B, k] f32 desc-sorted, rows [B, k] int32 corpus row
    indices; -1 where fewer than k valid rows exist). Ties go to the lowest
    row index, whatever `block_rows` and SWEEP_ROWS are.
    """
    B = user.shape[0]
    Cp, H = corpus.shape
    if Cp % block_rows:
        raise ValueError(
            f"corpus rows {Cp} not a multiple of block_rows {block_rows}")
    dev = corpus.device
    user = user.to(device=dev, dtype=torch.float32)
    if query_rows:
        n = max(-(-B // query_rows), 1) * query_rows
        if n > B:
            user = torch.cat([user, user[-1:].expand(n - B, H)])
        groups = [user[i:i + query_rows] for i in range(0, n, query_rows)]
    else:
        groups = [user]
    # the carry's keys: score -inf, row -1 (below every real candidate)
    keys = torch.full((B, k), (_ordered(torch.tensor(NEG_INF)).item() << 32),
                      dtype=torch.int64, device=dev)
    if Cp:
        span = min(max(SWEEP_ROWS // block_rows, 1) * block_rows, Cp)
        # the low half of a candidate's key: the complement of its row
        low = _LOW - torch.arange(span, dtype=torch.int64, device=dev)
        for s0 in range(0, Cp, span):
            s1 = min(s0 + span, Cp)
            rows_f32 = corpus[s0:s1].to(torch.float32).T
            tile = torch.cat([torch.matmul(g, rows_f32) for g in groups])[:B]  # [B, S]
            if scale is not None:
                tile = tile * scale[s0:s1].to(torch.float32)[None, :]
            tile = tile.masked_fill(~valid[s0:s1][None, :], NEG_INF)
            cand = (_ordered(tile).to(torch.int64) << 32) | (low[:s1 - s0] - s0)[None, :]
            keys = torch.topk(torch.cat([keys, cand], dim=1), k, dim=1).values
    vals = _from_ordered((keys >> 32).to(torch.int32))
    rows = (_LOW - (keys & _LOW)).to(torch.int32)
    rows = torch.where(vals > NEG_INF, rows, torch.full_like(rows, -1))
    return vals, rows
