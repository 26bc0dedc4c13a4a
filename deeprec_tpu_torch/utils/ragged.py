"""Shared ragged/rectangular padding — ONE vectorized implementation.

Three call sites used to carry parallel copies of "pad/trim bags to
[B, L]": the serving request parser (`serving/predictor.py::pad_ragged`),
the retrieval ingest coercion (`serving/retrieval.py::_coerce_item_col`),
and the reader-side multivalue packing. They are now all this module.

Semantics (the serving contract, pinned by
tests/test_serving_update.py::_legacy_ragged_pad):
  * each row pads with `pad_value` up to L and trims past L,
  * a scalar bag (non-list row) is a length-1 bag,
  * dtype is applied to the values, pad included.

The port's copy of `deeprec_tpu/utils/ragged.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

from itertools import chain
from typing import List

import numpy as np


def pad_ragged(rows: List, L: int, pad_value, dtype) -> np.ndarray:
    """Bulk pad/trim a ragged list-of-bags to [B, L]: one flatten, one
    index grid, one scatter — no per-row Python list building (the old
    `[(r + [pad] * (L - len(r)))[:L] for r in v]` walked every bag in
    the interpreter, which dominated parse time for long histories)."""
    B = len(rows)
    lens = np.fromiter(map(len, rows), np.intp, count=B)
    total = int(lens.sum())
    out = np.full((B, L), pad_value, dtype)
    if total == 0:
        return out
    flat = np.fromiter(chain.from_iterable(rows), dtype, count=total)
    starts = np.cumsum(lens) - lens
    col = np.arange(total) - np.repeat(starts, lens)
    keep = col < L
    row = np.repeat(np.arange(B, dtype=np.intp), lens)
    out[row[keep], col[keep]] = flat[keep]
    return out


def pad_rect(arr: np.ndarray, L: int, pad_value, dtype) -> np.ndarray:
    """Rectangular cousin of `pad_ragged`: coerce an already-rectangular
    [B] or [B, W] array to [B, L] — widen with `pad_value`, trim past L.
    The bulk-ingest path (retrieval upsert) where rows are not ragged."""
    arr = np.asarray(arr).astype(dtype)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.shape[1] < L:
        pad = np.full((arr.shape[0], L - arr.shape[1]), pad_value, dtype)
        arr = np.concatenate([arr, pad], axis=1)
    return arr[:, :L]
