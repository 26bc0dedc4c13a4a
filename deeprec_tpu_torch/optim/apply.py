"""Applying sparse gradients to a table — the port of
`deeprec_tpu/optim/apply.py` (`ensure_slots`, `apply_gradients`,
`apply_bag_gradients`), and `lookup_apply_region`, the single-table
program whose gathers and scatters `ops/traffic.py`'s op-count model
counts.

Autograd gives the gradients with respect to the unique gathered
embeddings [T, U, D]; the apply gathers the matching slot rows through the
row-gather kernel, runs the optimizer's row function, masks out invalid and
filter-blocked keys and writes the value and slot rows back through the
row-scatter kernel, IN PLACE. The fused bag step's apply
(`apply_bag_gradients`) takes per-bag gradients [T, B, D] instead and runs
the whole backward in the fused backward kernel.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.embedding.table import (
    META_DIRTY, META_VERSION, EmbeddingTable, TableState, UniqueLookup,
)
from deeprec_tpu_torch.ops import dedup
from deeprec_tpu_torch.ops import fused_lookup as fl
from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows
from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX, SparseOptimizer


def ensure_slots(table: EmbeddingTable, state: TableState,
                 opt: SparseOptimizer) -> TableState:
    """Create the optimizer's slot tensors for this table (idempotent):
    [T, C, w] f32 per-row slots and [T, 1, 1] per-table scalars, filled
    with their initial values."""
    T, C = state.keys.shape
    D = state.values.shape[-1]
    device = state.keys.device
    for name, (shape, init) in opt.slot_specs(D).items():
        if name in state.slots:
            continue
        (w,) = tuple(shape)
        size = (T, 1, 1) if name.startswith(SCALAR_PREFIX) else (T, C, w)
        state.slots[name] = torch.full(size, init, dtype=torch.float32,
                                       device=device)
    return state


def apply_gradients(
    table: EmbeddingTable,
    state: TableState,
    opt: SparseOptimizer,
    res: UniqueLookup,
    grad_u: torch.Tensor,  # [T, U, D] grads w.r.t. res.embeddings
    *,
    step: int = 0,
    lr: Optional[float] = None,
    grad_averaging: bool = False,
    reuse_rows: bool = False,
    stamp_meta: bool = True,
) -> TableState:
    """Update the touched rows of `state` IN PLACE in one pass.

    `reuse_rows=True` takes the value rows from the same step's train
    lookup (`res.rows`) instead of gathering them again, and
    `stamp_meta=False` leaves version/dirty to that lookup's metadata
    stamp: the trainer's hot path (valid only when nothing wrote the rows
    between that lookup and this apply). bf16 tables round the written
    rows stochastically with seed `step`; slots are f32 and store exactly.
    """
    lr = opt.lr if lr is None else lr
    ok = (res.slot_ix >= 0) & res.valid & res.admitted  # [T, U]
    safe_ix = torch.where(ok, res.slot_ix, 0)
    write_ix = torch.where(ok, res.slot_ix, -1)

    grad = grad_u.to(torch.float32)
    if grad_averaging:
        grad = grad / torch.clamp(res.counts.to(torch.float32), min=1.0)[..., None]

    if reuse_rows and res.rows.numel():
        value = res.rows.to(torch.float32)
    else:
        value = gather_rows(state.values, safe_ix).to(torch.float32)
    row_slots: Dict[str, torch.Tensor] = {
        name: arr if name.startswith(SCALAR_PREFIX) else gather_rows(arr, safe_ix)
        for name, arr in state.slots.items()
    }

    new_value, new_slots = opt.update(value, row_slots, grad, res.counts,
                                      step, lr)

    apply_rows_sr(state.values, write_ix, new_value, seed=step)
    for name, rows in new_slots.items():
        if name.startswith(SCALAR_PREFIX):
            state.slots[name].copy_(rows)
        else:
            apply_rows_sr(state.slots[name], write_ix, rows, seed=step)
    if stamp_meta:
        _stamp_version_dirty(state, safe_ix, ok, step)
    return state


def _stamp_version_dirty(state: TableState, safe_ix: torch.Tensor,
                         ok: torch.Tensor, step: int) -> None:
    """version = step, dirty = 1 at the slots safe_ix [T, U] where ok,
    IN PLACE (ok slots are unique per table; the rest add 0 at slot 0)."""
    T, U = ok.shape
    idx = safe_ix.long()[:, None, :].expand(T, 2, U)
    rows = state.meta[:, META_VERSION:META_DIRTY + 1]
    new = torch.stack([torch.full_like(safe_ix, int(step)),
                       torch.ones_like(safe_ix)], dim=1)
    old = rows.gather(2, idx)
    rows.scatter_add_(2, idx, torch.where(ok[:, None], new - old, 0))


def apply_bag_gradients(
    table: EmbeddingTable,
    state: TableState,
    opt: SparseOptimizer,
    res: "fl.FusedBags",  # from table.bag_forward(state, row_ix, ...)
    grad_out: torch.Tensor,  # [T, B, D] grads w.r.t. res.out
    row_ix: torch.Tensor,  # [T, B, L] the slot indices fed to bag_forward
    *,
    combiner: str = "mean",
    step: int = 0,
    lr: Optional[float] = None,
    grad_averaging: bool = False,
    stamp_meta: bool = True,
) -> TableState:
    """The fused-step counterpart of apply_gradients, IN PLACE: one pass
    segment-sums the per-bag grads into unique-row space and applies the
    optimizer update fused into the write-back
    (`ops.fused_lookup.fused_sparse_backward`, kernel #7 on the card). bf16
    tables round stochastically with seed `step`.

    `res` must come from `table.bag_forward(state, row_ix, ...)` with the
    same combiner. Requires a fusable optimizer (no scalar slots, every slot
    [dim]-shaped); version/dirty are stamped on the rows with uids >= 0."""
    if not fl.fusable_optimizer(opt, table.cfg.dim):
        raise NotImplementedError(
            f"apply_bag_gradients: optimizer {type(opt).__name__} has "
            "scalar or non-[dim] slots; use apply_gradients")
    fl.fused_sparse_backward(
        state.values, state.slots, grad_out, row_ix, res, opt,
        combiner=combiner, step=step, lr=lr, seed=step,
        grad_averaging=grad_averaging)
    if stamp_meta:
        C = state.values.shape[1]
        ok = (res.uids >= 0) & (res.uids < C)
        _stamp_version_dirty(state, torch.where(ok, res.uids, 0), ok, step)
    return state


def lookup_apply_region(opt: SparseOptimizer, *, diet: bool = True,
                        budgeted: bool = True,
                        device=None) -> Callable[[], TableState]:
    """The calibration program of `ops/traffic.expected_lookup_apply_ops`
    as a region for `ops/traffic.count_device_ops`: a fresh table
    (capacity 2^12, dim 16) with `opt`'s slots on `device`, and a call that
    runs one train `lookup_unique` of ids 0..255 (the hash dedup at
    `dedup.resolve_size(128, 256)` when `budgeted`, else the sort dedup)
    and `apply_gradients` of unit gradients on the `diet` or legacy arm."""
    t = EmbeddingTable(TableConfig(name="_traffic_probe", dim=16,
                                   capacity=1 << 12))
    state = ensure_slots(t, t.create(device=device), opt)
    ids = torch.arange(256, dtype=torch.int32, device=state.keys.device)[None]
    size = dedup.resolve_size(128, 256) if budgeted else None

    def region():
        res = t.lookup_unique(state, ids, step=0, train=True,
                              unique_size=size)
        grad = torch.ones_like(res.embeddings, dtype=torch.float32)
        return apply_gradients(t, state, opt, res, grad, step=0,
                               reuse_rows=diet, stamp_meta=not diet)
    return region
