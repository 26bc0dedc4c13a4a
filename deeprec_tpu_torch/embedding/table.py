"""Hash-embedding table — the port of `deeprec_tpu/embedding/table.py`,
serving subset.

The table is a set of dense tensors in device memory: `keys [T, C]`,
`values [T, C, D]` and the fused per-slot metadata `meta [T, 3, C]`
(freq / version / dirty rows). Every state carries a leading table axis
[T]: a grouped bundle stacks its T member tables there (the JAX package's
vmap over a stacked bundle becomes a batch dimension), and an unstacked
table has T = 1.

Lookups are the JAX package's vectorized open-addressing probe: every
pending id gathers its candidate slot, matches its key or stops at an empty
slot; inserts (checkpoint restore) claim empty slots by a batched scatter
whose losers advance to the next offset. Unlike JAX, the port updates keys
in place during an insert: the restore owns the state it fills.

Training-mode lookups (insert, metadata stamps, initializer rows),
`lookup_readonly` and `_init_rows` wait for the training slice: every
lookup here is read-only.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.ops import dedup
from deeprec_tpu_torch.ops.fused_lookup import gather_rows
from deeprec_tpu_torch.utils import hashing

KEY_DTYPES = {"int32": torch.int32, "int64": torch.int64}
VALUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Row indices of the fused metadata tensor (the third row is the dirty
# flag), and each row's fill value for an empty slot: freq 0, version -1
# (never touched), dirty 0.
META_FREQ = 0
META_VERSION = 1
_META_FILL = (0, -1, 0)


def empty_key(cfg: TableConfig) -> int:
    """Reserved sentinel marking a free slot (min value of the key dtype)."""
    return int(torch.iinfo(KEY_DTYPES[cfg.key_dtype]).min)


@dataclasses.dataclass
class TableState:
    """Device-resident state of T tables of one config."""

    keys: torch.Tensor  # [T, C] key dtype, empty slots hold the sentinel
    values: torch.Tensor  # [T, C, D] value dtype
    meta: torch.Tensor  # [T, 3, C] int32: freq / version / dirty rows


@dataclasses.dataclass
class UniqueLookup:
    """Result of a deduplicated lookup over T tables."""

    uids: torch.Tensor  # [T, U] unique ids (sentinel-padded)
    slot_ix: torch.Tensor  # [T, U] int32 slot index, -1 when absent
    inverse: torch.Tensor  # [T, *ids] position -> index into uids
    counts: torch.Tensor  # [T, U] int32 occurrences in this batch
    valid: torch.Tensor  # [T, U] bool: real id (not padding)
    admitted: torch.Tensor  # [T, U] bool: present and passes admission
    embeddings: torch.Tensor  # [T, U, D] rows (default where not admitted)


class EmbeddingTable:
    """Functions on TableState for one TableConfig."""

    def __init__(self, cfg: TableConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ state

    def create(self, num_tables: int = 1, device=None) -> TableState:
        """Empty state of `num_tables` stacked tables on `device`."""
        cfg = self.cfg
        if cfg.value_dtype not in VALUE_DTYPES:
            raise NotImplementedError(
                f"table {cfg.name}: value_dtype {cfg.value_dtype!r} (int8 "
                "serving residency) waits for a later slice"
            )
        device = resolve_device(device)
        T, C, D = num_tables, cfg.capacity, cfg.dim
        fill = torch.tensor(_META_FILL, dtype=torch.int32, device=device)
        return TableState(
            keys=torch.full((T, C), empty_key(cfg),
                            dtype=KEY_DTYPES[cfg.key_dtype], device=device),
            values=torch.zeros((T, C, D), dtype=VALUE_DTYPES[cfg.value_dtype],
                               device=device),
            meta=fill[None, :, None].expand(T, 3, C).contiguous(),
        )

    # ------------------------------------------------------------ probe/insert

    def _probe(
        self,
        keys: torch.Tensor,
        uids: torch.Tensor,
        want_create: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vectorized open-addressing lookup-or-create over T tables.

        Args:
          keys: [T, C] contiguous key tensor; claimed slots are written IN
            PLACE.
          uids: [T, U] ids to resolve (sentinel entries are ignored).
          want_create: [T, U] bool, ids allowed to claim an empty slot, or
            None for a read-only probe (no writes at all).

        Returns (slot_ix [T, U] int32 (-1 = not found/placed), failed
        [T, U]). The loop stops when no id is pending: one host sync per
        probe round.
        """
        T, C = keys.shape
        device = keys.device
        sentinel = empty_key(self.cfg)
        h = hashing.mix32(hashing.fold64(uids))
        flat = keys.view(-1)
        base = (torch.arange(T, device=device) * C)[:, None]
        slot_ix = torch.full(uids.shape, -1, dtype=torch.int64, device=device)
        pending = uids != sentinel
        for step in range(self.cfg.max_probes):
            if not bool(pending.any()):
                break
            pos = (h + step) & (C - 1)
            gpos = base + pos
            k = flat[gpos]
            found = pending & (k == uids)
            slot_ix = torch.where(found, pos, slot_ix)
            pending = pending & ~found
            is_empty = k == sentinel
            if want_create is None:
                # An id at an empty slot is definitively absent (linear
                # probing invariant).
                pending = pending & ~is_empty
                continue
            want = pending & is_empty & want_create
            # Claim race: scatter all claimants; duplicates resolve to one
            # winner, which the re-gather reveals. Losers keep probing.
            flat[gpos[want]] = uids[want]
            won = want & (flat[gpos] == uids)
            slot_ix = torch.where(won, pos, slot_ix)
            pending = pending & ~won & ~(is_empty & ~want_create)
        return slot_ix.to(torch.int32), pending

    # ----------------------------------------------------------------- lookup

    def lookup_unique(self, state: TableState, ids: torch.Tensor, *,
                      pad_value: int = -1) -> UniqueLookup:
        """Read-only lookup: deduplicate ids [T, ...] per table, resolve
        them, gather rows. The state is not changed."""
        uids, inverse, counts, valid = dedup.route_ids(
            ids, pad_value=pad_value, sentinel=empty_key(self.cfg), lead=1,
        )
        res = dataclasses.replace(
            self._resolve(state, uids, counts, valid), inverse=inverse)
        return self._finish_resolved(state, res)

    def _resolve(self, state: TableState, uids: torch.Tensor,
                 counts: torch.Tensor, valid: torch.Tensor) -> UniqueLookup:
        """Key half of a read-only lookup: probe, then the admission
        decision (the counter filter). Embeddings stay an empty placeholder
        until `_finish_resolved`."""
        slot_ix, _ = self._probe(state.keys, uids, None)
        present = slot_ix >= 0
        admitted = present
        cf = self.cfg.ev.counter_filter
        if cf is not None and cf.filter_freq > 0:
            safe = torch.where(present, slot_ix, 0).long()
            f_cur = state.meta[:, META_FREQ, :].gather(1, safe)
            admitted = present & (f_cur >= cf.filter_freq)
        return UniqueLookup(
            uids=uids, slot_ix=slot_ix, inverse=uids.new_zeros((0,)),
            counts=counts, valid=valid, admitted=admitted,
            embeddings=state.values.new_zeros((0,)),
        )

    def _finish_resolved(self, state: TableState,
                         res: UniqueLookup) -> UniqueLookup:
        """Value half of a lookup: gather the resolved rows through the
        row-gather kernel, then serve `default_value_no_permission` where a
        key is absent or not admitted."""
        safe_ix = torch.where(res.slot_ix >= 0, res.slot_ix, 0)
        emb = gather_rows(state.values, safe_ix)
        masked = torch.where(
            res.admitted[..., None], emb,
            self.cfg.ev.init.default_value_no_permission,
        )
        return dataclasses.replace(res, embeddings=masked)
