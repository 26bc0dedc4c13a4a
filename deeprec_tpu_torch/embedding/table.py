"""Hash-embedding table — the port of `deeprec_tpu/embedding/table.py`
(create, probe/insert, the split-phase train and read-only lookups with
counter and counting-Bloom admission, initializer rows, scatter_update,
the life cycle: eviction by TTL and L2 norm, rebuild, growth, and the
int8 serving residency: rows stored as int8 with a per-row f32 scale
(`TableState.qscale`), quantized on import (`quantize_rows_int8`) and
dequantized on every read-only gather).

The table is a set of dense tensors in device memory: `keys [T, C]`,
`values [T, C, D]`, the fused per-slot metadata `meta [T, 3, C]`
(freq / version / dirty rows) and the optimizer's `slots` ([T, C, w] per-row
rows, [T, 1, 1] per-table scalars). Every state carries a leading table axis
[T]: a grouped bundle stacks its T member tables there (the JAX package's
vmap over a stacked bundle becomes a batch dimension), and an unstacked
table has T = 1.

Lookups are the JAX package's vectorized open-addressing probe: every
pending id gathers its candidate slot, matches its key or stops at an empty
slot; inserts claim empty slots by a batched scatter whose losers advance to
the next offset. Unlike JAX, the port updates every tensor of a state IN
PLACE (keys on insert, values through the row-scatter kernel, meta, the
counters): a train step owns the state it is given, as the JAX step owns
its donated state. `rebuild` (eviction, growth) is the exception: it
returns a new state, at the new capacity, and leaves its input alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.embedding import filters
from deeprec_tpu_torch.ops import dedup
from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows
from deeprec_tpu_torch.utils import hashing

KEY_DTYPES = {"int32": torch.int32, "int64": torch.int64}
VALUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}

# int8 residency quantization range: symmetric, -127..127 (the -128 code is
# unused so negation is exact and the scale maps max|row| onto the top code).
QMAX = 127.0


def quantize_rows_int8(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization for the serving residency, the
    JAX package's formula and order: returns (q, scale) with rows ≈ q *
    scale[..., None]. `q` is integer-valued f32 in [-127, 127] (rounded half
    to even), `scale` f32 = max|row| / 127, 0 for an all-zero row (which
    decodes to 0). XLA flushes a subnormal scale to 0; so does this."""
    rows = rows.to(torch.float32)
    amax = rows.abs().amax(dim=-1)
    scale = amax / QMAX
    scale = torch.where(scale < torch.finfo(torch.float32).tiny,
                        torch.zeros_like(scale), scale)
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(rows * inv[..., None]), -QMAX, QMAX)
    return q, scale

# Row indices of the fused metadata tensor, and each row's fill value for an
# empty slot: freq 0, version -1 (never touched), dirty 0.
META_FREQ = 0
META_VERSION = 1
META_DIRTY = 2
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
    # optimizer slots, f32: [T, C, w] per-row, [T, 1, 1] per-table scalars
    slots: Dict[str, torch.Tensor]
    # [T] int32 counters of train lookups (not checkpointed): ids that found
    # no slot (the grow signal), unique ids and id positions seen, and
    # distinct ids past the unique budget (moves only under a budget)
    insert_fails: torch.Tensor
    dedup_unique: torch.Tensor
    dedup_ids: torch.Tensor
    dedup_overflow: torch.Tensor
    # [T, M] int32 counting-Bloom sketch of a CBF-filtered table, else None
    bloom: Optional[torch.Tensor] = None
    # [T, C] f32 per-row dequantization scale of an int8 table, else None
    qscale: Optional[torch.Tensor] = None


COUNTERS = ("insert_fails", "dedup_unique", "dedup_ids", "dedup_overflow")


def zero_counters(T: int, device) -> Dict[str, torch.Tensor]:
    """The [T] int32 counters of a fresh TableState."""
    return {name: torch.zeros((T,), dtype=torch.int32, device=device)
            for name in COUNTERS}


def member_view(ts: TableState, k: int) -> TableState:
    """Member k of a stacked state as a [1, ...] state of views (writes go
    through to the stacked tensors); a one-table state is its own member."""
    if ts.keys.shape[0] == 1:
        return ts
    cut = slice(k, k + 1)
    return TableState(
        keys=ts.keys[cut], values=ts.values[cut], meta=ts.meta[cut],
        slots={n: a[cut] for n, a in ts.slots.items()},
        **{n: getattr(ts, n)[cut] for n in COUNTERS},
        bloom=None if ts.bloom is None else ts.bloom[cut],
        qscale=None if ts.qscale is None else ts.qscale[cut])


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
    # [T, U, D] the forward residual: the raw gathered value rows, which
    # the same step's apply reuses instead of gathering again. The gather's
    # own output, never a view of `values`. Empty: not gathered.
    rows: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0,)))


class EmbeddingTable:
    """Functions on TableState for one TableConfig."""

    def __init__(self, cfg: TableConfig):
        self.cfg = cfg
        # Host syncs spent by the probe loop (one `pending.any()` per
        # round), summed over every lookup and restore of this table.
        self.probe_syncs = 0

    @property
    def quantized(self) -> bool:
        """int8 serving residency: rows store int8 plus a per-row f32 scale
        (`TableState.qscale`) and every gather dequantizes. Serving only:
        train-mode lookups raise (train f32, serve quantized)."""
        return self.cfg.value_dtype == "int8"

    @staticmethod
    def _gather_dequant(state: TableState, safe_ix: torch.Tensor) -> torch.Tensor:
        """Rows [T, n, D] f32 of an int8 table at slots safe_ix [T, n]: the
        int8 rows by plain indexing (no kernel: the TPU kernels move 4-byte
        items only, so the JAX package gathers int8 rows outside them too),
        then one [T, n] scale gather and a broadcast multiply."""
        t = torch.arange(state.values.shape[0], device=safe_ix.device)[:, None]
        ix = safe_ix.long()
        return state.values[t, ix].to(torch.float32) * state.qscale[t, ix][..., None]

    # ------------------------------------------------------------------ state

    def create(self, num_tables: int = 1, device=None) -> TableState:
        """Empty state of `num_tables` stacked tables on `device` (no
        optimizer slots: `optim.apply.ensure_slots` adds them)."""
        cfg = self.cfg
        if cfg.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"table {cfg.name}: unknown value_dtype {cfg.value_dtype!r}")
        device = resolve_device(device)
        T, C, D = num_tables, cfg.capacity, cfg.dim
        fill = torch.tensor(_META_FILL, dtype=torch.int32, device=device)
        cbf = cfg.ev.cbf_filter
        return TableState(
            keys=torch.full((T, C), empty_key(cfg),
                            dtype=KEY_DTYPES[cfg.key_dtype], device=device),
            values=torch.zeros((T, C, D), dtype=VALUE_DTYPES[cfg.value_dtype],
                               device=device),
            meta=fill[None, :, None].expand(T, 3, C).contiguous(),
            slots={},
            **zero_counters(T, device),
            bloom=(None if cbf is None else torch.zeros(
                (T, cbf.num_cells()), dtype=torch.int32, device=device)),
            qscale=(torch.zeros((T, C), dtype=torch.float32, device=device)
                    if self.quantized else None),
        )

    def occupied(self, state: TableState) -> torch.Tensor:
        """[T, C] bool: slots holding a key."""
        return state.keys != empty_key(self.cfg)

    def size(self, state: TableState) -> torch.Tensor:
        """Live key count per table, [T] int64."""
        return self.occupied(state).sum(-1)

    # ------------------------------------------------------------ initializer

    def default_salt(self) -> int:
        return hashing.name_salt(self.cfg.name)

    def _init_rows(self, uids: torch.Tensor, salt=None) -> torch.Tensor:
        """Initializer rows [T, U, D] (value dtype) for ids uids [T, U]: a
        pure function of (key, table salt), as in the JAX package. `salt` is
        an int, a [T] tensor (one per stacked member) or None for the
        table's own name salt."""
        cfg = self.cfg
        init = cfg.ev.init
        D = cfg.dim
        # an int8 table serves missing keys at full precision: the
        # initializer row never lives in the residency, so there is nothing
        # to dequantize
        vdt = torch.float32 if self.quantized else VALUE_DTYPES[cfg.value_dtype]
        device = uids.device
        if init.kind == "constant":
            return torch.full((*uids.shape, D), init.constant, dtype=vdt,
                              device=device)
        salt = torch.as_tensor(self.default_salt() if salt is None else salt,
                               dtype=torch.int64, device=device)
        if salt.dim() == 1:
            salt = salt[:, None, None]
        iota = torch.arange(D, dtype=torch.int64, device=device)
        if init.kind == "matrix_normal":
            # row (key % default_value_dim) of a normal matrix regenerated
            # from the salt, never stored
            rows = (uids.to(torch.int64) & 0xFFFFFFFF) % init.default_value_dim
            x = (rows[..., None] * D + iota).to(torch.int32)
            u = hashing.stateless_uniform_from_ids(
                x, (salt & 0xFFFFFFFF) ^ 0x5EED)
        elif init.kind == "stateless_normal":
            # `uids * D + iota` in the key dtype: int32 keys wrap as JAX's
            # int32 product does once an id passes 2^31 / D
            x = uids[..., None].to(torch.int64) * max(D, 1) + iota
            if uids.dtype == torch.int32:
                x = hashing.wrap_int32(x)
            u = hashing.stateless_uniform_from_ids(x, salt)
        else:
            raise ValueError(f"unknown initializer kind {init.kind!r}")
        return self._uniform_to_normal(u).to(vdt)

    def _uniform_to_normal(self, u: torch.Tensor) -> torch.Tensor:
        """N(mean, stddev) by the inverse CDF. `torch.erfinv` is not XLA's
        erfinv: over every uniform the hash gives, the two differ by at most
        65 f32 ulps of erfinv's output (4 away from the tails)."""
        init = self.cfg.ev.init
        eps = 1e-6
        z = math.sqrt(2.0) * torch.erfinv(
            torch.clamp(2.0 * u - 1.0, -1.0 + eps, 1.0 - eps))
        return init.mean + init.stddev * z

    # ------------------------------------------------------------ probe/insert

    def _probe(
        self,
        keys: torch.Tensor,
        uids: torch.Tensor,
        want_create: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Vectorized open-addressing lookup-or-create over T tables.

        Args:
          keys: [T, C] contiguous key tensor; claimed slots are written IN
            PLACE.
          uids: [T, U] ids to resolve (sentinel entries are ignored).
          want_create: [T, U] bool, ids allowed to claim an empty slot, or
            None for a read-only probe (no writes at all).

        Returns (slot_ix [T, U] int32 (-1 = not found/placed), created
        [T, U], failed [T, U]). The loop stops when no id is pending: one
        host sync per probe round, counted in `self.probe_syncs`.
        """
        T, C = keys.shape
        device = keys.device
        sentinel = empty_key(self.cfg)
        h = hashing.mix32(hashing.fold64(uids))
        flat = keys.view(-1)
        base = (torch.arange(T, device=device) * C)[:, None]
        slot_ix = torch.full(uids.shape, -1, dtype=torch.int64, device=device)
        created = torch.zeros(uids.shape, dtype=torch.bool, device=device)
        pending = uids != sentinel
        for step in range(self.cfg.max_probes):
            self.probe_syncs += 1
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
            # Claim race: every claimant of one empty slot writes at once
            # and the largest id wins (the sentinel is the dtype's minimum,
            # so non-claimants' sentinel writes change nothing, and no
            # host-side mask is needed); the re-gather reveals the winner.
            # Losers keep probing.
            flat.scatter_reduce_(0, gpos.flatten(),
                                 torch.where(want, uids, sentinel).flatten(),
                                 reduce="amax")
            won = want & (flat[gpos] == uids)
            slot_ix = torch.where(won, pos, slot_ix)
            created = created | won
            pending = pending & ~won & ~(is_empty & ~want_create)
        return slot_ix.to(torch.int32), created, pending

    # ----------------------------------------------------------------- lookup

    def lookup_unique(self, state: TableState, ids: torch.Tensor, *,
                      step: int = 0, train: bool = True, pad_value: int = -1,
                      salt=None, unique_size: Optional[int] = None
                      ) -> UniqueLookup:
        """Deduplicate ids [T, ...] per table, resolve them, gather rows:
        `_route_ids` -> `_resolve_routed` -> `_finish_resolved`.

        `unique_size=None` dedups at U = N (sort); an int engages the hash
        dedup engine at that static budget: ids past it serve the blocked
        default and count into `dedup_overflow`.

        train=True inserts new keys (initializer rows written through the
        row-scatter kernel, bf16 tables rounding stochastically with seed
        `step`), stamps freq/version/dirty, bumps a CBF sketch and moves the
        counters, all IN PLACE; train=False changes nothing."""
        route = self._route_ids(ids, pad_value, unique_size)
        return self._finish_resolved(state, self._resolve_routed(
            state, route, step=step, train=train, salt=salt))

    # The three phases of a lookup, which the pipelined trainer schedules
    # around the dense compute:
    #   route   - id dedup: ids only, no table state;
    #   resolve - probe/insert, metadata stamp, initializer rows of created
    #             keys, admission: reads and writes keys, meta and the
    #             sketch, writes only value rows of slots that were empty,
    #             so it commutes with the previous step's apply;
    #   finish  - the value gather: reads the CURRENT values.

    def _route_ids(self, ids: torch.Tensor, pad_value: int,
                   unique_size: Optional[int]):
        """Route ids [T, ...] (`ops.dedup.route_ids`): (uids, inverse,
        counts, valid, overflow)."""
        return dedup.route_ids(ids, pad_value=pad_value,
                               sentinel=empty_key(self.cfg), lead=1,
                               unique_size=unique_size)

    def _resolve_routed(self, state: TableState, route, *, step: int = 0,
                        train: bool = False, salt=None) -> UniqueLookup:
        """Key half of a lookup on a route: `_resolve`, then (train) the
        dedup counters. Embeddings stay placeholders until
        `_finish_resolved`."""
        uids, inverse, counts, valid, overflow = route
        res = self._resolve(state, uids, counts, valid, step=step,
                            train=train, salt=salt)
        if train:
            state.dedup_unique += valid.sum(-1, dtype=torch.int32)
            state.dedup_ids += counts.sum(-1, dtype=torch.int32)
            if overflow is not None:
                state.dedup_overflow += overflow
        return dataclasses.replace(res, inverse=inverse)

    def _resolve(self, state: TableState, uids: torch.Tensor,
                 counts: torch.Tensor, valid: torch.Tensor, *, step: int = 0,
                 train: bool = False, salt=None) -> UniqueLookup:
        """Key half of a lookup: probe (and, in train mode, insert, write
        the initializer rows of created keys and stamp the fused metadata),
        then the admission decision (the counter filter, on the
        post-update frequency). A CBF table's train lookup first bumps the
        sketch, and only keys whose estimate has reached `filter_freq` may
        claim a slot. Embeddings stay an empty placeholder until
        `_finish_resolved`."""
        cfg = self.cfg
        if train and self.quantized:
            raise ValueError(
                f"table {cfg.name}: int8 residency is serving-only — train "
                "fp32 and restore into a quantized Predictor "
                "(Predictor(quantize='int8'))"
            )
        cf = cfg.ev.counter_filter
        need_filter = cf is not None and cf.filter_freq > 0
        want_create = valid if train else None
        cbf = cfg.ev.cbf_filter
        if train and cbf is not None:
            est = filters.cbf_add(cbf, state.bloom, uids, counts)
            want_create = valid & (est >= cbf.filter_freq)
        slot_ix, created, failed = self._probe(state.keys, uids, want_create)
        present = slot_ix >= 0
        f_cur = None
        if train:
            # initializer rows of the keys this probe created (bf16 tables
            # round stochastically, seed `step`)
            apply_rows_sr(state.values, torch.where(created, slot_ix, -1),
                          self._init_rows(uids, salt).to(torch.float32),
                          seed=step)
            f_cur = self._stamp_meta(state, slot_ix, counts, step)
            state.insert_fails += failed.sum(-1, dtype=torch.int32)
        elif need_filter:
            safe = torch.where(present, slot_ix, 0).long()
            f_cur = state.meta[:, META_FREQ, :].gather(1, safe)
        admitted = present
        if need_filter:
            admitted = present & (f_cur >= cf.filter_freq)
        return UniqueLookup(
            uids=uids, slot_ix=slot_ix, inverse=uids.new_zeros((0,)),
            counts=counts, valid=valid, admitted=admitted,
            embeddings=state.values.new_zeros((0,)),
        )

    def _stamp_meta(self, state, slot_ix, counts, step) -> torch.Tensor:
        """The fused metadata update of a train lookup: ONE [T, 3, U]
        gather and ONE scatter set freq += counts, version = step, dirty = 1
        on every present slot. uids are unique, so present slots are too;
        the scatter adds (new - old) and adds 0 where an id is absent, which
        makes the write exact without a host-side mask. Returns the
        post-update freq [T, U]."""
        T, U = slot_ix.shape
        present = slot_ix >= 0
        idx = torch.where(present, slot_ix, 0).long()[:, None, :].expand(T, 3, U)
        old = state.meta.gather(2, idx)
        f_cur = old[:, META_FREQ] + counts
        new = torch.stack([f_cur, torch.full_like(f_cur, int(step)),
                           torch.ones_like(f_cur)], dim=1)
        state.meta.scatter_add_(2, idx, torch.where(present[:, None], new - old, 0))
        return f_cur

    def _finish_resolved(self, state: TableState,
                         res: UniqueLookup) -> UniqueLookup:
        """Value half of a lookup: gather the resolved rows through the
        row-gather kernel, then serve `default_value_no_permission` where a
        key is absent or not admitted. The raw gathered rows ride along as
        the `rows` residual. An int8 table gathers and dequantizes by plain
        indexing (`_gather_dequant`): its rows come out f32."""
        safe_ix = torch.where(res.slot_ix >= 0, res.slot_ix, 0)
        if self.quantized:
            emb = self._gather_dequant(state, safe_ix)
        else:
            emb = gather_rows(state.values, safe_ix)
        masked = torch.where(
            res.admitted[..., None], emb,
            self.cfg.ev.init.default_value_no_permission,
        )
        return dataclasses.replace(res, embeddings=masked, rows=emb)

    def bag_forward(self, state: TableState, row_ix: torch.Tensor, *,
                    combiner: str = "mean", unique_size: int):
        """Single-pass bag lookup over RESOLVED slot indices row_ix
        [T, B, L] (< 0 = pad): hash-probe dedup, row gather and combine
        in one fused op (`ops.fused_lookup.fused_sparse_forward`, kernel
        #6 on the card). Returns FusedBags; pair it with
        `optim.apply.apply_bag_gradients` for the fused backward."""
        from deeprec_tpu_torch.ops.fused_lookup import fused_sparse_forward

        return fused_sparse_forward(state.values, row_ix, combiner=combiner,
                                    unique_size=unique_size)

    # ---------------------------------------------------------------- updates

    def scatter_update(self, state: TableState, slot_ix: torch.Tensor,
                       new_values: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       seed: int = 0) -> TableState:
        """Write rows [T, U, D] at slot_ix [T, U] (< 0 = skip), IN PLACE,
        through the row-scatter kernel, and mark them dirty. Pass the
        global step as `seed` for a bf16 table so stochastic rounding draws
        fresh bits each step."""
        ok = slot_ix >= 0
        if mask is not None:
            ok = ok & mask
        write_ix = torch.where(ok, slot_ix, -1)
        apply_rows_sr(state.values, write_ix, new_values.to(torch.float32),
                      seed=seed)
        T, U = slot_ix.shape
        idx = torch.where(ok, slot_ix, 0).long()
        dirty = state.meta[:, META_DIRTY, :]
        dirty.scatter_add_(1, idx, torch.where(ok, 1 - dirty.gather(1, idx), 0))
        return state

    # ------------------------------------------------------ evict & rebuild

    def evict_mask(self, state: TableState, step: int) -> torch.Tensor:
        """[T, C] bool: the occupied slots the eviction policies drop —
        TTL (`step - version > steps_to_live`) and L2 (row norm^2 below the
        threshold)."""
        ev = self.cfg.ev
        drop = torch.zeros_like(state.keys, dtype=torch.bool)
        gse = ev.global_step_evict
        if gse is not None and gse.steps_to_live > 0:
            drop |= int(step) - state.meta[:, META_VERSION] > gse.steps_to_live
        l2e = ev.l2_weight_evict
        if l2e is not None and l2e.l2_weight_threshold >= 0:
            norm2 = (state.values.to(torch.float32) ** 2).sum(-1)
            drop |= norm2 < l2e.l2_weight_threshold
        return self.occupied(state) & drop

    def rebuild(self, state: TableState, keep: Optional[torch.Tensor] = None,
                new_capacity: Optional[int] = None,
                slot_fills: Optional[Tuple[Tuple[str, float], ...]] = None
                ) -> TableState:
        """A fresh state of capacity `new_capacity` (default: the same)
        holding the occupied slots where `keep` [T, C] holds, re-inserted by
        the probe: eviction (linear probing cannot delete in place) and
        growth, which also heal the probe chains.

        Rows move in their own dtype (a bf16 row is not rounded again),
        by plain indexing: no kernel. The metadata moves with its row;
        vacated slots take the empty fills, per-row optimizer slots their
        init value from `slot_fills` ((name, value) pairs; 0 when absent),
        and per-table scalar slots and the sketch pass through (an int8
        table's per-row scale moves with its row). The
        counters restart: `insert_fails` counts survivors that found no
        slot, the dedup counters are zero."""
        from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

        T, C = state.keys.shape
        C_new = new_capacity or C
        if C_new & (C_new - 1):
            raise ValueError("new_capacity must be a power of two")
        device = state.keys.device
        occ = self.occupied(state)
        if keep is not None:
            occ = occ & keep
        sentinel = empty_key(self.cfg)
        uids = torch.where(occ, state.keys, sentinel)
        keys = torch.full((T, C_new), sentinel, dtype=state.keys.dtype,
                          device=device)
        slot_ix, _, failed = self._probe(keys, uids, occ)
        moved = slot_ix >= 0
        src = torch.nonzero(moved.flatten()).flatten()
        dst = ((torch.arange(T, device=device) * C_new)[:, None]
               + slot_ix).flatten()[src]

        def move(arr, fill):
            """arr [T, C, ...] -> [T, C_new, ...] with moved rows placed."""
            out = torch.full((T * C_new, *arr.shape[2:]), fill, dtype=arr.dtype,
                             device=device)
            out[dst] = arr.reshape(T * C, *arr.shape[2:])[src]
            return out.view(T, C_new, *arr.shape[2:])

        fills = dict(slot_fills or ())
        meta = move(state.meta.transpose(1, 2), 0)  # [T, C_new, 3]
        meta[keys == sentinel] = torch.tensor(_META_FILL, dtype=torch.int32,
                                              device=device)
        counters = zero_counters(T, device)
        counters["insert_fails"] = failed.sum(-1, dtype=torch.int32)
        return TableState(
            keys=keys,
            values=move(state.values, 0),
            meta=meta.transpose(1, 2).contiguous(),
            slots={name: (arr if name.startswith(SCALAR_PREFIX)
                          else move(arr, fills.get(name, 0.0)))
                   for name, arr in state.slots.items()},
            **counters,
            bloom=state.bloom,
            qscale=None if state.qscale is None else move(state.qscale, 0.0),
        )

    def evict(self, state: TableState, step: int,
              slot_fills: Optional[Tuple[Tuple[str, float], ...]] = None
              ) -> TableState:
        """`rebuild` without the slots `evict_mask(state, step)` drops."""
        return self.rebuild(state, keep=~self.evict_mask(state, step),
                            slot_fills=slot_fills)

    def grow(self, state: TableState, new_capacity: int,
             slot_fills: Optional[Tuple[Tuple[str, float], ...]] = None
             ) -> TableState:
        """`rebuild` at `new_capacity`. Pass the optimizer's slot_fills so
        rows later created in the new slots start from the slot's init
        value, not 0."""
        return self.rebuild(state, new_capacity=new_capacity,
                            slot_fills=slot_fills)

    # ---------------------------------------------------------- serving

    @torch.no_grad()
    def lookup_readonly(self, state: TableState, ids: torch.Tensor,
                        pad_value: int = -1, salt=None) -> torch.Tensor:
        """Serving lookup of ids [T, ...] -> [T, ..., D] rows in the value
        dtype, no insertion and no counter: a resident key reads its row
        (through the row-gather kernel), a missing key its initializer row
        (pass a stacked bundle's per-member `salt` to match training), a
        pad zeros. An int8 table answers f32 rows (`_gather_dequant`)."""
        T = ids.shape[0]
        flat = ids.reshape(T, -1).to(state.keys.dtype)
        is_pad = flat == pad_value
        flat = torch.where(is_pad, empty_key(self.cfg), flat)
        slot_ix, _, _ = self._probe(state.keys, flat)
        present = slot_ix >= 0
        safe_ix = torch.where(present, slot_ix, 0)
        emb = (self._gather_dequant(state, safe_ix) if self.quantized
               else gather_rows(state.values, safe_ix))
        emb = torch.where(present[..., None], emb, self._init_rows(flat, salt))
        emb = torch.where(is_pad[..., None], 0.0, emb)
        return emb.reshape(*ids.shape, self.cfg.dim)
