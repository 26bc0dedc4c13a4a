"""Hash-sharded embedding tables over a mesh of processes — the port of
`deeprec_tpu/parallel/sharded.py`.

Every position of the mesh holds one shard of each table (capacity C / N)
and one slice of the batch. A lookup:

  forward:
    local ids --dedup--> local uniques U
    the id exchange (allgather | budgeted a2a | two-tier hier)
    owner-side dedup + probe/insert on the LOCAL shard (kernel #3 / #1 reads
    the rows)
    the embedding exchange back: each position gets its own U rows
  backward:
    the gradient exchange to the owners
    an owner-side segment sum in a fixed order, then one sparse apply on the
    local shard (kernel #5 / #2 writes the rows)

The lookup runs in three phases as in the JAX package: `route` (local dedup,
the id exchange, the owner dedup — ids only), `resolve` (owner probe,
insert, metadata, initializer rows — keys and metadata only) and `finish`
(the value gather and the embedding exchange). The pipelined trainer routes
and resolves batch t+1 before batch t's dense step and finishes it after
batch t's apply.

Every tensor carries the table axis [T] of a stacked bundle first (the JAX
package vmaps over it); the exchanges move all T tables in one collective.

Exactness: the forward's embedding exchange sums one nonzero contributor per
row (exact at the wire dtype). The owner-side sums of the backward add one
source position's rows at a time, in the source's mesh order: within one
source the exchanged ids are distinct, so each owner row takes at most one
addition per step of the loop, and the result does not depend on atomics,
the backend or the mesh's shape (the flat comms give the same bits on a 1-D
and a 2-D mesh). `exchange_chunks > 1` splits the value and gradient
payloads into column chunks with identical bits.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from deeprec_tpu_torch.embedding.table import EmbeddingTable, TableState, UniqueLookup, empty_key
from deeprec_tpu_torch.ops import dedup
from deeprec_tpu_torch.ops import traffic as T_
from deeprec_tpu_torch.optim.apply import apply_gradients as _apply_gradients
from deeprec_tpu_torch.parallel import mesh as M
from deeprec_tpu_torch.parallel.placement import plan_owner
from deeprec_tpu_torch.training.profiler import phase_scope

COMMS = ("allgather", "a2a", "hier")


def _empty(dtype=torch.int32):
    return torch.zeros((0,), dtype=dtype)


@dataclasses.dataclass
class ShardedRoute:
    """The routing half of a sharded lookup: local dedup, the id exchange
    and the owner-side dedup; a function of the ids only."""

    inverse: torch.Tensor  # [T, B, L] position -> local unique index
    counts: torch.Tensor  # [T, U] local unique counts
    valid: torch.Tensor  # [T, U]
    o_uids: torch.Tensor  # [T, O] owner-side unique ids this shard received
    o_inverse: torch.Tensor  # [T, G] exchanged position -> owner-unique index
    o_counts: torch.Tensor  # [T, O]
    o_valid: torch.Tensor  # [T, O]
    owned: torch.Tensor  # [T, G] bool: valid rows this shard received / owns
    loc_overflow: Optional[torch.Tensor]  # [T] local-dedup overflow (budget)
    # a2a: [T, U] slot of each local unique in the [N * Bd] send buffer (-1 =
    # past the budget, served the default); hier: the relay's inter-tier
    # slots [T, Rr]. Empty for allgather.
    send_slot: torch.Tensor = dataclasses.field(default_factory=_empty)
    a2a_overflow: Optional[torch.Tensor] = None  # [T]
    # hier: per gathered intra-tier position [T, I * U], whether this
    # position relays its id, and its index into the relay uniques
    h_rel_mask: torch.Tensor = dataclasses.field(default_factory=lambda: _empty(torch.bool))
    h_r_inverse: torch.Tensor = dataclasses.field(default_factory=_empty)


@dataclasses.dataclass
class ShardedLookup:
    """A position's sharded lookup result. `resolve` returns it with empty
    `embeddings`; `finish` fills them with the local uniques' rows [T, U, D].
    `owner_res` is the owner-side lookup on the local shard."""

    inverse: torch.Tensor
    counts: torch.Tensor
    valid: torch.Tensor
    embeddings: torch.Tensor
    owner_res: UniqueLookup
    o_inverse: torch.Tensor
    owned: torch.Tensor
    send_slot: torch.Tensor = dataclasses.field(default_factory=_empty)
    h_rel_mask: torch.Tensor = dataclasses.field(default_factory=lambda: _empty(torch.bool))
    h_r_inverse: torch.Tensor = dataclasses.field(default_factory=_empty)
    train: bool = True

    @property
    def slot_ix(self) -> torch.Tensor:
        """The owner-side slot indices on the local shard."""
        return self.owner_res.slot_ix


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [T, M, ...] rows at idx [T, K] -> [T, K, ...]."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[t, idx.long()]


def _bucket(dest: torch.Tensor, valid: torch.Tensor, n: int, B: int):
    """Slots of the entries of `dest` [T, M] (n = invalid) in an [n * B]
    send buffer: bucket d takes its first B entries in order. Returns
    (send_slot [T, M] int32, -1 past the budget; overflow [T, M] bool)."""
    T, M = dest.shape
    dev = dest.device
    sorted_d, sort_ix = torch.sort(dest, dim=-1, stable=True)
    start = torch.searchsorted(sorted_d.contiguous(),
                               torch.arange(n, dtype=dest.dtype, device=dev).expand(T, n).contiguous())
    rank = torch.arange(M, device=dev) - start.gather(1, sorted_d.clamp(0, n - 1).long())
    slot_sorted = torch.where((sorted_d < n) & (rank < B), sorted_d.long() * B + rank, -1)
    send_slot = torch.empty((T, M), dtype=torch.int32, device=dev).scatter_(
        1, sort_ix, slot_sorted.to(torch.int32))
    return send_slot, (send_slot < 0) & valid


def _fill(values: torch.Tensor, slot: torch.Tensor, size: int, fill) -> torch.Tensor:
    """An [T, size, ...] buffer of `fill` with values [T, M, ...] placed at
    slot [T, M] (< 0: dropped)."""
    T, M = slot.shape
    safe = torch.where(slot >= 0, slot, size).long()
    buf = torch.full((T, size + 1, *values.shape[2:]), fill, dtype=values.dtype,
                     device=values.device)
    idx = safe.reshape(T, M, *([1] * (values.dim() - 2))).expand_as(values)
    return buf.scatter_(1, idx, values)[:, :size]


def _source_sum(blocks: torch.Tensor, inv: torch.Tensor, keep: torch.Tensor,
                size: int) -> torch.Tensor:
    """[T, size, c] f32: blocks [n, T, B, c] (what each source sent) added at
    inv [T, n, B] where keep holds, one source after another in mesh order.
    A source's rows land on distinct indices, so every index takes at most
    one addition per source: a fixed order whatever the device."""
    n, T, B, c = blocks.shape
    out = torch.zeros((T, size + 1, c), dtype=torch.float32, device=blocks.device)
    for j in range(n):
        idx = torch.where(keep[:, j], inv[:, j], size).long()
        out.scatter_add_(1, idx[..., None].expand(T, B, c), blocks[j].to(torch.float32))
    return out[:, :size]


class ShardedTable:
    """Collective lookup and apply for one table (bundle) sharded over
    `mesh`; `state` is the local shard's TableState (capacity = global /
    N). Three exchanges, as in the JAX package:

      * comm="allgather": all-gather ids, reduce-scatter embeddings. Exact
        for any skew; U·D·(N−1) rows a position per direction.
      * comm="a2a": ids bucketed by owner under a per-destination budget
        (`ops/traffic.py` `a2a_dest_budgets`), one all-to-all each way.
        Ids past a bucket serve the default for that step and count into
        `a2a_overflow`.
      * comm="hier": the two-tier exchange of a `make_mesh_2d` mesh: ids
        gather on the intra tier, cross-position duplicates collapse at a
        relay (intra index i relays the ids whose owner sits at intra index
        i), and only the group's uniques cross the inter tier in a budgeted
        all-to-all (`hier_dest_budgets`). Inter-tier overflow counts in
        `a2a_overflow`.

    The value and gradient payloads ride `cfg.exchange_dtype` in training
    (bf16 by default; sums run in f32 at the owner and relay), f32 in
    evaluation."""

    def __init__(self, table: EmbeddingTable, mesh: "M.Mesh", comm: str = "allgather",
                 a2a_slack: float = 2.0, exchange_chunks: int = 1,
                 hier_group_factor: Optional[float] = None):
        if comm not in COMMS:
            raise ValueError(f"comm must be one of {COMMS}, got {comm!r}")
        self.table = table
        self.mesh = mesh
        self.num_shards = mesh.size
        self.axis = M.mesh_batch_axes(mesh)
        self.comm = comm
        self.a2a_slack = a2a_slack
        self.exchange_chunks = max(1, int(exchange_chunks))
        self.hier_group_factor = hier_group_factor
        self.intra = mesh.shape.get(M.INTRA_AXIS)
        self.inter = mesh.shape.get(M.INTER_AXIS)
        if comm == "hier" and self.intra is None:
            raise ValueError("comm='hier' needs a 2-D mesh (make_mesh_2d), got axes "
                             f"{mesh.axis_names}")
        # the budgets the last routed call used (measured side of the
        # modeled budgets)
        self.last_a2a_unique = None
        self.last_a2a_budgets = None
        self.last_a2a_bucket = None

    # --------------------------------------------------------- split phases

    def route(self, ids: torch.Tensor, *, pad_value: int = -1,
              unique_size: Optional[int] = None, plan=None) -> ShardedRoute:
        """ids [T, ...] -> the route (local dedup at `unique_size`, the id
        exchange, the owner dedup). `plan`: placement leaves (None = the
        uniform hash)."""
        with phase_scope("sharded_route"):
            if self.comm == "a2a":
                return self._route_a2a(ids, pad_value, unique_size, plan)
            if self.comm == "hier":
                return self._route_hier(ids, pad_value, unique_size, plan)
            return self._route_allgather(ids, pad_value, unique_size, plan)

    def resolve(self, state: TableState, route: ShardedRoute, *, step: int = 0,
                train: bool = True, salt=None) -> ShardedLookup:
        """Owner-side keys and metadata on the local shard, IN PLACE: probe
        and insert, metadata, initializer rows of created keys, admission,
        and (train) the dedup and owner counters. Never writes a row an
        apply writes, so resolve(t+1) commutes with apply(t)."""
        res = self.table._resolve(state, route.o_uids, route.o_counts, route.o_valid,
                                  step=step, train=train, salt=salt)
        if train:
            i32 = torch.int32
            state.dedup_unique += route.valid.sum(-1, dtype=i32)
            state.dedup_ids += route.counts.sum(-1, dtype=i32)
            if route.loc_overflow is not None:
                state.dedup_overflow += route.loc_overflow
            state.owner_arrivals += route.owned.sum(-1, dtype=i32)
            state.owner_unique += route.o_valid.sum(-1, dtype=i32)
            if route.a2a_overflow is not None:
                state.a2a_overflow += route.a2a_overflow
        return ShardedLookup(
            inverse=route.inverse, counts=route.counts, valid=route.valid,
            embeddings=torch.zeros((0,), device=route.counts.device),
            owner_res=res, o_inverse=route.o_inverse, owned=route.owned,
            send_slot=route.send_slot, h_rel_mask=route.h_rel_mask,
            h_r_inverse=route.h_r_inverse, train=train)

    def finish(self, state: TableState, sl: ShardedLookup) -> ShardedLookup:
        """The value phase: gather the owner rows from the CURRENT values
        and exchange them back; the local uniques' rows [T, U, D] f32."""
        o_res = self.table._finish_resolved(state, sl.owner_res)
        with phase_scope("sharded_finish"):
            if self.comm == "a2a":
                emb = self._finish_a2a(sl, o_res)
            elif self.comm == "hier":
                emb = self._finish_hier(sl, o_res)
            else:
                emb = self._finish_allgather(sl, o_res)
        return dataclasses.replace(sl, embeddings=emb, owner_res=o_res)

    def lookup_unique(self, state: TableState, ids: torch.Tensor, *, step: int = 0,
                      train: bool = True, pad_value: int = -1, salt=None,
                      unique_size: Optional[int] = None, plan=None) -> ShardedLookup:
        """route -> resolve -> finish."""
        route = self.route(ids, pad_value=pad_value, unique_size=unique_size, plan=plan)
        return self.finish(state, self.resolve(state, route, step=step, train=train,
                                                salt=salt))

    # ------------------------------------------------------- shared helpers

    def _wire_dtype(self, train: bool):
        """Train payloads ride cfg.exchange_dtype; evaluation's stay f32."""
        if train and self.table.cfg.exchange_dtype == "bfloat16":
            return torch.bfloat16
        return torch.float32

    def _col_chunks(self, D: int) -> List[Tuple[int, int]]:
        """[start, stop) column blocks of the value and gradient exchanges:
        `exchange_chunks` near-equal pieces of >= 1 column."""
        k = max(1, min(self.exchange_chunks, int(D)))
        bounds = [round(i * D / k) for i in range(k + 1)]
        return [(a, b) for a, b in zip(bounds, bounds[1:]) if b > a]

    def _sentinel(self) -> int:
        return empty_key(self.table.cfg)

    def _route_ids(self, ids, pad_value, unique_size):
        return dedup.route_ids(ids, pad_value=pad_value, sentinel=self._sentinel(),
                               lead=1, unique_size=unique_size)

    def _gather_ids(self, uids, counts, axis):
        """(ids [T, n * U], counts) gathered over `axis` in its order."""
        T, U = uids.shape
        g = M.all_gather(self.mesh, torch.stack([uids, counts.to(uids.dtype)]), axis)
        g = g.permute(1, 2, 0, 3).reshape(2, T, -1)
        return g[0], g[1].to(torch.int32)

    def _exchange_ids(self, buf_ids, buf_counts, axis, n):
        """Send buckets [T, n * B] of ids and counts: bucket j to position j.
        Returns what arrived [T, n * B], sources in order."""
        T, G = buf_ids.shape
        x = torch.stack([buf_ids, buf_counts.to(buf_ids.dtype)]).reshape(2, T, n, G // n)
        r = M.all_to_all(self.mesh, x.permute(2, 0, 1, 3).contiguous(), axis)
        r = r.permute(1, 2, 0, 3).reshape(2, T, G)
        return r[0], r[1].to(torch.int32)

    def _exchange_rows(self, rows, axis, n):
        """Row buckets [T, n * B, c] out to their positions; [T, n * B, c]
        back, sources in order."""
        T, G, c = rows.shape
        x = rows.reshape(T, n, G // n, c).permute(1, 0, 2, 3).contiguous()
        return M.all_to_all(self.mesh, x, axis).permute(1, 0, 2, 3).reshape(T, G, c)

    def _scatter_rows(self, rows, axis, n):
        """rows [T, n * U, c]: position j receives the rank-order sum of
        every position's block j ([T, U, c])."""
        T, G, c = rows.shape
        x = rows.reshape(T, n, G // n, c).permute(1, 0, 2, 3).contiguous()
        return M.psum_scatter(self.mesh, x, axis)

    def _owner_dedup(self, g_ids, g_counts, include, budgeted: bool):
        """Dedup exchanged ids on the owner (one id may come from many
        sources) and sum their counts. Budgeted: the hash engine sized to
        hold every exchanged id, so the owner side never overflows."""
        sentinel = self._sentinel()
        G = g_ids.shape[1]
        masked = torch.where(include, g_ids, sentinel)
        w = torch.where(include, g_counts, 0)
        if budgeted:
            o_uids, o_inverse, o_counts, _ = dedup.hash_dedup(
                masked, dedup.resolve_size(G, G), sentinel=sentinel, weights=w)
            return o_uids, o_inverse, o_counts, o_uids != sentinel
        o_uids, o_inverse, _ = dedup.sort_unique(masked, sentinel=sentinel)
        o_valid = o_uids != sentinel
        o_counts = torch.zeros(o_uids.shape, dtype=torch.int32, device=g_ids.device)
        o_counts.scatter_add_(1, o_inverse.long(), w.to(torch.int32))
        return o_uids, o_inverse, torch.where(o_valid, o_counts, 0), o_valid

    def _default_rows(self, emb, keep):
        """emb [T, K, c] where keep [T, K], else the blocked default."""
        return torch.where(keep[..., None], emb,
                           self.table.cfg.ev.init.default_value_no_permission)

    # -------------------------------------------------------- allgather path

    def _route_allgather(self, ids, pad_value, unique_size, plan=None) -> ShardedRoute:
        N = self.num_shards
        uids, inverse, counts, valid, loc_ovf = self._route_ids(ids, pad_value, unique_size)
        g_uids, g_counts = self._gather_ids(uids, counts, self.axis)  # [T, N * U]
        me = M.axis_index(self.mesh, self.axis)
        owned = (plan_owner(g_uids, N, plan) == me) & (g_uids != self._sentinel())
        o_uids, o_inverse, o_counts, o_valid = self._owner_dedup(
            g_uids, g_counts, owned, budgeted=unique_size is not None)
        return ShardedRoute(inverse=inverse, counts=counts, valid=valid, o_uids=o_uids,
                            o_inverse=o_inverse, o_counts=o_counts, o_valid=o_valid,
                            owned=owned, loc_overflow=loc_ovf)

    def _finish_allgather(self, sl: ShardedLookup, o_res: UniqueLookup) -> torch.Tensor:
        # back to the gathered layout (rows this shard does not own are 0),
        # then one reduce-scatter: exact, one nonzero contributor per row
        wire = self._wire_dtype(sl.train)
        e = _take(o_res.embeddings, sl.o_inverse)
        e_g = e * sl.owned[..., None].to(e.dtype)
        parts = [self._scatter_rows(e_g[..., a:b].to(wire), self.axis, self.num_shards)
                 for a, b in self._col_chunks(e_g.shape[-1])]
        return torch.cat(parts, -1).to(torch.float32)

    # ------------------------------------------------------------- a2a path

    def _a2a_budget(self, U: int) -> int:
        budgets = T_.a2a_dest_budgets(unique=U, num_shards=self.num_shards,
                                      slack=self.a2a_slack)
        return self._record_budget(U, budgets)

    def _record_budget(self, U: int, budgets) -> int:
        self.last_a2a_unique = int(U)
        self.last_a2a_budgets = budgets
        self.last_a2a_bucket = int(budgets.max())
        return self.last_a2a_bucket

    def _route_a2a(self, ids, pad_value, unique_size, plan=None) -> ShardedRoute:
        N = self.num_shards
        sentinel = self._sentinel()
        uids, inverse, counts, valid, loc_ovf = self._route_ids(ids, pad_value, unique_size)
        Bd = self._a2a_budget(uids.shape[1])
        owner = torch.where(valid, plan_owner(uids, N, plan), N)  # invalid sort last
        send_slot, overflow = _bucket(owner, valid, N, Bd)
        recv_ids, recv_counts = self._exchange_ids(
            _fill(uids, send_slot, N * Bd, sentinel), _fill(counts, send_slot, N * Bd, 0),
            self.axis, N)
        recv_valid = recv_ids != sentinel
        o_uids, o_inverse, o_counts, o_valid = self._owner_dedup(
            recv_ids, recv_counts, recv_valid, budgeted=unique_size is not None)
        return ShardedRoute(inverse=inverse, counts=counts, valid=valid, o_uids=o_uids,
                            o_inverse=o_inverse, o_counts=o_counts, o_valid=o_valid,
                            owned=recv_valid, loc_overflow=loc_ovf, send_slot=send_slot,
                            a2a_overflow=overflow.sum(-1, dtype=torch.int32))

    def _finish_a2a(self, sl: ShardedLookup, o_res: UniqueLookup) -> torch.Tensor:
        wire = self._wire_dtype(sl.train)
        e_out = _take(o_res.embeddings, sl.o_inverse).to(wire)
        e_out = e_out * sl.owned[..., None].to(wire)
        e_back = torch.cat([self._exchange_rows(e_out[..., a:b], self.axis, self.num_shards)
                            for a, b in self._col_chunks(e_out.shape[-1])], -1)
        # e_back[send_slot[u]] is u's row; past the budget: the default
        ok = sl.send_slot >= 0
        emb = _take(e_back.to(torch.float32), torch.where(ok, sl.send_slot, 0))
        return self._default_rows(emb, ok)

    def _apply_a2a(self, grad_u, sl: ShardedLookup) -> torch.Tensor:
        N = self.num_shards
        T, G2 = sl.o_inverse.shape
        Bd = G2 // N
        O = sl.owner_res.uids.shape[1]
        wire = self._wire_dtype(True)
        parts = []
        for ci, (a, b) in enumerate(self._col_chunks(grad_u.shape[-1])):
            g_buf = _fill(grad_u[..., a:b].to(wire), sl.send_slot, G2, 0)
            with phase_scope(f"exchange_chunk{ci}"):
                g_recv = self._exchange_rows(g_buf, self.axis, N)
            parts.append(_source_sum(g_recv.reshape(T, N, Bd, b - a).transpose(0, 1),
                                     sl.o_inverse.reshape(T, N, Bd),
                                     sl.owned.reshape(T, N, Bd), O))
        return torch.cat(parts, -1)

    # ------------------------------------------------- hierarchical path

    def _hier_budget(self, U: int) -> int:
        budgets = T_.hier_dest_budgets(unique=U, intra=self.intra, inter=self.inter,
                                       slack=self.a2a_slack,
                                       group_factor=self.hier_group_factor)
        return self._record_budget(U, budgets)

    def _route_hier(self, ids, pad_value, unique_size, plan=None) -> ShardedRoute:
        N, I, J = self.num_shards, self.intra, self.inter
        sentinel = self._sentinel()
        uids, inverse, counts, valid, loc_ovf = self._route_ids(ids, pad_value, unique_size)
        U = uids.shape[1]
        # intra tier: the host group's ids and counts
        with phase_scope("hier_intra_ids"):
            g_uids, g_counts = self._gather_ids(uids, counts, M.INTRA_AXIS)  # [T, I * U]
        owner = plan_owner(g_uids, N, plan)
        i_me = M.axis_index(self.mesh, M.INTRA_AXIS)
        # relay: owner % I is the owner's intra index, which the inter tier
        # cannot change; one position of the group relays each id
        rel_mask = ((owner % I) == i_me) & (g_uids != sentinel)
        r_uids, r_inverse, r_counts, r_valid = self._owner_dedup(
            g_uids, g_counts, rel_mask, budgeted=True)
        # inter tier: relay uniques bucketed by owner group under the budget
        Bg = self._hier_budget(U)
        group = torch.where(r_valid, plan_owner(r_uids, N, plan) // I, J)
        send_slot, overflow = _bucket(group, r_valid, J, Bg)
        with phase_scope("hier_inter_ids"):
            recv_ids, recv_counts = self._exchange_ids(
                _fill(r_uids, send_slot, J * Bg, sentinel),
                _fill(r_counts, send_slot, J * Bg, 0), M.INTER_AXIS, J)
        # everything that arrives is owned here (relay index == my intra
        # index, bucket == my group)
        recv_valid = recv_ids != sentinel
        o_uids, o_inverse, o_counts, o_valid = self._owner_dedup(
            recv_ids, recv_counts, recv_valid, budgeted=True)
        return ShardedRoute(inverse=inverse, counts=counts, valid=valid, o_uids=o_uids,
                            o_inverse=o_inverse, o_counts=o_counts, o_valid=o_valid,
                            owned=recv_valid, loc_overflow=loc_ovf, send_slot=send_slot,
                            a2a_overflow=overflow.sum(-1, dtype=torch.int32),
                            h_rel_mask=rel_mask, h_r_inverse=r_inverse)

    def _finish_hier(self, sl: ShardedLookup, o_res: UniqueLookup) -> torch.Tensor:
        I, J = self.intra, self.inter
        wire = self._wire_dtype(sl.train)
        e_out = _take(o_res.embeddings, sl.o_inverse).to(wire)
        e_out = e_out * sl.owned[..., None].to(wire)
        ok = sl.send_slot >= 0
        rel = sl.h_rel_mask[..., None].to(torch.float32)
        parts = []
        for ci, (a, b) in enumerate(self._col_chunks(e_out.shape[-1])):
            with phase_scope(f"hier_inter_chunk{ci}"):
                e_back = self._exchange_rows(e_out[..., a:b], M.INTER_AXIS, J)
            v_r = self._default_rows(_take(e_back.to(torch.float32),
                                           torch.where(ok, sl.send_slot, 0)), ok)
            # relay rows -> the gathered layout -> one reduce-scatter on the
            # intra tier; exactly one relay contributes per position
            e_g = _take(v_r, sl.h_r_inverse) * rel
            with phase_scope(f"hier_intra_chunk{ci}"):
                parts.append(self._scatter_rows(e_g.to(wire), M.INTRA_AXIS, I))
        return torch.cat(parts, -1).to(torch.float32)

    def _apply_hier(self, grad_u, sl: ShardedLookup) -> torch.Tensor:
        I, J = self.intra, self.inter
        T, G2 = sl.o_inverse.shape
        Bg = G2 // J
        Rr = sl.send_slot.shape[1]
        U = grad_u.shape[1]
        O = sl.owner_res.uids.shape[1]
        wire = self._wire_dtype(True)
        parts = []
        for ci, (a, b) in enumerate(self._col_chunks(grad_u.shape[-1])):
            # intra tier: the group's gradients meet at the relay, summed
            # in f32 (cross-position duplicates merge before the inter tier)
            with phase_scope(f"hier_intra_chunk{ci}"):
                g_g = M.all_gather(self.mesh, grad_u[..., a:b].to(wire), M.INTRA_AXIS)
            r_grad = _source_sum(g_g, sl.h_r_inverse.reshape(T, I, U),
                                 sl.h_rel_mask.reshape(T, I, U), Rr)
            # inter tier: relay subtotals back to the owners in the
            # budgeted buckets (rows past the budget drop, as their forward
            # served the default)
            g_buf = _fill(r_grad.to(wire), sl.send_slot, G2, 0)
            with phase_scope(f"hier_inter_chunk{ci}"):
                g_recv = self._exchange_rows(g_buf, M.INTER_AXIS, J)
            parts.append(_source_sum(g_recv.reshape(T, J, Bg, b - a).transpose(0, 1),
                                     sl.o_inverse.reshape(T, J, Bg),
                                     sl.owned.reshape(T, J, Bg), O))
        return torch.cat(parts, -1)

    # ------------------------------------------------------------- backward

    def _apply_allgather(self, grad_u, sl: ShardedLookup) -> torch.Tensor:
        N = self.num_shards
        T, G = sl.o_inverse.shape
        U = G // N
        O = sl.owner_res.uids.shape[1]
        wire = self._wire_dtype(True)
        parts = []
        for ci, (a, b) in enumerate(self._col_chunks(grad_u.shape[-1])):
            with phase_scope(f"exchange_chunk{ci}"):
                g_g = M.all_gather(self.mesh, grad_u[..., a:b].to(wire), self.axis)
            parts.append(_source_sum(g_g, sl.o_inverse.reshape(T, N, U),
                                     sl.owned.reshape(T, N, U), O))
        return torch.cat(parts, -1)

    @torch.no_grad()
    def apply_gradients(self, state: TableState, opt, sl: ShardedLookup,
                        grad_u: torch.Tensor, *, step: int = 0, lr=None,
                        grad_averaging: bool = False, reuse_rows: bool = False,
                        stamp_meta: bool = True) -> TableState:
        """grad_u [T, U, D]: gradients w.r.t. sl.embeddings. Exchanges them to
        the owners, sums them per owner unique in a fixed order, divides by
        N (each position's loss is a mean over its B / N rows, so the sparse
        step sees the global-batch mean, as the all-reduced dense step does)
        and applies them to the local shard, IN PLACE."""
        with phase_scope("sharded_grad_exchange"):
            if self.comm == "a2a":
                o_grad = self._apply_a2a(grad_u, sl)
            elif self.comm == "hier":
                o_grad = self._apply_hier(grad_u, sl)
            else:
                o_grad = self._apply_allgather(grad_u, sl)
        o_grad = o_grad / float(self.num_shards)
        return _apply_gradients(self.table, state, opt, sl.owner_res, o_grad, step=step,
                                lr=lr, grad_averaging=grad_averaging,
                                reuse_rows=reuse_rows, stamp_meta=stamp_meta)
