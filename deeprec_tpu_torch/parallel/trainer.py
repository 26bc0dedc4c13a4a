"""The sharded trainer — the port of `deeprec_tpu/parallel/trainer.py`: one
process per mesh position, tables hash-sharded over the mesh, the batch
split across it.

Each position runs the single-device `Trainer`'s step on its slice of the
global batch, with the lookups and applies going through the collective
`ShardedTable` (`parallel/sharded.py`): the owner side of each table runs
the port's row kernels (#3 / #5 on f32 rows, #1 / #2 on bf16 rows) on the
local shard. The dense gradients are all-reduced and divided by N in rank
order, so every position applies the same dense update; the reported loss
and accuracy are global means, `eval_step` returns the global batch's
probabilities in rank order.

Callers pass the GLOBAL batch (the same on every position), as to the JAX
ShardedTrainer on one host: each position takes its rank-order slice
(`mesh.shard_batch`). `train_steps` and the pipeline modes run as on one
device: "lookahead" routes and resolves batch t+1 (the id exchange
included) before batch t's dense step and finishes it after batch t's
apply; "chunked" and "nested" add the column-chunked exchanges
(`pipeline_chunks`). All are bit for bit "off".

Skew-aware placement (`parallel/placement.py`): `placement="plan"` arms the
drift-driven replanner — `maintain()` runs `maybe_replan` before the
budgets, which runs the cost-model placer (`update_placement`) when the
windowed per-shard imbalance breaches the `ReplanConfig` trigger, and the
placer adopts a candidate when it models `min_gain` less imbalance AND its
straggler-bytes gain amortizes the migration within `horizon_steps` (or
`force=True`). Every rank plans from the same numbers: each rank's live keys
and freqs are gathered in rank order (`mesh.all_gather_object`) and every
rank runs the deterministic numpy placer on them. The migration
(`placement.reshard_members`) is collective and agreed: one failed rank
keeps the old plan and state on every rank. Any single-owner routing trains
bit for bit the same per key, so the losses never see a replan.

Multi-tier bundles (storage hbm_dram / hbm_dram_ssd): each position keeps
its own tier per member — its host store and, under a storage path, its
disk log `<path>_m<k>_<s>` (`_m<s>` for a one-table bundle) at mesh
position s, as the JAX package keys its (table, shard) members — and
`maintain()` syncs only its own shard against them, so no collective runs on
a tier thread. The growth and auto-tier decisions read every position's
occupancy and failed inserts and the whole mesh's table bytes, so every
position takes the same one; `demoted`, `promoted` and `rows_reinit` are
summed over the mesh. Tiered bundles keep the hash under placement="plan"
(their demoted rows live in per-position stores no migration moves).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeprec_tpu_torch.embedding.table import (
    SHARD_COUNTERS, EmbeddingTable, TableState)
from deeprec_tpu_torch.parallel import mesh as M
from deeprec_tpu_torch.parallel import placement as placement_lib
from deeprec_tpu_torch.parallel.placement import BundlePlan
from deeprec_tpu_torch.parallel.sharded import ShardedTable
from deeprec_tpu_torch.training import metrics as Mt
from deeprec_tpu_torch.training.trainer import (
    Bundle, StagedBatch, Trainer, TrainState, _loss_from_logits, _tiered)


def _local_cfg(cfg, num_shards: int):
    if cfg.capacity % num_shards:
        raise ValueError(
            f"table {cfg.name}: capacity {cfg.capacity} not divisible by mesh size "
            f"{num_shards}")
    return dataclasses.replace(cfg, capacity=cfg.capacity // num_shards)


def ensure_shard_counters(ts: TableState) -> TableState:
    """Give a table state its shard counters (zeros) where it has none
    (a fresh, rebuilt or restored state)."""
    for name in SHARD_COUNTERS:
        if getattr(ts, name) is None:
            setattr(ts, name, torch.zeros_like(ts.insert_fails))
    return ts


class LocalBatch(StagedBatch):
    """A batch already cut to this position's rows (and perhaps staged on
    the device): the sharded trainer does not cut it again."""


class ShardedTrainer(Trainer):
    """Drop-in Trainer over a mesh (`parallel/mesh.py`): tables
    hash-sharded, the batch split. `comm` is the exchange ("allgather",
    "a2a", "hier" on a 2-D mesh); `a2a_slack` and `hier_group_factor` size
    the budgets. `placement` is "uniform" (the hash) or "plan" (the
    drift-driven replanner; `placement_hot_budget` hot keys per member,
    `replan` its trigger). Plans start uniform; `update_placement(force=
    True)` places once under either. Runs on `mesh.device`."""

    def __init__(self, model, sparse_opt, dense_opt=None, mesh: Optional[M.Mesh] = None,
                 grad_averaging: bool = False, comm: str = "allgather",
                 remat: bool = False, a2a_slack: float = 2.0, unique_budget=None,
                 pipeline_mode: str = "off", pipeline_chunks: int = 4,
                 placement: str = "uniform", placement_hot_budget: int = 64,
                 replan: Optional[placement_lib.ReplanConfig] = None,
                 hier_group_factor: Optional[float] = None,
                 stage: str = "auto", sentinel=None, device=None):
        from deeprec_tpu_torch.parallel.costmodel import PlacementCostModel

        if placement not in ("uniform", "plan"):
            raise ValueError(f"placement must be 'uniform' or 'plan', got {placement!r}")
        self.mesh = mesh if mesh is not None else M.make_mesh(device=device)
        self.placement = placement
        self.placement_hot_budget = int(placement_hot_budget)
        self.replan_config = replan or placement_lib.ReplanConfig()
        self._drift = placement_lib.DriftDetector(self.replan_config)
        # trained from this trainer's own (plan, measured bytes) windows;
        # the analytic choice bit for bit until trained
        self.cost_model = PlacementCostModel()
        self._plans: Dict[str, BundlePlan] = {}
        # each adopted plan's plan_owner constants on the device, built once
        self._plan_leaves: Dict[str, dict] = {}
        self.last_placement: Optional[Dict] = None
        self._window_reset_step = 0
        # (bundle, member) -> (step, sorted keys, freqs) at the last placer
        # run: the baseline of the windowed arrivals
        self._freq_snaps: Dict = {}
        self._replan_stats: Dict[str, object] = {
            "replans": 0, "forced_replans": 0, "migration_rows": 0,
            "migration_bytes": 0.0, "deferred": 0, "last_gain_bytes_per_step": None}
        self.axis = M.mesh_batch_axes(self.mesh)
        self.num_shards = self.mesh.size
        names = self.mesh.axis_names
        if comm == "hier" and len(names) != 2:
            raise ValueError(f"comm='hier' needs a 2-D mesh (make_mesh_2d); got axes {names}")
        super().__init__(model, sparse_opt, dense_opt, grad_averaging, device=self.mesh.device,
                         unique_budget=unique_budget, remat=remat, stage=stage,
                         pipeline_mode=pipeline_mode, pipeline_chunks=pipeline_chunks,
                         sentinel=sentinel)
        # "chunked" and "nested" (the 2-D lookahead) split the value and
        # gradient exchanges into pipeline_chunks column chunks
        self._chunks = (self.pipeline_chunks if pipeline_mode in ("chunked", "nested")
                        else 1)
        self._comm, self._a2a_slack = comm, a2a_slack
        self.hier_group_factor = hier_group_factor
        for b in self.bundles.values():
            b.table = EmbeddingTable(_local_cfg(b.table.cfg, self.num_shards))
        self.sharded = {bname: self._sharded_table(b.table) for bname, b in self.bundles.items()}

    def _sharded_table(self, table: EmbeddingTable) -> ShardedTable:
        return ShardedTable(table, self.mesh, comm=self._comm, a2a_slack=self._a2a_slack,
                            exchange_chunks=self._chunks,
                            hier_group_factor=self.hier_group_factor)

    # ------------------------------------------------------------ the mesh

    def _psum(self, x: torch.Tensor) -> torch.Tensor:
        return M.psum(self.mesh, x, self.axis)

    def _pmean(self, x: torch.Tensor) -> torch.Tensor:
        return M.pmean(self.mesh, x, self.axis)

    def _local(self, batch, stacked: bool = False) -> "LocalBatch":
        """This position's rows of a global batch (dim 1 of a stacked one)."""
        if isinstance(batch, LocalBatch):
            return batch
        return LocalBatch(M.shard_batch(self.mesh, dict(batch), axis=self.axis,
                                        stacked=stacked))

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        return super().device_batch(self._local(batch))

    def _window(self, batches):
        if isinstance(batches, dict):
            batches = self._local(batches, stacked=True)
        return super()._window(batches)

    def stage_batch(self, batch):
        out = super().stage_batch(self._local(batch))
        local = LocalBatch(out)
        local.ready = getattr(out, "ready", None)
        return local

    # ------------------------------------------------------------------ init

    def init(self, seed: Optional[int] = None) -> TrainState:
        """Empty local shards (capacity global / N, with the shard counters)
        and the dense state: position 0's parameters on every position."""
        st = super().init(seed)
        for ts in st.tables.values():
            ensure_shard_counters(ts)
        names = list(st.dense)
        flat = M.broadcast(self.mesh, torch.cat([st.dense[n].reshape(-1) for n in names]))
        off = 0
        for n in names:
            t = st.dense[n]
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        return st

    # ------------------------------------------------------------- lookups

    def _budget_capacity(self, b: Bundle) -> int:
        # the bundle's cfg is the per-shard capacity; local-batch uniques are
        # bounded by the global table
        return b.table.cfg.capacity * self.num_shards

    def _route_one(self, b: Bundle, ids, pad, train):
        return self.sharded[b.name].route(
            ids, pad_value=pad, unique_size=self._budget_for_lookup(b, ids, train),
            plan=self._plan_leaves.get(b.name))

    def _resolve_one(self, bname, ts, route, step, train):
        return self.sharded[bname].resolve(ensure_shard_counters(ts), route, step=step,
                                           train=train, salt=self._salts.get(bname))

    def _finish_one(self, bname, ts, res):
        return self.sharded[bname].finish(ts, res)

    # --------------------------------------------------------------- steps

    def _fwd_bwd(self, params, views, bundle_res, batch):
        """The local forward and backward; the dense gradients all-reduced
        and divided by N in rank order (every position gets the same)."""
        loss, logits, g_dense, g_embs = super()._fwd_bwd(params, views, bundle_res, batch)
        names = list(g_dense)
        flat = self._pmean(torch.cat([g_dense[n].reshape(-1) for n in names]))
        out, off = {}, 0
        for n in names:
            g = g_dense[n]
            out[n] = flat[off:off + g.numel()].view_as(g)
            off += g.numel()
        return loss, logits, out, g_embs

    def _apply_one(self, b, ts, res, grad, step, lr, reuse):
        self.sharded[b.name].apply_gradients(
            ts, self.sparse_opt, res, grad, step=step, lr=lr,
            grad_averaging=self.grad_averaging, reuse_rows=reuse, stamp_meta=False)

    @torch.no_grad()
    def _metrics(self, loss, logits, batch) -> Dict[str, torch.Tensor]:
        m = super()._metrics(loss, logits, batch)
        g = self._pmean(torch.stack([m["loss"].to(torch.float32),
                                     m["accuracy"].to(torch.float32)]))
        return {"loss": g[0], "accuracy": g[1]}

    @torch.no_grad()
    def _sentinel_observe(self, tables, bundle_res, loss, g_dense, g_embs, step: int):
        """The local observations reduced over the mesh, so every position
        folds the same flags: the mean loss, every gradient finite on every
        position, the largest squared norm and row norm."""
        obs = super()._sentinel_observe(tables, bundle_res, loss, g_dense, g_embs, step)
        keys = [k for k in ("loss", "grads_finite", "grad_norm_sq", "row_max") if k in obs]
        g = M.all_gather(self.mesh, torch.stack([obs[k].to(torch.float32) for k in keys]),
                         self.axis)
        out = dict(obs)
        for i, k in enumerate(keys):
            col = g[:, i]
            if k == "loss":
                out[k] = M.rank_order_sum(col) / float(self.num_shards)
            elif k == "grads_finite":
                out[k] = col.min() > 0
            else:
                out[k] = col.max()
        return out

    def train_step_accum(self, state: TrainState, batch, accum_steps: int, lr=None,
                         guard=None):
        """The JAX layout: micro-batch a is rows [a B/A, (a + 1) B/A) of the
        global batch, and each position takes its slice of every
        micro-batch."""
        if not isinstance(batch, LocalBatch):
            A = int(accum_steps)
            stacked = {k: (v if torch.is_tensor(v) else np.asarray(v)) for k, v in batch.items()}
            n = next(iter(stacked.values())).shape[0]
            if A < 1 or n % A:
                raise ValueError(f"batch of {n} rows does not split into {A} micro-batches")
            stacked = {k: v.reshape(A, n // A, *v.shape[1:]) for k, v in stacked.items()}
            local = M.shard_batch(self.mesh, stacked, axis=self.axis, stacked=True)
            batch = LocalBatch({k: v.reshape(-1, *v.shape[2:]) for k, v in local.items()})
        return super().train_step_accum(state, batch, accum_steps, lr, guard)

    # ---------------------------------------------------------- evaluation

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """Read-only forward of a global batch: (the global mean loss, the
        global batch's probabilities in rank order)."""
        batch = LocalBatch(self.device_batch(batch))
        views, _ = self._lookup_all(state.tables, batch)
        logits, probs = self.probs_from_views(state, views, batch)
        loss = self._pmean(_loss_from_logits(logits, batch).to(torch.float32))

        def glob(p):
            return M.all_gather(self.mesh, p, self.axis).reshape(-1, *p.shape[1:])

        probs = {t: glob(p) for t, p in probs.items()} if isinstance(probs, dict) else glob(probs)
        return loss, probs

    def evaluate(self, state: TrainState, batches) -> Dict[str, float]:
        aucs: Dict[str, Mt.AucState] = {}
        total, n = 0.0, 0
        for batch in batches:
            batch = LocalBatch(self.device_batch(batch))
            loss, probs = self.eval_step(state, batch)
            for task, p in (probs.items() if isinstance(probs, dict) else [("", probs)]):
                lab = batch[f"label_{task}" if task else "label"]
                lab = M.all_gather(self.mesh, lab, self.axis).reshape(-1, *lab.shape[1:])
                if task not in aucs:
                    aucs[task] = Mt.AucState.create(self.device)
                aucs[task] = Mt.auc_update(aucs[task], p, lab)
            total += float(loss)
            n += 1
        out = {"loss": total / max(n, 1)}
        for task, auc in aucs.items():
            out[f"auc_{task}" if task else "auc"] = float(Mt.auc_compute(auc))
        return out

    # ----------------------------------------------------------- telemetry

    def _bundle_dedup_counters(self, ts: TableState, member: Optional[int] = None
                               ) -> Tuple[int, int, int]:
        """(unique, ids, overflow) totals over every position."""
        sel = slice(None) if member is None else slice(member, member + 1)
        local = torch.stack([getattr(ts, n)[sel].sum().to(torch.int64)
                             for n in ("dedup_unique", "dedup_ids", "dedup_overflow")])
        return tuple(int(v) for v in self._psum(local).tolist())

    def _per_shard_stats(self, b: Bundle, ts: TableState):
        """Owner load per mesh position of each member (one gather for the
        bundle): the counters resolve accumulates, as modeled exchange
        bytes (ops/traffic.py), and their max / mean imbalance."""
        from deeprec_tpu_torch.ops import traffic as T

        ensure_shard_counters(ts)
        g = M.all_gather(self.mesh, torch.stack([ts.owner_arrivals, ts.owner_unique]),
                         self.axis)  # [N, 2, T]
        cfg = b.table.cfg
        rb = T.exchange_row_bytes(dim=cfg.dim,
                                  wire_bytes=2 if cfg.exchange_dtype == "bfloat16" else 4)
        out = []
        for oa, ou in g.permute(2, 1, 0).tolist():  # [T][2][N]
            xb = [round(float(a) * rb, 1) for a in oa]
            out.append({"owner_unique": [int(x) for x in ou],
                        "owner_arrivals": [int(x) for x in oa],
                        "exchange_bytes": xb, "imbalance": round(T.shard_imbalance(xb), 4)})
        return out

    def dedup_stats(self, state: TrainState) -> Dict[str, Dict[str, float]]:
        """The base trainer's per-table telemetry over every position, with
        `per_shard` (`_per_shard_stats`) per table, and under
        placement="plan" the replanner's record under `__placement__`."""
        out = super().dedup_stats(state)
        if self.placement == "plan":
            out["__placement__"] = self.placement_stats()
        return out

    def a2a_overflow(self, state: TrainState) -> int:
        """Ids served the default past the exchange budgets, summed over
        every table and position."""
        local = torch.stack([ensure_shard_counters(ts).a2a_overflow.sum().to(torch.int64)
                             for ts in state.tables.values()]).sum()
        return int(self._psum(local))

    def update_budgets(self, state: TrainState, **kw):
        """The base budgets; the owner counters reset with the dedup ones,
        and the window the replanner normalizes them by starts here."""
        state, rep = super().update_budgets(state, **kw)
        for ts in state.tables.values():
            ensure_shard_counters(ts)
            ts.owner_arrivals.zero_()
            ts.owner_unique.zero_()
        self._window_reset_step = int(state.step)
        return state, rep

    # ------------------------------------------------------ capacity loop

    def _bundle_fill(self, b: Bundle, ts: TableState) -> Tuple[int, List[int]]:
        """Growth decides on every position's shard, so all grow alike."""
        local = torch.stack([b.table.size(ts).to(torch.int64),
                             ts.insert_fails.to(torch.int64)])
        g = M.all_gather(self.mesh, local, self.axis)  # [N, 2, T]
        return int(g[:, 0].max()), g[:, 1].reshape(-1).tolist()

    def _set_bundle_capacity(self, b: Bundle, new_c: int) -> None:
        """Re-point the collective table at the grown shard; the plan's
        per-destination budget inputs carry over (growth and an adoption
        can land in the same maintain)."""
        super()._set_bundle_capacity(b, new_c)
        old = self.sharded[b.name]
        self.sharded[b.name] = self._sharded_table(b.table)
        self.sharded[b.name].plan_dest_hot = old.plan_dest_hot
        self.sharded[b.name].plan_hot_count = old.plan_hot_count

    def _mesh_sum(self, *counts: int) -> List[int]:
        local = torch.tensor(counts, dtype=torch.int64, device=self.device)
        return [int(v) for v in self._psum(local).tolist()]

    def _table_bytes(self, ts: TableState) -> int:
        """The whole mesh's bytes of the bundle: every shard has the same
        shape, so N times this position's."""
        return self._state_bytes(ts) * self.num_shards

    def _tier_index(self, b: Bundle, k: int) -> Tuple[int, ...]:
        s = self.mesh.index
        return (k, s) if b.stacked else (s,)

    def enable_tier_paging(self, **kw):
        raise NotImplementedError(
            "tier paging is wired for the base Trainer; sharded multi-tier runs keep "
            "maintain(tier_async=True)")

    def maintain(self, state: TrainState, **kw):
        """`Trainer.maintain` with a GLOBAL `max_capacity` (divided by N for
        the shards) and a GLOBAL `hbm_budget_bytes` (the whole mesh's table
        bytes); every position takes the same growth or auto-tier
        decision, and tiered bundles sync each position's own shard."""
        if kw.get("max_capacity"):
            kw["max_capacity"] = max(1, kw["max_capacity"] // self.num_shards)
        state, report = super().maintain(state, **kw)
        for ts in state.tables.values():
            ensure_shard_counters(ts)
        return state, report

    def evict_tables(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        state = super().evict_tables(state, step)
        for ts in state.tables.values():
            ensure_shard_counters(ts)
        return state


    # --------------------------------------------------------- placement

    def _set_plan(self, bname: str, bp: BundlePlan) -> None:
        """Adopt `bp` for bundle `bname`: its `plan_owner` constants on the
        device (none for a uniform plan) and the per-destination budget
        inputs (`ops/traffic.py a2a_dest_budgets`): each destination pays
        the hot keys the plan routes to it, elementwise-max over members,
        and the tail share shrinks by the keys every member routes
        explicitly."""
        b = self.bundles[bname]
        self._plans[bname] = bp
        self._plan_leaves[bname] = ({} if bp.is_uniform else bp.leaves(
            np.dtype(b.table.cfg.key_dtype), b.stacked, self.device))
        dest_hot = bp.dest_hot_counts()
        sh = self.sharded[bname]
        sh.plan_dest_hot = dest_hot if dest_hot.any() else None
        sh.plan_hot_count = bp.hot_count_min() if dest_hot.any() else 0

    def _member_traffics(self, state: TrainState, return_pulls: bool = False):
        """Placer inputs: one MemberTraffic per member table, over the whole
        mesh. Each rank's live keys and freqs are gathered in rank order
        (shard-major, slot order within a shard, as the JAX package reads
        its [N, C] arrays), so every rank plans from the same numbers. A
        key's modeled arrivals per step are its freq over the steps, at
        most N; once a snapshot exists (`_snapshot_freqs`) the freq is the
        delta since it over the window's steps. return_pulls=True also
        returns the (keys, freqs) per member for the snapshot."""
        from deeprec_tpu_torch.embedding.table import META_FREQ, empty_key
        from deeprec_tpu_torch.ops import traffic as T

        N = self.num_shards
        steps = max(1, int(state.step))
        local = {}
        for bname, b in self.bundles.items():
            ts = state.tables[bname]
            occ = ts.keys != empty_key(b.table.cfg)
            keys, freq = ts.keys.cpu().numpy(), ts.meta[:, META_FREQ].cpu().numpy()
            occ = occ.cpu().numpy()
            local[bname] = [(keys[m][occ[m]], freq[m][occ[m]]) for m in range(b.num_tables)]
        ranks = M.all_gather_object(self.mesh, local)
        out, pulls = [], {}
        for bname, b in self.bundles.items():
            cfg = b.table.cfg
            sent = empty_key(cfg)
            row_bytes = T.exchange_row_bytes(
                dim=cfg.dim, wire_bytes=2 if cfg.exchange_dtype == "bfloat16" else 4)
            for m in range(b.num_tables):
                k_live = np.concatenate([r[bname][m][0] for r in ranks])
                f_live = np.concatenate([r[bname][m][1] for r in ranks]).astype(np.float64)
                pulls[(bname, m)] = (k_live, f_live)
                snap = self._freq_snaps.get((bname, m))
                w_steps = steps
                # a snapshot taken at this step is an empty window: lifetime
                # rates instead
                if snap is not None and steps - snap[0] > 0:
                    snap_step, snap_keys, snap_freq = snap
                    w_steps = steps - snap_step
                    if snap_keys.size:
                        pos = np.clip(np.searchsorted(snap_keys, k_live), 0, len(snap_keys) - 1)
                        prev = np.where(snap_keys[pos] == k_live, snap_freq[pos], 0.0)
                    else:
                        prev = np.zeros_like(f_live)
                    # eviction or a row re-init resets freq mid-window
                    f_live = np.maximum(f_live - prev, 0.0)
                out.append(placement_lib.MemberTraffic(
                    bundle=bname, member=m, keys=k_live,
                    weight=np.minimum(f_live / w_steps, float(N)),
                    row_bytes=row_bytes, sentinel=sent))
        return (out, pulls) if return_pulls else out

    def _snapshot_freqs(self, step: int, pulls) -> None:
        """Stamp the per-key freqs (sorted by key) so the next placer run
        models arrivals over the window since this one."""
        for ref, (k_live, f_live) in pulls.items():
            order = np.argsort(k_live, kind="stable")
            self._freq_snaps[ref] = (int(step), k_live[order], f_live[order])

    def _measured_member_windows(self, state: TrainState, window_steps: int):
        """(bundle, member) -> measured per-shard exchange bytes per STEP of
        the current counter window: the cost model's training targets.
        Members whose window saw no arrivals are left out."""
        out = {}
        for bname, b in self.bundles.items():
            for m, ps in enumerate(self._per_shard_stats(b, state.tables[bname])):
                if sum(ps["owner_arrivals"]) == 0:
                    continue
                out[(bname, m)] = (np.asarray(ps["exchange_bytes"], np.float64)
                                   / max(1, int(window_steps)))
        return out

    def update_placement(self, state: TrainState, *, hot_budget: Optional[int] = None,
                         min_gain: Optional[float] = None, force: bool = False,
                         horizon_steps: Optional[int] = None):
        """The cost-model placer, end to end, at a step boundary (every rank
        calls it): model each member's per-shard exchange load from the
        live freqs (`_member_traffics`), build a candidate plan per member
        (`placement.build_plans`, the learned model ranking analytic ties),
        and adopt it when it models `min_gain`x less imbalance than the
        active plan AND its straggler-bytes gain per step amortizes the
        modeled migration bytes within `horizon_steps` (force=True skips
        both bars). Adoption migrates the moved rows
        (`placement.reshard_members`, IN PLACE, bit for bit per key) and
        swaps the plan; a migration that cannot place every key keeps the
        old plan and state on every rank. Every run first records one
        cost-model observation per member.

        Returns (state, per-bundle report); the model and amortization
        numbers land on `last_placement`."""
        import math

        from deeprec_tpu_torch.obs import metrics as obs_metrics
        from deeprec_tpu_torch.ops import traffic as T

        cfg = self.replan_config
        hot_budget = self.placement_hot_budget if hot_budget is None else hot_budget
        min_gain = cfg.min_gain if min_gain is None else min_gain
        horizon = cfg.horizon_steps if horizon_steps is None else horizon_steps
        step_now = int(state.step)
        snap_steps = {ref: step_now - snap[0] for ref, snap in self._freq_snaps.items()}
        members_info, pulls = self._member_traffics(state, return_pulls=True)
        current = {(m.bundle, m.member): self._plans[m.bundle].member(m.member)
                   for m in members_info if m.bundle in self._plans}
        # the cost-model observation, before planning (a deferred run
        # teaches it too): the active plan's modeled TAIL bytes per shard
        # beside the measured bytes less the modeled hot ones, only where
        # the modeled window (since the last placer run) roughly matches
        # the measured one (since the last counter reset)
        window_steps = max(1, step_now - self._window_reset_step)
        measured = self._measured_member_windows(state, window_steps)
        for m in members_info:
            ref = (m.bundle, m.member)
            if ref not in measured or len(m.keys) == 0:
                continue
            ss = snap_steps.get(ref)
            if ss is None or ss <= 0 or ss > 2 * window_steps:
                continue
            plan = current.get(ref)
            owner = (plan.owner_np(m.keys) if plan is not None
                     else placement_lib.home_np(m.keys, self.num_shards))
            load = m.weight * m.row_bytes
            hot_mask = (np.isin(m.keys, np.asarray(plan.hot_keys, m.keys.dtype))
                        if plan is not None and plan.hot_keys else
                        np.zeros(len(m.keys), bool))
            modeled_tail = np.bincount(owner[~hot_mask], weights=load[~hot_mask],
                                       minlength=self.num_shards)
            modeled_hot = np.bincount(owner[hot_mask], weights=load[hot_mask],
                                      minlength=self.num_shards)
            self.cost_model.record_window(self.cost_model.member_stats(m), modeled_tail,
                                          np.maximum(measured[ref] - modeled_hot, 0.0))
        self._snapshot_freqs(step_now, pulls)
        # tiered bundles keep the hash (their demoted rows live in per-shard
        # stores no migration moves); their load is a base to pack around
        pinned = {bname for bname, b in self.bundles.items() if _tiered(b)}
        plannable = [m for m in members_info if m.bundle not in pinned]
        fixed = [m for m in members_info if m.bundle in pinned]
        candidate, model_rep = placement_lib.build_plans(
            self.num_shards, plannable, hot_budget=hot_budget,
            base_loads=placement_lib.modeled_loads(self.num_shards, fixed),
            cost_model=self.cost_model)
        loads_current = placement_lib.modeled_loads(self.num_shards, members_info, current)
        loads_candidate = placement_lib.modeled_loads(self.num_shards, members_info, candidate)
        imb_current = T.shard_imbalance(loads_current)
        imb_candidate = T.shard_imbalance(loads_candidate)
        moved_map = placement_lib.plan_moved_rows(plannable, current, candidate)
        row_bytes_by_ref = {(m.bundle, m.member): m.row_bytes for m in plannable}
        mig_bytes = sum(T.migration_bytes(n, row_bytes=row_bytes_by_ref[ref])
                        for ref, n in moved_map.items())
        gain = T.replan_gain_bytes(loads_current, loads_candidate)
        self.last_placement = dict(
            model_rep,
            imbalance_current=round(imb_current, 4),
            imbalance_candidate=round(imb_candidate, 4),
            gain_bytes_per_step=round(gain, 1),
            migration_rows=int(sum(moved_map.values())),
            migration_bytes=round(float(mig_bytes), 1),
            horizon_steps=horizon,
            amortize_steps=int(math.ceil(mig_bytes / gain)) if gain > 0 else None)
        self._replan_stats["last_gain_bytes_per_step"] = round(gain, 1)
        if obs_metrics.metrics_enabled():
            obs_metrics.default_registry().gauge(
                "deeprec_placement_modeled_gain",
                "modeled straggler exchange bytes/step a candidate plan would save over "
                "the active plan").set(gain)
        imb_ok = imb_candidate * min_gain <= imb_current
        amortized = gain > 0 and gain * float(horizon) >= mig_bytes
        if not (force or (imb_ok and amortized)):
            reason = "min_gain" if not imb_ok else "amortization"
            self._replan_stats["deferred"] = int(self._replan_stats.get("deferred", 0)) + 1
            self._replan_stats["last_deferred_reason"] = reason
            return state, {bname: {"adopted": False, "deferred": reason,
                                   "imbalance_current": imb_current,
                                   "imbalance_candidate": imb_candidate,
                                   "gain_bytes_per_step": round(gain, 1),
                                   "migration_bytes": round(float(mig_bytes), 1)}
                           for bname in self.bundles}

        report = {}
        changed_any = False
        moved_rows, moved_bytes = 0, 0.0
        for bname, b in self.bundles.items():
            if bname in pinned:
                report[bname] = {"adopted": False, "skipped": "multi_tier"}
                continue
            bp_new = BundlePlan(tuple(candidate[(bname, m)] for m in range(b.num_tables)))
            bp_old = self._plans.get(bname)
            rep = {"adopted": False, "moved": 0,
                   "offsets": [p.offset for p in bp_new.plans],
                   "hot_keys": sum(len(p.hot_keys) for p in bp_new.plans)}
            if bp_old == bp_new or (bp_old is None and bp_new.is_uniform):
                rep["adopted"] = bp_old is not None or not bp_new.is_uniform
                report[bname] = rep
                continue
            ok, moved, fail = placement_lib.reshard_members(
                b.table, ensure_shard_counters(state.tables[bname]), bp_new, self.mesh,
                slot_fills=self._slot_fills(b))
            if not ok:
                rep["migrate_failed"] = fail or "reshard aborted"
                report[bname] = rep
                continue
            self._set_plan(bname, bp_new)
            moved_bytes += T.migration_bytes(moved, row_bytes=row_bytes_by_ref[(bname, 0)])
            moved_rows += moved
            rep.update(adopted=True, moved=moved)
            report[bname] = rep
            changed_any = True
        if changed_any:
            st = self._replan_stats
            st["replans"] = int(st["replans"]) + 1
            if force:
                st["forced_replans"] = int(st["forced_replans"]) + 1
            st["migration_rows"] = int(st["migration_rows"]) + moved_rows
            st["migration_bytes"] = round(float(st["migration_bytes"]) + moved_bytes, 1)
            if obs_metrics.metrics_enabled():
                reg = obs_metrics.default_registry()
                reg.counter("deeprec_placement_replans", "adopted placement replans",
                            {"trigger": "forced" if force else "auto"}).inc(1)
                reg.counter("deeprec_placement_migration_bytes",
                            "modeled bytes of rows migrated at plan adoptions"
                            ).inc(moved_bytes)
        return state, report

    def maybe_replan(self, state: TrainState):
        """The drift-driven replan trigger (`maintain()` runs it before the
        budgets under placement="plan"): publish the window's per-shard
        telemetry (`dedup_stats`), read the windowed imbalance level and
        the slope of its gauge, and run the placer only when the
        DriftDetector's hysteresis and cooldown let it; the placer then
        applies its min_gain and amortization bars. Every rank reaches the
        same decision: the level is gathered over the mesh, and the slope
        is position 0's, broadcast."""
        if self.placement != "plan":
            return state, {}
        from deeprec_tpu_torch.obs import metrics as obs_metrics

        cfg = self.replan_config
        stats = self.dedup_stats(state)
        tables_ps = {t: d["per_shard"] for t, d in stats.items()
                     if isinstance(d, dict) and d.get("per_shard")}
        level = max((ps["imbalance"] for ps in tables_ps.values()), default=1.0)
        slope = None
        if obs_metrics.metrics_enabled():
            reg = obs_metrics.default_registry()
            slopes = [reg.window("deeprec_shard_imbalance", {"table": t},
                                 cfg.window_secs).get("slope_per_sec") for t in tables_ps]
            slopes = [s for s in slopes if s is not None]
            slope = max(slopes) if slopes else None
        slope = M.all_gather_object(self.mesh, slope)[0]
        fired = self._drift.observe(level, slope)
        report = {"drift": dict(self._drift.last)}
        if not fired:
            return state, report
        state, placer_rep = self.update_placement(state)
        if any(r.get("adopted") for r in placer_rep.values() if isinstance(r, dict)):
            self._drift.adopted()
        else:
            self._drift.deferred()
        report.update(placer_rep)
        return state, report

    def placement_stats(self) -> Dict[str, object]:
        """Replanner telemetry (`dedup_stats()['__placement__']`): adoption
        and migration counters, the last drift observation and the cost
        model's training state."""
        out = dict(self._replan_stats)
        out["cost_model"] = self.cost_model.info()
        if self._drift.last:
            out["drift"] = dict(self._drift.last)
        return out

    def restore_owner(self, bname: str, member, keys) -> np.ndarray:
        """Owner position of `keys` under the ACTIVE plan (the uniform hash
        without one): where a restore puts each checkpointed row, so a
        checkpoint saved under plan A restores into a trainer on plan B."""
        bp = self._plans.get(bname)
        if bp is None:
            return placement_lib.home_np(keys, self.num_shards)
        return bp.member(member).owner_np(keys)

    def routing_fingerprint(self, bname: str) -> str:
        """A stable digest of the bundle's ACTIVE routing, recorded in the
        checkpoint manifest: a saved per-shard CBF sketch is reused only
        where save and restore route alike (else it is rebuilt from the
        rows)."""
        bp = self._plans.get(bname)
        if bp is None or bp.is_uniform:
            return "uniform"
        import hashlib

        canon = "|".join(f"{p.num_shards}:{p.offset}:{','.join(map(str, p.hot_keys))}:"
                         f"{','.join(map(str, p.hot_owners))}" for p in bp.plans)
        return hashlib.sha1(canon.encode()).hexdigest()[:16]
