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

Left for slice 18 (ROADMAP queue A item 6b): `placement="plan"`,
`update_placement` and `maybe_replan` raise NotImplementedError. Multi-tier
(hbm_dram) bundles are not ported to the sharded trainer either.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch.embedding.table import (
    SHARD_COUNTERS, EmbeddingTable, TableState)
from deeprec_tpu_torch.parallel import mesh as M
from deeprec_tpu_torch.parallel.sharded import ShardedTable
from deeprec_tpu_torch.training import metrics as Mt
from deeprec_tpu_torch.training.trainer import (
    Bundle, StagedBatch, Trainer, TrainState, _loss_from_logits, _tiered)

_SLICE_18 = "waits for slice 18 (ROADMAP queue A item 6b)"


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
    the budgets. Runs on `mesh.device`."""

    def __init__(self, model, sparse_opt, dense_opt=None, mesh: Optional[M.Mesh] = None,
                 grad_averaging: bool = False, comm: str = "allgather",
                 remat: bool = False, a2a_slack: float = 2.0, unique_budget=None,
                 pipeline_mode: str = "off", pipeline_chunks: int = 4,
                 placement: str = "uniform", hier_group_factor: Optional[float] = None,
                 stage: str = "auto", sentinel=None, device=None):
        if placement == "plan":
            raise NotImplementedError(f"ShardedTrainer(placement='plan') {_SLICE_18}")
        if placement != "uniform":
            raise ValueError(f"placement must be 'uniform' or 'plan', got {placement!r}")
        self.mesh = mesh if mesh is not None else M.make_mesh(device=device)
        self.placement = placement
        self.axis = M.mesh_batch_axes(self.mesh)
        self.num_shards = self.mesh.size
        names = self.mesh.axis_names
        if comm == "hier" and len(names) != 2:
            raise ValueError(f"comm='hier' needs a 2-D mesh (make_mesh_2d); got axes {names}")
        super().__init__(model, sparse_opt, dense_opt, grad_averaging, device=self.mesh.device,
                         unique_budget=unique_budget, remat=remat, stage=stage,
                         pipeline_mode=pipeline_mode, pipeline_chunks=pipeline_chunks,
                         sentinel=sentinel)
        tiered = [bname for bname, b in self.bundles.items() if _tiered(b)]
        if tiered:
            raise NotImplementedError(
                f"ShardedTrainer: multi-tier bundles {tiered} are not ported to the "
                "sharded trainer")
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
            ids, pad_value=pad, unique_size=self._budget_for_lookup(b, ids, train))

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

    def _per_shard_stats(self, b: Bundle, ts: TableState, member: int = 0):
        """Owner load per mesh position of one member: the counters resolve
        accumulates, as modeled exchange bytes (ops/traffic.py), and their
        max / mean imbalance."""
        from deeprec_tpu_torch.ops import traffic as T

        ensure_shard_counters(ts)
        g = M.all_gather(self.mesh, torch.stack([ts.owner_arrivals[member],
                                                 ts.owner_unique[member]]), self.axis)
        oa, ou = g[:, 0].tolist(), g[:, 1].tolist()
        cfg = b.table.cfg
        rb = T.exchange_row_bytes(dim=cfg.dim,
                                  wire_bytes=2 if cfg.exchange_dtype == "bfloat16" else 4)
        xb = [round(float(a) * rb, 1) for a in oa]
        return {"owner_unique": [int(x) for x in ou],
                "owner_arrivals": [int(x) for x in oa],
                "exchange_bytes": xb, "imbalance": round(T.shard_imbalance(xb), 4)}

    def dedup_stats(self, state: TrainState) -> Dict[str, Dict[str, float]]:
        """The base trainer's per-table telemetry over every position, plus
        `per_shard` (`_per_shard_stats`) per table."""
        out = super().dedup_stats(state)
        for bname, b in self.bundles.items():
            for k, f in enumerate(b.features):
                out[fcol.resolve_table_name(f)]["per_shard"] = self._per_shard_stats(
                    b, state.tables[bname], k if b.stacked else 0)
                if not b.stacked:
                    break
        return out

    def a2a_overflow(self, state: TrainState) -> int:
        """Ids served the default past the exchange budgets, summed over
        every table and position."""
        local = torch.stack([ensure_shard_counters(ts).a2a_overflow.sum().to(torch.int64)
                             for ts in state.tables.values()]).sum()
        return int(self._psum(local))

    def update_budgets(self, state: TrainState, **kw):
        state, rep = super().update_budgets(state, **kw)
        for ts in state.tables.values():
            ensure_shard_counters(ts)
            ts.owner_arrivals.zero_()
            ts.owner_unique.zero_()
        return state, rep

    # ------------------------------------------------------ capacity loop

    def _bundle_fill(self, b: Bundle, ts: TableState) -> Tuple[int, List[int]]:
        """Growth decides on every position's shard, so all grow alike."""
        local = torch.stack([b.table.size(ts).to(torch.int64),
                             ts.insert_fails.to(torch.int64)])
        g = M.all_gather(self.mesh, local, self.axis)  # [N, 2, T]
        return int(g[:, 0].max()), g[:, 1].reshape(-1).tolist()

    def _set_bundle_capacity(self, b: Bundle, new_c: int) -> None:
        super()._set_bundle_capacity(b, new_c)
        self.sharded[b.name] = self._sharded_table(b.table)

    def maintain(self, state: TrainState, **kw):
        """`Trainer.maintain` with a GLOBAL `max_capacity` (divided by N for
        the shards); every position takes the same growth decision."""
        if kw.get("max_capacity"):
            kw["max_capacity"] = max(1, kw["max_capacity"] // self.num_shards)
        if kw.get("hbm_budget_bytes"):
            raise NotImplementedError(
                "ShardedTrainer.maintain(hbm_budget_bytes=): auto-tiering is not ported "
                "to the sharded trainer")
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

    def restore_owner(self, bname: str, member, keys) -> np.ndarray:
        """Owner position of `keys` (the uniform hash): where a restore puts
        each checkpointed row."""
        from deeprec_tpu_torch.utils.hashing import hash_shard

        return hash_shard(torch.as_tensor(np.asarray(keys)), self.num_shards).numpy()

    def routing_fingerprint(self, bname: str) -> str:
        """The bundle's routing as the checkpoint manifest records it."""
        return "uniform"

    def update_placement(self, state, **kw):
        raise NotImplementedError(f"ShardedTrainer.update_placement {_SLICE_18}")

    def maybe_replan(self, state):
        raise NotImplementedError(f"ShardedTrainer.maybe_replan {_SLICE_18}")
