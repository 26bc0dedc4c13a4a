"""Training and the read-only forward over (hash tables + dense params) —
the port of `deeprec_tpu/training/trainer.py`, single device: `init`,
`train_step`, the K-step window `train_steps` (every `pipeline_mode`),
`train_step_accum`, the staged input (`stage`, `stage_batch`), `eval_step`,
`evaluate`, `forward_views`, `probs_from_views`, the unique-budget engine's
`update_budgets` and `dedup_stats`, the tables' life cycle
(`evict_tables`, `maintain`), and the storage tiers: `maintain` syncs each
member of an hbm_dram / hbm_dram_ssd bundle with its own `MultiTierTable`
(synchronously, or overlapped with `tier_async`), auto-tiers a bundle whose
growth would pass `hbm_budget_bytes`, and tier paging
(`enable_tier_paging`, `fold_tier_prefetch`) folds demoted rows back ahead
of the lookups that need them. `Trainer(sentinel=)` computes the step
sentinel's flags on the device after each step's sparse applies (see
`guard/sentinel.py`): a bit-for-bit no-op on the update math while
untripped.

A K-step window is exactly K `train_step` calls: the same inserts,
admission, counters and version stamps, the step advancing by one per
inner step. PyTorch runs eagerly, so the JAX package's `lax.scan` becomes a
loop; the window's gain is the lookahead. `pipeline_mode="lookahead"`
routes and resolves batch t+1 (dedup, probe, insert, metadata, initializer
rows) before batch t's dense forward and backward, and gathers its value
rows after batch t's sparse apply, so it is bit for bit the same as "off".
On one device "chunked" and "nested" run as "lookahead" (their chunked
exchanges exist only across devices).

A multi-task model returns {task: logits}: the loss sums one BCE per task
over `batch["label_<task>"]`, the train step reports accuracy 0, and
`eval_step`, `probs_from_views` and `evaluate` answer per task (`auc_<task>`).

Unique budgets: a bundle whose budget mode (the trainer's
`unique_budget`, else its features', else its table config's) is an int or
"auto" dedups its TRAIN lookups through the hash engine at a static budget
(`ops/dedup.py`); ids past it serve the blocked default and count into
`dedup_overflow`. Eval and serving lookups stay exact at U = N. "auto" runs
at U = N through the hash engine until `update_budgets` has measured a
unique fraction; a changed budget takes effect at the next step (the port
has no compiled step to rebuild).

The read-only forward (`probs_from_views`, which `eval_step` runs, and
`Predictor.predict` on the same `_build_inputs`) pools every bag through kernel #4
`fused_gather_combine_grouped`, one launch per group of pooled features
that share row dtype and width; the train step pools through the
differentiable `combiners.combine`.

Features whose tables share a config and id shape are bundled: their
states stack along the leading table axis [T] and one batched lookup serves
all of them (the JAX package vmaps over that axis; here every table op
takes it as a batch dimension). The dense parameters live in a flat
{name: tensor} dict and the model runs through `torch.func.functional_call`.

A train step mutates the state it is given IN PLACE (tables, dense
parameters, optimizer moments) and returns a TrainState over the same
tensors, as the JAX step consumes its donated state. Table tensors never
enter the autograd graph: the lookup runs under `no_grad`, the unique
embeddings [T, U, D] of each bundle become the leaves that require grad,
and `torch.autograd.grad` differentiates the loss with respect to (dense
parameters, those leaves).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.embedding import combiners
from deeprec_tpu_torch.embedding.table import (
    COUNTERS, KEY_DTYPES, SHARD_COUNTERS, EmbeddingTable, TableState)
from deeprec_tpu_torch.embedding.table import member_view as _member
from deeprec_tpu_torch.features import SparseFeature
from deeprec_tpu_torch.ops import dedup
from deeprec_tpu_torch.optim import dense as dense_optim
from deeprec_tpu_torch.optim.apply import apply_gradients, ensure_slots
from deeprec_tpu_torch.training import metrics as M
from deeprec_tpu_torch.training.profiler import phase_scope
from deeprec_tpu_torch.utils.hashing import name_salt

# `pipeline_mode`: how a K-step window schedules the lookups of its batches
# (see the module docstring); every mode is exact.
PIPELINE_MODES = ("off", "lookahead", "chunked", "nested")


def validate_pipeline_mode(mode: str, where: str) -> None:
    if mode not in PIPELINE_MODES:
        raise ValueError(
            f"{where}: pipeline_mode must be one of {PIPELINE_MODES}, "
            f"got {mode!r}")


def stack_batches(batches) -> Dict[str, Any]:
    """K same-shape batch dicts as one dict with a leading [K, ...] axis,
    the stacked input of `Trainer.train_steps` (numpy arrays stack on the
    host, tensors where they lie)."""
    batches = list(batches)
    return {k: (torch.stack([b[k] for b in batches]) if torch.is_tensor(v)
                else np.stack([np.asarray(b[k]) for b in batches]))
            for k, v in batches[0].items()}


class StagedBatch(dict):
    """A batch whose tensors `Trainer.stage_batch` is copying to the card
    on its copy stream; `ready` is the event recorded after the copies."""

    ready: Optional[torch.cuda.Event] = None


@dataclasses.dataclass
class TrainState:
    step: int
    tables: Dict[str, TableState]  # bundle name -> stacked table state
    dense: Dict[str, torch.Tensor]  # model parameter name -> tensor
    opt_state: Any = None  # the dense optimizer's state (None: serving only)


@dataclasses.dataclass
class Bundle:
    """A set of features served by one table state. stacked=True: T member
    tables of one shared config on the leading axis; stacked=False: one
    table (T = 1), possibly shared by several features."""

    name: str
    table: EmbeddingTable
    features: List[SparseFeature]
    stacked: bool

    @property
    def num_tables(self) -> int:
        return len(self.features) if self.stacked else 1

    @property
    def salts(self) -> List[int]:
        """Per-member initializer salts of a stacked bundle (the feature
        names', as in the JAX package)."""
        return [name_salt(f.name) for f in self.features]


def build_bundles(specs) -> Dict[str, Bundle]:
    """Group single-use tables by (config-sans-name, pad, pooling, max_len);
    keep shared tables as individual bundles. Same names and order as the
    JAX package, so checkpoints map bundle for bundle."""
    sparse = fcol.sparse_features(specs)
    by_table: Dict[str, List[SparseFeature]] = {}
    for f in sparse:
        by_table.setdefault(fcol.resolve_table_name(f), []).append(f)
    cfgs = fcol.table_configs(specs)

    bundles: Dict[str, Bundle] = {}
    groups: Dict[tuple, List[SparseFeature]] = {}
    for tname, feats in by_table.items():
        cfg = cfgs[tname]
        if len(feats) > 1:
            bundles[tname] = Bundle(tname, EmbeddingTable(cfg), feats, False)
        else:
            f = feats[0]
            key = (dataclasses.replace(cfg, name="_"), f.pad_value, f.pooling,
                   f.max_len)
            groups.setdefault(key, []).append(f)
    for i, (key, feats) in enumerate(sorted(groups.items(), key=lambda kv: kv[1][0].name)):
        if len(feats) == 1:
            tname = fcol.resolve_table_name(feats[0])
            bundles[tname] = Bundle(tname, EmbeddingTable(cfgs[tname]), feats, False)
        else:
            cfg = dataclasses.replace(key[0], name=f"group{i}")
            bundles[cfg.name] = Bundle(cfg.name, EmbeddingTable(cfg), feats, True)
    return bundles


@dataclasses.dataclass
class ModelInputs:
    """What the model's forward receives: pooled bags, sequence features
    (pooling "none": the embeddings per position, zero where the mask is
    False, and the mask) and dense features."""

    pooled: Dict[str, torch.Tensor]  # feature -> [B, D]
    dense: Dict[str, torch.Tensor]  # feature -> [B, W]
    seq: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default_factory=dict)  # feature -> ([B, L, D], [B, L] mask)


def _prep_ids(ids: torch.Tensor) -> torch.Tensor:
    return ids[:, None] if ids.dim() == 1 else ids


TIERED = ("hbm_dram", "hbm_dram_ssd")
_NP_KEYS = {"int32": np.int32, "int64": np.int64}


def _tiered(b: "Bundle") -> bool:
    return b.table.cfg.ev.storage.storage_type.value in TIERED


def _put_member(ts: TableState, k: int, m: TableState) -> TableState:
    """Write member state m back as member k of ts (the member's tensors
    only: the other members' rows, counters and sketch stay as they are).
    Returns the bundle's state."""
    if ts.keys.shape[0] == 1:
        return m
    cut = slice(k, k + 1)
    pairs = [(ts.keys, m.keys), (ts.values, m.values), (ts.meta, m.meta)]
    pairs += [(ts.slots[n], m.slots[n]) for n in ts.slots]
    pairs += [(getattr(ts, n), getattr(m, n)) for n in COUNTERS]
    # a rebuilt member carries no shard counters: they restart at zero
    pairs += [(getattr(ts, n), getattr(m, n) if getattr(m, n) is not None
               else torch.zeros_like(m.insert_fails))
              for n in SHARD_COUNTERS if getattr(ts, n) is not None]
    if ts.bloom is not None:
        pairs.append((ts.bloom, m.bloom))
    if ts.qscale is not None:
        pairs.append((ts.qscale, m.qscale))
    for dst, src in pairs:
        dst = dst[cut]
        if src.data_ptr() != dst.data_ptr():
            dst.copy_(src)
    return ts


class Trainer:
    """Single-device trainer. `model` is an nn.Module with `features` and
    `forward(inputs)`; its own parameters are only the template of
    `TrainState.dense`. `sparse_opt` (an `optim.sparse` row optimizer)
    trains the tables and `dense_opt` (default `optim.dense.adam(1e-3)`, as
    the JAX package's `optax.adam(1e-3)`) the dense parameters; a Trainer
    without a sparse optimizer only serves (lookups and forward) and its
    `init()` carries no optimizer state. `remat` recomputes the model's
    forward in the backward; `stage` ("auto" | "off") is what `stage()`
    does; `pipeline_mode` (PIPELINE_MODES) schedules `train_steps`;
    `sentinel` (a `guard.SentinelConfig`) adds the step sentinel's flags
    and EMA to every train path's metrics and the anomaly eviction to
    `maintain`."""

    def __init__(self, model, sparse_opt=None, dense_opt=None,
                 grad_averaging: bool = False, device=None,
                 unique_budget=None, remat: bool = False, stage: str = "auto",
                 pipeline_mode: str = "off", pipeline_chunks: int = 4, sentinel=None):
        self.model = model
        # the step sentinel (guard/sentinel.py SentinelConfig): per-step
        # model-quality flags computed on the device after the sparse
        # applies; a bit-for-bit no-op on the update math while untripped
        if sentinel is not None:
            from deeprec_tpu_torch.guard.sentinel import SentinelConfig

            if not isinstance(sentinel, SentinelConfig):
                raise TypeError("sentinel must be a guard.SentinelConfig, got "
                                f"{type(sentinel).__name__}")
        self.sentinel = sentinel
        self.sparse_opt = sparse_opt
        self.dense_opt = dense_opt or dense_optim.adam(1e-3)
        self.grad_averaging = grad_averaging
        # remat=True recomputes the model's forward in the backward
        # (torch.utils.checkpoint): activation memory for compute
        self.remat = remat
        if stage not in ("auto", "off"):
            raise ValueError(f"unknown stage mode {stage!r}")
        self.stage_mode = stage
        validate_pipeline_mode(pipeline_mode, type(self).__name__)
        self.pipeline_mode = pipeline_mode
        # the chunk count of a sharded table's exchanges; one device has none
        self.pipeline_chunks = max(1, int(pipeline_chunks))
        # trainer-wide budget override: None (the configs decide) | "auto"
        # | "off" | a positive int, checked like the configs'
        fcol.validate_unique_budget(unique_budget, "Trainer(unique_budget=)")
        self.unique_budget = unique_budget
        self.device = resolve_device(device)
        self.sparse_specs = fcol.sparse_features(model.features)
        self.dense_specs = fcol.dense_features(model.features)
        self.bundles = build_bundles(model.features)
        self._budget_modes = {bname: self._bundle_budget_mode(b)
                              for bname, b in self.bundles.items()}
        self._auto_frac: Dict[str, float] = {}  # bundle -> budget fraction
        self._unique_ema: Dict[str, float] = {}  # bundle -> raw EMA
        self._salts = {
            bname: torch.tensor(b.salts, dtype=torch.int64, device=self.device)
            for bname, b in self.bundles.items() if b.stacked
        }
        self._copy_stream = None  # stage_batch's, made at its first use
        # (bundle, member index) -> MultiTierTable, made at a member's first
        # tier sync; the tier-paging pump and its fold chunk
        self._tiers: Dict[tuple, Any] = {}
        self._tier_pager = None
        self._tier_chunk = 256

    @property
    def tables(self) -> Dict[str, EmbeddingTable]:
        """{table name: EmbeddingTable} over every feature's table."""
        return {fcol.resolve_table_name(f): b.table
                for b in self.bundles.values() for f in b.features}

    def table_state(self, state: TrainState, table_name: str) -> TableState:
        """The [1, ...] state of one named table: a view into a stacked
        bundle's member (writes go through), or the bundle's own state."""
        for b in self.bundles.values():
            for k, f in enumerate(b.features):
                if fcol.resolve_table_name(f) == table_name:
                    ts = state.tables[b.name]
                    return _member(ts, k) if b.stacked else ts
        raise KeyError(table_name)

    def init(self, seed: Optional[int] = None) -> TrainState:
        """Empty tables (with the sparse optimizer's slots), the dense
        parameters and the dense optimizer's state, on the device. seed=None
        takes the model's own parameters; an int draws them again through
        the model's own initialiser from a torch.Generator seeded with it
        (`nn.SeededModule.reseeded`). The values are not the JAX package's
        `init(seed)`: jax.random streams are out of reach."""
        src = self.model
        if seed is not None:
            if not hasattr(self.model, "reseeded"):
                raise TypeError(
                    f"init(seed={seed}): {type(self.model).__name__} cannot draw "
                    "its weights again (build it on nn.SeededModule)")
            src = self.model.reseeded(seed)
        tables = {}
        for bname, b in self.bundles.items():
            ts = b.table.create(b.num_tables, self.device)
            if self.sparse_opt is not None:
                ensure_slots(b.table, ts, self.sparse_opt)
            tables[bname] = ts
        dense = {n: p.detach().to(self.device, copy=True)
                 for n, p in src.named_parameters()}
        opt_state = (self.dense_opt.init(dense)
                     if self.sparse_opt is not None else None)
        return TrainState(step=0, tables=tables, dense=dense, opt_state=opt_state)

    def input_keys(self) -> frozenset:
        return frozenset(f.name for f in self.sparse_specs) | frozenset(
            f.name for f in self.dense_specs
        )

    def device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's input features and labels as tensors on the device:
        numpy arrays are copied once, tensors already there pass as they
        are. A `StagedBatch` makes the current stream wait for its copies
        and hands its tensors to that stream."""
        ready = getattr(batch, "ready", None)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for v in batch.values():
                v.record_stream(stream)
        keep = self.input_keys()
        return {
            k: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)
                               ).to(self.device)
            for k, v in batch.items() if k in keep or k.startswith("label")
        }

    def _ids(self, b: Bundle, batch, feats) -> torch.Tensor:
        """[T, B, L] id stack of `feats` in the table's key dtype (64-bit
        ids narrow as they do on the way into a 32-bit JAX table)."""
        ids = [_prep_ids(batch[f.name]) for f in feats]
        shapes = {f.name: tuple(i.shape) for f, i in zip(feats, ids)}
        if len(set(shapes.values())) > 1:
            raise ValueError(
                f"grouped features have mismatched id shapes {shapes}; "
                "declare distinct SparseFeature.max_len values to keep "
                "them in separate embedding groups"
            )
        return torch.stack(ids).to(KEY_DTYPES[b.table.cfg.key_dtype])

    @staticmethod
    def _members(b: Bundle) -> List[List[SparseFeature]]:
        """The feature groups of one bundle that look up together: all
        members of a stacked bundle at once, a shared table's features one
        after another."""
        return [b.features] if b.stacked else [[f] for f in b.features]

    @staticmethod
    def _results(b: Bundle, res) -> list:
        """(features, lookup result) pairs of one bundle's entry of
        `bundle_res`, in lookup order."""
        if b.stacked:
            return [(b.features, res)]
        return [([f], res[f.name]) for f in b.features]

    # ----------------------------------------------------- unique budgets

    def _bundle_budget_mode(self, b: Bundle):
        """Effective budget mode of one bundle: the trainer-wide override
        wins, then feature-level settings (largest int, else "auto" if
        any), then the table config. None (U = N, logged) | "off" (U = N,
        silent) | "auto" | int."""
        mode = self.unique_budget
        if mode is None:
            feat = [f.unique_budget for f in b.features
                    if f.unique_budget is not None]
            if feat:
                ints = [m for m in feat if isinstance(m, int)]
                mode = (max(ints) if ints
                        else ("auto" if any(m == "auto" for m in feat) else "off"))
            else:
                mode = b.table.cfg.unique_budget
        return mode

    def _resolve_budget(self, b: Bundle, n: int) -> Optional[int]:
        """Static uids size for an n-position lookup of bundle `b`, or None
        for U = N. "auto" uses the quantized EMA fraction once
        `update_budgets` has measured one (clamped by the table capacity),
        and before that runs at U = N through the hash engine."""
        mode = self._budget_modes.get(b.name)
        if mode is None or mode == "off":
            if mode is None:  # "off" is a deliberate choice: stay silent
                dedup.log_full_fallback(b.name, n)
            return None
        if isinstance(mode, int):
            return dedup.resolve_size(mode, n)
        frac = self._auto_frac.get(b.name)
        budget = n if frac is None else min(int(math.ceil(frac * n)),
                                            self._budget_capacity(b))
        return dedup.resolve_size(budget, n)

    def _budget_capacity(self, b: Bundle) -> int:
        """Upper clamp of the auto budget: a batch cannot hold more
        resident uniques than the table has slots."""
        return b.table.cfg.capacity

    def _budget_for_lookup(self, b: Bundle, ids: torch.Tensor,
                           train: bool) -> Optional[int]:
        """Static unique size of one lookup of ids [T, ...]: budgets apply
        to TRAIN lookups only (the overflow counter moves only on train
        state); eval and serving run exact at U = N."""
        if not train:
            return None
        return self._resolve_budget(b, math.prod(ids.shape[1:]))

    @staticmethod
    def _bundle_dedup_counters(ts: TableState, member: Optional[int] = None
                               ) -> Tuple[int, int, int]:
        """Host-read (unique, ids, overflow) totals of a state's counters:
        of one member of a stacked state, else summed over the table
        axis."""
        sel = slice(None) if member is None else slice(member, member + 1)
        return tuple(int(getattr(ts, name)[sel].sum())
                     for name in ("dedup_unique", "dedup_ids", "dedup_overflow"))

    def dedup_stats(self, state: TrainState) -> Dict[str, Dict[str, float]]:
        """Per-TABLE dedup telemetry since the last counter reset:
        `unique_fraction` ((budgeted uniques + overflow) over id positions,
        what the auto budget tracks) and `dedup_overflow`. Stacked bundles
        report each member under its table's name. Mirrored into the obs
        plane as the gauges `deeprec_dedup_unique_fraction{table}` and
        `deeprec_dedup_overflow{table}`."""
        out: Dict[str, Dict[str, float]] = {}
        for bname, b in self.bundles.items():
            ts = state.tables[bname]
            per_shard = self._per_shard_stats(b, ts)
            for k, f in enumerate(b.features):
                uniq, ids, ovf = self._bundle_dedup_counters(
                    ts, k if b.stacked else None)
                rec = out[fcol.resolve_table_name(f)] = {
                    "unique_fraction": round((uniq + ovf) / ids, 4) if ids else None,
                    "dedup_overflow": ovf,
                }
                if per_shard is not None:
                    rec["per_shard"] = per_shard[k if b.stacked else 0]
                if not b.stacked:
                    break  # a shared table holds one merged counter
        self._publish_dedup_obs(out)
        return out

    def _per_shard_stats(self, b: Bundle, ts: TableState):
        """Owner load per mesh position of each member of a bundle, or None
        without a shard axis (the sharded trainer overrides)."""
        return None

    @staticmethod
    def _publish_dedup_obs(stats: Dict[str, Dict]) -> None:
        """The dedup telemetry into the obs plane: per-table unique-fraction
        and overflow gauges, from the host ints `dedup_stats` already read,
        and for a sharded trainer the per-shard exchange bytes
        (`deeprec_shard_exchange_bytes{table,shard}`) and their max / mean
        imbalance (`deeprec_shard_imbalance{table}`, whose windowed slope
        the replan trigger reads). The labels are bounded sets."""
        from deeprec_tpu_torch.obs import metrics as obs_metrics

        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.default_registry()
        for tname, rec in stats.items():
            lab = {"table": tname}
            if rec.get("unique_fraction") is not None:
                reg.gauge("deeprec_dedup_unique_fraction",
                          "budgeted uniques + overflow over id positions",
                          lab).set(rec["unique_fraction"])
            reg.gauge("deeprec_dedup_overflow",
                      "ids past the unique budget since last reset",
                      lab).set(rec.get("dedup_overflow") or 0)
            ps = rec.get("per_shard")
            if not ps:
                continue
            reg.gauge("deeprec_shard_imbalance",
                      "max/mean per-shard exchange-bytes imbalance",
                      lab).set(ps["imbalance"])
            for i, xb in enumerate(ps.get("exchange_bytes", ())):
                reg.gauge("deeprec_shard_exchange_bytes",
                          "modeled exchange bytes per mesh position",
                          {"table": tname, "shard": str(i)}).set(xb)

    def update_budgets(self, state: TrainState, *, slack: float = 1.5,
                       ema: float = 0.5
                       ) -> Tuple[TrainState, Dict[str, Dict[str, float]]]:
        """Fold each bundle's dedup counters into the auto-budget EMA,
        derive each "auto" bundle's budget fraction (slack x EMA, rounded
        UP onto a 1/16 grid) and reset the counters IN PLACE. Host-side:
        call at log cadence. Returns (state, report) with per-bundle
        unique_fraction / dedup_overflow / unique_budget_fraction."""
        report: Dict[str, Dict[str, float]] = {}
        for bname, b in self.bundles.items():
            ts = state.tables[bname]
            uniq, ids, ovf = self._bundle_dedup_counters(ts)
            rep: Dict[str, float] = {"dedup_overflow": ovf}
            if ids > 0:
                # overflowed ids are uniques the budget refused: count them
                # so a too-tight budget widens instead of latching
                frac = min(1.0, (uniq + ovf) / ids)
                rep["unique_fraction"] = round(frac, 4)
                old = self._unique_ema.get(bname)
                self._unique_ema[bname] = (
                    frac if old is None else (1.0 - ema) * old + ema * frac)
                if self._budget_modes.get(bname) == "auto":
                    self._auto_frac[bname] = dedup.auto_budget_fraction(
                        self._unique_ema[bname], slack=slack)
            if bname in self._auto_frac:
                rep["unique_budget_fraction"] = self._auto_frac[bname]
            for name in ("dedup_unique", "dedup_ids", "dedup_overflow"):
                getattr(ts, name).zero_()
            report[bname] = rep
        return state, report

    # ----------------------------------------------------- table life cycle

    def _slot_fills(self, b: Bundle) -> Tuple[Tuple[str, float], ...]:
        """(slot name, init value) of the sparse optimizer's slots: the
        value a freed or new slot row takes."""
        return tuple((name, init) for name, (_, init)
                     in self.sparse_opt.slot_specs(b.table.cfg.dim).items())

    def evict_tables(self, state: TrainState, step: Optional[int] = None
                     ) -> TrainState:
        """Apply each table's eviction policies (TTL, L2) at `step`
        (default: the state's) and rebuild it; tables without one are left
        alone. Run it at checkpoint cadence, between windows."""
        step = int(state.step) if step is None else int(step)
        tables = dict(state.tables)
        for bname, b in self.bundles.items():
            ev = b.table.cfg.ev
            if ev.global_step_evict is None and ev.l2_weight_evict is None:
                continue
            tables[bname] = b.table.evict(tables[bname], step,
                                          slot_fills=self._slot_fills(b))
        return TrainState(step=state.step, tables=tables, dense=state.dense,
                          opt_state=state.opt_state)

    def maintain(self, state: TrainState, *, grow_threshold: float = 0.85,
                 max_capacity: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 step: Optional[int] = None, tier_async: bool = False
                 ) -> Tuple[TrainState, Dict[str, Dict[str, float]]]:
        """The capacity loop, between windows: `update_budgets`, then per
        bundle a report of `occupancy` (the fullest member's live keys over
        the capacity), `insert_fails`, `capacity` and the dedup fields.

        A tiered bundle (storage hbm_dram / hbm_dram_ssd) syncs each member
        with its MultiTierTable at `step` (default: the state's) and reports
        `demoted` and `promoted`; `tier_async=True` runs `sync_async`
        instead, whose store IO overlaps the next windows. Any other bundle
        with failed inserts or occupancy above `grow_threshold` grows to the
        next power of two that holds twice its worst member's demand, at
        most `max_capacity` (rounded down to a power of two), and reports
        `grew_to` — unless the growth would take the table bytes of all
        bundles past `hbm_budget_bytes`: then it is auto-tiered instead
        (a synchronous forced sync, `auto_tiered`, `demoted`, `promoted`).
        Bytes are counted as `_table_bytes` counts them (the sharded
        trainer's: the whole mesh's). `demoted`, `promoted` and
        `rows_reinit` are totals over every member (and mesh position).

        With a sentinel whose `row_evict_quantile` is set, each member's
        anomalous rows (`guard/rows.anomaly_evict`) are re-initialized
        first, before occupancy and growth read the state, and counted as
        `rows_reinit` (and into `deeprec_guard_rows_reinit{table}`).

        Under `placement="plan"` (the sharded trainer) the drift gate
        `maybe_replan` runs first, while the window's owner counters are
        still unreset, and each bundle's report carries its `placement`
        record."""
        step = int(state.step) if step is None else int(step)
        placement_report = {}
        if getattr(self, "placement", "uniform") == "plan":
            state, placement_report = self.maybe_replan(state)
        state, dedup_report = self.update_budgets(state)
        total_bytes = (sum(self._table_bytes(ts) for ts in state.tables.values())
                       if hbm_budget_bytes else 0)
        if max_capacity:
            max_capacity = 1 << (int(max_capacity).bit_length() - 1)
        tables = dict(state.tables)
        report: Dict[str, Dict[str, float]] = {}
        for bname, b in self.bundles.items():
            ts = tables[bname]
            C = b.table.cfg.capacity
            ts, rows_reinit = self._row_hygiene(b, ts)
            live_max, fails_each = self._bundle_fill(b, ts)
            occ = live_max / C
            rep = {"occupancy": occ, "insert_fails": sum(fails_each), "capacity": C}
            if rows_reinit:
                rep["rows_reinit"] = rows_reinit
            rep.update(dedup_report.get(bname, {}))
            if bname in placement_report:
                rep["placement"] = placement_report[bname]
            if _tiered(b):
                with phase_scope("tier_sync"):
                    ts, demoted, promoted = self._tier_sync(b, ts, step,
                                                            tier_async=tier_async)
                rep.update(demoted=demoted, promoted=promoted)
            elif sum(fails_each) > 0 or occ > grow_threshold:
                worst = max(fails_each)
                new_c = C * 2
                while worst > 0 and new_c < (worst + occ * C) * 2:
                    new_c *= 2
                if max_capacity:
                    new_c = min(new_c, max_capacity)
                growth_bytes = self._table_bytes(ts) * (new_c // C - 1)
                if hbm_budget_bytes and total_bytes + growth_bytes > hbm_budget_bytes:
                    # over the budget: demote cold rows to the host tier and
                    # keep the capacity; forced, since the pressure may come
                    # from probe clustering below the high watermark
                    with phase_scope("tier_sync"):
                        ts, demoted, promoted = self._tier_sync(b, ts, step, force=True)
                    rep.update(auto_tiered=True, demoted=demoted, promoted=promoted)
                elif new_c > C:
                    ts = b.table.grow(ts, new_c, slot_fills=self._slot_fills(b))
                    self._set_bundle_capacity(b, new_c)
                    rep["grew_to"] = new_c
                    total_bytes += growth_bytes
            tables[bname] = ts
            report[bname] = rep
        if self._tier_pager is not None:
            # the demotes retired the pump's gathers and may have demoted
            # rows the staged batches are about to look up: probe them again
            self._tier_pager.requeue_recent()
        return (TrainState(step=state.step, tables=tables, dense=state.dense,
                           opt_state=state.opt_state), report)

    def update_placement(self, state: TrainState, **kw):
        """Recompute the skew-aware shard placement and migrate rows: a
        no-op without a shard axis (the sharded trainer implements it)."""
        return state, {}

    def maybe_replan(self, state: TrainState):
        """The drift-driven replan gate: a no-op without a shard axis (the
        sharded trainer implements it)."""
        return state, {}

    def _bundle_fill(self, b: Bundle, ts: TableState) -> Tuple[int, List[int]]:
        """(the fullest member's live keys, every member's insert_fails):
        what `maintain` decides growth on."""
        return int(b.table.size(ts).max()), ts.insert_fails.tolist()

    def _row_hygiene(self, b: Bundle, ts: TableState) -> Tuple[TableState, int]:
        """The sentinel's anomaly eviction over every member of bundle `b`
        (a member with anomalous rows is rebuilt without them and written
        back; the others stay as they are). Returns (the bundle's state, the
        rows re-initialized)."""
        sen = self.sentinel
        if sen is None or sen.row_evict_quantile is None:
            return ts, 0
        from deeprec_tpu_torch.guard import rows as guard_rows

        fills = self._slot_fills(b)
        total = 0
        for k in range(b.num_tables):
            m, n = guard_rows.anomaly_evict(b.table, _member(ts, k), sen.row_evict_quantile,
                                            sen.row_evict_factor, fills)
            if n:
                ts = _put_member(ts, k, m)
                total += n
        total = self._mesh_sum(total)[0]
        if total:
            from deeprec_tpu_torch.obs import metrics as obs_metrics

            if obs_metrics.metrics_enabled():
                obs_metrics.default_registry().counter(
                    "deeprec_guard_rows_reinit",
                    "anomalous table rows re-initialized by maintain() row hygiene",
                    {"table": b.name}).inc(total)
        return ts, total

    def _mesh_sum(self, *counts: int) -> List[int]:
        """Integer counts summed over the mesh (the sharded trainer's; one
        device: as they are). Every position must call it."""
        return [int(c) for c in counts]

    def _table_bytes(self, ts: TableState) -> int:
        """The bytes one bundle's table state takes, counted as
        `hbm_budget_bytes` counts them: `_state_bytes` here, the whole
        mesh's on the sharded trainer."""
        return self._state_bytes(ts)

    def _tier_index(self, b: Bundle, k: int) -> Tuple[int, ...]:
        """The index of member k's tier: (k,) in a stacked bundle, ()
        otherwise (the sharded trainer adds its mesh position)."""
        return (k,) if b.stacked else ()

    @staticmethod
    def _state_bytes(ts: TableState) -> int:
        """Bytes of one bundle's table state, counted as the JAX package
        counts the leaves of its TableState: keys, values, meta, every
        optimizer slot and the sketch, plus seven int32 counters per member
        (the JAX TableState's insert_fails, a2a_overflow, three dedup and
        two owner-load counters; the port keeps four of them). So one
        `hbm_budget_bytes` grows or auto-tiers the same bundles in both
        packages."""
        leaves = [ts.keys, ts.values, ts.meta, *ts.slots.values()]
        if ts.bloom is not None:
            leaves.append(ts.bloom)
        return (sum(t.numel() * t.element_size() for t in leaves)
                + 7 * 4 * ts.keys.shape[0])

    def _multi_tier_for(self, b: Bundle, idx: Tuple[int, ...]):
        """The MultiTierTable of one member (`_tier_index`), made at first
        use with its own host store and, under a storage path, its own disk
        log `<path>_m<i>_<j>...` over the index."""
        from deeprec_tpu_torch.embedding.multi_tier import MultiTierTable

        key = (b.name, idx)
        mt = self._tiers.get(key)
        if mt is None:
            base = b.table.cfg.ev.storage.storage_path
            path = base + "_m" + "_".join(map(str, idx)) if base and idx else base
            mt = MultiTierTable(b.table, slot_fills=self._slot_fills(b),
                                storage_path=path)
            self._tiers[key] = mt
        mt.table = b.table  # follows a grown capacity
        return mt

    def _tier_sync(self, b: Bundle, ts: TableState, step: int, force: bool = False,
                   tier_async: bool = False):
        """Sync every member of bundle `b` with its MultiTierTable (sync, or
        sync_async when tier_async and not force). Returns (the bundle's
        state, demoted, promoted), the counts summed over the mesh."""
        from deeprec_tpu_torch.embedding.multi_tier import probe_members

        demoted = promoted = 0
        tiers = [self._multi_tier_for(b, self._tier_index(b, k))
                 for k in range(b.num_tables)]
        overlapped = tier_async and not force
        # the last rounds' candidates of every member, probed in one loop
        slots = probe_members(b.table, ts, tiers) if overlapped else None
        for k, mt in enumerate(tiers):
            m = _member(ts, k)
            if overlapped:
                m, stats = mt.sync_async(m, step, pending_slots=slots[k])
            else:
                m, stats = mt.sync(m, step, force=force)
            ts = _put_member(ts, k, m)
            demoted += stats.demoted
            promoted += stats.promoted
        demoted, promoted = self._mesh_sum(demoted, promoted)
        return ts, demoted, promoted

    def tier_stall_ms(self) -> float:
        """Caller-side tier sync stall summed over every member tier."""
        return sum(mt.sync_stall_ms for mt in self._tiers.values())

    # ------------------------------------------------ overlapped tier paging

    def enable_tier_paging(self, *, depth: int = 4, chunk: int = 256,
                           max_pending: int = 8192):
        """Turn on tier paging: a background `TierPrefetcher` probes each
        staged batch's ids (the Prefetcher's `peek`, before the copy to the
        device) against every tiered member's host and disk stores, and
        `fold_tier_prefetch` folds the gathered rows into the device tables
        at dispatch boundaries. Call before `stage()`. Returns the pager
        (`close_tier_paging()` stops it). Raises ValueError without a tiered
        bundle."""
        from deeprec_tpu_torch.embedding.tier_prefetch import TierPrefetcher

        specs = []
        for bname, b in self.bundles.items():
            if not _tiered(b):
                continue
            kd = _NP_KEYS[b.table.cfg.key_dtype]
            if b.stacked:
                specs.extend(((bname, (k,)), (f.name,), kd)
                             for k, f in enumerate(b.features))
            else:
                specs.append(((bname, ()), tuple(f.name for f in b.features), kd))
        if not specs:
            raise ValueError("no multi-tier bundle (storage_type hbm_dram / "
                             "hbm_dram_ssd) — nothing to page")

        def extract(batch, specs=tuple(specs)):
            # the ids as the table stores them: cast to its key dtype
            out = {}
            for key, names, kd in specs:
                arrs = [np.asarray(batch[n].cpu() if torch.is_tensor(batch[n])
                                   else batch[n]).reshape(-1).astype(kd)
                        for n in names if n in batch]
                if arrs:
                    out[key] = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
            return out

        self._tier_chunk = int(chunk)
        # resolve through the dict, never _multi_tier_for: the pump must not
        # make tiers (a member that never demoted has nothing to page)
        self._tier_pager = TierPrefetcher(resolve=self._tiers.get, extract=extract,
                                          depth=depth, max_pending=max_pending)
        return self._tier_pager

    def warm_tier_folds(self, state: TrainState) -> None:
        """Make every tiered member's stores and run an empty fold through
        it (a no-op on the state), so the first real fold pays no set-up."""
        for bname, b in self.bundles.items():
            if not _tiered(b):
                continue
            for k in range(b.num_tables):
                self._multi_tier_for(b, self._tier_index(b, k)).warm_fold(
                    _member(state.tables[bname], k), chunk=self._tier_chunk)

    def fold_tier_prefetch(self, state: TrainState):
        """Dispatch-boundary half of tier paging: fold every buffered
        package into its member's table, IN PLACE (a row that trained past
        its tier copy is dropped to the retry set, never clobbered), the
        members of a bundle together (`multi_tier.fold_members`). Returns
        (state, {bundle: {"folded", "dropped"}})."""
        from deeprec_tpu_torch.embedding.multi_tier import fold_members

        pager = self._tier_pager
        if pager is None:
            return state, {}
        by_bundle: Dict[str, list] = {}
        for key in pager.pending_keys():
            by_bundle.setdefault(key[0], []).append(key)
        report: Dict[str, Dict[str, int]] = {}
        for bname, bkeys in by_bundle.items():
            b = self.bundles.get(bname)
            if b is None:
                continue
            folds = []
            for key in bkeys:
                idx = key[1]
                k = idx[0] if idx else 0
                if idx != ((k,) if b.stacked else ()) or k >= b.num_tables:
                    continue
                cand = pager.take(key)
                if cand is not None:
                    mt = self._multi_tier_for(b, idx)
                    mt._ensure_tiers(_member(state.tables[bname], k))
                    folds.append((k, mt, cand))
            if not folds:
                continue
            # every member's fold, one insert probe per chunk
            with phase_scope("tier_fold"):
                counts = fold_members(b.table, state.tables[bname], folds, self._tier_chunk)
            folded, dropped = (sum(c[i] for c in counts) for i in (0, 1))
            if folded or dropped:
                report[bname] = {"folded": folded, "dropped": dropped}
        return state, report

    def tier_paging_stats(self) -> Dict[str, float]:
        """The pump's drop and error counters and the fold totals (rows,
        bytes, training-thread stall ms); the probe counters are the obs
        plane's `deeprec_tier_prefetch_*`."""
        out: Dict[str, float] = (dict(self._tier_pager.stats())
                                 if self._tier_pager is not None else {})
        tiers = self._tiers.values()
        for name in ("folded_rows", "fold_bytes", "fold_stall_ms"):
            out[name] = sum(getattr(mt, name) for mt in tiers)
        return out

    def close_tier_paging(self) -> None:
        """Stop the pager's pump (safe mid-gather: probes are read-only)."""
        if self._tier_pager is not None:
            self._tier_pager.close()
            self._tier_pager = None

    def _set_bundle_capacity(self, b: Bundle, new_c: int) -> None:
        """Point bundle `b` at a grown capacity (a new EmbeddingTable; its
        probe-sync count carries over). Nothing else is cached per table:
        the salts are the features', the auto budget's clamp reads the
        bundle's table."""
        table = EmbeddingTable(dataclasses.replace(b.table.cfg, capacity=new_c))
        table.probe_syncs = b.table.probe_syncs
        b.table = table

    # ------------------------------------------------------------- lookups
    #
    # A lookup runs in three phases (`EmbeddingTable._route_ids`,
    # `_resolve_routed`, `_finish_resolved`) over every lookup group: a
    # stacked bundle at once, a shared table's features one after another.

    # One group's phases; the sharded trainer's go through its collective
    # ShardedTable (parallel/trainer.py).
    def _route_one(self, b: Bundle, ids: torch.Tensor, pad: int, train: bool):
        return b.table._route_ids(ids, pad, self._budget_for_lookup(b, ids, train))

    def _resolve_one(self, bname: str, ts: TableState, route, step: int, train: bool):
        return self.bundles[bname].table._resolve_routed(
            ts, route, step=step, train=train, salt=self._salts.get(bname))

    def _finish_one(self, bname: str, ts: TableState, res):
        return self.bundles[bname].table._finish_resolved(ts, res)

    def _route_all(self, batch, train: bool = True) -> list:
        """Route every lookup group of `batch`: [(bundle, features, masks
        [T, B, L], route)], in bundle and feature order."""
        out = []
        for bname, b in self.bundles.items():
            for feats in self._members(b):
                ids = self._ids(b, batch, feats)
                pad = feats[0].pad_value
                out.append((bname, feats, ids != pad, self._route_one(b, ids, pad, train)))
        return out

    def _resolve_all(self, tables, routes: list, step: int = 0,
                     train: bool = True) -> list:
        """Resolve each routed group in order (train mode inserts and
        stamps IN PLACE): [(bundle, features, masks, pending result)]."""
        return [(bname, feats, masks,
                 self._resolve_one(bname, tables[bname], route, step, train))
                for bname, feats, masks, route in routes]

    def _finish_all(self, tables, pending: list):
        """Gather each resolved group's rows from the CURRENT tables.
        Returns (per-feature views (embeddings [U, D], inverse [B, L],
        mask [B, L]), per-bundle results: a stacked bundle's result, or
        {feature: result} for the rest)."""
        views, bundle_res = {}, {}
        for bname, feats, masks, res in pending:
            b = self.bundles[bname]
            res = self._finish_one(bname, tables[bname], res)
            for k, f in enumerate(feats):
                views[f.name] = (res.embeddings[k], res.inverse[k], masks[k])
            if b.stacked:
                bundle_res[bname] = res
            else:
                bundle_res.setdefault(bname, {})[feats[0].name] = res
        return views, bundle_res

    def _lookup_all(self, tables, batch, step: int = 0, train: bool = False):
        """Every group's lookup, route -> resolve -> finish. Returns
        (views, bundle_res) as `_finish_all`."""
        return self._finish_all(tables, self._resolve_all(
            tables, self._route_all(batch, train), step, train))

    def _build_inputs(self, embs, views, batch, read_only: bool = False
                      ) -> ModelInputs:
        """The model's inputs from per-feature unique embeddings. The train
        step pools through the differentiable `combine`; read_only=True
        (serving and evaluation) pools the bags through kernel #4, one
        launch per group of features whose rows share dtype and width
        (`combine_pooled_group`), the rows in their own dtype."""
        pooled, seq, groups = {}, {}, {}
        for f in self.sparse_specs:
            _, inverse, mask = views[f.name]
            if f.pooling == "none":
                e = embs[f.name].to(torch.float32)[inverse.long()]  # [B, L, D]
                seq[f.name] = (torch.where(mask[..., None], e, 0.0), mask)
            elif read_only:
                e = embs[f.name]
                groups.setdefault((e.dtype, e.shape[-1]), []).append(f)
                pooled[f.name] = None  # filled below, in feature order
            else:
                pooled[f.name] = combiners.combine(embs[f.name], inverse, mask,
                                                   f.pooling)
        for feats in groups.values():
            pooled.update(zip((f.name for f in feats), combiners.combine_pooled_group(
                [embs[f.name] for f in feats], [views[f.name][1] for f in feats],
                [views[f.name][2] for f in feats], [f.pooling for f in feats])))
        dense = {f.name: batch[f.name] for f in self.dense_specs}
        return ModelInputs(pooled=pooled, dense=dense, seq=seq)

    # ---------------------------------------------------------------- training

    def _model_call(self, dense, inputs):
        return functional_call(self.model, dense, (inputs,))

    def _fwd_bwd(self, params, views, bundle_res, batch):
        """Dense forward and backward of one batch on its finished lookups:
        the unique embeddings [T, U, D] of each lookup group are the leaves
        that take gradients, with the dense parameters. Returns (loss,
        logits, {name: dense gradient}, [group gradients in lookup
        order])."""
        with phase_scope("dense_fwd_bwd"):
            leaves, embs = [], {}
            for bname, b in self.bundles.items():
                for feats, res in self._results(b, bundle_res[bname]):
                    e = res.embeddings.to(torch.float32).detach().requires_grad_(True)
                    leaves.append(e)
                    for k, f in enumerate(feats):
                        embs[f.name] = e[k]
            dense = {n: p.detach().requires_grad_(True) for n, p in params.items()}
            inputs = self._build_inputs(embs, views, batch)
            if self.remat:
                logits = checkpoint(self._model_call, dense, inputs,
                                    use_reentrant=False)
            else:
                logits = self._model_call(dense, inputs)
            loss = _loss_from_logits(logits, batch)
            wrt = [*dense.values(), *leaves]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for x, g in zip(wrt, grads)]
        return (loss.detach(), logits, dict(zip(dense, grads[:len(dense)])),
                grads[len(dense):])

    @torch.no_grad()
    def _apply_all(self, tables, bundle_res, g_embs, step: int, lr: float):
        """Every lookup group's sparse apply, IN PLACE."""
        with phase_scope("sparse_apply"):
            g_embs = iter(g_embs)
            for bname, b in self.bundles.items():
                # A shared table's features apply one after another, so each
                # gathers its rows again (an earlier apply may have moved
                # them); every other bundle reuses the lookup's rows.
                reuse = b.stacked or len(b.features) == 1
                for _, res in self._results(b, bundle_res[bname]):
                    self._apply_one(b, tables[bname], res, next(g_embs), step, lr, reuse)

    def _apply_one(self, b: Bundle, ts: TableState, res, grad, step: int, lr: float,
                   reuse: bool) -> None:
        """One lookup group's sparse apply, IN PLACE."""
        apply_gradients(b.table, ts, self.sparse_opt, res, grad, step=step, lr=lr,
                        grad_averaging=self.grad_averaging, reuse_rows=reuse,
                        stamp_meta=False)

    @torch.no_grad()
    def _dense_apply(self, params, opt_state, g_dense):
        """The dense optimizer's update, IN PLACE on `params`; returns the
        new optimizer state."""
        with phase_scope("dense_apply"):
            updates, opt_state = self.dense_opt.update(g_dense, opt_state, params)
            dense_optim.apply_updates(params, updates)
        return opt_state

    @staticmethod
    @torch.no_grad()
    def _metrics(loss, logits, batch) -> Dict[str, torch.Tensor]:
        return {"loss": loss, "accuracy": (
            loss.new_zeros(()) if isinstance(logits, dict)
            else M.accuracy(torch.sigmoid(logits.detach()), batch["label"]))}

    def _train_lr(self, what: str, lr) -> float:
        if self.sparse_opt is None:
            raise ValueError(f"{what} needs a Trainer with a sparse optimizer")
        return self.sparse_opt.lr if lr is None else float(lr)

    # ------------------------------------------------------- step sentinel

    @torch.no_grad()
    def _sentinel_observe(self, tables, bundle_res, loss, g_dense, g_embs,
                          step: int) -> Dict[str, torch.Tensor]:
        """Device half of the step sentinel, after the sparse applies: the
        loss, the gradients' finiteness and squared norm, and (when a row
        bound or clamp is configured) the largest L2 norm of the rows this
        step updated, read through #3 (#1 on bf16 tables) at each lookup
        group's slot indices. Reads only, unless `row_clamp_norm` is set:
        then the rows past it are rescaled IN PLACE through #5 (#2)."""
        from deeprec_tpu_torch.guard import rows as guard_rows
        from deeprec_tpu_torch.guard import sentinel as guard_sentinel

        with phase_scope("sentinel"):
            cfg = self.sentinel
            finite, norm_sq = guard_sentinel.grad_observations(g_dense, g_embs)
            obs = {"loss": loss.to(torch.float32), "grads_finite": finite,
                   "grad_norm_sq": norm_sq}
            if cfg.row_norm_max is None and cfg.row_clamp_norm is None:
                return obs
            row_max = torch.zeros((), dtype=torch.float32, device=self.device)
            for bname, b in self.bundles.items():
                for _, res in self._results(b, bundle_res[bname]):
                    values = tables[bname].values
                    n = guard_rows.touched_row_norms(values, res.slot_ix)
                    if cfg.row_clamp_norm is not None:
                        guard_rows.clamp_rows(values, res.slot_ix, n, cfg.row_clamp_norm,
                                              step)
                    row_max = torch.maximum(row_max, n.max())
            obs["row_max"] = row_max
        return obs

    def _sentinel_fold(self, mets, obs, guard):
        """Fold a step's observations with the guard carry into the flags
        scalar and the advanced EMA, both riding out through `mets`
        ("guard_flags", "guard_ema"). Returns the next carry."""
        from deeprec_tpu_torch.guard import sentinel as guard_sentinel

        if guard is None:
            guard = guard_sentinel.guard_init(self.device)
        flags, guard = guard_sentinel.step_flags(
            self.sentinel, obs["loss"], obs["grads_finite"], obs["grad_norm_sq"],
            obs.get("row_max"), guard)
        mets["guard_flags"] = flags
        mets["guard_ema"] = guard["ema"]
        return guard

    def _step(self, state: TrainState, batch, lr: float, guard=None):
        """One train step on a device batch (see `train_step`). Returns (the
        next TrainState, metrics, the next guard carry)."""
        step = int(state.step)
        with phase_scope("lookup"), torch.no_grad():
            views, bundle_res = self._lookup_all(state.tables, batch, step, True)
        loss, logits, g_dense, g_embs = self._fwd_bwd(state.dense, views,
                                                      bundle_res, batch)
        self._apply_all(state.tables, bundle_res, g_embs, step, lr)
        mets = self._metrics(loss, logits, batch)
        if self.sentinel is not None:
            guard = self._sentinel_fold(mets, self._sentinel_observe(
                state.tables, bundle_res, loss, g_dense, g_embs, step), guard)
        opt_state = self._dense_apply(state.dense, state.opt_state, g_dense)
        return (TrainState(step=step + 1, tables=state.tables, dense=state.dense,
                           opt_state=opt_state), mets, guard)

    def train_step(self, state: TrainState, batch, lr: Optional[float] = None,
                   guard=None):
        """One step: train lookups (insert, initializer rows, metadata),
        forward and backward, the sparse applies and the dense optimizer,
        all IN PLACE on `state`'s tensors. Returns (the next TrainState,
        {"loss", "accuracy"} as 0-d device tensors). With a sentinel the
        metrics also carry "guard_flags" (int32) and "guard_ema"; `guard` is
        the carry of the previous dispatch (`guard.sentinel.guard_carry`),
        None for a fresh one. Nothing is read on the host."""
        lr = self._train_lr("train_step", lr)
        state, mets, _ = self._step(state, self.device_batch(batch), lr, guard)
        return state, mets

    def _window(self, batches) -> List[Dict[str, torch.Tensor]]:
        """A window's K device batches from a list of K batches or one
        stacked [K, ...] dict."""
        if isinstance(batches, dict):
            batches = self.device_batch(batches)
            K = next(iter(batches.values())).shape[0]
            return [{k: v[i] for k, v in batches.items()} for i in range(K)]
        return [self.device_batch(b) for b in batches]

    def train_steps(self, state: TrainState, batches, lr: Optional[float] = None,
                    guard=None):
        """K train steps in one call: `batches` is a list of K same-shape
        batches or one stacked [K, ...] dict (`stack_batches`). Exactly K
        `train_step` calls in every `pipeline_mode`, IN PLACE, the sentinel's
        carry threaded from step to step. Returns (the state after K steps,
        metrics as [K] device tensors, one entry per inner step: with a
        sentinel, "guard_flags" and "guard_ema" too). Evict, maintain, save
        and evaluate between windows."""
        lr = self._train_lr("train_steps", lr)
        batches = self._window(batches)
        if self.pipeline_mode == "off":
            mets = []
            for b in batches:
                state, m, guard = self._step(state, b, lr, guard)
                mets.append(m)
        else:
            state, mets = self._steps_pipelined(state, batches, lr, guard)
        return state, {k: torch.stack([m[k] for m in mets]) for k in mets[0]}

    def _steps_pipelined(self, state: TrainState, batches, lr: float, guard=None):
        """The window with a one-batch lookahead: the first batch's full
        lookup, then for each batch t: route and resolve batch t+1 (under
        step t+1), the dense forward and backward and the sparse apply of
        batch t, the value gather of batch t+1 (after that apply, so it
        reads the rows batch t wrote), the dense update. resolve(t+1)
        touches keys, metadata, the sketch and value rows of slots that
        were empty, never a row apply(t) writes: the order is exact. The
        sentinel observes batch t after its apply and before the gather of
        batch t+1 (a clamp lands before that gather reads the rows)."""
        step = int(state.step)
        tables, params, opt_state = state.tables, state.dense, state.opt_state
        with phase_scope("lookup"), torch.no_grad():
            views, res = self._lookup_all(tables, batches[0], step, True)
        mets = []
        for t, batch in enumerate(batches):
            nxt = batches[t + 1] if t + 1 < len(batches) else None
            if nxt is not None:
                with phase_scope("route_next"), torch.no_grad():
                    pending = self._resolve_all(tables, self._route_all(nxt),
                                                step + 1)
            loss, logits, g_dense, g_embs = self._fwd_bwd(params, views, res, batch)
            self._apply_all(tables, res, g_embs, step, lr)
            m = self._metrics(loss, logits, batch)
            if self.sentinel is not None:
                guard = self._sentinel_fold(m, self._sentinel_observe(
                    tables, res, loss, g_dense, g_embs, step), guard)
            if nxt is not None:
                with phase_scope("finish_next"), torch.no_grad():
                    views, res = self._finish_all(tables, pending)
            opt_state = self._dense_apply(params, opt_state, g_dense)
            mets.append(m)
            step += 1
        return TrainState(step=step, tables=tables, dense=params,
                          opt_state=opt_state), mets

    def train_step_accum(self, state: TrainState, batch, accum_steps: int,
                         lr: Optional[float] = None, guard=None):
        """One step over a batch of A x B rows in A micro-batches of B: each
        micro-batch looks up and applies its sparse gradients (all under
        the same step, with the dense parameters as they were), the dense
        gradients are summed, divided by A and applied once. Returns (the
        next TrainState, the mean loss and accuracy over the
        micro-batches). The dispatch is the sentinel's unit: the
        micro-batches' observations reduce to one record (the mean loss,
        every gradient finite, the largest squared norm and row norm) and
        one "guard_flags" / "guard_ema"."""
        lr = self._train_lr("train_step_accum", lr)
        batch = self.device_batch(batch)
        A = int(accum_steps)
        n = next(iter(batch.values())).shape[0]
        if A < 1 or n % A:
            raise ValueError(f"batch of {n} rows does not split into {A} micro-batches")
        step = int(state.step)
        g_acc = {name: torch.zeros_like(p) for name, p in state.dense.items()}
        mets, obs = [], []
        for a in range(A):
            mb = {k: v.reshape(A, n // A, *v.shape[1:])[a] for k, v in batch.items()}
            with phase_scope("lookup"), torch.no_grad():
                views, res = self._lookup_all(state.tables, mb, step, True)
            loss, logits, g_dense, g_embs = self._fwd_bwd(state.dense, views, res, mb)
            self._apply_all(state.tables, res, g_embs, step, lr)
            for name, g in g_dense.items():
                g_acc[name] += g
            mets.append(self._metrics(loss, logits, mb))
            if self.sentinel is not None:
                obs.append(self._sentinel_observe(state.tables, res, loss, g_dense, g_embs,
                                                  step))
        g_mean = {name: g / float(A) for name, g in g_acc.items()}
        out = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        if obs:
            red = {"loss": torch.stack([o["loss"] for o in obs]).mean(),
                   "grads_finite": torch.stack([o["grads_finite"] for o in obs]).all(),
                   "grad_norm_sq": torch.stack([o["grad_norm_sq"] for o in obs]).max()}
            if "row_max" in obs[0]:
                red["row_max"] = torch.stack([o["row_max"] for o in obs]).max()
            self._sentinel_fold(out, red, guard)
        opt_state = self._dense_apply(state.dense, state.opt_state, g_mean)
        return (TrainState(step=step + 1, tables=state.tables, dense=state.dense,
                           opt_state=opt_state), out)

    # ----------------------------------------------------------- staged input

    def stage_batch(self, batch):
        """Trim a host batch to the model's inputs and labels and start its
        copy to the device. On CUDA each array goes through pinned host
        memory onto the card with `non_blocking=True` on the trainer's copy
        stream; the result is a `StagedBatch` whose `ready` event the
        consuming stream waits on when the batch reaches a train or eval
        call. Tensors already on the device pass as they are."""
        keep = self.input_keys()
        batch = {k: v for k, v in batch.items() if k in keep or k.startswith("label")}
        if self.device.type != "cuda":
            return self.device_batch(batch)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = StagedBatch()
        with torch.cuda.stream(self._copy_stream):
            for k, v in batch.items():
                if torch.is_tensor(v) and v.device == self.device:
                    out[k] = v
                    continue
                host = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))
                out[k] = host.pin_memory().to(self.device, non_blocking=True)
            out.ready = torch.cuda.Event()
            out.ready.record(self._copy_stream)
        return out

    def stage(self, source, depth: int = 2, on_consume=None):
        """The staged input pipeline: a `Prefetcher` over `source` that
        runs `stage_batch` on each batch in its own thread, `depth` batches
        ahead of the train loop. Returns `source` unchanged under
        stage="off".

        `on_consume` is called once per batch DELIVERED to the loop; when
        it is omitted and `source` carries `mark_consumed` (and
        `attach_consumer`), those are wired in, so a stream position
        checkpoints what the loop received, not what the ring read ahead.
        With tier paging on, the pager observes each raw batch (`peek`)."""
        if self.stage_mode != "auto":
            return source
        from deeprec_tpu_torch.data.prefetch import Prefetcher

        if on_consume is None:
            mark = getattr(source, "mark_consumed", None)
            if callable(mark):
                attach = getattr(source, "attach_consumer", None)
                if callable(attach):
                    attach()
                on_consume = mark
        pager = self._tier_pager
        return Prefetcher(iter(source), depth=depth, transform=self.stage_batch,
                          on_consume=on_consume,
                          peek=pager.observe if pager is not None else None)

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        """Read-only forward of a labelled batch: (loss, probabilities; a
        {task: probabilities} dict for a multi-task model)."""
        batch = self.device_batch(batch)
        views, _ = self._lookup_all(state.tables, batch)
        logits, probs = self.probs_from_views(state, views, batch)
        return _loss_from_logits(logits, batch), probs

    def evaluate(self, state: TrainState, batches) -> Dict[str, float]:
        """Streamed loss and histogram AUC over an iterable of batches:
        `auc`, or one `auc_<task>` per task of a multi-task model."""
        aucs: Dict[str, M.AucState] = {}
        total, n = 0.0, 0
        for batch in batches:
            batch = self.device_batch(batch)
            loss, probs = self.eval_step(state, batch)
            for task, p in (probs.items() if isinstance(probs, dict)
                            else [("", probs)]):
                label = batch[f"label_{task}" if task else "label"]
                if task not in aucs:
                    aucs[task] = M.AucState.create(self.device)
                aucs[task] = M.auc_update(aucs[task], p, label)
            total += float(loss)
            n += 1
        out = {"loss": total / max(n, 1)}
        for task, auc in aucs.items():
            out[f"auc_{task}" if task else "auc"] = float(M.auc_compute(auc))
        return out

    # ------------------------------------------------------------- serving

    @torch.no_grad()
    def forward_views(self, state: TrainState, batch):
        """Read-only lookup pass (no inserts or counters): per-feature
        views plus per-bundle results."""
        return self._lookup_all(state.tables, batch)

    @torch.no_grad()
    def probs_from_views(self, state: TrainState, views, batch):
        """Label-free forward: views -> (logits, sigmoid probabilities),
        both {task: [B]} dicts for a multi-task model. The pooled features
        pool through kernel #4, one launch per group of features whose rows
        share dtype and width."""
        embs = {n: v[0] for n, v in views.items()}
        inputs = self._build_inputs(embs, views, batch, read_only=True)
        logits = functional_call(self.model, state.dense, (inputs,))
        if isinstance(logits, dict):
            return logits, {t: torch.sigmoid(v) for t, v in logits.items()}
        return logits, torch.sigmoid(logits)


def _loss_from_logits(logits, batch) -> torch.Tensor:
    """BCE against `label`, or for {task: logits} the sum over tasks of the
    BCE against `label_<task>`."""
    if isinstance(logits, dict):
        return sum(M.bce_loss(v, batch[f"label_{t}"]) for t, v in logits.items())
    return M.bce_loss(logits, batch["label"])
