"""Skew-aware placement of keys over the shards — the port of
`deeprec_tpu/parallel/placement.py`.

Uniform `hash_shard(id) % N` routing makes one shard the straggler of every
exchange under zipf traffic: the head of the distribution lands on its hash
home, and tables that share a raw id space park their heads on the same
shards. The pieces, as in the JAX package:

  * `plan_owner` — the device route: an owner-offset rotation per member
    table (`(hash_shard(id) + offset) % N`) and a sentinel-padded [H]
    hot-key table consulted before the hash.
  * `ShardPlan` / `BundlePlan` — one member's plan (its host mirror
    `owner_np`, its per-destination hot counts, its device leaves) and a
    bundle's member plans.
  * `build_plans` — the greedy cost-model placer (best rotation per table,
    heaviest first; hot keys LPT onto the least-loaded shard), with the
    learned ranker of ties (`parallel/costmodel.py`) and `base_loads` for
    pinned tables; `modeled_loads` and `plan_moved_rows` price a plan.
  * `ReplanConfig` / `DriftDetector` — the drift trigger's hysteresis,
    cooldown and slope projection.
  * `reshard_members` — the migration. In the JAX package one controller
    holds every shard; here each rank holds its own, so the move is
    collective: every rank routes its live rows to their new owners with
    one uneven all-to-all per row array, probes the arrivals into an empty
    key array, and agrees with every other rank before any of them swaps.
    Rows move verbatim (values, metadata, every per-row optimizer slot), so
    the per-key state is bit for bit the same before and after.

Correctness contract: any single-owner routing trains bit for bit the same
per key. Each source contributes at most one arrival per key (local dedup
precedes the exchange) and the owner sums arrivals in source order under
every plan, so the optimizer's arithmetic cannot observe the placement.
The host functions are numpy and equal the JAX package's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprec_tpu_torch.utils import hashing


# ------------------------------------------------------------- device route


def plan_owner(ids: torch.Tensor, num_shards: int,
               leaves: Optional[dict] = None) -> torch.Tensor:
    """Owner shard (int32) of each id of `ids` [..., n].

    `leaves` is a plan's constant dict (None / {} = the uniform hash):
      offset     [...]      int32  owner rotation (one per member)
      hot_keys   [..., H]   key dtype, sentinel-padded routing table
      hot_owners [..., H]   int32 explicit owners of the hot keys
    Hot keys take their table entry, every other id its rotated hash home,
    as the JAX `plan_owner` (leading dims are the stacked bundle's members,
    which the JAX package vmaps over). Equals `ShardPlan.owner_np`."""
    base = hashing.hash_shard(ids, num_shards)
    if not leaves:
        return base
    off = torch.as_tensor(leaves["offset"], dtype=torch.int32, device=ids.device)
    off = off.reshape(*off.shape, *([1] * (base.dim() - off.dim())))
    owner = (base + off) % num_shards
    hk = torch.as_tensor(leaves["hot_keys"], device=ids.device).to(ids.dtype)
    if hk.shape[-1]:
        eq = ids[..., :, None] == hk[..., None, :]
        hot = eq.any(-1)
        hix = eq.to(torch.int8).argmax(-1)
        ho = torch.as_tensor(leaves["hot_owners"], dtype=torch.int32,
                             device=ids.device)
        hot_owner = torch.gather(ho.expand(*hix.shape[:-1], ho.shape[-1]), -1, hix)
        owner = torch.where(hot, hot_owner, owner)
    return owner.to(torch.int32)


def home_np(keys, num_shards: int) -> np.ndarray:
    """The uniform hash home of host keys, as the device computes it
    (`hash_shard`; on int32 keys equal to `hash_shard_np`)."""
    keys = np.asarray(keys)
    if keys.dtype in (np.int32, np.int64):
        return hashing.hash_shard(torch.from_numpy(np.ascontiguousarray(keys)),
                                  num_shards).numpy()
    return hashing.hash_shard_np(keys, num_shards)


# --------------------------------------------------------------- plan types


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Routing plan of ONE (member) table over `num_shards` shards.

    `hot_keys` are unique real keys (never the sentinel); `sentinel` pads
    the device routing table out to the bundle's common H. The default
    plan (offset 0, no hot keys) routes exactly like the uniform hash."""

    num_shards: int
    sentinel: int
    offset: int = 0
    hot_keys: Tuple[int, ...] = ()
    hot_owners: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.hot_keys) != len(self.hot_owners):
            raise ValueError("hot_keys and hot_owners differ in length")
        if len(set(self.hot_keys)) != len(self.hot_keys):
            raise ValueError("hot_keys must be unique (duplicates would make the device "
                             "argmax and the host searchsorted disagree)")

    @property
    def is_uniform(self) -> bool:
        return self.offset == 0 and not self.hot_keys

    def owner_np(self, keys) -> np.ndarray:
        """Host mirror of `plan_owner` (equal per id): the checkpoint
        restore's router and the planner's pricing."""
        keys = np.asarray(keys)
        owner = ((home_np(keys, self.num_shards) + self.offset)
                 % self.num_shards).astype(np.int32)
        if self.hot_keys:
            hk = np.asarray(self.hot_keys, dtype=keys.dtype)
            ho = np.asarray(self.hot_owners, np.int32)
            order = np.argsort(hk, kind="stable")
            pos = np.clip(np.searchsorted(hk[order], keys), 0, len(order) - 1)
            cand = order[pos]
            hit = hk[cand] == keys
            owner = np.where(hit, ho[cand], owner).astype(np.int32)
        return owner

    def dest_hot_counts(self) -> np.ndarray:
        """[N] explicit hot-key arrivals this plan routes to each
        destination: the per-destination half of the a2a budget vector
        (`ops/traffic.py a2a_dest_budgets`)."""
        return np.bincount(np.asarray(self.hot_owners, np.int64),
                           minlength=self.num_shards).astype(np.int64)

    def leaves_np(self, key_dtype, pad_h: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The `plan_owner` constants as numpy, the hot arrays
        sentinel-padded to `pad_h` (a stacked bundle's members share one
        H)."""
        H = len(self.hot_keys) if pad_h is None else pad_h
        hk = np.full((H,), self.sentinel, dtype=key_dtype)
        ho = np.zeros((H,), np.int32)
        if self.hot_keys:
            hk[:len(self.hot_keys)] = np.asarray(self.hot_keys, dtype=key_dtype)
            ho[:len(self.hot_owners)] = np.asarray(self.hot_owners, np.int32)
        return {"offset": np.asarray(self.offset, np.int32), "hot_keys": hk,
                "hot_owners": ho}

    def leaves(self, key_dtype, device, pad_h: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """`leaves_np` as tensors on `device`."""
        return {k: torch.from_numpy(v).to(device)
                for k, v in self.leaves_np(key_dtype, pad_h).items()}


@dataclasses.dataclass(frozen=True)
class BundlePlan:
    """Per-member ShardPlans of one bundle (T for a stacked bundle, one
    otherwise: a shared table routes every feature through its single
    member plan)."""

    plans: Tuple[ShardPlan, ...]

    def member(self, m: Optional[int]) -> ShardPlan:
        return self.plans[m or 0]

    @property
    def is_uniform(self) -> bool:
        return all(p.is_uniform for p in self.plans)

    def leaves(self, key_dtype, stacked: bool, device) -> Dict[str, torch.Tensor]:
        """Device constants for `plan_owner`: a stacked bundle's carry a
        leading [T] member axis, a single table's are the bare member
        leaves. Built once per adopted plan."""
        H = max((len(p.hot_keys) for p in self.plans), default=0)
        per = [p.leaves_np(key_dtype, pad_h=H) for p in self.plans]
        if not stacked:
            per = per[:1]
        out = {k: np.stack([leaf[k] for leaf in per]) if stacked else per[0][k]
               for k in per[0]}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in out.items()}

    def dest_hot_counts(self) -> np.ndarray:
        """Elementwise max of the members' per-destination hot counts: the
        members share one bucket, so each destination budgets for its worst
        member."""
        out = np.zeros((self.plans[0].num_shards,), np.int64)
        for p in self.plans:
            out = np.maximum(out, p.dest_hot_counts())
        return out

    def hot_count_min(self) -> int:
        """The fewest hot keys of any member: only keys every member routes
        explicitly leave the shared bucket's tail share."""
        return min((len(p.hot_keys) for p in self.plans), default=0)


# --------------------------------------------------- drift-driven replanning


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    """Knobs of the drift-driven replan trigger (`ShardedTrainer.
    maybe_replan`, run from maintain()):

      threshold      windowed max-table imbalance (max / mean exchange
                     bytes) that counts as drift
      sustain        consecutive maintain() observations at or over the
                     threshold before the placer runs
      cooldown       maintain() calls after an adoption during which the
                     trigger stays quiet
      horizon_steps  steps over which the modeled straggler-bytes gain must
                     amortize the modeled migration bytes
      min_gain       modeled-imbalance improvement factor a candidate needs
      window_secs    obs window read for the imbalance gauge's slope
      lead_secs      slope projection: a positive slope projected
                     `lead_secs` ahead may breach the threshold early
                     (0 = level only)
    """

    threshold: float = 1.5
    sustain: int = 2
    cooldown: int = 2
    horizon_steps: int = 2000
    min_gain: float = 1.05
    window_secs: float = 120.0
    lead_secs: float = 0.0


class DriftDetector:
    """Host hysteresis gate over (level, slope) observations, one
    observe() per maintain()."""

    def __init__(self, cfg: ReplanConfig):
        self.cfg = cfg
        self._breaches = 0
        self._cooldown = 0
        self.last: Dict[str, object] = {}

    def observe(self, level: float, slope: Optional[float] = None) -> bool:
        """Feed one windowed observation; True = run the placer now.
        `level` is the windowed max-table imbalance, `slope` its d/dt
        (None with fewer than 2 ring slots of history)."""
        cfg = self.cfg
        projected = level
        if slope is not None and slope > 0 and cfg.lead_secs > 0:
            projected = level + slope * cfg.lead_secs
        breach = level >= cfg.threshold or projected >= cfg.threshold
        self._breaches = self._breaches + 1 if breach else 0
        cooling = self._cooldown > 0
        if cooling:
            self._cooldown -= 1
        fire = (not cooling) and self._breaches >= cfg.sustain
        self.last = {
            "level": round(float(level), 4),
            "slope_per_sec": None if slope is None else round(float(slope), 6),
            "projected": round(float(projected), 4),
            "breaches": self._breaches,
            "cooldown": self._cooldown + (1 if cooling else 0),
            "fired": fire,
        }
        return fire

    def adopted(self) -> None:
        """A plan was adopted: start the cooldown, reset the breach run."""
        self._cooldown = self.cfg.cooldown
        self._breaches = 0

    def deferred(self) -> None:
        """The placer ran but declined: reset the breach run without a
        cooldown, so the trigger re-arms after another `sustain` run."""
        self._breaches = 0


def plan_moved_rows(
    members: Sequence["MemberTraffic"],
    current: Optional[Dict[Tuple[str, int], ShardPlan]],
    candidate: Dict[Tuple[str, int], ShardPlan],
) -> Dict[Tuple[str, int], int]:
    """Rows whose owner changes between two plan sets, per member, from the
    live key sets and without migrating: what `reshard_members` moves."""
    out: Dict[Tuple[str, int], int] = {}
    for m in members:
        ref = (m.bundle, m.member)
        if ref not in candidate or len(m.keys) == 0:
            out[ref] = 0
            continue
        cur = (current or {}).get(ref)
        cur_owner = (cur.owner_np(m.keys) if cur is not None
                     else home_np(m.keys, candidate[ref].num_shards))
        out[ref] = int(np.sum(candidate[ref].owner_np(m.keys) != cur_owner))
    return out


# -------------------------------------------------------------- cost model


def modeled_loads(
    num_shards: int,
    members: Sequence["MemberTraffic"],
    plans: Optional[Dict[Tuple[str, int], ShardPlan]] = None,
) -> np.ndarray:
    """Modeled per-shard exchange load (bytes per step) of member tables
    under `plans` (missing entries = the uniform hash)."""
    L = np.zeros((num_shards,), np.float64)
    for m in members:
        if len(m.keys) == 0:
            continue
        plan = (plans or {}).get((m.bundle, m.member))
        owner = (plan.owner_np(m.keys) if plan is not None
                 else home_np(m.keys, num_shards))
        L += np.bincount(owner, weights=m.weight.astype(np.float64) * m.row_bytes,
                         minlength=num_shards)
    return L


@dataclasses.dataclass
class MemberTraffic:
    """Placer input of one member table: its live keys, each key's modeled
    exchange arrivals per step (min(freq / steps, N)), and the wire bytes
    of one arrival row (`ops/traffic.py exchange_row_bytes`)."""

    bundle: str
    member: int
    keys: np.ndarray  # [n] live keys
    weight: np.ndarray  # [n] modeled arrivals per step
    row_bytes: float
    sentinel: int


def build_plans(
    num_shards: int,
    members: Sequence[MemberTraffic],
    *,
    hot_budget: int = 64,
    base_loads=None,
    cost_model=None,
    ambiguity: float = 1e-6,
) -> Tuple[Dict[Tuple[str, int], ShardPlan], Dict[str, object]]:
    """Greedy cost-model placer: minimize the max-shard exchange load.

    Heaviest table first, against a running per-shard load vector L:
      1. offset rotation: the table's non-hot load lands at its hash home
         rotated by r; the r minimizing max(L + roll(load, r)) wins;
      2. hot keys: the top `hot_budget` keys by modeled arrivals with
         weight > 1 leave the rotation and go LPT (heaviest first, each to
         the least-loaded shard).

    `base_loads` [N] is load the placer packs around but cannot move
    (tables pinned to the uniform hash). A TRAINED `cost_model` re-ranks
    rotations whose analytic cost ties the best within `ambiguity`; an
    untrained or absent one leaves every choice the analytic one.

    Returns (plans keyed by (bundle, member), report with the modeled
    loads and max/mean imbalance before (uniform hash) and after)."""
    from deeprec_tpu_torch.ops import traffic as T

    N = num_shards
    base = (np.zeros((N,), np.float64) if base_loads is None
            else np.asarray(base_loads, np.float64))
    L = base.copy()
    L_before = base.copy()
    plans: Dict[Tuple[str, int], ShardPlan] = {}
    hot_all: List[Tuple[float, int, Tuple[str, int]]] = []
    hot_per: Dict[Tuple[str, int], List[Tuple[int, int]]] = {}
    offsets: Dict[Tuple[str, int], int] = {}

    order = sorted(members, key=lambda m: -float(np.sum(m.weight) * m.row_bytes))
    for m in order:
        ref = (m.bundle, m.member)
        hot_per[ref] = []
        n = len(m.keys)
        if n == 0:
            offsets[ref] = 0
            continue
        home = home_np(m.keys, N)
        load = m.weight.astype(np.float64) * m.row_bytes
        L_before += np.bincount(home, weights=load, minlength=N)
        # only keys that arrive from more than one shard are worth a slot
        by_w = np.argsort(-m.weight, kind="stable")[:max(0, hot_budget)]
        hot_ix = by_w[m.weight[by_w] > 1.0]
        hot_mask = np.zeros((n,), bool)
        hot_mask[hot_ix] = True
        tail = np.bincount(home[~hot_mask], weights=load[~hot_mask], minlength=N)
        costs = [float(np.max(L + np.roll(tail, r))) for r in range(N)]
        best_r, best_cost = 0, float("inf")
        for r, cost in enumerate(costs):
            if cost < best_cost - 1e-9:
                best_r, best_cost = r, cost
        if cost_model is not None and cost_model.trained:
            # the learned re-rank of analytic ties; ties in the prediction
            # fall back to the analytic winner, then the smallest rotation
            tol = abs(best_cost) * ambiguity + 1e-9
            tied = [r for r in range(N) if costs[r] <= best_cost + tol]
            if len(tied) > 1:
                stats = cost_model.member_stats(m)
                best_r = min(tied, key=lambda r: (
                    float(np.max(L + cost_model.predict_loads(stats, np.roll(tail, r)))),
                    0 if r == best_r else 1, r))
        offsets[ref] = best_r
        L += np.roll(tail, best_r)
        for i in hot_ix:
            hot_all.append((float(load[i]), int(m.keys[i]), ref))

    # LPT over every table's hot keys against the shared load vector
    hot_all.sort(key=lambda t: (-t[0], t[1]))
    for w, key, ref in hot_all:
        s = int(np.argmin(L))
        L[s] += w
        hot_per[ref].append((key, s))

    for m in members:
        ref = (m.bundle, m.member)
        pairs = hot_per.get(ref, [])
        plans[ref] = ShardPlan(num_shards=N, sentinel=m.sentinel,
                               offset=offsets.get(ref, 0),
                               hot_keys=tuple(k for k, _ in pairs),
                               hot_owners=tuple(s for _, s in pairs))
    report = {
        "imbalance_before": round(T.shard_imbalance(L_before), 4),
        "imbalance_after": round(T.shard_imbalance(L), 4),
        "modeled_loads_before": [round(float(x), 1) for x in L_before],
        "modeled_loads_after": [round(float(x), 1) for x in L],
        "hot_keys": sum(len(v) for v in hot_per.values()),
    }
    return plans, report


# ---------------------------------------------------------------- re-shard


def _flat_ix(t_ix: torch.Tensor, c_ix: torch.Tensor, C: int) -> torch.Tensor:
    """[1, n] int32 row indices into a [1, T * C, ...] view."""
    return (t_ix.to(torch.int64) * C + c_ix.to(torch.int64)).to(torch.int32)[None]


@torch.no_grad()
def reshard_members(table, state, bundle_plan: BundlePlan, mesh,
                    slot_fills=None) -> Tuple[bool, int, str]:
    """Move the rows of this rank's shard `state` ([T, C, ...], T members)
    so every live key resides on the rank `bundle_plan.member(t)` routes it
    to. Collective: every rank of `mesh` calls it with the same plan.

    Each rank computes the new owner of its live keys (`plan_owner`),
    gathers their rows (kernel #3, #1 on bf16 values: the value rows and
    every per-row slot) and sends key, member, metadata and rows to the
    owners (`mesh.all_to_all_uneven`, the staying rows to itself). The
    arrivals are probed into an empty key array; a shard past its local
    capacity, or a probe that cannot place a key, fails on its rank, and
    one flag gathered over the mesh aborts the move on EVERY rank before
    any swaps: each keeps its state as it was. Otherwise each rank writes
    its new shard IN PLACE: the keys, the value and slot rows through the
    row-scatter kernel (#5, #2 on bf16 values; slots not written take their
    `slot_fills` value, values 0), the metadata verbatim, the CBF sketch
    rebuilt from the migrated freqs; the owner counters restart, the other
    counters carry over. Returns (ok, rows moved over the mesh, reason)."""
    from deeprec_tpu_torch.embedding.table import _META_FILL, empty_key
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX
    from deeprec_tpu_torch.parallel import mesh as M

    if state.qscale is not None:
        raise ValueError("reshard_members: an int8 table does not train")
    axis = M.mesh_batch_axes(mesh)
    N, me = mesh.size, mesh.index
    cfg = table.cfg
    sent = empty_key(cfg)
    T, C = state.keys.shape
    dev = state.keys.device
    kd = np.dtype({torch.int32: np.int32, torch.int64: np.int64}[state.keys.dtype])
    occ = state.keys != sent
    t_ix, c_ix = torch.nonzero(occ, as_tuple=True)
    keys = state.keys[t_ix, c_ix]
    owner = torch.empty_like(t_ix, dtype=torch.int32)
    for t in range(T):
        at = t_ix == t
        owner[at] = plan_owner(keys[at][None], N, bundle_plan.member(t).leaves(
            kd, dev))[0]
    moved_local = (owner != me).sum().to(torch.int64)
    order = torch.argsort(owner, stable=True)
    t_ix, c_ix, keys, owner = t_ix[order], c_ix[order], keys[order], owner[order]
    counts = torch.bincount(owner.long(), minlength=N).tolist()
    ix = _flat_ix(t_ix, c_ix, C)

    def send(x):
        return M.all_to_all_uneven(mesh, x, counts, axis)[0]

    head = torch.cat([t_ix[:, None].to(torch.int64), keys[:, None].to(torch.int64),
                      state.meta[t_ix, :, c_ix].to(torch.int64)], 1)
    r_head = send(head)
    r_values = send(gather_rows(state.values.view(1, T * C, -1), ix)[0])
    slot_names = [n for n in state.slots if not n.startswith(SCALAR_PREFIX)]
    r_slots = {n: send(gather_rows(state.slots[n].view(1, T * C, -1), ix)[0])
               for n in slot_names}
    # the arrivals of each member, in source order, padded to [T, m]
    r_t, r_keys = r_head[:, 0], r_head[:, 1].to(state.keys.dtype)
    by_t = torch.argsort(r_t, stable=True)
    n_t = torch.bincount(r_t, minlength=T)
    start = torch.cumsum(n_t, 0) - n_t
    pos = torch.empty_like(r_t)
    pos[by_t] = torch.arange(r_t.shape[0], device=dev) - start[r_t[by_t]]
    m = max(int(n_t.max()) if T else 0, 1)
    uids = torch.full((T, m), sent, dtype=state.keys.dtype, device=dev)
    uids[r_t, pos] = r_keys
    code = torch.zeros(3, dtype=torch.int64, device=dev)
    load = int(n_t.max()) if T else 0
    new_keys = torch.full_like(state.keys, sent)
    slot_ix = None
    if load > C:
        code[0], code[1] = 1, load
    else:
        slot_ix, _, failed = table._probe(new_keys, uids, uids != sent)
        if bool(failed.any()):
            code[0], code[1] = 2, load
    code[2] = moved_local
    agreed = M.all_gather(mesh, code, axis)  # [N, 3]
    bad = torch.nonzero(agreed[:, 0]).flatten().tolist()
    if bad:
        s = bad[0]
        what, load_s = int(agreed[s, 0]), int(agreed[s, 1])
        return False, 0, (f"shard {s} would hold {load_s} keys > local capacity {C}"
                          if what == 1 else f"shard {s}: probe overflow at load {load_s}/{C}")
    moved = int(agreed[:, 2].sum())
    # every rank placed every arrival: swap IN PLACE
    dst = _flat_ix(r_t, slot_ix[r_t, pos], C)
    fills = dict(slot_fills or ())
    state.keys.copy_(new_keys)
    state.values.zero_()
    apply_rows_sr(state.values.view(1, T * C, -1), dst, r_values.float()[None], seed=0)
    for n in slot_names:
        state.slots[n].fill_(fills.get(n, 0.0))
        apply_rows_sr(state.slots[n].view(1, T * C, -1), dst, r_slots[n].float()[None],
                      seed=0)
    state.meta.copy_(torch.tensor(_META_FILL, dtype=torch.int32, device=dev
                                  )[None, :, None].expand_as(state.meta))
    state.meta[r_t, :, slot_ix[r_t, pos].long()] = r_head[:, 2:].to(torch.int32)
    if state.bloom is not None and cfg.ev.cbf_filter is not None:
        from deeprec_tpu_torch.embedding import filters

        freqs = torch.zeros((T, m), dtype=torch.int32, device=dev)
        freqs[r_t, pos] = r_head[:, 2].to(torch.int32)
        state.bloom.zero_()
        filters.cbf_add(cfg.ev.cbf_filter, state.bloom, uids, freqs)
    for name in ("owner_arrivals", "owner_unique"):
        if getattr(state, name) is not None:
            getattr(state, name).zero_()
    return True, moved, ""
