"""Traffic accounting of the embedding engine: the port of
`deeprec_tpu/ops/traffic.py`, whole. Host arithmetic; every number equals
the JAX package's (the same expressions, so the same floats).

  * **Step bytes**: `table_step_traffic` (one table's device bytes per
    train step, plus the sharded exchange's wire bytes), the fused bag
    step's `fused_sparse_step_traffic`, the reference DLRM's
    `dlrm_reference_traffic`, and the lookahead's resident double buffer
    `pipeline_buffer_bytes` with the overlap model `modeled_overlap_step`.
    `chip_smoke.py` phase 8 takes #6 / #7's byte bounds from the fused
    model, and phase 24 holds them against the card's step.
  * **Op counts**: `count_device_ops` counts the gather- and scatter-class
    operations one eager region dispatches (torch.profiler, at the
    dispatcher), and `expected_lookup_apply_ops` says what the
    single-table lookup + apply should dispatch; a change to the engine's
    op mix must show in both.
  * **Serving**: the residency model `Predictor.residency_info` compares
    its measured bytes with, the retrieval sweep's that
    `RetrievalEngine.sweep_info` does, and the compute-reuse models
    (`serving_reuse_speedup`, its inverse, `zipf_expected_hit_rate`).
  * **The sharded exchanges**: the per-destination a2a budgets and the
    hierarchical budgets that `parallel/sharded.py` compiles its buckets
    from, the wire bytes the sharded trainer reports (`dedup_stats`
    `per_shard`), and the replanner's amortization model
    (`migration_bytes`, `replan_gain_bytes`).

The step models carry a `diet` switch: the forward's gathered rows reused
by the apply and one fused metadata gather / scatter (`diet=True`, the
port's hot path: `apply_gradients(reuse_rows=True, stamp_meta=False)` over
the fused [T, 3, C] metadata) against the apply that gathers the value
rows again and stamps version / dirty a second time (`diet=False`).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

# freq / version / dirty, int32 each: the rows of the fused [T, 3, C]
# metadata tensor (embedding/table.py TableState.meta)
META_COLS = 3


def serving_residency_bytes(
    *, capacity: int, dim: int, value_dtype: str = "float32",
) -> float:
    """Resident device bytes of ONE serving table's value storage at a
    residency dtype — the quantity `Predictor(quantize=...)` halves or
    quarters:

      float32  : C * D * 4
      bfloat16 : C * D * 2
      int8     : C * D * 1  +  C * 4   (per-row fp32 dequant scale)

    Keys and metadata are excluded (the same in every residency)."""
    vb = {"float32": 4, "bfloat16": 2, "int8": 1}
    if value_dtype not in vb:
        raise ValueError(f"unknown residency dtype {value_dtype!r}")
    b = float(capacity) * float(dim) * vb[value_dtype]
    if value_dtype == "int8":
        b += float(capacity) * 4  # per-row fp32 scale (TableState.qscale)
    return float(b)


def retrieval_sweep_bytes(
    *, corpus_rows: int, dim: int, value_dtype: str = "int8",
    block_rows: int = 4096,
) -> float:
    """Device bytes ONE full-corpus retrieval sweep reads
    (serving/retrieval.py with ops/topk.py): the resident item matrix at its
    storage dtype, the per-row dequant scale (int8 only) and the validity
    mask. `corpus_rows` is the pow2-padded resident capacity (a multiple of
    `block_rows`: the sweep reads padding rows too, which score -inf).

      float32  : C * D * 4  +  C        (values + valid mask)
      bfloat16 : C * D * 2  +  C
      int8     : C * D * 1  +  C * 4  +  C   (+ per-row f32 scale)

    The [B, k] carry and the score tile are excluded: the full [C] score
    vector is never stored. `RetrievalEngine.sweep_info()` measures the same
    quantity off the resident tensors' shapes."""
    vb = {"float32": 4, "bfloat16": 2, "int8": 1}
    if value_dtype not in vb:
        raise ValueError(f"unknown residency dtype {value_dtype!r}")
    if block_rows <= 0 or corpus_rows % block_rows:
        raise ValueError(
            f"corpus_rows {corpus_rows} must be a positive multiple of "
            f"block_rows {block_rows}")
    b = float(corpus_rows) * float(dim) * vb[value_dtype]
    if value_dtype == "int8":
        b += float(corpus_rows) * 4  # per-row f32 dequant scale
    b += float(corpus_rows)  # validity mask (1 byte/row)
    return float(b)


# ----------------------------------------------------------- imbalance model
#
# The wire terms below model the MEAN per-device exchange payload; under a
# uniform hash and zipf traffic the max shard does a multiple of that, and
# after the in-step pipelining PR the exchange straggler is exactly what
# bounds step time. These two helpers are the shared vocabulary between the
# placement cost model (parallel/placement.py), the live owner counters
# (Trainer.dedup_stats per_shard) and the bench/CI gate
# (`bench.py --placement`, `roofline.py --assert-imbalance`): everyone
# reports load as exchange bytes and skew as max/mean of that.


def exchange_row_bytes(
    *, dim: int, wire_bytes: int = 4, key_bytes: int = 4
) -> float:
    """Wire bytes ONE exchanged row costs its owner shard per step:
    embedding down + grad up at the wire dtype, plus the id + count int32
    ride-along. This is the per-arrival weight of the placement cost
    model and of the per-shard `exchange_bytes` telemetry."""
    return float(2 * dim * wire_bytes + key_bytes + 4)


def shard_imbalance(loads) -> float:
    """max/mean of a per-shard load vector — 1.0 is perfectly balanced,
    N is everything-on-one-shard. Defined as 1.0 for empty/zero loads
    (nothing exchanged is not skewed)."""
    import numpy as np

    l = np.asarray(loads, dtype=np.float64)
    if l.size == 0:
        return 1.0
    mean = float(l.mean())
    if mean <= 0.0:
        return 1.0
    return float(l.max()) / mean


# ------------------------------------------------- a2a budget model (plan v2)
#
# The a2a exchange buckets ids by destination with a static per-bucket
# budget. Placement v1 modeled the budget as hash-uniform spread
# (slack·U/N) plus one GLOBAL hot-key headroom — the plan's worst
# per-destination hot concentration added to EVERY bucket. Placement v2
# replaces that with a per-destination budget VECTOR derived from the
# plan's own routing: destination d pays the tail share (the uniques the
# plan's hot table does NOT route explicitly — slack·(U−H)/N) plus
# exactly the hot-key arrivals the plan routes to d. The compiled bucket
# is the vector's max (all_to_all moves equal chunks — SPMD programs
# cannot ship ragged per-destination buckets), which is still strictly
# tighter than the global-headroom bucket whenever the plan routes enough
# hot keys to shrink the tail share past the 8-row rounding.
# `ShardedTable._a2a_budget` calls `a2a_dest_budgets` directly, so the
# model and the program share one formula by construction; bench.py's
# drift arm additionally records the bucket the trace actually used next
# to the modeled vector (measured == modeled, the residency discipline).


def a2a_dest_budgets(
    *,
    unique: int,
    num_shards: int,
    slack: float = 2.0,
    dest_hot=None,
    hot_count: int = 0,
    floor: int = 8,
):
    """Per-destination a2a bucket budgets [N] (rows).

    `dest_hot` is the plan's per-destination explicit hot-key arrival
    counts (None = uniform hash: no hot routing) and `hot_count` the
    number of plan hot keys removed from the hash-spread tail (each hot
    key is a local unique that the plan routes explicitly, so it never
    competes for tail slots). dest_hot=None/hot_count=0 reproduces the
    legacy slack·U/N budget bit-for-bit. Each budget rounds up to a
    VPU-friendly multiple of 8 with a floor of `floor`.

    Drift-safety margin: the tail subtraction is capped at U/4, so even
    when the ENTIRE routed hot set goes cold at once (a rotated key
    distribution — the window between a drift and the replan that chases
    it) every destination still budgets ≥ 3/4·slack × the uniform
    per-dest spread of what is then an all-tail stream (1.5× the
    expected per-dest load at the default slack=2 — real variance
    headroom, not just the mean). Shortfall beyond that degrades via the
    sentinel bucket (default-served, counted), never drops rows."""
    import math

    import numpy as np

    N = int(num_shards)
    h_eff = min(max(0, int(hot_count)), int(unique) // 4)
    tail = math.ceil(max(0, int(unique) - h_eff) * slack / N)
    hot = (
        np.zeros((N,), np.int64)
        if dest_hot is None
        else np.asarray(dest_hot, np.int64)
    )
    if hot.shape != (N,):
        raise ValueError(
            f"dest_hot must be a length-{N} vector, got shape {hot.shape}"
        )
    b = np.maximum(int(floor), ((tail + hot + 7) // 8) * 8)
    return b.astype(np.int64)


def a2a_bucket_rows(
    *,
    unique: int,
    num_shards: int,
    slack: float = 2.0,
    dest_hot=None,
    hot_count: int = 0,
    floor: int = 8,
) -> int:
    """The uniform physical bucket the a2a program compiles: the max of
    the per-destination budget vector (all_to_all chunks are equal)."""
    return int(a2a_dest_budgets(
        unique=unique, num_shards=num_shards, slack=slack,
        dest_hot=dest_hot, hot_count=hot_count, floor=floor,
    ).max())


def a2a_bucket_rows_global(
    *,
    unique: int,
    num_shards: int,
    slack: float = 2.0,
    hot_max: int = 0,
    floor: int = 8,
) -> int:
    """The placement-v1 global-headroom bucket: the full hash-spread tail
    (hot keys NOT subtracted) plus the plan's worst per-destination hot
    concentration on every bucket. Kept as the reproducible "before"
    column of the per-dest budget diet (the traffic-diet discipline)."""
    import math

    per = math.ceil(int(unique) * slack / num_shards) + int(hot_max)
    return max(int(floor), ((per + 7) // 8) * 8)


def a2a_exchange_wire_bytes(
    *,
    bucket_rows: int,
    num_shards: int,
    dim: int,
    wire_bytes: int = 4,
    key_bytes: int = 4,
) -> float:
    """Per-device per-step wire bytes of the budgeted a2a exchange at a
    physical bucket of `bucket_rows`: id + count buckets out, embeddings
    back, grads out — (N−1) remote buckets each direction (the bucket a
    shard addresses to itself never leaves the chip)."""
    per_dir = (num_shards - 1) * int(bucket_rows)
    return float(
        per_dir * (key_bytes + 4) + 2 * per_dir * dim * wire_bytes
    )


# ------------------------------------------ hierarchical (two-tier) model
#
# The 2-D mesh splits the flat device axis into a cheap `intra` tier
# (same host group: ICI/NVLink) and an expensive `inter` tier (DCN).
# The hierarchical exchange aggregates ids per host-group on the cheap
# tier first — cross-device duplicates collapse at a relay before
# anything crosses the expensive tier — so the inter-tier bucket is
# budgeted off the GROUP uniques (U_g ≤ group_factor·U ≤ intra·U), not
# off intra·U raw gathered rows. `ShardedTable._hier_budget` calls
# `hier_dest_budgets` directly: model and program share one formula by
# construction, and `bench.py --mesh` records both per-tier modeled and
# measured bytes for `roofline.py --assert-hierarchy` to gate.


def hier_group_unique_budget(
    *, unique: int, intra: int, group_factor: Optional[float] = None,
) -> int:
    """Static budget U_g for the per-host-group unique ids after the
    intra-tier aggregation. `group_factor=None` means exact (intra·U —
    no dedup assumed, the inter bucket can never bind on group overlap);
    a float f budgets U_g = ceil(f·U), capped at intra·U, expressing the
    expected cross-device id overlap inside a group (f→1 as devices in a
    group see the same hot ids). Rounded up to a multiple of 8."""
    import math

    U, I = int(unique), int(intra)
    cap = I * U
    if group_factor is None:
        return cap
    ug = min(cap, math.ceil(float(group_factor) * U))
    return min(cap, ((ug + 7) // 8) * 8)


def hier_relay_rows(*, unique: int, intra: int) -> int:
    """Static size of the relay dedup stage: the intra-tier allgather
    hands every device intra·U rows; the relay (device i of each group
    handles gathered ids whose owner sits at intra position i) dedups
    over that full static extent — compute-only, nothing crosses a
    wire at this size."""
    return int(intra) * int(unique)


def hier_dest_budgets(
    *,
    unique: int,
    intra: int,
    inter: int,
    slack: float = 2.0,
    group_factor: Optional[float] = None,
    dest_hot=None,
    hot_count: int = 0,
    floor: int = 8,
):
    """Per-destination-GROUP budgets [J] (rows) of the inter-tier a2a.

    Each relay holds ~U_g/intra of its group's uniques (owner intra-pos
    partitions the group uniques across relays under a uniform hash), and
    buckets them by owner GROUP — J destinations. This reuses the per-dest
    budget discipline of `a2a_dest_budgets` verbatim at the group tier:
    `dest_hot` is the plan's per-device hot arrival vector [N] folded to
    per-group maxima over the relay position (all relays compile one
    bucket), `hot_count` the plan hot keys removed from the tail (split
    across relays). Overflow degrades via the sentinel bucket exactly as
    in the flat a2a — default-served, counted, never dropped."""
    import math

    import numpy as np

    I, J = int(intra), int(inter)
    ug = hier_group_unique_budget(
        unique=unique, intra=I, group_factor=group_factor
    )
    relay_u = math.ceil(ug / I)
    group_hot = None
    if dest_hot is not None:
        hot = np.asarray(dest_hot, np.int64)
        if hot.shape != (J * I,):
            raise ValueError(
                f"dest_hot must be a length-{J * I} per-device vector, "
                f"got shape {hot.shape}"
            )
        group_hot = hot.reshape(J, I).max(axis=1)
    return a2a_dest_budgets(
        unique=relay_u, num_shards=J, slack=slack,
        dest_hot=group_hot, hot_count=math.ceil(int(hot_count) / I),
        floor=floor,
    )


def hier_bucket_rows(
    *,
    unique: int,
    intra: int,
    inter: int,
    slack: float = 2.0,
    group_factor: Optional[float] = None,
    dest_hot=None,
    hot_count: int = 0,
    floor: int = 8,
) -> int:
    """The uniform physical inter-tier bucket (max of the per-group
    budget vector — all_to_all chunks are equal)."""
    return int(hier_dest_budgets(
        unique=unique, intra=intra, inter=inter, slack=slack,
        group_factor=group_factor, dest_hot=dest_hot, hot_count=hot_count,
        floor=floor,
    ).max())


def hier_exchange_bytes(
    *,
    unique: int,
    intra: int,
    inter: int,
    dim: int,
    wire_bytes: int = 4,
    key_bytes: int = 4,
    slack: float = 2.0,
    group_factor: Optional[float] = None,
    dest_hot=None,
    hot_count: int = 0,
    intra_bw_gbs: Optional[float] = None,
    inter_bw_gbs: Optional[float] = None,
) -> Dict[str, float]:
    """Per-device per-step wire bytes of the hierarchical exchange, split
    by tier (the whole point of the 2-D mesh: the tiers have different
    bandwidths, so one aggregate byte count hides the term that matters).

    intra tier (cheap) per device:
      id+count allgather        (I−1)·U·(kb+4)
      value psum_scatter        (I−1)·U·D·wb   (tiled partial sums)
      grad allgather            (I−1)·U·D·wb
    inter tier (expensive) per device, bucket B_g = hier_bucket_rows:
      id+count buckets out      (J−1)·B_g·(kb+4)
      embeddings back           (J−1)·B_g·D·wb
      grads out                 (J−1)·B_g·D·wb

    With `intra_bw_gbs`/`inter_bw_gbs` (GB/s per device, e.g. ICI vs DCN
    injection bandwidth) the dict also carries modeled per-tier
    milliseconds — the roofline form `bench.py --mesh` records."""
    U, D, I, J = int(unique), int(dim), int(intra), int(inter)
    kb, wb = int(key_bytes), int(wire_bytes)
    Bg = hier_bucket_rows(
        unique=U, intra=I, inter=J, slack=slack, group_factor=group_factor,
        dest_hot=dest_hot, hot_count=hot_count,
    )
    intra_b = float(
        (I - 1) * U * (kb + 4) + 2 * (I - 1) * U * D * wb
    )
    inter_b = float(
        (J - 1) * Bg * (kb + 4) + 2 * (J - 1) * Bg * D * wb
    )
    out: Dict[str, float] = {
        "intra_bytes": intra_b,
        "inter_bytes": inter_b,
        "total_bytes": intra_b + inter_b,
        "bucket_rows": float(Bg),
        "group_unique_budget": float(hier_group_unique_budget(
            unique=U, intra=I, group_factor=group_factor
        )),
    }
    if intra_bw_gbs:
        out["intra_ms"] = intra_b / (float(intra_bw_gbs) * 1e9) * 1e3
    if inter_bw_gbs:
        out["inter_ms"] = inter_b / (float(inter_bw_gbs) * 1e9) * 1e3
    return out


def flat_exchange_tier_bytes(
    *,
    unique: int,
    num_shards: int,
    intra: int,
    comm: str = "a2a",
    dim: int = 16,
    wire_bytes: int = 4,
    key_bytes: int = 4,
    slack: float = 2.0,
) -> Dict[str, float]:
    """The FLAT exchange's per-device bytes mapped onto the two-tier
    topology: of its N−1 remote peers, I−1 sit inside the host group
    (intra tier) and N−I across groups (inter tier). This is the
    baseline column of the hierarchy diet — `roofline.py
    --assert-hierarchy` pins hier inter_bytes ≤ total/intra and
    ≤ 0.5 × this function's inter_bytes at the reference shape."""
    U, D, N, I = int(unique), int(dim), int(num_shards), int(intra)
    kb, wb = int(key_bytes), int(wire_bytes)
    if comm == "a2a":
        Bd = a2a_bucket_rows(unique=U, num_shards=N, slack=slack)
        row = (kb + 4) + 2 * D * wb
        return {
            "intra_bytes": float((I - 1) * Bd * row),
            "inter_bytes": float((N - I) * Bd * row),
            "total_bytes": float((N - 1) * Bd * row),
        }
    if comm == "allgather":
        row = (kb + 4) + 2 * D * wb
        return {
            "intra_bytes": float((I - 1) * U * row),
            "inter_bytes": float((N - I) * U * row),
            "total_bytes": float((N - 1) * U * row),
        }
    raise ValueError(f"unknown comm {comm!r}")


# --------------------------------------------- replanning amortization model


def migration_bytes(moved_rows: int, *, row_bytes: float) -> float:
    """Modeled one-shot cost of migrating `moved_rows` between shards at a
    plan adoption: `exchange_row_bytes` over the moved rows, the unit of
    the placement load model, so gain per step and cost share one
    currency and the amortization horizon is a division."""
    return float(moved_rows) * float(row_bytes)


def replan_gain_bytes(loads_current, loads_candidate) -> float:
    """Modeled per-step byte gain of adopting a candidate plan: the drop in
    the MAX-shard exchange load (the straggler bounds the step; the mean
    load does not move under re-routing)."""
    import numpy as np

    cur = np.asarray(loads_current, np.float64)
    cand = np.asarray(loads_candidate, np.float64)
    if cur.size == 0 or cand.size == 0:
        return 0.0
    return float(cur.max() - cand.max())


# --------------------------------------------------------------- bytes model


def table_step_traffic(
    *,
    unique: int,
    dim: int,
    value_bytes: int = 4,
    key_bytes: int = 4,
    slot_widths: Sequence[int] = (0,),
    diet: bool = True,
    counter_filter: bool = False,
    num_shards: int = 1,
    comm: Optional[str] = None,
    wire_bytes: int = 4,
    a2a_slack: float = 2.0,
    imbalance: float = 1.0,
) -> Dict[str, float]:
    """Per-table per-step traffic of the embedding engine.

    `unique` is the number of unique rows the step touches (post-dedup, the
    budgeted U); `slot_widths` the optimizer's per-row slot widths (f32).
    Steady state: the initializer scatter for newly created rows is
    excluded (it is proportional to table GROWTH, not step traffic).

    Returns {"hbm_bytes", "wire_bytes", "wire_bytes_max_shard",
    "total_bytes"}: "hbm_bytes" are the device-memory bytes (the key is the
    JAX package's name), wire_bytes is 0 for unsharded tables; for
    num_shards > 1 it models the per-device payload of the `comm` exchange
    ("allgather" | "a2a") at `wire_bytes` per value/grad element (4 = fp32,
    2 = bf16; ids/counts always ride int32).

    `imbalance` is the max/mean per-shard owner-load skew
    (`shard_imbalance`): wire_bytes stays the MEAN payload, and
    "wire_bytes_max_shard" models the straggler shard that bounds the
    exchange (mean x imbalance), the quantity the placement plan flattens.
    """
    U, D, vb, kb = unique, dim, value_bytes, key_bytes
    slot_b = sum(w * 4 for w in slot_widths)

    # --- device memory: per-unique-id engine traffic (gathers read,
    # scatters write; .add reads and writes).
    probe = 2 * kb * U  # key gather + claim scatter
    value = (1 * D * vb) * U  # lookup row gather — the apply reuses it
    value += (1 * D * vb) * U  # apply row scatter
    slots = 2 * slot_b * U  # apply slot gather + scatter
    if diet:
        # one fused [3] gather + one fused [3] scatter
        meta = 2 * META_COLS * 4 * U
    else:
        # forward: freq RMW (r+w) + version set + dirty set; admission
        # freq gather when a counter filter gates; apply re-gather of the
        # value rows and the duplicate version/dirty re-stamps.
        meta = (2 * 4 + 4 + 1) * U
        meta += (4 * U) if counter_filter else 0
        meta += (4 + 1) * U  # apply-side version/dirty re-stamp
        value += (1 * D * vb) * U  # apply-side value re-gather
    hbm = probe + value + slots + meta

    # --- wire: per-device exchange payload for sharded tables.
    wire = 0.0
    if num_shards > 1 and comm:
        N = num_shards
        if comm == "allgather":
            # ids + counts allgather (int32), value psum_scatter, grad
            # allgather — each moves ~(N-1)·U rows per device.
            wire += (N - 1) * U * (kb + 4)
            wire += (N - 1) * U * D * wire_bytes  # embeddings down
            wire += (N - 1) * U * D * wire_bytes  # grads up
        elif comm == "a2a":
            # the bucket is the max of the per-destination budget vector
            # (uniform hash: hot terms zero, the slack·U/N bucket)
            Bd = a2a_bucket_rows(unique=U, num_shards=N, slack=a2a_slack)
            wire += a2a_exchange_wire_bytes(
                bucket_rows=Bd, num_shards=N, dim=D,
                wire_bytes=wire_bytes, key_bytes=kb,
            )
        else:
            raise ValueError(f"unknown comm {comm!r}")
    return {
        "hbm_bytes": float(hbm),
        "wire_bytes": float(wire),
        "wire_bytes_max_shard": float(wire) * max(1.0, float(imbalance)),
        "total_bytes": float(hbm + wire),
    }


def fused_sparse_step_traffic(
    *,
    positions: int,
    batch: int,
    unique: int,
    dim: int,
    value_bytes: int = 4,
    key_bytes: int = 4,
    slot_widths: Sequence[int] = (0,),
    fused: bool = True,
) -> Dict[str, float]:
    """Modeled device bytes of one fwd+bwd sparse bag step (lookup +
    combine + optimizer apply) for one table.

    `positions` is the flattened id-stream length N = B·L, `batch` the bag
    count B, `unique` the budgeted U. The split-phase model
    (`fused=False`) counts every materialization of the unfused path,
    including the O(N·D) expansion terms the fused kernels eliminate: the
    `emb_u[inverse]` gather that materializes [N, D] before the combine,
    and the mirrored [N, D] per-position grad contributions the backward
    expands before segment-summing. The fused model (`fused=True`; kernels
    #6 and #7) keeps only the irreducible stream: ids in, unique rows read
    once, bags out, grads in, unique value and slot rows read and written
    once; the [U, D] and [N, D] intermediates never reach device memory.
    `chip_smoke.py` phase 8 takes #6 / #7's byte bounds from these terms.
    """
    N, B, U, D = positions, batch, unique, dim
    vb, kb = value_bytes, key_bytes
    slot_b = sum(w * 4 for w in slot_widths)

    if not fused:
        hbm = 2 * kb * N  # dedup: key gather + claim scatter over N lanes
        hbm += U * D * vb  # unique row gather (read)
        hbm += 2 * U * D * vb  # [U, D] emb_u round-trip (write, re-read)
        hbm += N * D * vb  # combine: emb_u[inverse] expands to [N, D]
        hbm += B * D * 4  # combined bags out (f32)
        hbm += B * D * 4  # backward: bag grads in (f32)
        hbm += N * D * 4  # per-position grad contribs expand to [N, D]
        hbm += 2 * U * D * 4  # [U, D] grad_u round-trip (scatter, re-read)
        hbm += 2 * U * D * vb  # apply: value row gather + scatter
        hbm += 2 * slot_b * U  # apply: slot gather + scatter
    else:  # the terms live once, split per kernel, in fused_step_directions
        hbm = sum(fused_step_directions(
            positions=N, batch=B, unique=U, dim=D, value_bytes=vb,
            key_bytes=kb, slot_widths=slot_widths).values())
    return {"hbm_bytes": float(hbm)}


def fused_step_directions(
    *,
    positions: int,
    batch: int,
    unique: int,
    dim: int,
    value_bytes: int = 4,
    key_bytes: int = 4,
    slot_widths: Sequence[int] = (0,),
) -> Dict[str, int]:
    """The terms of `fused_sparse_step_traffic(fused=True)` split by
    direction: {"forward": kernel #6's bytes, "backward": kernel #7's}.
    The whole-step model is their sum; `chip_smoke.py` phase 8 bounds #6
    and #7 with them."""
    N, B, U, D = positions, batch, unique, dim
    vb, kb = value_bytes, key_bytes
    slot_b = sum(w * 4 for w in slot_widths)
    fwd = kb * N  # forward reads the id stream once; the probe is on-chip
    fwd += U * D * vb  # unique rows read once
    fwd += B * D * 4  # combined bags out (f32)
    bwd = B * D * 4  # backward: bag grads in (f32)
    bwd += kb * N  # backward re-reads ids/inverse
    bwd += 2 * U * D * vb  # value rows: read + updated write
    bwd += 2 * slot_b * U  # slot rows: read + write
    if vb == 2:
        bwd += U * D * 4  # row-keyed SR bits (u32) for bf16 tables
    return {"forward": fwd, "backward": bwd}


def dlrm_reference_traffic(
    *,
    batch: int = 2048,
    num_tables: int = 26,
    dim: int = 16,
    unique_fraction: float = 1.0,
    slot_widths: Sequence[int] = (16,),
    diet: bool = True,
    num_shards: int = 1,
    comm: Optional[str] = None,
    exchange_dtype: str = "float32",
    pipeline_mode: str = "off",
) -> Dict[str, float]:
    """Whole-model per-step traffic at the reference DLRM shape (26 single-
    hot features, dim 16, Adagrad). `unique_fraction` scales the per-table
    touched rows (the dedup budget); sharded shapes split the batch across
    devices and add the exchange term. `pipeline_mode != "off"` adds the
    lookahead's double-buffer residency under "pipeline_buffer_bytes"
    (per-step traffic itself is unchanged by pipelining: the same ops,
    reordered)."""
    wire_bytes = 2 if exchange_dtype == "bfloat16" else 4
    local_batch = batch // max(num_shards, 1)
    U = max(1, int(round(local_batch * unique_fraction)))
    per_table = table_step_traffic(
        unique=U, dim=dim, slot_widths=slot_widths, diet=diet,
        num_shards=num_shards, comm=comm, wire_bytes=wire_bytes,
    )
    out = {k: v * num_tables for k, v in per_table.items()}
    out["pipeline_buffer_bytes"] = num_tables * pipeline_buffer_bytes(
        unique=U, dim=dim, positions=local_batch, num_shards=num_shards,
        comm=comm, pipeline_mode=pipeline_mode,
    )
    return out


# ------------------------------------------------------- compute reuse


def serving_reuse_speedup(
    *, hit_rate: float, hit_cost_ratio: float = 0.0,
) -> float:
    """Modeled effective requests/s factor of the serving compute-reuse
    layer (serving/reuse.py) at an answer-cache hit rate, closed-loop:

        speedup = 1 / (1 - h + h * c)

    where ``h`` is the hit rate and ``c`` the cost of serving a hit
    relative to a full evaluation (fingerprint + dict lookup against a
    device dispatch; about 0 for the answer cache, more for a user-tower
    cache whose candidate lane still runs the item tower). Amdahl on the
    per-request serial cost: at h = 0.5, c = 0 the tier answers 2x the
    requests per second from the same compute. `chip_smoke.py` phase 24
    prints the measured factor beside this model at the measured c."""
    h = float(hit_rate)
    c = float(hit_cost_ratio)
    if not 0.0 <= h <= 1.0:
        raise ValueError(f"hit_rate must be in [0, 1], got {h}")
    if c < 0.0:
        raise ValueError(f"hit_cost_ratio must be >= 0, got {c}")
    denom = (1.0 - h) + h * c
    if denom <= 0.0:
        raise ValueError("hit_rate 1.0 with zero hit cost: infinite model")
    return 1.0 / denom


def reuse_hit_rate_for_speedup(
    *, speedup: float, hit_cost_ratio: float = 0.0,
) -> float:
    """Inverse of `serving_reuse_speedup`: the answer-cache hit rate a
    target requests/s factor requires (capacity planning: size the cache
    and population so the zipf head clears this rate)."""
    s = float(speedup)
    c = float(hit_cost_ratio)
    if s < 1.0:
        raise ValueError(f"speedup must be >= 1, got {s}")
    if c >= 1.0:
        raise ValueError(f"hit_cost_ratio must be < 1, got {c}")
    return (1.0 - 1.0 / s) / (1.0 - c)


def zipf_expected_hit_rate(*, users: int, alpha: float,
                           resident: int) -> float:
    """Expected answer-cache hit rate for a zipf(alpha) population of
    `users` distinct request keys with the hottest `resident` keys cached
    (steady state, capacity >= resident): the probability mass of the
    resident head,

        sum_{r<resident} r^-alpha / sum_{r<users} r^-alpha."""
    if users < 1 or resident < 0:
        raise ValueError(f"bad population users={users} resident={resident}")
    ranks = [float(r + 1) ** (-float(alpha)) for r in range(int(users))]
    total = sum(ranks)
    return sum(ranks[: min(int(resident), int(users))]) / total


# ---------------------------------------------------------- pipelining model


def pipeline_buffer_bytes(
    *,
    unique: int,
    dim: int,
    positions: Optional[int] = None,
    value_bytes: int = 4,
    key_bytes: int = 4,
    num_shards: int = 1,
    comm: Optional[str] = None,
    pipeline_mode: str = "lookahead",
) -> float:
    """Extra RESIDENT bytes per table of the one-batch lookahead
    (`pipeline_mode != "off"`): the pipelined window double-buffers one
    in-flight lookup — the carried batch's finished embedding buffer, its
    routing arrays and the owner-side residual live alongside the current
    step's. This is capacity, not per-step traffic: the per-step totals of
    `table_step_traffic` are unchanged by pipelining (the same ops run,
    reordered).

    `positions` is the flattened id-position count of the batch (B·L per
    table); the carried inverse / mask / batch ids are batch-shaped, not
    unique-shaped, so under a dedup budget (U < positions) they dominate
    the int side of the carry. Defaults to `unique` (the no-dedup U = N
    case)."""
    if pipeline_mode == "off":
        return 0.0
    U, D = unique, dim
    pos = unique if positions is None else int(positions)
    b = U * key_bytes  # carried uids
    b += U * 4  # counts
    b += pos * 4  # inverse (batch-shaped [B, L])
    b += pos * key_bytes  # the prefetched batch's ids themselves
    b += pos * 1  # per-position mask in the carried views
    b += U * D * value_bytes  # finished local embedding buffer
    b += U * D * value_bytes  # owner-side residual rows (reuse_rows diet)
    if num_shards > 1 and comm == "a2a":
        b += U * 4  # send_slot routing metadata
    return float(b)


def modeled_overlap_step(
    *,
    dense_ms: float,
    route_ms: float,
    other_ms: float,
    mode: str = "off",
    chunks: int = 1,
) -> float:
    """Modeled step time (ms) under the in-step pipelining schedule.

    `route_ms` is the hoistable half of the lookup — id dedup + id
    exchange + owner probe/metadata (everything the pipelined window issues
    ahead of the dense compute); `dense_ms` the dense fwd/bwd it hides
    behind; `other_ms` everything that stays serial (value gather +
    embedding exchange, grad exchange, sparse apply, dense update).

      off:       dense + route + other           (strictly sequential)
      lookahead: max(dense, route) + other       (route hidden behind dense)
      chunked:   like lookahead; the model keeps other_ms whole (it cannot
                 split the gather from the wire without a trace), so
                 chunked == lookahead here.

    `chip_smoke.py` phase 24 prints the measured lookahead step beside this
    model, with the off step's phase times as its inputs."""
    dense_ms = max(0.0, float(dense_ms))
    route_ms = max(0.0, float(route_ms))
    other_ms = max(0.0, float(other_ms))
    if mode == "off":
        return dense_ms + route_ms + other_ms
    return max(dense_ms, route_ms) + other_ms


# ------------------------------------------------------------ op-count model
#
# The JAX package counts gathers and scatters in the text of the lowered
# program. The port's program is eager: `count_device_ops` profiles one
# region and counts the operations it dispatches from Python, by name. An
# operation nested inside another aten op is that op's business (a
# composite's internals differ between the CPU and the card) and is not
# counted; the row-kernel wrappers count once per call, whether the call
# launched #3 / #5 or ran the plain version on the CPU. So one region gives
# one count on either device.

GATHER_OPS = {
    "aten::index": "x[idx], advanced-indexing read (the probe's key reads)",
    "aten::gather": "torch.gather (dedup scratch reads, the metadata gather)",
    "aten::index_select": "torch.index_select, rows along one dim",
    "aten::take": "torch.take, flat-index read",
    "aten::take_along_dim": "torch.take_along_dim, gather along a dim",
    "aten::embedding": "F.embedding, a table row read",
    "aten::embedding_bag": "F.embedding_bag, pooled row reads",
    "aten::_embedding_bag": "the embedding_bag kernel when called direct",
}
SCATTER_OPS = {
    "aten::index_put_": "x[idx] = v, advanced-indexing write",
    "aten::index_put": "torch.index_put, out of place",
    "aten::_index_put_impl_": "index_put_'s implementation called direct",
    "aten::scatter_": "Tensor.scatter_ (the sort dedup's uid and inverse)",
    "aten::scatter": "torch.scatter, out of place",
    "aten::scatter_add_": "Tensor.scatter_add_ (counts, the metadata stamp)",
    "aten::scatter_add": "torch.scatter_add, out of place",
    "aten::scatter_reduce_": "Tensor.scatter_reduce_ (the probes' claims)",
    "aten::scatter_reduce": "torch.scatter_reduce, out of place",
    "aten::index_add_": "Tensor.index_add_, rows added along one dim",
    "aten::index_add": "torch.index_add, out of place",
    "aten::index_copy_": "Tensor.index_copy_, rows written along one dim",
    "aten::index_copy": "torch.index_copy, out of place",
    "aten::index_fill_": "Tensor.index_fill_, rows filled along one dim",
    "aten::masked_scatter_": "Tensor.masked_scatter_, writes at a mask",
    "aten::put_": "Tensor.put_, flat-index write",
}
# the profiler ranges of the row-kernel wrappers (ops/fused_lookup.py
# row_op_ranges)
ROW_KERNEL_OPS = {
    "deeprec_tpu_torch::gather_rows": "gather",  # kernel #3 (#1 on bf16)
    "deeprec_tpu_torch::apply_rows_sr": "scatter",  # kernel #5 (#2 on bf16)
}
_REGION = "deeprec_tpu_torch::count_device_ops"


def _op_class(name: str) -> Optional[str]:
    if name in ROW_KERNEL_OPS:
        return ROW_KERNEL_OPS[name]
    if name in GATHER_OPS:
        return "gather"
    if name in SCATTER_OPS:
        return "scatter"
    return None


def count_device_ops(region: Callable[[], object]) -> Dict[str, int]:
    """Run `region()` once under torch.profiler (host activity only: the
    dispatcher's records, on the CPU and on the card alike) and count the
    gather- and scatter-class operations it dispatched: the aten ops of
    `GATHER_OPS` / `SCATTER_OPS` called from Python, and each call of a
    row-kernel wrapper (`ROW_KERNEL_OPS`) as one. Returns {"gather",
    "scatter", "row_gather", "row_scatter"}: the last two are the wrappers'
    share, the calls that launch #3 / #5 on the card. Collectives are not
    counted."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from deeprec_tpu_torch.ops.fused_lookup import row_op_ranges

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with row_op_ranges(), record_function(_REGION):
            region()
    out = {"gather": 0, "scatter": 0, "row_gather": 0, "row_scatter": 0}
    for e in prof.events():
        kind = _op_class(e.name)
        if kind is None:
            continue
        p, inside = e.cpu_parent, False
        while p is not None:
            if p.name == _REGION:
                inside = True
                break
            if p.name.startswith("aten::") or p.name in ROW_KERNEL_OPS:
                break  # dispatched by another op, not from Python
            p = p.cpu_parent
        if not inside:
            continue
        out[kind] += 1
        if e.name in ROW_KERNEL_OPS:
            out["row_" + kind] += 1
    return out


def expected_lookup_apply_ops(
    *,
    diet: bool = True,
    budgeted: bool = True,
    n_row_slots: int = 1,
) -> Dict[str, int]:
    """Expected gather / scatter counts (`count_device_ops`) of the
    single-table TRAIN `EmbeddingTable.lookup_unique` +
    `optim.apply.apply_gradients` program (no sharding, no admission
    filter, one per-row optimizer slot unless overridden).

    Base constants are CALIBRATED against the port's program
    (`optim.apply.lookup_apply_region`): a table of
    capacity 2^12, dim 16, Adagrad, ids 0..255 into an empty table, the
    hash dedup at `dedup.resolve_size(128, 256)` (`budgeted`) or the sort
    dedup at U = N. The probe loops are eager, so each round dispatches its
    gathers and its claim scatter again; at that input the hash dedup runs
    3 rounds and the table's probe 2 (3 behind the sort dedup). Counted:

      budgeted, diet   15 gathers  = dedup 3 x 2 + its tail and rank
                                     gathers 2 + probe 2 x 2 + the fused
                                     [T, 3, U] metadata gather 1 + the
                                     value gather #3 1 + the slot gather #3 1
                       10 scatters = dedup 3 claims + its counts 1 + probe
                                     2 claims + the initializer rows #5 1 +
                                     the metadata stamp 1 + value and slot
                                     writes #5 2
      sort, diet        9 gathers, 10 scatters (the sort dedup's uid,
                                     inverse and count scatters 3; probe 3
                                     rounds)

    The diet arm (`apply_gradients(reuse_rows=True, stamp_meta=False)`,
    the trainer's hot path) against the legacy one (`reuse_rows=False,
    stamp_meta=True`), as measured on the port: the legacy apply adds 2
    gathers and 1 scatter — the value rows gathered again (#3) and the
    version / dirty re-stamp's gather and scatter. The forward's metadata
    is one fused gather and one scatter on both arms (the port never had
    the JAX package's separate freq / version / dirty trio, whose removal
    is the JAX model's 4 scatters). Every further per-row slot adds one
    gather (#3) and one write (#5).

    `chip_smoke.py` phase 24 holds this against the count on the card."""
    if budgeted:  # hash dedup engine front end (ops/dedup.py hash_dedup)
        counts = {"gather": 15, "scatter": 10}
    else:  # sort-based dedup front end at U = N (ops/dedup.py sort_unique)
        counts = {"gather": 9, "scatter": 10}
    if not diet:
        counts["gather"] += 2
        counts["scatter"] += 1
    extra_slots = n_row_slots - 1
    counts["gather"] += extra_slots
    counts["scatter"] += extra_slots
    return counts
