"""Byte accounting of the embedding engine — the port holds, of
`deeprec_tpu/ops/traffic.py`, the serving residency model, which
`Predictor.residency_info` compares its measured bytes with, the retrieval
sweep's, which `RetrievalEngine.sweep_info` does, and the sharded
exchanges' models: the per-destination a2a budgets and the hierarchical
budgets that `parallel/sharded.py` compiles its buckets from, and the wire
bytes the sharded trainer reports (`dedup_stats` `per_shard`). Host
arithmetic; every number equals the JAX package's. The train-step gather /
scatter model belongs to ROADMAP queue A item 2, the migration and replan
models to item 6b."""
from __future__ import annotations

from typing import Dict, Optional


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
