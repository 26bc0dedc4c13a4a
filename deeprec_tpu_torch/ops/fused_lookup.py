"""Row gather, pooled gather, row scatter and the fused sparse bag step —
the port of the Pallas kernels of `deeprec_tpu/ops/fused_lookup.py`:
`gather_rows` (#3), `fused_gather_combine` (#4, one launch for a group of
features through `fused_gather_combine_grouped`), `apply_rows_sr` (#5),
`fused_sparse_forward` (#6) and `fused_sparse_backward` (#7). The bf16
pair-granule kernels (#1 `gather_rows_pair`, #2 `apply_rows_sr_pair`)
exist only because a TPU cannot move one bf16 row; on Hopper they are the
bf16 branches of #3 and #5, as the bf16 pair branch of #4 is #4's bf16
branch.

Each wrapper launches its hand-written kernel for a CUDA tensor
(`csrc/<name>.cu`, built by `ops/_build.py` at first use) and counts the
launch in `<wrapper>.launches` (#3 and #5 also count their bf16 branches,
#1 and #2, in `.launches_bf16`); for a CPU tensor it runs its plain PyTorch
version. Nothing falls back: a failed build or launch raises. Inside
`row_op_ranges()` the row gather and scatter run in a torch.profiler range
named `deeprec_tpu_torch::<wrapper>`, on either device, so `ops/traffic.py`
`count_device_ops` counts each call once, kernel or plain version.

Stochastic rounding: the port cannot reproduce `jax.random`'s threefry
stream, so the row scatter's random bits are its own (`sr_bits`, a counter
hash of (seed, element index) on the device). The bits reach the kernel as
a tensor, so the kernel and `apply_rows_sr_plain` round identically given
the same bits — and so does the JAX package given its own bits. The fused
backward's bits are the JAX package's own (`sr_bits_rows`, an integer hash
of (seed, row id, column)), computed inside the kernel, so a bf16 table
trained through it rounds bit for bit as the JAX package rounds it.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import threading
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from deeprec_tpu_torch.utils import hashing

_DTYPES = (torch.float32, torch.bfloat16)
_SR_SALT = 0x5EED


def _launch(name: str, tensor: torch.Tensor, *args, launcher: str = "") -> None:
    """Run the launcher `launcher` (default `<name>_launch`) of kernel
    library `name` on the current stream of `tensor`'s device; raise on any
    CUDA error code."""
    from deeprec_tpu_torch.ops import _build

    lib = _build.load(name)
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, launcher or f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


_RANGES = threading.local()  # .open: row_op_ranges() entered on this thread


@contextlib.contextmanager
def row_op_ranges():
    """While open, each call of a `_profiled_range` wrapper on this thread
    runs inside a torch.profiler range `deeprec_tpu_torch::<wrapper>`;
    outside, no range is made, so no other profile sees one."""
    _RANGES.open = getattr(_RANGES, "open", 0) + 1
    try:
        yield
    finally:
        _RANGES.open -= 1


def _profiled_range(fn):
    """`fn`, run inside its `deeprec_tpu_torch::<name>` range while
    `row_op_ranges()` is open on the calling thread."""
    label = f"deeprec_tpu_torch::{fn.__name__}"

    @functools.wraps(fn)
    def inner(*args, **kw):
        if not getattr(_RANGES, "open", 0):
            return fn(*args, **kw)
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return inner


# ------------------------------------------------------------- row gather


def gather_rows_plain(values: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[t, i] = values[t, clip(ix[t, i], 0, C-1)]
    over a stacked table values [T, C, D], ix [T, n] -> [T, n, D]. The CPU
    tests and the on-card comparison use it; the CUDA path never does."""
    C = values.shape[-2]
    safe = ix.long().clamp(0, C - 1)
    t = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[t, safe]


@_profiled_range
def gather_rows(values: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """values [T, C, D] (f32 or bf16), ix [T, n] int32 -> [T, n, D], with
    each index clipped to its own table's [0, C-1]."""
    if values.dim() != 3 or ix.dim() != 2 or ix.shape[0] != values.shape[0]:
        raise ValueError(
            f"gather_rows: want values [T, C, D] and ix [T, n], got "
            f"{tuple(values.shape)} and {tuple(ix.shape)}"
        )
    if values.dtype not in _DTYPES:
        raise TypeError(f"gather_rows: unsupported dtype {values.dtype}")
    if values.device.type == "cpu":
        return gather_rows_plain(values, ix)
    if values.device.type != "cuda" or ix.device != values.device:
        raise ValueError(
            f"gather_rows: values on {values.device}, ix on {ix.device}"
        )
    if ix.dtype != torch.int32:
        raise TypeError(f"gather_rows: ix must be int32, got {ix.dtype}")
    if not values.is_contiguous():
        raise ValueError("gather_rows: values must be contiguous")
    ix = ix.contiguous()
    T, C, D = values.shape
    n = ix.shape[1]
    out = torch.empty((T, n, D), dtype=values.dtype, device=values.device)
    if T * n == 0:
        return out
    _launch("gather_rows", values, values.data_ptr(), ix.data_ptr(),
            out.data_ptr(), T, C, n, D * values.element_size())
    gather_rows.launches += 1
    if values.dtype == torch.bfloat16:  # the branch that stands for #1
        gather_rows.launches_bf16 += 1
    return out


gather_rows.launches = 0
gather_rows.launches_bf16 = 0


# ------------------------------------------------------- pooled gather


def _check_combine(values, row_ix, weights):
    if (values.dim() != 2 or row_ix.dim() != 2
            or tuple(weights.shape) != tuple(row_ix.shape)):
        raise ValueError(
            f"fused_gather_combine: want values [C, D], row_ix [B, L] and "
            f"weights [B, L], got {tuple(values.shape)}, {tuple(row_ix.shape)} "
            f"and {tuple(weights.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"fused_gather_combine: unsupported dtype {values.dtype}")


def fused_gather_combine_plain(values: torch.Tensor, row_ix: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out [B, D] f32, positions added in l order,
    out = out + w * row, where row_ix >= 0 (clipped to C - 1). The CPU
    path and the on-card comparison use it."""
    _check_combine(values, row_ix, weights)
    C = values.shape[0]
    B, L = row_ix.shape
    ix = row_ix.long()
    safe = ix.clamp(0, C - 1)
    w = weights.to(torch.float32)
    out = torch.zeros((B, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    for pos in range(L):
        row = values[safe[:, pos]].to(torch.float32)
        out = torch.where((ix[:, pos] >= 0)[:, None],
                          out + w[:, pos, None] * row, out)
    return out


def fused_gather_combine(values: torch.Tensor, row_ix: torch.Tensor,
                         weights: torch.Tensor) -> torch.Tensor:
    """Pooled bags straight from the table: values [C, D] (f32 or bf16,
    upcast on load), row_ix [B, L] int32 rows (< 0 = skip, >= C clipped to
    C - 1), weights [B, L] f32 carrying the combiner. Returns [B, D] f32,
    out[b] = sum_l weights[b, l] * values[row_ix[b, l]], each column summed
    in l order (multiply, then add). Any B, L and D. On the card, a group
    of one of `fused_gather_combine_grouped`.

    A skipped position reads no row, where the Pallas kernel adds
    0 * values[0]: the same result bit for bit wherever values[0] is
    finite (ROADMAP.md C, free divergences)."""
    _check_combine(values, row_ix, weights)
    if values.device.type == "cpu":
        return fused_gather_combine_plain(values, row_ix, weights)
    return fused_gather_combine_grouped([values], [row_ix], [weights])[0]


# Features per launch of the grouped kernel: kMaxFeatures of
# csrc/fused_gather_combine.cu, the capacity of the parameter struct that
# carries their pointers. A larger group takes several launches.
GROUP_CAPACITY = 64


def _check_group(values, row_ix, weights):
    if not len(values) == len(row_ix) == len(weights):
        raise ValueError(
            f"fused_gather_combine_grouped: {len(values)} values, {len(row_ix)} "
            f"row_ix and {len(weights)} weights")
    for v, ix, w in zip(values, row_ix, weights):
        _check_combine(v, ix, w)
    if not values:
        return
    v0, ix0 = values[0], row_ix[0]
    for f, (v, ix, w) in enumerate(zip(values, row_ix, weights)):
        if not v.device == ix.device == w.device == v0.device:
            raise ValueError(
                f"fused_gather_combine_grouped: feature {f} has values on "
                f"{v.device}, row_ix on {ix.device}, weights on {w.device}; "
                f"feature 0's values on {v0.device}")
        if v.dtype != v0.dtype or v.shape[1] != v0.shape[1]:
            raise ValueError(
                f"fused_gather_combine_grouped: feature {f} has {v.dtype} rows "
                f"of D {v.shape[1]}, feature 0 {v0.dtype} rows of D {v0.shape[1]}")
        if ix.shape[0] != ix0.shape[0]:
            raise ValueError(
                f"fused_gather_combine_grouped: feature {f} has B {ix.shape[0]}, "
                f"feature 0 B {ix0.shape[0]}")


def fused_gather_combine_grouped_plain(values, row_ix, weights):
    """Plain PyTorch version of the grouped launch:
    `fused_gather_combine_plain` feature by feature."""
    _check_group(values, row_ix, weights)
    return [fused_gather_combine_plain(v, ix, w)
            for v, ix, w in zip(values, row_ix, weights)]


def fused_gather_combine_grouped(values: Sequence[torch.Tensor],
                                 row_ix: Sequence[torch.Tensor],
                                 weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """`fused_gather_combine` of F features in one launch (one per
    GROUP_CAPACITY features): values[f] [C_f, D], row_ix[f] and weights[f]
    [B, L_f]. The features share device, row dtype, D and B, and may differ
    in C and L. Returns F tensors [B, D] f32, views of one [F, B, D]
    buffer."""
    values, row_ix, weights = list(values), list(row_ix), list(weights)
    _check_group(values, row_ix, weights)
    if not values:
        return []
    v0 = values[0]
    if v0.device.type == "cpu":
        return fused_gather_combine_grouped_plain(values, row_ix, weights)
    if v0.device.type != "cuda":
        raise ValueError(f"fused_gather_combine_grouped: values on {v0.device}")
    if any(ix.dtype != torch.int32 or w.dtype != torch.float32
           for ix, w in zip(row_ix, weights)):
        raise TypeError("fused_gather_combine_grouped: row_ix must be int32 and "
                        "weights float32")
    if not all(v.is_contiguous() for v in values):
        raise ValueError("fused_gather_combine_grouped: values must be contiguous")
    F, (B, D) = len(values), (row_ix[0].shape[0], v0.shape[1])
    out = torch.empty((F, B, D), dtype=torch.float32, device=v0.device)
    if B * D == 0:
        return list(out.unbind(0))
    row_ix = [ix.contiguous() for ix in row_ix]
    weights = [w.contiguous() for w in weights]

    def ptrs(ts):
        return (ctypes.c_void_p * F)(*[t.data_ptr() for t in ts])

    def sizes(xs):
        return (ctypes.c_longlong * F)(*xs)

    outs = out.unbind(0)
    _launch("fused_gather_combine", v0, ptrs(values), ptrs(row_ix), ptrs(weights),
            ptrs(outs), sizes(ix.shape[1] for ix in row_ix),
            sizes(v.shape[0] for v in values), F, B, D,
            int(v0.dtype == torch.bfloat16),
            launcher="fused_gather_combine_grouped_launch")
    fused_gather_combine.launches += -(-F // GROUP_CAPACITY)
    return list(outs)


fused_gather_combine.launches = 0


# ------------------------------------------------ stochastic-rounded scatter


def sr_bits(seed, shape, device) -> torch.Tensor:
    """Random bits for stochastic rounding, int32 [shape] (the uint32
    pattern): a counter hash of (seed, flat element index) built on
    `hashing.mix32`, computed on `device` with no host RNG state. The same
    (seed, shape) gives the same bits on every device."""
    n = math.prod(shape)
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    key = hashing.mix32((seed & 0xFFFFFFFF) ^ _SR_SALT)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = hashing.mix32(hashing.mix32(idx) ^ key)
    return hashing.wrap_int32(bits).view(shape)


def stochastic_round_plain(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 by stochastic rounding: add the low 16 bits of
    `bits` (int32 pattern, x's shape) to the float32 bit pattern and keep
    the high 16. E[result] == x; bf16-representable values never move. The
    same bit-twiddle as the JAX package's `stochastic_round`."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    u = ((u & 0xFFFFFFFF) + (bits.to(torch.int64) & 0xFFFF)) & 0xFFFF0000
    return hashing.wrap_int32(u).view(torch.float32).to(torch.bfloat16)


def _check_scatter(values, slot_ix, rows):
    if (values.dim() != 3 or slot_ix.dim() != 2 or rows.dim() != 3
            or tuple(rows.shape) != (*slot_ix.shape, values.shape[2])
            or slot_ix.shape[0] != values.shape[0]):
        raise ValueError(
            f"apply_rows_sr: want values [T, C, D], slot_ix [T, U] and rows "
            f"[T, U, D], got {tuple(values.shape)}, {tuple(slot_ix.shape)} "
            f"and {tuple(rows.shape)}"
        )
    if values.dtype not in _DTYPES:
        raise TypeError(f"apply_rows_sr: unsupported dtype {values.dtype}")


def apply_rows_sr_plain(values: torch.Tensor, slot_ix: torch.Tensor,
                        rows: torch.Tensor, bits=None) -> torch.Tensor:
    """Plain PyTorch version, IN PLACE: values[t, slot_ix[t, u]] =
    SR(rows[t, u]) where 0 <= slot_ix < C; f32 tables store exactly, bf16
    tables round stochastically with `bits` ([T, U, D] int32). Returns
    `values`. The CPU path and the on-card comparison use it."""
    _check_scatter(values, slot_ix, rows)
    C = values.shape[1]
    ok = (slot_ix >= 0) & (slot_ix < C)
    if values.dtype == torch.bfloat16:
        if bits is None:
            raise ValueError("apply_rows_sr_plain: a bf16 table needs bits")
        new = stochastic_round_plain(rows, bits)
    else:
        new = rows.to(values.dtype)
    t = torch.arange(values.shape[0], device=values.device)[:, None]
    t = t.expand_as(slot_ix)
    values[t[ok], slot_ix[ok].long()] = new[ok]
    return values


@_profiled_range
def apply_rows_sr(values: torch.Tensor, slot_ix: torch.Tensor,
                  rows: torch.Tensor, seed=0, bits=None) -> torch.Tensor:
    """values [T, C, D] (f32 or bf16) updated IN PLACE — the port's
    counterpart of the TPU kernel's input/output aliasing: for every
    (t, u) with 0 <= slot_ix[t, u] < C, values[t, slot_ix[t, u]] = rows
    [t, u] (f32 [T, U, D]), stochastically rounded for bf16 with `bits`
    (default `sr_bits(seed, rows.shape)`); f32 tables never read bits.
    Valid slot indices must be unique within a table. Returns `values`."""
    _check_scatter(values, slot_ix, rows)
    sr = values.dtype == torch.bfloat16
    if sr and bits is None:
        bits = sr_bits(seed, tuple(rows.shape), rows.device)
    if values.device.type == "cpu":
        return apply_rows_sr_plain(values, slot_ix, rows, bits if sr else None)
    devs = {values.device, slot_ix.device, rows.device}
    if sr:
        devs.add(bits.device)
    if values.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"apply_rows_sr: tensors on {sorted(map(str, devs))}")
    if slot_ix.dtype != torch.int32 or (sr and bits.dtype != torch.int32):
        raise TypeError("apply_rows_sr: slot_ix and bits must be int32")
    if not values.is_contiguous():
        raise ValueError("apply_rows_sr: values must be contiguous")
    T, C, D = values.shape
    U = slot_ix.shape[1]
    if T * U == 0:
        return values
    slot_ix = slot_ix.contiguous()
    rows = rows.to(torch.float32).contiguous()
    bits = bits.contiguous() if sr else None
    _launch("apply_rows_sr", values, values.data_ptr(), slot_ix.data_ptr(),
            rows.data_ptr(), bits.data_ptr() if sr else None, T, C, U, D,
            int(sr))
    apply_rows_sr.launches += 1
    if sr:  # the branch that stands for #2
        apply_rows_sr.launches_bf16 += 1
    return values


apply_rows_sr.launches = 0
apply_rows_sr.launches_bf16 = 0


# ------------------------------------------------------- fused sparse step
#
# The single-pass per-table step of the JAX package (docs/kernels.md).
# Forward: hash-probe dedup at a static budget U, one row read per
# position, a segment sum straight into [B, D]. Backward: a segment sum of
# the per-bag gradients into unique-row space in a fixed order, then the
# optimizer's row function and the write-back of the value and slot rows.
# Both take the port's leading table axis [T].


class FusedBags(NamedTuple):
    """What fused_sparse_forward produces and the backward consumes.

    out      [T, B, D] f32 pooled bags (rows are cast up before the
             combine, so bf16 tables pool exactly).
    uids     [T, U] int32 unique row indices; uids[:, 0] == -1 (the
             reserved sentinel). The ORDER is path-dependent: the kernel
             ranks ids in the order its claim race claims them (as the TPU
             kernel ranks in first-occurrence order), the plain version in
             scratch-slot order; under overflow so is the SET of budgeted
             ids. `out`, the overflow count and the uids-inverse
             correspondence are not, and neither is the backward's result.
    inverse  [T, B, L] int32 position -> unique slot (0 = pad/overflow).
    counts   [T, U] int32 occurrences per unique slot (counts[:, 0] == 0).
    overflow [T] int32 distinct ids past the budget + unresolved probes.
    """

    out: torch.Tensor
    uids: torch.Tensor
    inverse: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def sr_bits_rows(seed, uids: torch.Tensor, dim: int) -> torch.Tensor:
    """Row-keyed stochastic-rounding bits, int32 [..., U, dim] (the uint32
    pattern): a pure integer hash of (seed, row id, column), bit for bit
    the JAX package's `_sr_bits_rows`. The bits belong to the row, not to
    its position in the unique set, so paths that emit uids in different
    orders round alike."""
    s = hashing.mix32(torch.as_tensor(seed, dtype=torch.int64,
                                      device=uids.device) & 0xFFFFFFFF)
    base = hashing.mix32(hashing.fold64(uids) ^ s)
    # column * golden ratio, wrapped to uint32 (exact in int64 for any dim)
    col = hashing.mix32(torch.arange(dim, dtype=torch.int64, device=uids.device)
                        * 0x9E3779B9 & 0xFFFFFFFF)
    return hashing.wrap_int32(hashing.mix32(base[..., None] ^ col))


def _bag_denominator(mask: torch.Tensor, combiner: str) -> torch.Tensor:
    """Per-bag combine denominator [..., B, 1] f32: 1 for sum, max(n, 1)
    for mean, sqrt(max(n, 1)) for sqrtn. Applied outside the kernel (the
    forward's epilogue and the backward's gradient pre-scaling), so the
    kernel and the plain version share one division."""
    n = mask.to(torch.float32).sum(-1, keepdim=True)
    if combiner == "sum":
        return torch.ones_like(n)
    if combiner == "mean":
        return torch.clamp(n, min=1.0)
    if combiner == "sqrtn":
        return torch.sqrt(torch.clamp(n, min=1.0))
    raise ValueError(f"unknown combiner: {combiner}")


def _prescale(grad_out: torch.Tensor, ids: torch.Tensor,
              combiner: str) -> torch.Tensor:
    """The backward's per-bag gradients divided by the combine denominator
    (shared by both paths; "sum" divides by 1, which changes nothing)."""
    g = grad_out.to(torch.float32)
    return g if combiner == "sum" else g / _bag_denominator(ids >= 0, combiner)


def _combine_epilogue(bags: FusedBags, ids: torch.Tensor,
                      combiner: str) -> FusedBags:
    """mean/sqrtn scaling of the raw per-bag sums, shared by both paths."""
    if combiner == "sum":
        return bags
    return bags._replace(out=bags.out / _bag_denominator(ids >= 0, combiner))


def fusable_optimizer(opt, dim: int) -> bool:
    """True iff every slot of `opt` is a full-width (dim,) row: no
    per-table scalars (AdamAsync), no (1,)-wide rows (AdagradDecay).
    sgd, adagrad, adam, adamw and ftrl qualify."""
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

    for name, (shape, _) in opt.slot_specs(dim).items():
        if name.startswith(SCALAR_PREFIX) or tuple(shape) != (dim,):
            return False
    return True


def _check_bags(values, ids, unique_size):
    if values.dim() != 3 or ids.dim() != 3 or ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"fused_sparse_forward: want values [T, C, D] and ids [T, B, L], "
            f"got {tuple(values.shape)} and {tuple(ids.shape)}")
    if values.dtype not in _DTYPES:
        raise TypeError(f"fused_sparse_forward: unsupported dtype {values.dtype}")
    if int(unique_size) < 2:
        raise ValueError("fused_sparse_forward: unique_size must be >= 2 "
                         "(index 0 is the reserved sentinel)")


def _forward_sums_plain(values, ids, U, max_probes) -> FusedBags:
    """The raw per-bag sums by the JAX package's fallback composition:
    hash_dedup -> unique-row gather -> combine, positions summed in l
    order (the kernel's order)."""
    from deeprec_tpu_torch.ops import dedup

    T, B, L = ids.shape
    flat = torch.where(ids >= 0, ids, -1).reshape(T, B * L).to(torch.int32)
    uids, inverse, counts, overflow = dedup.hash_dedup(
        flat, U, sentinel=-1, max_probes=max_probes)
    emb = gather_rows_plain(values, uids).to(torch.float32)
    emb = torch.where((uids >= 0)[..., None], emb, 0.0)
    t = torch.arange(T, device=ids.device)[:, None]
    e = emb[t, inverse.long()].view(T, B, L, -1)
    m = (ids >= 0).to(torch.float32)[..., None]
    out = torch.zeros((T, B, values.shape[2]), dtype=torch.float32,
                      device=values.device)
    for pos in range(L):
        out = out + e[:, :, pos] * m[:, :, pos]
    return FusedBags(out, uids, inverse.view(T, B, L), counts, overflow)


def fused_sparse_forward_plain(values: torch.Tensor, ids: torch.Tensor, *,
                               combiner: str = "sum", unique_size: int,
                               max_probes: int = 64) -> FusedBags:
    """Plain PyTorch version of `fused_sparse_forward` (the JAX package's
    fallback). The CPU path and the on-card comparison use it."""
    _check_bags(values, ids, unique_size)
    return _combine_epilogue(
        _forward_sums_plain(values, ids, int(unique_size), max_probes),
        ids, combiner)


def fused_sparse_forward(values: torch.Tensor, ids: torch.Tensor, *,
                         combiner: str = "sum", unique_size: int,
                         max_probes: int = 64) -> FusedBags:
    """Single-pass budgeted bag lookup: dedup probe + row gather + combine.

    values [T, C, D] (f32 or bf16); ids [T, B, L] int32 ROW indices into
    values (< 0 = pad; the gather clips to [0, C-1], the dedup keys on the
    raw value); `unique_size` the static budget U >= 2 (index 0 is the
    reserved sentinel: use `dedup.resolve_size`). Returns FusedBags. When
    `overflow > 0`, WHICH distinct ids make the budget is path-dependent;
    both paths keep the budget contract."""
    _check_bags(values, ids, unique_size)
    if values.device.type == "cpu":
        return fused_sparse_forward_plain(values, ids, combiner=combiner,
                                          unique_size=unique_size,
                                          max_probes=max_probes)
    if values.device.type != "cuda" or ids.device != values.device:
        raise ValueError(f"fused_sparse_forward: values on {values.device}, "
                         f"ids on {ids.device}")
    if not values.is_contiguous():
        raise ValueError("fused_sparse_forward: values must be contiguous")
    from deeprec_tpu_torch.ops import dedup

    T, C, D = values.shape
    _, B, L = ids.shape
    U, N = int(unique_size), B * L
    S = dedup.scratch_size(N)
    dev = values.device
    flat = ids.to(torch.int32).contiguous()
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((T, B, D), dtype=torch.float32, device=dev)
    uids = torch.empty((T, U), **i32)
    inverse = torch.empty((T, B, L), **i32)
    counts = torch.empty((T, U), **i32)
    overflow = torch.empty((T,), **i32)
    if T * N == 0:
        bags = FusedBags(out.zero_(), uids.fill_(-1), inverse.zero_(),
                         counts.zero_(), overflow.zero_())
        return _combine_epilogue(bags, ids, combiner)
    # scratch keys and ranks, the two per-table counters, each position's
    # scratch slot: one memset inside the launcher, then the probe and the
    # bag launch (csrc/fused_sparse_forward.cu)
    work = torch.empty((2 * T * S + T * N + 2 * T,), **i32)
    _launch("fused_sparse_forward", values, values.data_ptr(), flat.data_ptr(),
            work.data_ptr(), out.data_ptr(), uids.data_ptr(), inverse.data_ptr(),
            counts.data_ptr(), overflow.data_ptr(), T, B, L, C, D, S, U,
            int(max_probes), int(values.dtype == torch.bfloat16))
    fused_sparse_forward.launches += 1
    return _combine_epilogue(FusedBags(out, uids, inverse, counts, overflow),
                             ids, combiner)


fused_sparse_forward.launches = 0


# The backward's fixed summation order, in three levels that depend only
# on the set of positions of a unique slot, never on the slot's number:
# the slot's positions, in ascending flat order, go in chunks of _CHUNK,
# each summed in order from 0; the chunk partials go in runs of _RUN, each
# summed in order from 0; the runs' sums are summed in order from 0. A zipf
# head id's tens of thousands of positions are then chunks and runs that
# many warps sum side by side, and a slot of at most _CHUNK positions is
# one chunk. The kernel and the plain version follow the same order.
_CHUNK = 32
_RUN = 8


def _ordered_sums(rows: torch.Tensor, first: torch.Tensor, count: torch.Tensor
                  ) -> torch.Tensor:
    """[len(first), D]: sum k < count[i] of rows[first[i] + k], in k order
    from 0. One round per k, over the sums that still have a k-th term."""
    by = torch.sort(count, descending=True, stable=True)[1]
    sizes = count[by].tolist()  # descending
    acc = torch.zeros((count.numel(), rows.shape[-1]), dtype=torch.float32,
                      device=rows.device)
    m = len(sizes)
    for k in range(sizes[0] if sizes else 0):
        while sizes[m - 1] <= k:  # sums with no k-th term drop out
            m -= 1
        acc[:m].add_(rows[first[by[:m]] + k])
    out = torch.empty_like(acc)
    out[by] = acc
    return out


def _groups(size: torch.Tensor, width: int):
    """Cut sequences of size[i] consecutive items each into groups of
    `width` items, groups in sequence order: (first item [G] within the
    concatenation, items [G], groups per sequence [len(size)])."""
    ng = (size + width - 1) // width
    owner = torch.repeat_interleave(torch.arange(size.numel(), device=size.device), ng)
    j = torch.arange(owner.numel(), device=size.device) - (torch.cumsum(ng, 0) - ng)[owner]
    first = (torch.cumsum(size, 0) - size)[owner] + width * j
    return first, torch.clamp(size[owner] - width * j, max=width), ng


def _segment_sum_plain(gs, mask, inverse, U) -> torch.Tensor:
    """grad_u [T, U, D] f32: every position's bag gradient gs[t, b] times
    its mask, summed per unique slot in the kernel's three-level order, so
    the two agree bit for bit."""
    T, B, L = inverse.shape
    D = gs.shape[-1]
    N = B * L
    contrib = (gs[:, :, None, :] * mask.to(torch.float32)[..., None]).reshape(T * N, D)
    inv = inverse.reshape(T, N).long()
    # every slot's positions in ascending flat order, slots in (t, u) order
    key = torch.where((inv > 0) & (inv < U),
                      torch.arange(T, device=gs.device)[:, None] * U + inv, -1).reshape(-1)
    order = torch.sort(key, stable=True)[1][int((key < 0).sum()):]
    size = torch.bincount(key[key >= 0], minlength=T * U)
    first, count, nch = _groups(size, _CHUNK)
    part = _ordered_sums(contrib[order], first, count)  # level 1: chunks
    first, count, nrun = _groups(nch, _RUN)
    run = _ordered_sums(part, first, count)             # level 2: runs
    return _ordered_sums(run, torch.cumsum(nrun, 0) - nrun, nrun).view(T, U, D)


_OPT_CODES = {"GradientDescent": 0, "Adagrad": 1, "Adam": 2, "AdamW": 3,
              "Ftrl": 4}
# slot order of each optimizer in the kernel's (s0, s1) arguments
_OPT_SLOTS = {0: (), 1: ("accum",), 2: ("m", "v"), 3: ("m", "v"),
              4: ("accum", "linear")}


def _check_backward(values, slots, grad_out, ids, res, opt):
    if values.dim() != 3 or ids.dim() != 3:
        raise ValueError(
            f"fused_sparse_backward: want values [T, C, D] and ids [T, B, L], "
            f"got {tuple(values.shape)} and {tuple(ids.shape)}")
    T, C, D = values.shape
    for name in sorted(slots):
        if tuple(slots[name].shape) != (T, C, D):
            raise ValueError(
                f"fused_sparse_backward: slot {name!r} has shape "
                f"{tuple(slots[name].shape)}, want {(T, C, D)} — slot layouts "
                "other than [T, C, D] keep the split-phase apply_gradients path")
    if tuple(grad_out.shape) != (T, ids.shape[1], D):
        raise ValueError(
            f"fused_sparse_backward: grad_out {tuple(grad_out.shape)}, want "
            f"{(T, ids.shape[1], D)}")
    if not fusable_optimizer(opt, D):
        raise NotImplementedError(
            f"fused_sparse_backward: optimizer {type(opt).__name__} has scalar "
            "or non-[dim] slots; use apply_gradients")


def _backward_plain(values, slots, gs, ids, res, opt, lr, step, seed,
                    grad_averaging):
    """The JAX package's fallback composition, IN PLACE, with the kernel's
    summation order."""
    T, C, D = values.shape
    U = res.uids.shape[1]
    grad_u = _segment_sum_plain(gs, ids >= 0, res.inverse, U)
    grad_u[:, 0] = 0.0
    if grad_averaging:
        grad_u = grad_u / torch.clamp(res.counts.to(torch.float32), min=1.0)[..., None]
    ok = res.uids >= 0
    safe = torch.where(ok, res.uids.clamp(0, C - 1), 0)
    value = gather_rows_plain(values, safe).to(torch.float32)
    snames = sorted(slots)
    row_slots = {n: gather_rows_plain(slots[n], safe) for n in snames}
    new_value, new_slots = opt.update(value, row_slots, grad_u, res.counts,
                                      step, lr)
    if values.dtype == torch.bfloat16:
        rows = stochastic_round_plain(new_value, sr_bits_rows(seed, res.uids, D))
    else:
        rows = new_value.to(values.dtype)
    t = torch.arange(T, device=values.device)[:, None].expand_as(safe)
    tk, sk = t[ok], safe[ok].long()
    values[tk, sk] = rows[ok]
    for n in snames:
        slots[n][tk, sk] = new_slots[n][ok].to(slots[n].dtype)
    return values, slots


def fused_sparse_backward_plain(values, slots, grad_out, ids, res, opt, *,
                                combiner: str = "sum", step=0, lr=None,
                                seed=0, grad_averaging: bool = False):
    """Plain PyTorch version of `fused_sparse_backward`, IN PLACE. The CPU
    path and the on-card comparison use it."""
    from deeprec_tpu_torch.optim.sparse import _f32

    _check_backward(values, slots, grad_out, ids, res, opt)
    lr = _f32(opt.lr if lr is None else lr, values)
    return _backward_plain(values, slots, _prescale(grad_out, ids, combiner),
                           ids, res, opt, lr, int(step), seed, grad_averaging)


def fused_sparse_backward(values: torch.Tensor, slots: Dict[str, torch.Tensor],
                          grad_out: torch.Tensor, ids: torch.Tensor,
                          res: FusedBags, opt, *, combiner: str = "sum",
                          step=0, lr=None, seed=0,
                          grad_averaging: bool = False,
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-pass backward: segment-sum the per-bag gradients to unique
    rows and apply the optimizer's row function, fused into the write-back.

    values [T, C, D]; slots {name: [T, C, D] f32} (a fusable optimizer's
    row slots; any other layout raises ValueError); grad_out [T, B, D]
    w.r.t. the forward's `out`; ids and res from the matching forward.
    Updates values and slots IN PLACE (the port's counterpart of the TPU
    kernel's input/output aliasing) and returns them. bf16 tables round
    stochastically with `sr_bits_rows(seed, uids)`. The sentinel and
    unclaimed slots (uids < 0) are never written."""
    from deeprec_tpu_torch.optim.sparse import _bias_corrected_lr, _f32

    _check_backward(values, slots, grad_out, ids, res, opt)
    dev = values.device
    lr = _f32(opt.lr if lr is None else lr, values)
    # the combiner's scaling, shared by both paths (see _bag_denominator)
    gs = _prescale(grad_out, ids, combiner)
    if dev.type == "cpu":
        return _backward_plain(values, slots, gs, ids, res, opt, lr, int(step),
                               seed, grad_averaging)
    tensors = [values, grad_out, ids, res.uids, res.inverse, res.counts,
               *slots.values()]
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("fused_sparse_backward: every tensor must be on "
                         f"{dev}")
    if not values.is_contiguous() or not all(s.is_contiguous()
                                             for s in slots.values()):
        raise ValueError("fused_sparse_backward: values and slots must be "
                         "contiguous")
    code = _OPT_CODES.get(type(opt).__name__)
    if code is None or set(_OPT_SLOTS[code]) != set(slots):
        raise NotImplementedError(
            f"fused_sparse_backward: no fused row function for "
            f"{type(opt).__name__} with slots {sorted(slots)}")
    T, C, D = values.shape
    _, B, L = ids.shape
    U = res.uids.shape[1]
    if T * U == 0 or B * L == 0:
        return values, slots
    # the per-call scalar factors, computed on the device by the same torch
    # expressions the plain version evaluates: lr, Adam's bias-corrected lr
    # and AdamW's lr * weight_decay
    alpha = lrwd = lr
    if code in (2, 3):
        alpha = _bias_corrected_lr(lr, opt.beta1, opt.beta2, int(step) + 1, lr)
    if code == 3:
        lrwd = lr * opt.weight_decay
    scal = torch.stack([lr, alpha, lrwd]).contiguous()
    hyper = [float(getattr(opt, a, 0.0)) for a in ("beta1", "beta2", "epsilon")]
    b1, b2, eps = hyper
    if code == 4:
        p, l2x2, l1 = -opt.learning_rate_power, 2.0 * opt.l2, opt.l1
    else:
        p = l2x2 = l1 = 0.0
    # the three launches' workspace, sized by the library
    # (csrc/fused_sparse_backward.cu)
    from deeprec_tpu_torch.ops import _build

    size = _build.load("fused_sparse_backward").fused_sparse_backward_workspace(
        T, B, L, D, U)
    work = torch.empty((size,), dtype=torch.int32, device=dev)
    sl = [slots[n] for n in _OPT_SLOTS[code]]
    gs = gs.contiguous()
    flat, inverse, uids, counts = (x.to(torch.int32).contiguous() for x in (
        ids, res.inverse, res.uids, res.counts))
    _launch("fused_sparse_backward", values, values.data_ptr(),
            sl[0].data_ptr() if sl else None,
            sl[1].data_ptr() if len(sl) > 1 else None,
            gs.data_ptr(), flat.data_ptr(), inverse.data_ptr(), uids.data_ptr(),
            counts.data_ptr(), scal.data_ptr(),
            work.data_ptr(), T, B, L, C, D, U, code,
            b1, 1.0 - b1, b2, 1.0 - b2, eps, p, l2x2, l1,
            int(seed) & 0xFFFFFFFF, int(bool(grad_averaging)),
            int(values.dtype == torch.bfloat16))
    fused_sparse_backward.launches += 1
    return values, slots


fused_sparse_backward.launches = 0
