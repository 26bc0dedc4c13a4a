"""Row gather and row scatter of the embedding tables — the port of the
Pallas kernels `deeprec_tpu/ops/fused_lookup.py::gather_rows` (#3) and
`::apply_rows_sr` (#5).

Each wrapper launches its hand-written kernel for a CUDA tensor
(`csrc/gather_rows.cu`, `csrc/apply_rows_sr.cu`, built by `ops/_build.py`
at first use) and counts the launch in `<wrapper>.launches`; for a CPU
tensor it runs its plain PyTorch version. Nothing falls back: a failed
build or launch raises. The other TPU kernels of `fused_lookup.py` wait for
later slices (ROADMAP.md, queue B).

Stochastic rounding: the port cannot reproduce `jax.random`'s threefry
stream, so its random bits are its own (`sr_bits`, a counter hash of
(seed, element index) on the device). The bits reach the kernel as a
tensor, so the kernel and `apply_rows_sr_plain` round identically given
the same bits — and so does the JAX package given its own bits.
"""
from __future__ import annotations

import math

import torch

from deeprec_tpu_torch.utils import hashing

_DTYPES = (torch.float32, torch.bfloat16)
_SR_SALT = 0x5EED


def _launch(name: str, tensor: torch.Tensor, *args) -> None:
    """Run kernel `name`'s launcher on the current stream of `tensor`'s
    device; raise on any CUDA error code."""
    from deeprec_tpu_torch.ops import _build

    lib = _build.load(name)
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


# ------------------------------------------------------------- row gather


def gather_rows_plain(values: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: out[t, i] = values[t, clip(ix[t, i], 0, C-1)]
    over a stacked table values [T, C, D], ix [T, n] -> [T, n, D]. The CPU
    tests and the on-card comparison use it; the CUDA path never does."""
    C = values.shape[-2]
    safe = ix.long().clamp(0, C - 1)
    t = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[t, safe]


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
    return out


gather_rows.launches = 0


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
    return values


apply_rows_sr.launches = 0
