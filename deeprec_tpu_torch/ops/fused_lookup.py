"""Row gather of the serving lookup — the port of the Pallas kernel
`deeprec_tpu/ops/fused_lookup.py::gather_rows`.

`gather_rows` is the wrapper: for a CUDA tensor it launches the
hand-written kernel in `csrc/gather_rows.cu` (built by `ops/_build.py` at
first use) and counts the launch in `gather_rows.launches`; for a CPU
tensor it runs `gather_rows_plain`. Nothing falls back: a failed build or
launch raises. The other TPU kernels of `fused_lookup.py` wait for later
slices (ROADMAP.md, queue B).
"""
from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16)


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
    from deeprec_tpu_torch.ops import _build

    lib = _build.load("gather_rows")
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gather_rows_launch(
            values.data_ptr(), ix.data_ptr(), out.data_ptr(),
            T, C, n, D * values.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows: CUDA launch failed (cudaError {err})")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
