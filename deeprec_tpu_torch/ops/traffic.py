"""Byte accounting of the embedding engine — the port holds only the
serving residency model of `deeprec_tpu/ops/traffic.py`, which
`Predictor.residency_info` compares its measured bytes with. The rest of
the JAX traffic model (train-step gathers and scatters, exchange wire
bytes) belongs to ROADMAP queue A item 8."""
from __future__ import annotations


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
