"""Byte accounting of the embedding engine — the port holds the serving
residency model of `deeprec_tpu/ops/traffic.py`, which
`Predictor.residency_info` compares its measured bytes with, and the
retrieval sweep's, which `RetrievalEngine.sweep_info` does. The rest of
the JAX traffic model belongs to ROADMAP queue A items 2 (the train-step
gathers and scatters, the benchmark's byte models) and 6 (the exchange
wire bytes)."""
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
