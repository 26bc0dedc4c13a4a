#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeprec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     started together);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at the main paths' shape (26 tables x 2^20 slots x 128, 2048 ids per
     table) and at edge shapes, with its time, the plain version's time,
     one PyTorch library call's time and the memory-bound least time:
     `gather_rows` (row gather, f32 and bf16), `apply_rows_sr` (row
     scatter, f32 and bf16 given the same random bits, the whole table
     compared) and `fused_gather_combine` (#4, pooled bags: one 2^20 x 128
     f32 table, batch 2048 of L = 100 zipf(1.2) ids, 5 % pads, mean
     weights, against embedding_bag; edge shapes in f32 and bf16, D 128,
     16, 12 and 7, sum, mean and sqrtn weights);
  4. the serving main path at full width: MLPerf DLRM-DCN (emb_dim 128,
     26 x 2^20-slot tables, bottom 512-256-128, top 512-256-1, cross depth
     3) restored from a full checkpoint written with numpy from --seed
     (2^17 live keys per table), answering 5 requests of batch 2048 and one
     each of batch 1 and 37 (ids 90% live, 5% unseen, 5% pad). Live ids must
     return their checkpoint row bit for bit, unseen ids the blocked default,
     probabilities must be finite in (0, 1), and every kernel of the path
     must have launched during those requests (one gather and 26 #4
     launches per request); then multi-hot requests to the same Predictor:
     bags of the MLPerf multi-hot sizes padded with -1 to L = 100 (5 of
     batch 2048, one of 1, one of 37), 26 #4 launches per request, 64 bags
     of every feature bit-exact against a numpy recomputation, #4 against
     its plain version at the L = 100 feature's own rows and bags, p50,
     p90 and a profile;
  5. the same model at capacity 2^12 restored on the card and on the CPU,
     answering one batch and one multi-hot batch within PROB_ATOL;
  6. the training main path at full width: the same model from empty
     tables, Adagrad(0.05) on the tables and Adam(1e-3) on the dense
     parameters, batch 2048 of SyntheticCriteo(vocab=1_000_000) staged on
     the card; 5 checked steps (finite losses, no failed insert, table sizes
     equal to the distinct ids seen, rows the step's batch does not hold
     unchanged across it, every kernel of the path launched as the bundles
     imply), then 30 timed steps and 3 profiled ones; the trained state is
     saved and served back by Predictor bit for bit;
  7. the same widths at capacity 2^12 and batch 256 from one initial state,
     3 train steps on the card and 3 on the CPU, within TRAIN_RTOL and
     ROW_ATOL;
  8. the fused bag step at full width: 26 tables of 2^20 x 128 f32 with
     Adagrad(0.05), stacked by bag length (the MLPerf DLRM-DCNv2
     multi-hot sizes: 12 groups), batch 2048 of zipf(1.2) ids over 10^6
     with 10 % pads in multi-hot bags; each step runs, per group, the train
     lookup, row_ix = slot_ix[inverse], bag_forward (kernel #6),
     g = out * 0.25 + 1 and apply_bag_gradients (kernel #7). 5 checked
     steps (launch counts, finite bags and rows), 20 timed, 3 profiled;
     then on copies of the L = 100 and L = 1 groups (and a bf16 copy of one
     table, and a head-heavy bag matrix: one row in all 2048 x 100
     positions) both kernels bit for bit against their plain versions,
     rows off the batch unchanged, and a tight budget whose overflow both
     count alike and whose out-of-budget positions add nothing; the device
     operations of one #6 and one #7 call at the L = 100 and L = 1 groups
     (torch.profiler; at most 3 and 5); per-step device times of both
     kernels, their plain versions and embedding_bag;
  9. DLRM-DCN training with Trainer(unique_budget="auto"): 5 steps,
     update_budgets, 5 steps at the measured budget, no overflow;
 10. the flash attention kernels (forward #8; backward #9, a dK/dV and a dQ
     launch) against their plain versions on the card at BST's attention
     shape [2048, 4, 256, 8] (masks of SyntheticBehaviorSequence histories
     plus the target, padded to 256) and at FLASH_SHAPES (causal, blocks 64
     and 128, dead rows, Dh 64, a padded Dh), o and lse within 1e-5
     relative and the gradients within 1e-4 of their largest (bf16
     q, k, v at [2, 2, 256, 32]: one bf16 ulp more); at BST's
     shape the device times of both, their plain versions and
     scaled_dot_product_attention (forward and backward), and the bounds;
 11. BST with use_flash=True as modelzoo/bst/train.py runs it (emb 16,
     3 tables of 2^20 slots, two of them shared by the histories, heads 4,
     ff 128, hidden 256-64, Adagrad 0.2 + Adam 1e-3), histories of 200,
     batch 2048 of SyntheticBehaviorSequence(vocab=100_000): 5 checked
     steps (finite losses, no failed insert, table sizes, rows off the
     batch unchanged, one launch each of flash fwd, dK/dV and dQ and the
     gather/scatter launches the bundles imply per step), 30 timed, 3
     profiled, on to 300 steps; held-out AUC over 8 batches at step 0 and
     step 300, at least 0.60 at the end; card vs CPU at capacity 2^12
     (bst_agreement);
 12. the phase-11 state saved and served by Predictor: 30 requests of
     batch 2048 and one each of batch 1 and 37, every answer equal to
     Trainer.eval_step's on the trained state bit for bit, one flash
     forward and three #4 launches per request; p50 and p90;
 13. WDL, DeepFM, DCN, DCNv2, MaskNet and DIN at the modelzoo's widths
     (emb 16, 2^20 slots per table, batch 2048; Criteo vocab 10^6, DIN
     histories of 50 over vocab 10^5): 5 checked steps (finite losses, no
     failed insert, the gather and scatter launches the bundles imply), 20
     timed, on to 300; held-out AUC at least 0.60; the state saved and
     served by Predictor, 5 requests equal to eval_step bit for bit with
     26 (DIN: 3) #4 launches per request.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when a
phase fails, when CUDA is absent, or when the package is missing.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# CUDA vs CPU probabilities: same bf16-operand / f32-accumulate math, but
# the f32 sums run in another order, and a 1-ulp difference before a bf16
# rounding flips that operand by 2^-8 relative. Width 3456 makes flips common.
PROB_ATOL = 1e-3
# CUDA vs CPU training, 3 steps: the same flips reach the loss (a mean over
# the batch) and the gradients; an Adagrad step is at most lr per element
# and a gradient difference of 1e-3 relative moves it by far less than
# ROW_ATOL; dense parameters move at most 2 lr per step apart under Adam.
TRAIN_RTOL = 1e-3
ROW_ATOL = 1e-4

FULL = dict(emb_dim=128, capacity=1 << 20, bottom=(512, 256, 128))
LIVE_KEYS = 1 << 17
SMALL_CAPACITY, SMALL_LIVE = 1 << 12, 1500
TRAIN = dict(batch=2048, vocab=1_000_000, checked=5, timed=30, profiled=3,
             lr=0.05, dense_lr=1e-3, agree_batch=256, sample=4096)


def _ms(fn, dev, reps=50, warm=3):
    """(device ms, call ms) of fn() after `warm` calls. Device: the summed
    duration of the kernels one call launches, from torch.profiler over
    `reps` calls, the larger of two such windows (the profiler now and then
    drops a window's kernels). Call: CUDA events around `reps` back-to-back
    calls, which times the host's launch interval wherever that is longer
    than the kernels (a wrapper's Python checks and a ctypes launch take
    tens of microseconds). (None, None) off the card: a CPU rehearsal
    measures nothing."""
    if dev.type != "cuda":
        return None, None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    call = a.elapsed_time(b) / reps
    busy_us = 0.0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = max(busy_us, sum(e.self_device_time_total for e in prof.key_averages()
                                   if getattr(e, "device_type", None) == DeviceType.CUDA))
    return busy_us / reps / 1e3, call


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _cycled_ms(fn, args, dev, reps=50):
    """_ms of fn over a cycle of argument tuples."""
    it = itertools.cycle(args)
    return _ms(lambda: fn(*next(it)), dev, reps=reps)


def _timed_record(rec, label, kernel, plain, library):
    """Fill a kernel record's ms, plain_ms and library_ms with device times
    from ((device, call) ms pairs), and print the per-call times beside
    them."""
    rec.update(ms=kernel[0], plain_ms=plain[0], library_ms=library[0])
    print(f"{label} timing, device ms (per-call ms): kernel {kernel[0]} "
          f"({kernel[1]}), plain {plain[0]} ({plain[1]}), library "
          f"{library[0]} ({library[1]}), byte bound {rec['bound_ms']}")
    return rec


# bf16 launches of #3 and #5 on the main paths, read by `_row_counts`:
# they are the launches of #1 and #2, whose work is those kernels' bf16
# branches on this card.
PAIR_LAUNCHES = {"gather_rows": 0, "apply_rows_sr": 0}


def _zero_row_counts():
    """Zero the launch counts of #3 and #5, their bf16 branches' too, just
    before a main path."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    for k in (gather_rows, apply_rows_sr):
        k.launches = k.launches_bf16 = 0


def _row_counts():
    """(apply_rows_sr, gather_rows) launches just after a main path; the
    bf16 ones among them are added to PAIR_LAUNCHES."""
    from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows

    for k in (gather_rows, apply_rows_sr):
        PAIR_LAUNCHES[k.__name__] += k.launches_bf16
    return apply_rows_sr.launches, gather_rows.launches


# ------------------------------------------------------------ phase 3


def kernel_phase(dev, main_shape, edge_shapes, seed):
    """gather_rows against its plain version; returns the kernel records
    {dtype: record}, timed at the main shape: f32, the table dtype of the
    main paths (#3), and bf16, the branch that stands for the TPU's
    pair-granule gather (#1)."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    records = {}
    for T, C, D, n in [main_shape] + list(edge_shapes):
        values32 = torch.randn((T, C, D), generator=g, device=dev)
        ix = torch.randint(-8, C + 8, (T, n), generator=g, device=dev,
                           dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            values = values32 if dtype == torch.float32 else values32.to(dtype)
            got, want = gather_rows(values, ix), gather_rows_plain(values, ix)
            _sync(dev)
            if got.shape != (T, n, D) or not torch.equal(got, want):
                raise AssertionError(
                    f"gather_rows {dtype} T={T} C={C} D={D} n={n}: kernel "
                    "differs from the plain version")
            err = float((got.float() - want.float()).abs().max())
            print(f"gather_rows {str(dtype)[6:]} T={T} C={C} D={D} n={n}: "
                  f"bit-exact (max_abs_err {err})")
            if (T, C, D, n) == tuple(main_shape):
                records[dtype] = time_gather(values, n, g, err)
            del values
        del values32, ix
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return records


def time_gather(values, n, g, err, sets=8):
    """The kernel record at one shape: the kernel, its plain version and
    torch.index_select timed over `sets` index sets in turn, so the rows
    one call reads were not read by the call before (8 sets of 26 x 2048
    rows of 512 B span 218 MB, past the 50 MB L2). The bound counts the
    distinct rows each set reads, its indices and the rows written."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    T, C, D = values.shape
    dev = values.device
    ixs = [torch.randint(0, C, (T, n), generator=g, device=dev, dtype=torch.int32)
           for _ in range(sets)]
    flat = values.view(T * C, D)
    gidx = [(torch.arange(T, device=dev)[:, None] * C + ix.long()).flatten()
            for ix in ixs]
    row = D * values.element_size()
    moved = sum(int(torch.unique(gi).numel()) * row + T * n * (row + 4)
                for gi in gidx) / sets
    bf16 = values.dtype == torch.bfloat16
    rec = {
        "name": "gather_rows_pair" if bf16 else "gather_rows", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/gather_rows.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:" + ("204" if bf16 else "367"),
        "launches": 0, "max_abs_err": err,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    return _timed_record(
        rec, f"gather_rows {str(values.dtype)[6:]}", _cycled_ms(gather_rows, [(values, ix) for ix in ixs], dev),
        _cycled_ms(gather_rows_plain, [(values, ix) for ix in ixs], dev),
        _cycled_ms(torch.index_select, [(flat, 0, gi) for gi in gidx], dev))


def _scatter_inputs(T, C, D, U, g, dev, skip=0.05):
    """Unique slots per table (about `skip` of them -1) and f32 rows."""
    slot = torch.stack([torch.randperm(C, generator=g, device=dev)[:U]
                        for _ in range(T)]).to(torch.int32)
    drop = torch.rand((T, U), generator=g, device=dev) < skip
    slot = torch.where(drop, -1, slot)
    rows = torch.randn((T, U, D), generator=g, device=dev)
    return slot, rows


def scatter_phase(dev, main_shape, edge_shapes, seed):
    """apply_rows_sr against its plain version on the same input and bits:
    the whole table after the write, bit-exact in f32 and bf16. Returns the
    kernel records {dtype: record} timed at the main shape: f32 (#5) and
    bf16, the branch that stands for the TPU's pair-granule scatter (#2)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, apply_rows_sr_plain, sr_bits)

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    records = {}
    for T, C, D, U in [main_shape] + list(edge_shapes):
        slot, rows = _scatter_inputs(T, C, D, U, g, dev)
        values32 = torch.randn((T, C, D), generator=g, device=dev)
        for dtype in (torch.bfloat16, torch.float32):  # f32 last: it writes values32
            bits = sr_bits(seed, (T, U, D), dev) if dtype == torch.bfloat16 else None
            want = values32.to(dtype, copy=True)
            apply_rows_sr_plain(want, slot, rows, bits)
            got = values32 if dtype == torch.float32 else values32.to(dtype)
            apply_rows_sr(got, slot, rows, bits=bits)
            _sync(dev)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"apply_rows_sr {dtype} T={T} C={C} D={D} U={U}: kernel "
                    "differs from the plain version")
            err = float((got.float() - want.float()).abs().max())
            print(f"apply_rows_sr {str(dtype)[6:]} T={T} C={C} D={D} U={U} "
                  f"({int((slot >= 0).sum())} rows written): whole table "
                  f"bit-exact (max_abs_err {err})")
            del want
            if (T, C, D, U) == tuple(main_shape):
                records[dtype] = time_scatter(got, U, g, err, seed)
            del got
        del values32, slot, rows
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return records


def time_scatter(values, U, g, err, seed, sets=8):
    """The kernel record at one shape: the kernel, its plain version and
    (f32) index_copy_ of the valid rows into the flattened table with
    pre-offset int64 indices, timed over `sets` slot sets in turn (8 sets
    of 26 x 2048 rows of 512 B read and written span 436 MB, past the 50 MB
    L2). The bound counts, per set, the rows written (read once from
    `rows` and, for bf16, one row of 4-byte bits each; written once) and
    every slot index."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        apply_rows_sr, apply_rows_sr_plain, sr_bits)

    T, C, D = values.shape
    dev = values.device
    bf16 = values.dtype == torch.bfloat16
    ins = [_scatter_inputs(T, C, D, U, g, dev) for _ in range(sets)]
    args = [(values, slot, rows, sr_bits(seed, (T, U, D), dev) if bf16 else None)
            for slot, rows in ins]
    moved = 0
    for slot, _ in ins:
        n = int((slot >= 0).sum())
        moved += n * D * (4 + values.element_size() + (4 if bf16 else 0)) + T * U * 4
    moved /= sets
    rec = {
        "name": "apply_rows_sr_pair" if bf16 else "apply_rows_sr", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/apply_rows_sr.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:" + ("278" if bf16 else "564"),
        "launches": 0, "max_abs_err": err,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    library = (None, None)
    if not bf16:  # no single PyTorch call rounds stochastically
        flat = values.view(T * C, D)
        lib = []
        for slot, rows in ins:
            ok = slot >= 0
            gi = (torch.arange(T, device=dev)[:, None] * C + slot.long())[ok]
            lib.append((0, gi, rows[ok]))
        library = _cycled_ms(flat.index_copy_, lib, dev)
    return _timed_record(
        rec, f"apply_rows_sr {str(values.dtype)[6:]}",
        _cycled_ms(lambda v, s, r, b: apply_rows_sr(v, s, r, bits=b), args, dev),
        _cycled_ms(apply_rows_sr_plain, args, dev), library)


# ------------------------------------------------------------ phase 3: #4

# Kernel #4 at the use the JAX docstring names, bags pooled straight out of
# a full table: one 2^20 x 128 f32 table, batch 2048 of L = 100 zipf(1.2)
# ids over 10^6 mapped to rows by a random permutation, 5 % pads, mean
# weights; `sets` index sets (each with its own permutation) timed in turn,
# so one call's rows were not read by the call before. The edge shapes
# (C, D, B, L, dtype), each under sum, mean and sqrtn weights with a bag of
# pads only and rows past the table: B = 37, L = 1, bf16 at D 128 and 16,
# f32 at the modelzoo's D 16, D 12 (three 16-byte vectors a row) and D 7
# (the scalar path).
COMBINE = dict(capacity=1 << 20, dim=128, batch=2048, L=100, vocab=1_000_000,
               zipf=1.2, pad=0.05, sets=4)
COMBINE_EDGES = [(4096, 128, 37, 100, torch.float32), (4096, 128, 2048, 1, torch.float32),
                 (4096, 128, 64, 8, torch.bfloat16), (4096, 16, 64, 8, torch.bfloat16),
                 (4096, 16, 2048, 20, torch.float32), (1000, 12, 37, 9, torch.float32),
                 (1000, 7, 37, 9, torch.float32)]


def combine_weights(row_ix, combiner):
    """The combiner's per-position weights [B, L] of the read-only path
    (`combiners.pooled_operands`) for rows `row_ix`, < 0 at pads."""
    from deeprec_tpu_torch.embedding.combiners import pooled_operands

    return pooled_operands(row_ix, row_ix >= 0, combiner)[1]


def compare_combine(values, row_ix, w, what):
    """Kernel #4 against its plain version on the same inputs, bit for bit.
    Returns the max abs error (0)."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_plain)

    got = fused_gather_combine(values, row_ix, w)
    want = fused_gather_combine_plain(values, row_ix, w)
    _sync(values.device)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"fused_gather_combine {what}: kernel differs from the "
                             "plain version")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"fused_gather_combine {what}: bit-exact (max_abs_err {err})")
    return err


def _zipf_rows(rng, cfg, perm, dev):
    """[B, L] int32 rows: zipf ids over `vocab` through the permutation
    `perm` of the table's rows, about `pad` of them -1."""
    from deeprec_tpu_torch.data.synthetic import zipf_ids

    ids = zipf_ids(rng, cfg["vocab"], cfg["zipf"], (cfg["batch"], cfg["L"]))
    rows = perm[torch.from_numpy(ids).to(dev)].to(torch.int32)
    pad = torch.from_numpy(rng.random(ids.shape) < cfg["pad"]).to(dev)
    return torch.where(pad, -1, rows)


def combine_phase(dev, seed, cfg=COMBINE, edges=COMBINE_EDGES):
    """Kernel #4 against its plain version at the edge shapes and at the
    main shape; at the main shape the device times of the kernel, its plain
    version and embedding_bag (clamped rows, the weights as
    per_sample_weights, 0 at pads), and the byte bound. Returns the kernel
    record."""
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_gather_combine, fused_gather_combine_plain)

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    rng = np.random.default_rng(seed + 31)
    err = 0.0
    for C, D, B, L, dtype in edges:
        values = torch.randn((C, D), generator=g, device=dev).to(dtype)
        row_ix = torch.randint(-1, C + 3, (B, L), generator=g, device=dev,
                               dtype=torch.int32)
        row_ix[min(1, B - 1)] = -1  # a bag of pads only
        for combiner in ("sum", "mean", "sqrtn"):
            err = max(err, compare_combine(
                values, row_ix, combine_weights(row_ix, combiner),
                f"C={C} D={D} B={B} L={L} {str(dtype)[6:]} {combiner}"))
    C, D, B, L = cfg["capacity"], cfg["dim"], cfg["batch"], cfg["L"]
    values = torch.randn((C, D), generator=g, device=dev)
    sets = []
    for _ in range(cfg["sets"]):
        row_ix = _zipf_rows(rng, cfg, torch.randperm(C, generator=g, device=dev), dev)
        sets.append((row_ix, combine_weights(row_ix, "mean")))
    err = max(err, compare_combine(values, *sets[0],
                                   f"main shape C={C} D={D} B={B} L={L} mean"))
    # the bound by the table's rule: each distinct row read once, 8 bytes of
    # row_ix and weight per position, out written once; and, beside it, the
    # figure with every non-pad position's row read
    moved = per_position = 0
    for row_ix, _ in sets:
        live = row_ix[row_ix >= 0]
        fixed = row_ix.numel() * 8 + B * D * 4
        moved += int(torch.unique(live).numel()) * D * 4 + fixed
        per_position += int(live.numel()) * D * 4 + fixed
    moved, per_position = moved / len(sets), per_position / len(sets)
    rec = {"name": "fused_gather_combine", "route": "cuda",
           "source": "deeprec_tpu_torch/csrc/fused_gather_combine.cu",
           "replaces": "deeprec_tpu/ops/fused_lookup.py:441",
           "launches": 0, "max_abs_err": err,
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    print(f"fused_gather_combine main shape: {moved / 1e6:.3f} MB by the table's rule "
          f"(distinct rows), {per_position / 1e6:.3f} MB with every non-pad "
          f"position's row: bounds {rec['bound_ms']:.5f} / "
          f"{per_position / HBM_BYTES_PER_S * 1e3:.5f} ms at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    lib = [(row_ix.clamp(min=0), w) for row_ix, w in sets]
    _timed_record(
        rec, f"fused_gather_combine (C={C} D={D} B={B} L={L})",
        _cycled_ms(lambda ix, w: fused_gather_combine(values, ix, w), sets, dev),
        _cycled_ms(lambda ix, w: fused_gather_combine_plain(values, ix, w), sets, dev,
                   reps=4),
        _cycled_ms(lambda ix, w: torch.nn.functional.embedding_bag(
            ix, values, per_sample_weights=w, mode="sum"), lib, dev))
    del values, sets, lib
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"fused_gather_combine checks and timing took {time.perf_counter() - t0:.1f} s")
    return rec


# ------------------------------------------------------------ checkpoint


def write_checkpoint(model, path, live, seed):
    """A full checkpoint in the JAX format, data from numpy: `live` random
    keys per table with random rows, freqs and versions, and the model's
    own (seeded) dense weights. Returns {feature: (keys, values)}."""
    from deeprec_tpu_torch.nn import jax_leaf_names
    from deeprec_tpu_torch.training.checkpoint import table_file, write_full
    from deeprec_tpu_torch.training.trainer import build_bundles

    rng = np.random.default_rng(seed)
    host, files, bundles = {}, {}, {}
    for bname, b in build_bundles(model.features).items():
        bundles[bname] = [f.name for f in b.features]
        for k, f in enumerate(b.features):
            keys = np.unique(rng.integers(0, 1 << 30, 2 * live))[:live]
            keys = rng.permutation(keys).astype(np.int32)
            values = rng.standard_normal((live, b.table.cfg.dim), np.float32) * 0.05
            host[f.name] = (keys, values)
            files[table_file(bname, k if b.stacked else None)] = {
                "keys": keys, "values": values,
                "freqs": rng.integers(1, 100, live).astype(np.int32),
                "versions": rng.integers(0, 1000, live).astype(np.int32),
            }
    params = dict(model.named_parameters())
    leaves = [params[n].detach().numpy() for n in jax_leaf_names(model)]
    write_full(os.path.join(path, "full-1000"), 1000, files, leaves, bundles)
    return host


def make_batch(model, host, B, rng):
    """Ids 90% live, 5% never seen (>= 2^30, outside every key range), 5%
    pad (-1); dense features lognormal like Criteo counts."""
    batch = {}
    for f in model.features:
        if f.name in host:
            keys = host[f.name][0]
            ids = keys[rng.integers(0, len(keys), B)]
            u = rng.random(B)
            ids = np.where(u < 0.10, rng.integers(1 << 30, (1 << 31) - 1, B), ids)
            batch[f.name] = np.where(u < 0.05, -1, ids).astype(np.int32)
        else:
            batch[f.name] = rng.lognormal(0, 1, (B, f.width)).astype(np.float32)
    return batch


def check_rows(p, host, batch):
    """Through forward_views: live ids return their checkpoint row bit for
    bit; unseen and pad ids the blocked default. Returns the count of live
    positions checked."""
    dflt = p.model.features[0].table.ev.init.default_value_no_permission
    views, _ = p._trainer.forward_views(p._snap.state, p._device_batch(batch))
    checked = 0
    for name, (keys, values) in host.items():
        emb, inv, _ = views[name]
        got = emb[inv[:, 0].long()].float().cpu().numpy()
        ids = batch[name]
        order = np.argsort(keys)
        pos = np.searchsorted(keys[order], ids)
        pos = order[np.clip(pos, 0, len(keys) - 1)]
        live = keys[pos] == ids
        if not np.array_equal(got[live], values[pos[live]]):
            raise AssertionError(f"{name}: a live id did not return its checkpoint row")
        if not np.all(got[~live] == dflt):
            raise AssertionError(f"{name}: an unseen or pad id did not serve the default")
        checked += int(live.sum())
    return checked


def _per_request(trainer):
    """Launches of (gather_rows, fused_gather_combine) one read-only forward
    implies: a gather per lookup group (a stacked bundle at once, a shared
    table per feature) and a #4 launch per pooled feature."""
    return (sum(1 if b.stacked else len(b.features) for b in trainer.bundles.values()),
            sum(1 for f in trainer.sparse_specs if f.pooling != "none"))


def serve_phase(dev, model_kw, live, ckdir, seed, batches, timed):
    """Write a checkpoint, restore it through Predictor and answer
    `batches` on the main path, counting kernel launches; then time
    `timed` more requests of the first batch. Returns (predictor, first
    batch, stats, the checkpoint's {feature: (keys, rows)})."""
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.serving import Predictor

    model = DLRMDCN(**model_kw, seed=seed)
    t0 = time.perf_counter()
    host = write_checkpoint(model, ckdir, live, seed)
    write_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    p = Predictor(model, ckdir, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    reqs = [make_batch(model, host, B, rng) for B in batches]

    tables = [b.table for b in p._trainer.bundles.values()]
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    for t in tables:
        t.probe_syncs = 0
    for b in reqs:
        probs = p.predict(b)
        n = len(next(iter(b.values())))
        if probs.shape != (n,) or not np.all(np.isfinite(probs)) or not (
                np.all(probs > 0) and np.all(probs < 1)):
            raise AssertionError(f"batch {n}: probabilities not finite in (0, 1)")
    launches = _row_counts()[1]  # ... and ends here
    combines = fused_gather_combine.launches
    probe_syncs = sum(t.probe_syncs for t in tables) / len(reqs)
    per_request, pooled = _per_request(p._trainer)
    if dev.type == "cuda" and (launches, combines) != (per_request * len(reqs),
                                                       pooled * len(reqs)):
        raise AssertionError(
            f"(gather_rows, fused_gather_combine) launched {(launches, combines)} "
            f"times on the main path, the path implies "
            f"{(per_request * len(reqs), pooled * len(reqs))}")
    live_checked = check_rows(p, host, reqs[0])

    lat = []
    for _ in range(timed):
        t0 = time.perf_counter()
        p.predict(reqs[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    stats = {
        "write_s": write_s, "restore_s": restore_s, "launches": launches,
        "combine_launches": combines, "pooled": pooled,
        "requests": len(reqs), "launches_per_request": per_request,
        "live_ids_checked": live_checked, "probe_syncs": probe_syncs,
        "p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "p90_ms": float(np.percentile(lat, 90)) if lat else None,
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else None),
    }
    return p, reqs[0], stats, host


def profile_device(fn, reps):
    """Device kernel time by name over `reps` calls of fn() and the wall
    time they took. The first profiled window (CUPTI start-up) is
    discarded. Returns (wall_us per call, busy_us per call, kernels per
    call, [(device us per call, name, count per call)] by time, {phase
    range: (host us per call, device us per call)} of the `phase_*`
    ranges and of the autograd engine's backward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for n in (1, reps):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # A `phase_*` range appears twice: its host range (device type CPU,
    # whose device time sums the kernels launched inside it) and its span
    # on the device timeline, which is no kernel and is left out of the
    # busy time.
    rows = sorted((
        (e.self_device_time_total / reps, e.key, e.count // reps)
        for e in events
        if getattr(e, "device_type", None) == DeviceType.CUDA
        and not e.key.startswith("phase_")
    ), reverse=True)
    busy = sum(r[0] for r in rows)
    host = [e for e in events if getattr(e, "device_type", None) == DeviceType.CPU]
    phases = {e.key: (e.cpu_time_total / reps, e.device_time_total / reps)
              for e in host if e.key.startswith("phase_")}
    # The backward's kernels are launched by autograd's engine thread, so
    # they fall outside the main thread's `phase_dense_fwd_bwd` range.
    bwd = [e for e in host if e.key.startswith("autograd::engine::evaluate_function")]
    if bwd:
        phases["autograd_engine_backward"] = (
            sum(e.cpu_time_total for e in bwd) / reps,
            sum(e.device_time_total for e in bwd) / reps)
    return wall_us / reps, busy, sum(r[2] for r in rows), rows, phases


def profile_predict(p, batch, p50_ms, reps=5):
    """The share of wall time the device was idle over `reps` predicts: of
    the profiled wall time, and of the unprofiled p50 latency (the
    profiler slows the host, not the device)."""
    wall, busy, kernels, rows, _ = profile_device(lambda: p.predict(batch), reps)
    print(f"profile: {reps} predicts of batch {len(next(iter(batch.values())))}: "
          f"wall {wall / 1e3:.3f} ms/request, device busy "
          f"{busy / 1e3:.3f} ms/request, idle share "
          f"{1 - busy / wall:.3f} (of the p50 latency "
          f"{1 - busy / 1e3 / p50_ms:.3f}), {kernels} kernels/request")
    for dt, key, count in rows[:12]:
        print(f"profile:   {dt:10.1f} us/request  x{count:<4d} {key[:100]}")


# ------------------------------------------------------------ multi-hot serving

# Multi-hot requests to phase 4's Predictor: each of the 26 features gets
# bags of its MLPerf DLRM-DCNv2 `multi_hot_sizes` length (MULTI_HOT), padded
# with -1 to the longest, L = 100 (one stacked bundle needs one id shape);
# 5 requests of batch 2048, one of 1 and one of 37, 10 timed.
MULTI = dict(batch=2048, requests=5, timed=10, check_bags=64, profiled=3)


def make_multi_hot(model, host, B, rng, lengths=None):
    """[B, max(lengths)] ids per feature: within the feature's real length
    the ids of make_batch (90 % live, 5 % never seen, 5 % pad), -1 past it;
    dense features lognormal."""
    lengths = MULTI_HOT if lengths is None else lengths
    L, lengths = max(lengths), iter(lengths)
    batch = {}
    for f in model.features:
        if f.name not in host:
            batch[f.name] = rng.lognormal(0, 1, (B, f.width)).astype(np.float32)
            continue
        keys = host[f.name][0]
        ids = keys[rng.integers(0, len(keys), (B, L))]
        u = rng.random((B, L))
        ids = np.where(u < 0.10, rng.integers(1 << 30, (1 << 31) - 1, (B, L)), ids)
        ids = np.where(u < 0.05, -1, ids)
        real = np.arange(L)[None, :] < next(lengths)
        batch[f.name] = np.where(real, ids, -1).astype(np.int32)
    return batch


def check_pooled(p, host, batch, nbags):
    """The read-only forward's pooled inputs of the first `nbags` bags of
    every feature against numpy: the checkpoint row of each live id, the
    blocked default of an unseen one, pads skipped, summed in position order
    in f32 as out = out + w * row with w = 1/max(n, 1) (mean). Bit for bit.
    Returns the count of bags checked."""
    dflt = np.float32(p.model.features[0].table.ev.init.default_value_no_permission)
    trainer = p._trainer
    dbatch = p._device_batch(batch)
    views, _ = trainer.forward_views(p._snap.state, dbatch)
    inputs = trainer._build_inputs({n: v[0] for n, v in views.items()}, views, dbatch,
                                   read_only=True)
    checked = 0
    for name, (keys, values) in host.items():
        ids = batch[name][:nbags]
        order = np.argsort(keys)
        pos = order[np.clip(np.searchsorted(keys[order], ids), 0, len(keys) - 1)]
        rows = np.where((keys[pos] == ids)[..., None], values[pos], dflt)
        real = ids != -1
        w = np.float32(1) / np.maximum(real.sum(1), 1).astype(np.float32)
        want = np.zeros((len(ids), values.shape[1]), np.float32)
        for pos_l in range(ids.shape[1]):
            want = np.where(real[:, pos_l, None], want + w[:, None] * rows[:, pos_l], want)
        got = inputs.pooled[name][:nbags].cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"{name}: pooled bags differ from numpy by "
                                 f"{np.abs(got - want).max()}")
        checked += len(ids)
    return checked, views


def multi_hot_phase(dev, p, host, seed, cfg=MULTI):
    """Multi-hot serving at full width on phase 4's Predictor (see MULTI).
    Returns stats."""
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 41)
    B = cfg["batch"]
    reqs = [make_multi_hot(p.model, host, B, rng) for _ in range(cfg["requests"])]
    extra = make_multi_hot(p.model, host, 37, rng)
    reqs += [{k: a[:1] for k, a in reqs[0].items()}, extra]
    trainer = p._trainer
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    for b in reqs:
        probs = p.predict(b)
        n = len(next(iter(b.values())))
        if probs.shape != (n,) or not (np.all(np.isfinite(probs)) and np.all(probs > 0)
                                       and np.all(probs < 1)):
            raise AssertionError(f"multi-hot batch {n}: probabilities not finite in (0, 1)")
    launches = (_row_counts()[1], fused_gather_combine.launches)  # ... and ends here
    per_request = _per_request(trainer)
    want = tuple(len(reqs) * n for n in per_request)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"multi-hot serving launched (gather_rows, "
                             f"fused_gather_combine) {launches}, the path implies {want}")
    checked, views = check_pooled(p, host, reqs[0], cfg["check_bags"])
    # main shape (b): the L = 100 feature's unique rows and inverse
    name = f"C{MULTI_HOT.index(max(MULTI_HOT)) + 1}"
    emb, inv, mask = views[name]
    row_ix = torch.where(mask, inv.to(torch.int32), -1)
    err = compare_combine(emb, row_ix, combine_weights(row_ix, "mean"),
                          f"serving shape {name}: rows {tuple(emb.shape)}, "
                          f"bags {tuple(row_ix.shape)}")
    real = int((row_ix >= 0).sum())
    del views, emb, inv, mask, row_ix
    lat = []
    for _ in range(cfg["timed"]):
        t1 = time.perf_counter()
        p.predict(reqs[0])
        lat.append((time.perf_counter() - t1) * 1e3)
    stats = {"launches": launches, "per_request": per_request, "requests": len(reqs),
             "bags_checked": checked, "err": err, "ids": real,
             "p50_ms": float(np.percentile(lat, 50)),
             "p90_ms": float(np.percentile(lat, 90))}
    if dev.type == "cuda":
        wall, busy, kernels, rows, _ = profile_device(lambda: p.predict(reqs[0]),
                                                      cfg["profiled"])
        combine_us = sum(r[0] for r in rows if "gather_combine_kernel" in r[1])
        stats["profile"] = (wall, busy, kernels, rows, combine_us)
    stats["seconds"] = time.perf_counter() - t0
    return stats


# ------------------------------------------------------------ training


def _table_rows(ts, t, slots):
    """(values rows, accum rows) of table t at `slots`, copied."""
    return (ts.values[t, slots].clone(), ts.slots["accum"][t, slots].clone())


def _untouched_sample(trainer, state, batch, n, gen):
    """Per table (each member of a stacked bundle; a shared table once, for
    all its features): up to `n` resident slots whose key the batch does
    not hold, with their key, value and accum rows."""
    out = []
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        sentinel = torch.iinfo(ts.keys.dtype).min
        members = (list(enumerate([f] for f in b.features)) if b.stacked
                   else [(0, b.features)])
        for t, feats in members:
            ids = torch.cat([batch[f.name].flatten() for f in feats]).to(ts.keys.dtype)
            live = torch.nonzero(ts.keys[t] != sentinel).flatten()
            keep = live[~torch.isin(ts.keys[t, live], ids)]
            pick = keep[torch.randperm(keep.numel(), generator=gen)[:n].to(keep.device)]
            out.append((bname, t, pick, ts.keys[t, pick].clone(),
                        *_table_rows(ts, t, pick)))
    return out


def _check_untouched(state, sample):
    for bname, t, pick, keys, values, accum in sample:
        ts = state.tables[bname]
        now = _table_rows(ts, t, pick)
        if not (torch.equal(ts.keys[t, pick], keys) and torch.equal(now[0], values)
                and torch.equal(now[1], accum)):
            raise AssertionError(
                f"{bname}[{t}]: a row the step's batch does not hold changed")
    return sum(s[2].numel() for s in sample)


def _path_launches(trainer):
    """Launches of (apply_rows_sr, gather_rows) one train step implies:
    per lookup group, the initializer scatter, the value write-back and one
    write-back per per-row slot; the forward gather, one gather per per-row
    slot, and a value re-gather where the apply cannot reuse the lookup's
    rows (shared tables)."""
    from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX

    nslots = sum(1 for name in trainer.sparse_opt.slot_specs(1)
                 if not name.startswith(SCALAR_PREFIX))
    apply = gather = 0
    for b in trainer.bundles.values():
        groups = 1 if b.stacked else len(b.features)
        reuse = b.stacked or len(b.features) == 1
        apply += groups * (2 + nslots)
        gather += groups * (1 + nslots + (0 if reuse else 1))
    return apply, gather


def train_phase(dev, model_kw, ckdir, seed, cfg):
    """The training main path at full width (see the module docstring).
    Returns stats."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    model = DLRMDCN(**model_kw, seed=seed)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init()
    _sync(dev)
    init_s = time.perf_counter() - t0
    # the profiler discards its first window: one more batch for it
    nsteps = cfg["checked"] + cfg["timed"] + cfg["profiled"] + 1
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    host = [gen.batch() for _ in range(nsteps)]
    staged = [trainer.device_batch(b) for b in host]  # inputs on the device
    _sync(dev)
    tables = [b.table for b in trainer.bundles.values()]
    cpu_gen = torch.Generator().manual_seed(seed)

    _zero_row_counts()  # the main path starts here
    for t in tables:
        t.probe_syncs = 0
    losses, untouched = [], 0
    for i in range(cfg["checked"]):
        sample = (_untouched_sample(trainer, state, staged[i], cfg["sample"], cpu_gen)
                  if i else [])
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
        untouched += _check_untouched(state, sample)
    launches = _row_counts()  # ... and ends here
    probe_syncs = sum(t.probe_syncs for t in tables) / cfg["checked"]
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and launches != tuple(cfg["checked"] * n for n in per_step):
        raise AssertionError(
            f"train path launched (apply_rows_sr, gather_rows) {launches}, the "
            f"bundles imply {tuple(cfg['checked'] * n for n in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{fails} ids failed to insert")
    for bname, b in trainer.bundles.items():
        size = b.table.size(state.tables[bname]).cpu().numpy()
        want = [len(np.unique(np.concatenate([h[f.name] for h in host[:cfg["checked"]]])))
                for f in b.features]
        if not np.array_equal(size, want):
            raise AssertionError(f"{bname}: table sizes {size}, distinct ids {want}")

    _sync(dev)
    t0 = time.perf_counter()
    for i in range(cfg["checked"], cfg["checked"] + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t0
    losses.append(float(m["loss"]))
    stats = {
        "init_s": init_s, "losses": losses, "launches": launches,
        "per_step": per_step, "probe_syncs_per_step": probe_syncs,
        "untouched_rows_checked": untouched,
        "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s,
        "step_ms": timed_s / cfg["timed"] * 1e3,
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else None),
    }
    if dev.type == "cuda":
        box = [state]
        nxt = iter(staged[cfg["checked"] + cfg["timed"]:])

        def step():
            box[0] = trainer.train_step(box[0], next(nxt))[0]

        stats["profile"] = profile_device(step, cfg["profiled"])
        state = box.pop()

    # the trained rows, served back through a checkpoint and Predictor
    served = {}
    for bname, b in trainer.bundles.items():
        ts = state.tables[bname]
        for t, f in enumerate(b.features):
            live = torch.nonzero(ts.keys[t] != torch.iinfo(ts.keys.dtype).min).flatten()
            pick = live[torch.randperm(live.numel(), generator=cpu_gen)[:cfg["sample"]]
                        .to(live.device)]
            served[f.name] = (ts.keys[t, pick].cpu().numpy(),
                              ts.values[t, pick].float().cpu().numpy())
    t0 = time.perf_counter()
    CheckpointManager(ckdir, trainer).save(state)
    stats["save_s"] = time.perf_counter() - t0
    del state, staged, trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    p = Predictor(model, ckdir, device=dev)
    n = min(len(k) for k, _ in served.values())
    rng = np.random.default_rng(seed + 2)
    req = {f.name: rng.lognormal(0, 1, (n, f.width)).astype(np.float32)
           for f in model.features if f.name not in served}
    req.update({name: keys[:n] for name, (keys, _) in served.items()})
    stats["served_checked"] = check_rows(
        p, {name: (k[:n], v[:n]) for name, (k, v) in served.items()}, req)
    return stats


def _copy_state(state, dev):
    """A deep copy of a TrainState on `dev`."""
    import copy

    from deeprec_tpu_torch.optim.dense import AdamState

    out = copy.copy(state)
    out.tables = {
        b: type(ts)(**{
            k: ({n: a.to(dev, copy=True) for n, a in v.items()}
                if isinstance(v, dict) else v.to(dev, copy=True))
            for k, v in vars(ts).items()})
        for b, ts in state.tables.items()
    }
    out.dense = {n: p.to(dev, copy=True) for n, p in state.dense.items()}
    o = state.opt_state
    out.opt_state = AdamState(
        count=o.count.to(dev, copy=True),
        mu={n: a.to(dev, copy=True) for n, a in o.mu.items()},
        nu={n: a.to(dev, copy=True) for n, a in o.nu.items()})
    return out


def train_agreement(dev, model, gen, cfg, steps=3):
    """One initial state of `model` made on the CPU and copied to `dev`;
    `steps` train steps on each, on batches of `gen`; returns (max loss
    relative difference, max row difference, max dense difference, rows
    compared)."""
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    trainers = {d: Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=d)
                for d in ("cpu", dev)}
    states = {"cpu": trainers["cpu"].init()}
    states[dev] = _copy_state(states["cpu"], dev)
    loss_diff = 0.0
    for _ in range(steps):
        b = gen.batch()
        ls = {}
        for d in ("cpu", dev):
            states[d], m = trainers[d].train_step(states[d], b)
            ls[d] = float(m["loss"])
        loss_diff = max(loss_diff, abs(ls[dev] - ls["cpu"]) / abs(ls["cpu"]))
    row_diff, compared = 0.0, 0
    for bname, ts in states["cpu"].tables.items():
        tsd = states[dev].tables[bname]
        for t in range(ts.keys.shape[0]):
            rows = {}
            for side, s in (("cpu", ts), ("dev", tsd)):
                keys = s.keys[t].cpu().numpy()
                live = np.nonzero(keys != np.iinfo(keys.dtype).min)[0]
                v = s.values[t].float().cpu().numpy()[live]
                a = s.slots["accum"][t].cpu().numpy()[live]
                rows[side] = dict(zip(keys[live].tolist(), zip(v, a)))
            if rows["cpu"].keys() != rows["dev"].keys():
                raise AssertionError(f"{bname}[{t}]: card and CPU hold other keys")
            for k, (v, a) in rows["cpu"].items():
                dv, da = rows["dev"][k]
                row_diff = max(row_diff, float(np.abs(dv - v).max()),
                               float(np.abs(da - a).max()))
            compared += len(rows["cpu"])
    dense_diff = max(float((states[dev].dense[n].cpu() - p).abs().max())
                     for n, p in states["cpu"].dense.items())
    return loss_diff, row_diff, dense_diff, compared


def run_training(dev, full, small, ckroot, seed, cfg):
    """Phases 6 and 7. Returns the training stats."""
    st = train_phase(dev, full, os.path.join(ckroot, "train"), seed, cfg)
    apply_n, gather_n = st["launches"]
    losses = st["losses"]
    print(f"training: DLRM-DCN {full} from empty tables (init {st['init_s']:.2f} s), "
          f"batch {cfg['batch']}: {cfg['checked']} checked steps launched "
          f"apply_rows_sr {apply_n} and gather_rows {gather_n} times "
          f"({st['per_step'][0]} and {st['per_step'][1]} per step), "
          f"{st['untouched_rows_checked']} untouched rows unchanged, "
          f"{st['served_checked']} trained ids served back bit for bit "
          f"(checkpoint saved in {st['save_s']:.2f} s)")
    print(f"training: {st['examples_per_s']:.1f} examples/s over {cfg['timed']} "
          f"timed steps ({st['step_ms']:.3f} ms/step); loss step 1 {losses[0]:.6f}, "
          f"step {cfg['checked']} {losses[cfg['checked'] - 1]:.6f}, step "
          f"{cfg['checked'] + cfg['timed']} {losses[-1]:.6f}; peak device memory "
          f"{st['peak_gb']} GB; probe loop {st['probe_syncs_per_step']:.1f} host "
          f"syncs per step")
    if "profile" in st:
        wall, busy, kernels, rows, phases = st["profile"]
        print(f"profile: {cfg['profiled']} train steps of batch {cfg['batch']}: "
              f"wall {wall / 1e3:.3f} ms/step, device busy {busy / 1e3:.3f} ms/step, "
              f"idle share {1 - busy / wall:.3f} (of the timed step "
              f"{1 - busy / 1e3 / st['step_ms']:.3f}), {kernels} kernels/step")
        for name, (host_us, dev_us) in phases.items():
            print(f"profile:   {name:22s} host {host_us / 1e3:8.3f} ms/step, "
                  f"device {dev_us / 1e3:8.3f} ms/step")
        for dt, key, count in rows[:14]:
            print(f"profile:   {dt:10.1f} us/step  x{count:<4d} {key[:100]}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN

    model = DLRMDCN(**small, seed=seed)
    loss_d, row_d, dense_d, n = train_agreement(
        dev, model, SyntheticCriteo(batch_size=cfg["agree_batch"], vocab=cfg["vocab"],
                                    seed=seed + 3, num_cat=model.num_cat,
                                    num_dense=model.num_dense), cfg)
    print(f"agreement: training at capacity {small['capacity']}, batch "
          f"{cfg['agree_batch']}, 3 steps on {dev.type} vs cpu: loss rel diff "
          f"{loss_d:.3g} (tolerance {TRAIN_RTOL}), max row diff {row_d:.3g} over "
          f"{n} keys (tolerance {ROW_ATOL}), max dense diff {dense_d:.3g} "
          f"(bound {6 * cfg['dense_lr']:.3g})")
    if loss_d > TRAIN_RTOL or row_d > ROW_ATOL or dense_d > 6 * cfg["dense_lr"]:
        raise AssertionError("card and CPU training disagree")
    return st


# ------------------------------------------------------------ fused bag step

# Bag lengths of the 26 categorical features: `multi_hot_sizes` of the
# public MLPerf DLRM-DCNv2 reference (Criteo 1TB multi-hot).
MULTI_HOT = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
             100, 27, 10, 3, 1, 1)
FUSED = dict(batch=2048, vocab=1_000_000, zipf=1.2, pad=0.1, checked=5,
             timed=20, lr=0.05, capacity=1 << 20, dim=128, compare=(100, 1))


def bag_groups(lengths):
    """{L: feature indices}: features of one bag length stack into one
    bundle, as the JAX package groups features whose id shapes match."""
    groups = {}
    for i, L in enumerate(lengths):
        groups.setdefault(L, []).append(i)
    return dict(sorted(groups.items()))


def make_bags(rng, groups, cfg, dev):
    """One step's ids per group on `dev`: [T, B, L] int32 zipf ids over
    `vocab`, about `pad` of the positions padded (-1) in multi-hot bags."""
    from deeprec_tpu_torch.data.synthetic import zipf_ids

    out = {}
    for L, members in groups.items():
        ids = zipf_ids(rng, cfg["vocab"], cfg["zipf"], (len(members), cfg["batch"], L))
        if L > 1:
            ids = np.where(rng.random(ids.shape) < cfg["pad"], -1, ids)
        out[L] = torch.from_numpy(ids.astype(np.int32)).to(dev)
    return out


def fused_step(bundles, bags, step, opt):
    """One fused bag step through the public API, per group (the JAX
    package's fused bench, tools/bench_lookup.py): the train lookup
    resolves the keys, row_ix = slot_ix[inverse] where not pad,
    bag_forward, g = out * 0.25 + 1, apply_bag_gradients. Returns {L:
    (row_ix, FusedBags)}."""
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim.apply import apply_bag_gradients

    out = {}
    for L, (table, st) in bundles.items():
        ids = bags[L]
        T, B, _ = ids.shape
        look = table.lookup_unique(st, ids, step=step, train=True, pad_value=-1)
        slot = look.slot_ix.gather(1, look.inverse.reshape(T, -1).long())
        row_ix = torch.where(ids != -1, slot.view(T, B, L), -1)
        res = table.bag_forward(st, row_ix, combiner="sum",
                                unique_size=resolve_size(B * L, B * L))
        apply_bag_gradients(table, st, opt, res, res.out * 0.25 + 1.0, row_ix,
                            combiner="sum", step=step)
        out[L] = (row_ix, res)
    return out


def _bag_multisets(res):
    return [sorted(zip(res.uids[t].tolist(), res.counts[t].tolist()))
            for t in range(res.uids.shape[0])]


def _check_bags(kres, pres, what):
    if not torch.equal(kres.overflow, pres.overflow):
        raise AssertionError(f"{what}: overflow {kres.overflow.tolist()} vs "
                             f"{pres.overflow.tolist()}")
    if not torch.equal(kres.out, pres.out):
        raise AssertionError(f"{what}: pooled bags differ from the plain version")
    if _bag_multisets(kres) != _bag_multisets(pres):
        raise AssertionError(f"{what}: uids/counts differ as multisets")


def compare_fused(values, accum, row_ix, opt, step, what):
    """Kernels #6 and #7 against their plain versions on copies: out bit
    for bit, uids/counts as multisets, overflow; then each backward on its
    own copy of (values, accum) from its own forward, the tables compared
    whole (every row id) bit for bit; rows off the batch unchanged.
    Returns the count of rows written."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    T, B, L = row_ix.shape
    U = resolve_size(B * L, B * L)
    kres = fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)
    pres = fl.fused_sparse_forward_plain(values, row_ix, combiner="sum", unique_size=U)
    _check_bags(kres, pres, what)
    kv, ka, pv, pa = values.clone(), accum.clone(), values.clone(), accum.clone()
    fl.fused_sparse_backward(kv, {"accum": ka}, kres.out * 0.25 + 1.0, row_ix, kres,
                             opt, combiner="sum", step=step, seed=step)
    fl.fused_sparse_backward_plain(pv, {"accum": pa}, pres.out * 0.25 + 1.0, row_ix,
                                   pres, opt, combiner="sum", step=step, seed=step)
    if not (torch.equal(kv, pv) and torch.equal(ka, pa)):
        raise AssertionError(f"{what}: the backward's rows differ from the plain version")
    changed = (kv != values).any(-1) | (ka != accum).any(-1)  # [T, C]
    touched = torch.zeros_like(changed)
    ok = kres.uids >= 0
    t = torch.arange(T, device=values.device)[:, None].expand_as(ok)
    touched[t[ok], kres.uids[ok].long()] = True
    if bool((changed & ~touched).any()):
        raise AssertionError(f"{what}: a row off the batch changed")
    written = int(touched.sum())
    del kv, ka, pv, pa, changed, touched
    print(f"fused {what}: T={T} B={B} L={L}: out, overflow "
          f"{kres.overflow.tolist()[:3]}, uids/counts and {written} written rows "
          "bit-exact against the plain version; rows off the batch unchanged")
    return written


def tight_budget(values, row_ix, what):
    """A budget of a quarter of the batch's unique rows: equal overflow
    counts, and out-of-budget positions add nothing (the kernel's out equals
    the l-order sum of the budgeted positions' rows)."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    T, B, L = row_ix.shape
    C = values.shape[1]
    n = int((fl.fused_sparse_forward(values, row_ix, combiner="sum",
                                     unique_size=resolve_size(B * L, B * L)
                                     ).uids >= 0).sum(-1).min())
    U = resolve_size(n // 4, B * L)
    kres = fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)
    pres = fl.fused_sparse_forward_plain(values, row_ix, combiner="sum", unique_size=U)
    if not torch.equal(kres.overflow, pres.overflow) or int(kres.overflow.min()) <= 0:
        raise AssertionError(f"{what}: tight-budget overflow {kres.overflow.tolist()} "
                             f"vs {pres.overflow.tolist()}")
    t = torch.arange(T, device=values.device)[:, None, None]
    rows = values[t, row_ix.long().clamp(0, C - 1)].float()
    rows = torch.where((kres.inverse > 0)[..., None], rows, 0.0)
    want = torch.zeros_like(kres.out)
    for pos in range(L):
        want = want + rows[:, :, pos]
    if not torch.equal(kres.out, want):
        raise AssertionError(f"{what}: an out-of-budget position reached its bag")
    print(f"fused {what}: budget U={U} of {n} unique rows: overflow "
          f"{kres.overflow.tolist()[:3]} equal in kernel and plain version; "
          "out-of-budget positions add nothing")


def fused_bytes(bundles, last, slot_width):
    """The byte bounds (forward, backward) of one step from the fused
    model's terms (ops/traffic.py fused_sparse_step_traffic(fused=True) of
    the JAX package), summed over tables, with this step's unique rows: ids
    read once per direction, each unique row read once (and written once
    backward, with its slot rows), bags out, gradients in."""
    fwd = bwd = 0
    for L, (table, st) in bundles.items():
        row_ix, res = last[L]
        T, B, _ = row_ix.shape
        N, D = B * L, st.values.shape[2]
        vb = st.values.element_size()
        for u in (res.uids >= 0).sum(-1).tolist():
            fwd += 4 * N + u * D * vb + B * D * 4
            bwd += B * D * 4 + 4 * N + 2 * u * D * vb + 2 * slot_width * 4 * u
    return fwd, bwd


# Device operations per call of #6 (the memset and two launches) and of
# #7 under Adagrad and combiner "sum" (lr's fill, the scalar vector's
# stack, three launches): the most each may issue.
FUSED_OPS = (3, 5)


def device_ops(fn, calls=20):
    """Device operations (kernels, memsets, copies) per call of fn: the
    events torch.profiler records over `calls` calls, divided by `calls` and
    rounded, the larger of two windows (a window can lose an event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if getattr(e, "device_type", None) == DeviceType.CUDA))
    return round(most / calls)


def fused_ops_per_call(bundles, last, opt, step, groups):
    """{L: (#6, #7) device operations of one call} at the groups' main-path
    shapes (`device_ops`); fails above FUSED_OPS."""
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size

    out = {}
    for L in groups:
        _, st = bundles[L]
        row_ix, res = last[L]
        N = row_ix.shape[1] * L
        grad = res.out * 0.25 + 1.0
        fwd = device_ops(lambda: fl.fused_sparse_forward(
            st.values, row_ix, combiner="sum", unique_size=resolve_size(N, N)))
        bwd = device_ops(lambda: fl.fused_sparse_backward(
            st.values, st.slots, grad, row_ix, res, opt, combiner="sum", step=step,
            seed=step))
        out[L] = (fwd, bwd)
        print(f"fused L={L}: device operations per call: fused_sparse_forward {fwd} "
              f"(at most {FUSED_OPS[0]}), fused_sparse_backward {bwd} (at most "
              f"{FUSED_OPS[1]})")
        if fwd > FUSED_OPS[0] or bwd > FUSED_OPS[1]:
            raise AssertionError(f"fused L={L}: {fwd} and {bwd} device operations per "
                                 f"call, above {FUSED_OPS}")
    return out


def fused_phase(dev, seed, cfg):
    """The fused bag step at full width (see the module docstring). Returns
    (stats, forward record, backward record)."""
    from deeprec_tpu_torch.config import TableConfig
    from deeprec_tpu_torch.embedding.table import EmbeddingTable
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.optim.apply import ensure_slots

    opt = Adagrad(lr=cfg["lr"])
    groups = bag_groups(MULTI_HOT)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bundles = {}
    for L, members in groups.items():
        table = EmbeddingTable(TableConfig(name=f"bag{L}", dim=cfg["dim"],
                                           capacity=cfg["capacity"]))
        bundles[L] = (table, ensure_slots(table, table.create(len(members), dev), opt))
    rng = np.random.default_rng(seed + 11)
    nsteps = cfg["checked"] + cfg["timed"] + 1
    bags = [make_bags(rng, groups, cfg, dev) for _ in range(nsteps)]
    _sync(dev)

    kernels = (fl.fused_sparse_forward, fl.fused_sparse_backward)
    for k in kernels:  # the main path starts here
        k.launches = 0
    _zero_row_counts()
    for s in range(cfg["checked"]):
        last = fused_step(bundles, bags[s], s, opt)
        for L, (_, res) in last.items():
            if not bool(torch.isfinite(res.out).all()):
                raise AssertionError(f"bag length {L}: non-finite pooled bags")
    launches = [k.launches for k in kernels] + list(_row_counts()[::-1])  # ... and ends here
    want = cfg["checked"] * len(groups)
    if dev.type == "cuda" and launches != [want] * 4:
        raise AssertionError(
            f"fused path launched (forward, backward, gather_rows, apply_rows_sr) "
            f"{launches} times, the {len(groups)} groups imply {want} each")
    for L, (table, st) in bundles.items():
        row_ix, res = last[L]
        ok = res.uids >= 0
        t = torch.arange(ok.shape[0], device=dev)[:, None].expand_as(ok)
        rows = st.values[t[ok], res.uids[ok].long()]
        if not bool(torch.isfinite(rows).all()):
            raise AssertionError(f"bag length {L}: non-finite trained rows")

    _sync(dev)
    t0 = time.perf_counter()
    for s in range(cfg["checked"], cfg["checked"] + cfg["timed"]):
        last = fused_step(bundles, bags[s], s, opt)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / cfg["timed"] * 1e3
    stats = {"launches": launches, "groups": len(groups), "step_ms": step_ms,
             "examples_per_s": cfg["batch"] / step_ms * 1e3,
             "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None)}
    step = cfg["checked"] + cfg["timed"]
    if dev.type == "cuda":
        # the last staged batch, three times (its keys are resident after
        # the first, as in a steady state)
        box = [step]

        def one_step():
            last.update(fused_step(bundles, bags[-1], box[0], opt))
            box[0] += 1

        stats["profile"] = profile_device(one_step, 2)
        step = box[0]

    # kernel and plain version on copies of two groups, one step further
    written = 0
    for L in cfg["compare"]:
        table, st = bundles[L]
        one = fused_step({L: bundles[L]}, {L: bags[-1][L]}, step, opt)
        row_ix = one[L][0]
        written += compare_fused(st.values, st.slots["accum"], row_ix, opt,
                                 step + 1, f"L={L} f32")
        if L == cfg["compare"][0]:
            written += compare_fused(st.values[:1].to(torch.bfloat16),
                                     st.slots["accum"][:1], row_ix[:1], opt,
                                     step + 1, f"L={L} bf16 (table 0)")
            tight_budget(st.values, row_ix, f"L={L} f32")
            # one row in every position: a slot past the CTA's shared memory
            head = torch.full_like(row_ix[:1], int(row_ix[row_ix >= 0][0]))
            written += compare_fused(st.values[:1], st.slots["accum"][:1], head, opt,
                                     step + 1, f"L={L} head-heavy (table 0)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    stats["rows_compared"] = written
    if dev.type == "cuda":
        stats["peak_gb_checks"] = torch.cuda.max_memory_allocated() / 1e9

    # per-step device times at the main path's shapes: all groups once
    fwd_b, bwd_b = fused_bytes(bundles, last, cfg["dim"])
    items = [(L, table, st, *last[L]) for L, (table, st) in bundles.items()]
    U = {L: resolve_size(row_ix.shape[1] * L, row_ix.shape[1] * L)
         for L, _, _, row_ix, _ in items}

    def fwd(fn):
        return lambda: [fn(st.values, row_ix, combiner="sum", unique_size=U[L])
                        for L, _, st, row_ix, _ in items]

    lib_args = []
    for L, _, st, row_ix, _ in items:
        T, C, D = st.values.shape
        ok = row_ix >= 0
        flat = (torch.arange(T, device=dev)[:, None, None] * C + row_ix.long())[ok]
        per_bag = ok.sum(-1).flatten()
        offsets = torch.cumsum(per_bag, 0) - per_bag
        lib_args.append((flat, st.values.view(T * C, D), offsets))

    def library():
        return [torch.nn.functional.embedding_bag(i, w, o, mode="sum")
                for i, w, o in lib_args]

    grads = {L: res.out * 0.25 + 1.0 for L, _, _, _, res in items}

    def bwd(fn):
        return lambda: [fn(st.values, st.slots, grads[L], row_ix, res, opt,
                           combiner="sum", step=step, seed=step)
                        for L, _, st, row_ix, res in items]

    f_rec = {
        "name": "fused_sparse_forward", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/fused_sparse_forward.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:778",
        "launches": launches[0], "max_abs_err": 0.0,
        "bound_ms": fwd_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    b_rec = {
        "name": "fused_sparse_backward", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/fused_sparse_backward.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:1028",
        "launches": launches[1], "max_abs_err": 0.0,
        "bound_ms": bwd_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }
    if dev.type == "cuda":
        stats["ops_per_call"] = fused_ops_per_call(bundles, last, opt, step, cfg["compare"])
    _timed_record(f_rec, f"fused_sparse_forward ({len(items)} groups, per step)",
                  _ms(fwd(fl.fused_sparse_forward), dev, reps=10),
                  _ms(fwd(fl.fused_sparse_forward_plain), dev, reps=2, warm=1),
                  _ms(library, dev, reps=10))
    _timed_record(b_rec, f"fused_sparse_backward ({len(items)} groups, per step)",
                  _ms(bwd(fl.fused_sparse_backward), dev, reps=10),
                  _ms(bwd(fl.fused_sparse_backward_plain), dev, reps=1, warm=1),
                  (None, None))
    stats["bytes"] = (fwd_b, bwd_b)
    return stats, f_rec, b_rec


def budget_phase(dev, model_kw, seed, cfg, steps=5):
    """DLRM-DCN trained with Trainer(unique_budget="auto"): `steps` steps at
    U = N through the hash engine, update_budgets, `steps` steps at the
    measured budget. Returns stats; fails on overflow or a launch count
    the path does not imply."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.dedup import hash_dedup
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    model = DLRMDCN(**model_kw, seed=seed)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev,
                      unique_budget="auto")
    state = trainer.init()
    gen = SyntheticCriteo(batch_size=cfg["batch"], vocab=cfg["vocab"], seed=seed + 5,
                          num_cat=model.num_cat, num_dense=model.num_dense)
    staged = [trainer.device_batch(gen.batch()) for _ in range(2 * steps)]
    ids = staged[0][trainer.sparse_specs[0].name][None, :, None]
    sizes = {}
    _zero_row_counts()  # the main path starts here
    hash_dedup.probe_syncs = 0
    losses = []
    for i in range(2 * steps):
        if i == steps:
            state, report = trainer.update_budgets(state)
        for b in trainer.bundles.values():
            sizes.setdefault(b.name, []).append(trainer._budget_for_lookup(b, ids, True))
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
    launches = _row_counts()  # ... and ends here
    syncs = hash_dedup.probe_syncs / (2 * steps)
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and launches != tuple(2 * steps * n for n in per_step):
        raise AssertionError(
            f"budgeted path launched (apply_rows_sr, gather_rows) {launches}, "
            f"the bundles imply {tuple(2 * steps * n for n in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite budgeted training loss: {losses}")
    stats = trainer.dedup_stats(state)
    overflow = sum(r["dedup_overflow"] for r in stats.values()) + sum(
        r["dedup_overflow"] for r in report.values())
    if overflow:
        raise AssertionError(f"{overflow} ids overflowed the auto budget")
    for name, s in sizes.items():
        if not s[steps] < s[0]:
            raise AssertionError(f"{name}: the auto budget did not engage ({s})")
    return {"launches": launches, "losses": losses, "report": report,
            "probe_syncs_per_step": syncs,
            "sizes": {k: (v[0], v[-1]) for k, v in sizes.items()},
            "unique_fraction": {k: r["unique_fraction"] for k, r in stats.items()}}


# ------------------------------------------------------------ flash attention and BST

PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
# Flash kernels against their plain versions on the card: expf is not
# torch.exp and the sums run in another order, so they are not bit-exact.
# o and lse within 1e-5 * max(1, |plain|); dq, dk and dv within 1e-4 of the
# tensor's largest |plain| gradient.
FLASH_FWD_RTOL, FLASH_GRAD_TOL = 1e-5, 1e-4
# (B, H, Lq, S, D, causal, block_q, block_k, dead rows), besides BST's own
# shape: tests/test_attention.py's [2, 2, 256, 32] at blocks 64 and 128;
# rows that see no real key; a head width of 64; a width the kernels pad.
FLASH_SHAPES = [
    (2, 2, 256, 256, 32, False, 64, 64, False),
    (2, 2, 256, 256, 32, True, 64, 64, False),
    (2, 2, 256, 256, 32, False, 128, 128, False),
    (2, 2, 256, 256, 32, True, 128, 128, False),
    (4, 2, 256, 256, 16, False, 64, 64, True),
    (4, 2, 256, 256, 16, True, 64, 64, True),
    (64, 4, 256, 256, 64, False, 128, 128, False),
    (2, 3, 128, 384, 12, True, 64, 128, False),
]
# bf16 q, k, v, do (the JAX function takes them; the kernels upcast on load
# and store o, dq, dk, dv in bf16): tests/test_attention.py's shape.
FLASH_BF16_SHAPES = [(2, 2, 256, 256, 32, False, 64, 64, False)]
# BST as modelzoo/bst/train.py runs it (emb 16, capacity 2^20, batch 2048,
# vocab 100,000, Adagrad 0.2, Adam 1e-3; heads 4, ff 128, one block,
# hidden 256-64) with use_flash=True and histories at max_len 200. The
# agreement cell's vocabulary keeps every id of its 3 batches inside
# capacity 2^12.
BST_RUN = dict(emb_dim=16, capacity=1 << 20, heads=4, ff=128, blocks=1, max_len=200,
               hidden=(256, 64), batch=2048, vocab=100_000, seq_len=200, lr=0.2,
               dense_lr=1e-3, checked=5, timed=30, profiled=3, steps=300,
               eval_batches=8, auc_floor=0.60, agree_capacity=1 << 12,
               agree_batch=256, agree_vocab=2000, requests=30, sample=4096)


def _bst(cfg, seed, **over):
    from deeprec_tpu_torch.models import BST

    kw = {k: cfg[k] for k in ("emb_dim", "capacity", "heads", "ff", "blocks",
                              "max_len", "hidden")}
    return BST(**{**kw, **over}, use_flash=True, seed=seed)


def _bf16_ulp(x):
    """One bf16 ulp of each element of x (8 significant bits), 0 at 0."""
    a = x.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, torch.exp2(e - 7), torch.zeros_like(a))


def _flash_errs(got, want, grad):
    """(max abs error, the measure the tolerance applies to, its
    tolerance): forward tensors by error / max(1, |plain|), gradients by
    error over the largest |plain| gradient. bf16 tensors may differ by one
    more bf16 ulp of the plain value (a sum in another order rounds to the
    neighbour): their measure is the largest error over that widened
    tolerance, held to 1."""
    if want.dtype == torch.bfloat16:
        err = (got.double() - want.double()).abs()
        base = (FLASH_GRAD_TOL * float(want.double().abs().max()) if grad
                else FLASH_FWD_RTOL * torch.clamp(want.double().abs(), min=1.0))
        return float(err.max()), float((err / (base + _bf16_ulp(want))).max()), 1.0
    err = (got - want).abs()
    if grad:
        return float(err.max()), float(err.max()), FLASH_GRAD_TOL * float(want.abs().max())
    rel = float((err / torch.clamp(want.abs(), min=1.0)).max())
    return float(err.max()), rel, FLASH_FWD_RTOL


def compare_flash(q, k, v, mask, do, causal, block_q, block_k, what):
    """Both flash kernels against their plain versions (the backward from
    the plain forward's o and lse); a row that sees no key gets exactly 0
    gradients. Returns {tensor: max abs error}."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / q.shape[-1] ** 0.5
    o, lse = fa.flash_forward(q, k, v, mask, causal, scale, block_q, block_k)
    po, plse = fa.flash_forward_plain(q, k, v, mask, causal, scale, block_q, block_k)
    got = fa.flash_backward(q, k, v, mask, causal, scale, block_q, block_k, po, plse, do)
    want = fa.flash_backward_plain(q, k, v, mask, causal, scale, block_q, block_k,
                                   po, plse, do)
    _sync(q.device)
    errs, parts = {}, []
    for name, a, b, grad in (("o", o, po, False), ("lse", lse, plse, False),
                             ("dq", got[0], want[0], True), ("dk", got[1], want[1], True),
                             ("dv", got[2], want[2], True)):
        err, measure, tol = _flash_errs(a, b, grad)
        if not measure <= tol:
            raise AssertionError(f"flash {what}: {name} off by {measure:.3g} "
                                 f"(tolerance {tol:.3g})")
        errs[name] = err
        parts.append(f"{name} {err:.3g} ({measure:.3g} <= {tol:.3g})")
    dead = ~mask.any(dim=1)
    if bool(dead.any()) and not all(bool((g[dead] == 0).all()) for g in got):
        raise AssertionError(f"flash {what}: a dead row's gradient is not 0")
    print(f"flash {what}: kernel vs plain, max abs err " + ", ".join(parts))
    return errs


def _bst_attention_inputs(cfg, seed, dev):
    """q, k, v, do [B, H, 256, D] normal and the key mask BST's encoder
    gives flash attention: SyntheticBehaviorSequence histories of max_len,
    the always-real target at position max_len, zero padding to 256."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence

    B, L = cfg["batch"], cfg["max_len"] + 1
    H, D = cfg["heads"], 2 * cfg["emb_dim"] // cfg["heads"]
    Lp = -(-L // 128) * 128
    hist = SyntheticBehaviorSequence(batch_size=B, vocab=cfg["vocab"],
                                     seq_len=cfg["seq_len"], seed=seed + 21).batch()
    mask = np.zeros((B, Lp), bool)
    mask[:, :cfg["seq_len"]] = hist["hist_items"] != -1
    mask[:, L - 1] = True
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    q, k, v, do = (torch.randn((B, H, Lp, D), generator=g, device=dev) for _ in range(4))
    return q, k, v, torch.from_numpy(mask).to(dev), do


def flash_phase(dev, seed, cfg, shapes):
    """Phase 10: both flash kernels against their plain versions at BST's
    shape and at `shapes`; at BST's shape the device times of the kernels,
    their plain versions and scaled_dot_product_attention (forward, and its
    backward), and the bounds. Returns the two kernel records."""
    from deeprec_tpu_torch.ops import flash_attention as fa

    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(seed + 23)
    errs = []
    for B, H, Lq, S, D, causal, bq, bk, dead in shapes:
        q = torch.randn((B, H, Lq, D), generator=g, device=dev)
        k, v = (torch.randn((B, H, S, D), generator=g, device=dev) for _ in range(2))
        do = torch.randn((B, H, Lq, D), generator=g, device=dev)
        lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        if dead:  # batch 0 sees no key; batch 1's first 64 keys are masked
            mask[0] = False
            mask[1, :64] = False
        errs.append(compare_flash(q, k, v, mask, do, causal, bq, bk,
                                  f"B={B} H={H} Lq={Lq} S={S} D={D} causal={causal} "
                                  f"blocks {bq}/{bk}{' dead rows' if dead else ''}"))
    for B, H, Lq, S, D, causal, bq, bk, _ in FLASH_BF16_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                       for shape in ((B, H, Lq, D), (B, H, S, D), (B, H, S, D),
                                     (B, H, Lq, D)))
        lengths = torch.randint(S // 2, S + 1, (B,), generator=g, device=dev)
        mask = torch.arange(S, device=dev)[None, :] < lengths[:, None]
        compare_flash(q, k, v, mask, do, causal, bq, bk,
                      f"bf16 B={B} H={H} Lq={Lq} S={S} D={D} causal={causal} "
                      f"blocks {bq}/{bk}")
    q, k, v, mask, do = _bst_attention_inputs(cfg, seed, dev)
    B, H, Lq, D = q.shape
    errs.append(compare_flash(q, k, v, mask, do, False, 128, 128,
                              f"BST B={B} H={H} L={Lq} D={D}"))
    fwd_err = max(max(e["o"], e["lse"]) for e in errs)
    bwd_err = max(max(e["dq"], e["dk"], e["dv"]) for e in errs)

    # bounds, with the key pairs this run's mask needs (masked keys give
    # exactly-zero terms): forward 2 products, backward 5, of 2 D flops each
    scale = 1.0 / D ** 0.5
    pairs = H * Lq * int(mask.sum())
    elem = B * H * Lq * D * 4
    fwd_bytes = 3 * elem + mask.numel() + elem + B * H * Lq * 4
    bwd_bytes = 5 * elem + B * H * Lq * 4 + mask.numel() + 3 * elem

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    f_bound, f_by = bound(4 * D * pairs, fwd_bytes)
    b_bound, b_by = bound(10 * D * pairs, bwd_bytes)
    f_rec = {"name": "flash_attention_fwd", "route": "cuda",
             "source": "deeprec_tpu_torch/csrc/flash_attention_fwd.cu",
             "replaces": "deeprec_tpu/ops/flash_attention.py:136",
             "launches": 0, "max_abs_err": fwd_err, "bound_ms": f_bound, "bound_by": f_by}
    b_rec = {"name": "flash_attention_bwd", "route": "cuda",
             "source": "deeprec_tpu_torch/csrc/flash_attention_bwd.cu",
             "replaces": "deeprec_tpu/ops/flash_attention.py:309",
             "launches": 0, "max_abs_err": bwd_err, "bound_ms": b_bound, "bound_by": b_by}
    print(f"flash BST shape [{B}, {H}, {Lq}, {D}]: {int(mask.sum())} real keys of "
          f"{mask.numel()}; bounds forward {f_bound:.5f} ms ({f_by}), backward "
          f"{b_bound:.5f} ms ({b_by}) at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32, "
          f"{HBM_BYTES_PER_S / 1e12} TB/s")
    o, lse = fa.flash_forward_plain(q, k, v, mask, False, scale, 128, 128)
    am = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    lib_out = sdpa(*leaves, attn_mask=am)
    _timed_record(f_rec, "flash_attention_fwd (BST shape)",
                  _ms(lambda: fa.flash_forward(q, k, v, mask, False, scale, 128, 128),
                      dev, reps=20),
                  _ms(lambda: fa.flash_forward_plain(q, k, v, mask, False, scale, 128, 128),
                      dev, reps=2, warm=1),
                  _ms(lambda: sdpa(q, k, v, attn_mask=am), dev, reps=20))
    _timed_record(b_rec, "flash_attention_bwd (BST shape)",
                  _ms(lambda: fa.flash_backward(q, k, v, mask, False, scale, 128, 128,
                                                o, lse, do), dev, reps=20),
                  _ms(lambda: fa.flash_backward_plain(q, k, v, mask, False, scale, 128,
                                                      128, o, lse, do),
                      dev, reps=2, warm=1),
                  _ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True),
                      dev, reps=20))
    del q, k, v, mask, do, o, lse, leaves, lib_out
    return f_rec, b_rec


def _flash_counts():
    from deeprec_tpu_torch.ops import flash_attention as fa

    return (fa.flash_forward.launches, fa.flash_backward.launches_dkdv,
            fa.flash_backward.launches_dq)


def _reset_flash_counts():
    from deeprec_tpu_torch.ops import flash_attention as fa

    fa.flash_forward.launches = 0
    fa.flash_backward.launches_dkdv = fa.flash_backward.launches_dq = 0


def bst_train_phase(dev, seed, cfg):
    """Phase 11: BST with flash attention trained at full width (see the
    module docstring). Returns (trainer, state, stats)."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.training.trainer import Trainer

    model = _bst(cfg, seed)
    trainer = Trainer(model, Adagrad(lr=cfg["lr"]), adam(cfg["dense_lr"]), device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = trainer.init()

    def gen(s):
        return SyntheticBehaviorSequence(batch_size=cfg["batch"], vocab=cfg["vocab"],
                                         seq_len=cfg["seq_len"], seed=s)

    held = gen(seed + 1)
    evals = [trainer.device_batch(held.batch()) for _ in range(cfg["eval_batches"])]
    auc0 = trainer.evaluate(state, evals)["auc"]
    train_gen = gen(seed)
    nsteps = cfg["checked"] + cfg["timed"] + cfg["profiled"] + 1
    host = [train_gen.batch() for _ in range(nsteps)]
    staged = [trainer.device_batch(b) for b in host]
    _sync(dev)
    cpu_gen = torch.Generator().manual_seed(seed)

    _reset_flash_counts()  # the main path starts here
    _zero_row_counts()
    losses, untouched = [], 0
    for i in range(cfg["checked"]):
        sample = (_untouched_sample(trainer, state, staged[i], cfg["sample"], cpu_gen)
                  if i else [])
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
        untouched += _check_untouched(state, sample)
    flash = _flash_counts()
    rows = _row_counts()  # ... and ends here
    per_step = _path_launches(trainer)
    n = cfg["checked"]
    if dev.type == "cuda" and (flash != (n, n, n)
                               or rows != tuple(n * c for c in per_step)):
        raise AssertionError(
            f"BST train path launched (flash fwd, dK/dV, dQ) {flash} and "
            f"(apply_rows_sr, gather_rows) {rows}; {n} steps imply {(n, n, n)} and "
            f"{tuple(n * c for c in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite BST training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{fails} ids failed to insert")
    for bname, b in trainer.bundles.items():
        ids = np.concatenate([h[f.name].ravel() for h in host[:n] for f in b.features])
        want = len(np.unique(ids[ids != b.features[0].pad_value]))
        size = int(b.table.size(state.tables[bname]).sum())
        if size != want:
            raise AssertionError(f"{bname}: table size {size}, distinct ids {want}")

    _sync(dev)
    t0 = time.perf_counter()
    for i in range(n, n + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t0
    stats = {"flash": flash, "rows": rows, "per_step": per_step, "losses": losses,
             "untouched": untouched, "step_ms": timed_s / cfg["timed"] * 1e3,
             "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s}
    done = n + cfg["timed"]
    if dev.type == "cuda":
        box = [state]
        nxt = iter(staged[done:])

        def step():
            box[0] = trainer.train_step(box[0], next(nxt))[0]

        stats["profile"] = profile_device(step, cfg["profiled"])
        state = box.pop()
        done += cfg["profiled"] + 1
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del staged
    stats["rest_from"] = done
    t0 = time.perf_counter()
    for _ in range(done, cfg["steps"]):
        state, m = trainer.train_step(state, train_gen.batch())
    losses.append(float(m["loss"]))
    stats["rest_s"] = time.perf_counter() - t0
    auc = trainer.evaluate(state, evals)["auc"]
    stats.update(auc0=auc0, auc=auc, steps=state.step)
    if not np.isfinite(losses[-1]) or not auc >= cfg["auc_floor"]:
        raise AssertionError(f"BST after {state.step} steps: loss {losses[-1]}, "
                             f"held-out AUC {auc} (floor {cfg['auc_floor']})")
    return trainer, state, stats


def bst_serve_phase(dev, trainer, state, ckdir, seed, cfg):
    """Phase 12: the trained state saved and served by Predictor: `requests`
    requests of the full batch and one each of batch 1 and 37, every
    answer equal to Trainer.eval_step's on the trained state bit for bit,
    one flash forward and three #4 launches (user, target_item, target_cat)
    per request. Returns stats."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    CheckpointManager(ckdir, trainer).save(state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p = Predictor(trainer.model, ckdir, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    gen = SyntheticBehaviorSequence(batch_size=cfg["batch"], vocab=cfg["vocab"],
                                    seq_len=cfg["seq_len"], seed=seed + 2)
    reqs = [gen.batch() for _ in range(cfg["requests"])]
    reqs += [{k: a[:n] for k, a in reqs[0].items()} for n in (1, 37)]
    want = [trainer.eval_step(state, b)[1].cpu().numpy() for b in reqs]

    _reset_flash_counts()  # the main path starts here
    _zero_row_counts()
    fused_gather_combine.launches = 0
    got, lat = [], []
    for b in reqs:
        t0 = time.perf_counter()
        got.append(p.predict(b))
        lat.append((time.perf_counter() - t0) * 1e3)
    launches = (_flash_counts()[0], _row_counts()[1],
                fused_gather_combine.launches)  # ... and ends here
    per_request, pooled = _per_request(p._trainer)
    want_launches = tuple(len(reqs) * c for c in (1, per_request, pooled))
    if dev.type == "cuda" and launches != want_launches:
        raise AssertionError(
            f"BST serving launched (flash fwd, gather_rows, fused_gather_combine) "
            f"{launches}; {len(reqs)} requests imply {want_launches}")
    for b, g, w in zip(reqs, got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(
                f"BST serving, batch {len(w)}: Predictor differs from eval_step by "
                f"{np.abs(g - w).max() if g.shape == w.shape else g.shape}")
        if not (np.all(np.isfinite(g)) and np.all(g > 0) and np.all(g < 1)):
            raise AssertionError("BST serving: probabilities not finite in (0, 1)")
    full = lat[:cfg["requests"]]
    return {"save_s": save_s, "restore_s": restore_s, "launches": launches,
            "requests": len(reqs), "per_request": per_request,
            "p50_ms": float(np.percentile(full, 50)),
            "p90_ms": float(np.percentile(full, 90))}


@contextlib.contextmanager
def _f32_dense_operands():
    """dense_apply's bf16 operand rounding switched off in the port for the
    duration (the "f32 numerics" of tests/test_torch_bst.py)."""
    from deeprec_tpu_torch import nn as dnn

    rounding = dnn._bf16
    dnn._bf16 = lambda x: x
    try:
        yield
    finally:
        dnn._bf16 = rounding


def bst_agreement(dev, seed, cfg):
    """BST trained on the card and on the CPU from one state at capacity
    2^12 and batch 256. A 1-ulp difference before a bf16 operand rounding
    flips that operand by 2^-8, and Adam's first step moves a dense element
    by about lr whatever the size of its gradient, so a flipped sign moves
    it 2 lr apart; the next steps' embedding gradients carry that apart
    (card vs CPU rows 3.6e-3 after 3 steps, with or without flash
    attention). So: in the models' own numerics, 1 step within TRAIN_RTOL
    and ROW_ATOL and 3 steps' losses within TRAIN_RTOL; with dense_apply's
    operands in f32 on both sides, 3 steps within TRAIN_RTOL and ROW_ATOL.
    Dense parameters within 2 lr per step. Returns printable results."""
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence

    def agree(steps):
        model = _bst(cfg, seed, capacity=cfg["agree_capacity"])
        gen = SyntheticBehaviorSequence(batch_size=cfg["agree_batch"],
                                        vocab=cfg["agree_vocab"],
                                        seq_len=cfg["seq_len"], seed=seed + 3)
        return train_agreement(dev, model, gen, cfg, steps=steps)

    out = []
    for numerics, steps, rows_held in (("bf16", 1, True), ("bf16", 3, False),
                                       ("f32", 3, True)):
        if numerics == "f32":
            with _f32_dense_operands():
                loss_d, row_d, dense_d, n = agree(steps)
        else:
            loss_d, row_d, dense_d, n = agree(steps)
        dense_bound = 2 * steps * cfg["dense_lr"] + 1e-6  # + f32 rounding
        line = (f"{numerics} numerics, {steps} step(s): loss rel diff {loss_d:.3g} "
                f"(tolerance {TRAIN_RTOL}), max row diff {row_d:.3g} over {n} keys "
                f"({'tolerance ' + str(ROW_ATOL) if rows_held else 'not held'}), max "
                f"dense diff {dense_d:.3g} (bound {dense_bound:.3g})")
        out.append(line)
        if (loss_d > TRAIN_RTOL or (rows_held and row_d > ROW_ATOL)
                or dense_d > dense_bound):
            raise AssertionError(f"card and CPU BST training disagree: {line}")
    return out


def run_bst(dev, seed, cfg, ckroot):
    """Phases 11 and 12, and the card-vs-CPU BST agreement. Returns
    (training stats, serving stats)."""
    trainer, state, st = bst_train_phase(dev, seed, cfg)
    fl, (apply_n, gather_n) = st["flash"], st["rows"]
    print(f"BST training: emb {cfg['emb_dim']}, 3 tables of {cfg['capacity']} slots "
          f"(two shared), batch {cfg['batch']}, histories of {cfg['seq_len']}: "
          f"{cfg['checked']} checked steps launched flash fwd / dK/dV / dQ {fl}, "
          f"apply_rows_sr {apply_n} and gather_rows {gather_n} "
          f"({st['per_step'][0]} and {st['per_step'][1]} per step); "
          f"{st['untouched']} untouched rows unchanged")
    print(f"BST training: {st['examples_per_s']:.1f} examples/s over {cfg['timed']} "
          f"timed steps ({st['step_ms']:.3f} ms/step); loss step 1 "
          f"{st['losses'][0]:.6f}, step {st['steps']} {st['losses'][-1]:.6f}; held-out "
          f"AUC over {cfg['eval_batches']} batches {st['auc0']:.6f} at step 0, "
          f"{st['auc']:.6f} at step {st['steps']} (floor {cfg['auc_floor']}); peak "
          f"device memory {st.get('peak_gb')} GB; steps {st['rest_from'] + 1}-"
          f"{st['steps']} (batches made on the host) took {st['rest_s']:.1f} s")
    if "profile" in st:
        wall, busy, kernels, rows, phases = st["profile"]
        print(f"profile: {cfg['profiled']} BST train steps: wall {wall / 1e3:.3f} "
              f"ms/step, device busy {busy / 1e3:.3f} ms/step, idle share "
              f"{1 - busy / wall:.3f} (of the timed step "
              f"{1 - busy / 1e3 / st['step_ms']:.3f}), {kernels} kernels/step")
        for name, (host_us, dev_us) in phases.items():
            print(f"profile:   {name:24s} host {host_us / 1e3:8.3f} ms/step, "
                  f"device {dev_us / 1e3:8.3f} ms/step")
        for dt, key, count in rows[:14]:
            print(f"profile:   {dt:10.1f} us/step  x{count:<4d} {key[:100]}")
    sv = bst_serve_phase(dev, trainer, state, os.path.join(ckroot, "bst"), seed, cfg)
    print(f"BST serving: restored in {sv['restore_s']:.2f} s (saved in "
          f"{sv['save_s']:.2f} s); {sv['requests']} requests launched (flash fwd, "
          f"gather_rows, fused_gather_combine) {sv['launches']} "
          f"({sv['per_request']} gathers per request); "
          f"every answer equal to eval_step's bit for bit; p50 {sv['p50_ms']:.3f} ms, "
          f"p90 {sv['p90_ms']:.3f} ms at batch {cfg['batch']}")
    del trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for line in bst_agreement(dev, seed, cfg):
        print(f"agreement: BST at capacity {cfg['agree_capacity']}, batch "
              f"{cfg['agree_batch']}, {dev.type} vs cpu, {line}")
    return st, sv


# ------------------------------------------------------------ the modelzoo

# WDL, DeepFM, DCN, DCNv2, MaskNet and DIN at the modelzoo's widths
# (modelzoo/common.py: emb 16, capacity 2^20 per table, batch 2048, Adagrad
# 0.05, Adam 1e-3; modelzoo/din/train.py: vocab 100,000, Adagrad 0.2) and
# their own default architectures: the five Criteo models on
# SyntheticCriteo(vocab=1_000_000), DIN on SyntheticBehaviorSequence at its
# default seq_len of 50. Each: 5 checked steps, 20 timed, on to 300;
# held-out AUC over 8 batches of another seed at step 0 and step 300; the
# state saved, restored by Predictor and asked 5 requests of batch 2048.
ZOO = dict(emb_dim=16, capacity=1 << 20, batch=2048, dense_lr=1e-3, checked=5,
           timed=20, steps=300, eval_batches=8, auc_floor=0.60, requests=5,
           criteo=dict(vocab=1_000_000, lr=0.05), din=dict(vocab=100_000, lr=0.2,
                                                          seq_len=50),
           models=("WDL", "DeepFM", "DCN", "DCNv2", "MaskNet", "DIN"))


def zoo_model(name, seed, cfg):
    """(model, data generator factory seed -> generator, sparse lr)."""
    from deeprec_tpu_torch import models
    from deeprec_tpu_torch.data import SyntheticBehaviorSequence, SyntheticCriteo

    model = getattr(models, name)(emb_dim=cfg["emb_dim"], capacity=cfg["capacity"],
                                  seed=seed)
    if name == "DIN":
        d = cfg["din"]
        return model, (lambda s: SyntheticBehaviorSequence(
            batch_size=cfg["batch"], vocab=d["vocab"], seq_len=d["seq_len"], seed=s)), \
            d["lr"]
    d = cfg["criteo"]
    return model, (lambda s: SyntheticCriteo(
        batch_size=cfg["batch"], vocab=d["vocab"], seed=s, num_cat=model.num_cat,
        num_dense=model.num_dense)), d["lr"]


def zoo_run(dev, name, seed, cfg, ckdir):
    """One model of the modelzoo phase: trained, evaluated, saved and served
    (see ZOO). Returns stats."""
    from deeprec_tpu_torch.embedding.combiners import pooled_operands
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.serving import Predictor
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager
    from deeprec_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    model, gen, lr = zoo_model(name, seed, cfg)
    trainer = Trainer(model, Adagrad(lr=lr), adam(cfg["dense_lr"]), device=dev)
    state = trainer.init()
    held = gen(seed + 1)
    evals = [trainer.device_batch(held.batch()) for _ in range(cfg["eval_batches"])]
    auc0 = trainer.evaluate(state, evals)["auc"]
    train_gen = gen(seed)
    n = cfg["checked"]
    staged = [trainer.device_batch(train_gen.batch()) for _ in range(n + cfg["timed"])]
    _sync(dev)

    _zero_row_counts()  # the main path starts here
    losses = []
    for i in range(n):
        state, m = trainer.train_step(state, staged[i])
        losses.append(float(m["loss"]))
    rows = _row_counts()  # ... and ends here
    per_step = _path_launches(trainer)
    if dev.type == "cuda" and rows != tuple(n * c for c in per_step):
        raise AssertionError(f"{name} train path launched (apply_rows_sr, gather_rows) "
                             f"{rows}; {n} steps imply {tuple(n * c for c in per_step)}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite training loss: {losses}")
    fails = sum(int(ts.insert_fails.sum()) for ts in state.tables.values())
    if fails:
        raise AssertionError(f"{name}: {fails} ids failed to insert")
    _sync(dev)
    t1 = time.perf_counter()
    for i in range(n, n + cfg["timed"]):
        state, m = trainer.train_step(state, staged[i])
    _sync(dev)
    timed_s = time.perf_counter() - t1
    del staged
    for _ in range(n + cfg["timed"], cfg["steps"]):
        state, m = trainer.train_step(state, train_gen.batch())
    losses.append(float(m["loss"]))
    auc = trainer.evaluate(state, evals)["auc"]
    if not np.isfinite(losses[-1]) or not auc >= cfg["auc_floor"]:
        raise AssertionError(f"{name} after {state.step} steps: loss {losses[-1]}, "
                             f"held-out AUC {auc} (floor {cfg['auc_floor']})")

    CheckpointManager(ckdir, trainer).save(state)
    p = Predictor(model, ckdir, device=dev)
    serve_gen = gen(seed + 2)
    reqs = [serve_gen.batch() for _ in range(cfg["requests"])]
    want = [trainer.eval_step(state, b)[1].cpu().numpy() for b in reqs]
    _zero_row_counts()  # the main path starts here
    fused_gather_combine.launches = 0
    got, lat = [], []
    for b in reqs:
        t1 = time.perf_counter()
        got.append(p.predict(b))
        lat.append((time.perf_counter() - t1) * 1e3)
    served = (_row_counts()[1], fused_gather_combine.launches)  # ... and ends here
    per_request = _per_request(trainer)
    if dev.type == "cuda" and served != tuple(len(reqs) * c for c in per_request):
        raise AssertionError(f"{name} serving launched (gather_rows, "
                             f"fused_gather_combine) {served}; {len(reqs)} requests "
                             f"imply {tuple(len(reqs) * c for c in per_request)}")
    for g, w in zip(got, want):
        if g.shape != w.shape or not np.array_equal(g, w):
            raise AssertionError(f"{name} serving: Predictor differs from eval_step")
        if not (np.all(np.isfinite(g)) and np.all(g > 0) and np.all(g < 1)):
            raise AssertionError(f"{name} serving: probabilities not finite in (0, 1)")
    # #4 at this model's own serving shape: the first pooled feature of the
    # first request, rows [U, emb] and bags [batch, 1]
    f = next(f for f in trainer.sparse_specs if f.pooling != "none")
    views, _ = p._trainer.forward_views(p._snap.state, p._device_batch(reqs[0]))
    emb, inv, mask = views[f.name]
    row_ix, w = pooled_operands(inv, mask, f.pooling)
    err = compare_combine(emb, row_ix, w, f"{name} serving shape {f.name}: rows "
                          f"{tuple(emb.shape)}, bags {tuple(row_ix.shape)}")
    del views, emb, inv, mask, row_ix, w
    stats = {"rows": rows, "per_step": per_step, "served": served, "err": err,
             "per_request": per_request, "losses": losses, "auc0": auc0, "auc": auc,
             "steps": state.step, "step_ms": timed_s / cfg["timed"] * 1e3,
             "examples_per_s": cfg["timed"] * cfg["batch"] / timed_s,
             "p50_ms": float(np.percentile(lat, 50)),
             "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                         if dev.type == "cuda" else None)}
    del p, trainer, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stats["seconds"] = time.perf_counter() - t0
    return stats


def zoo_phase(dev, seed, cfg, ckroot):
    """Every model of ZOO in turn, each model's tables freed before the
    next. Returns {model: stats}."""
    out = {}
    for name in cfg["models"]:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        st = zoo_run(dev, name, seed, cfg, os.path.join(ckroot, f"zoo-{name}"))
        out[name] = st
        print(f"modelzoo {name}: emb {cfg['emb_dim']}, capacity {cfg['capacity']}, "
              f"batch {cfg['batch']}: {cfg['checked']} checked steps launched "
              f"(apply_rows_sr, gather_rows) {st['rows']} ({st['per_step']} per step); "
              f"{st['examples_per_s']:.1f} examples/s over {cfg['timed']} timed steps "
              f"({st['step_ms']:.3f} ms/step); loss step 1 {st['losses'][0]:.6f}, step "
              f"{st['steps']} {st['losses'][-1]:.6f}; held-out AUC {st['auc0']:.6f} at "
              f"step 0, {st['auc']:.6f} at step {st['steps']} (floor "
              f"{cfg['auc_floor']}); served {cfg['requests']} requests equal to "
              f"eval_step bit for bit, (gather_rows, fused_gather_combine) launched "
              f"{st['served']} ({st['per_request']} per request), p50 "
              f"{st['p50_ms']:.3f} ms; peak device memory {st['peak_gb']} GB; "
              f"{st['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ main


def run(dev, seed, full, small, kernel_shapes, batches, timed, train=TRAIN,
        fused=FUSED, flash_shapes=FLASH_SHAPES, bst=BST_RUN, combine=COMBINE,
        combine_edges=COMBINE_EDGES, multi=MULTI, zoo=ZOO):
    """Phases 3-13 on `dev`. Returns the kernel records, in the order of
    the TPU kernels they replace (#1-#9)."""
    t0 = time.perf_counter()
    PAIR_LAUNCHES.update(gather_rows=0, apply_rows_sr=0)
    gathers = kernel_phase(dev, kernel_shapes[0], kernel_shapes[1:], seed)
    scatters = scatter_phase(dev, kernel_shapes[0], kernel_shapes[1:], seed)
    rec = {"gather_rows_pair": gathers[torch.bfloat16],
           "apply_rows_sr_pair": scatters[torch.bfloat16],
           "gather_rows": gathers[torch.float32],
           "fused_gather_combine": combine_phase(dev, seed, combine, combine_edges),
           "apply_rows_sr": scatters[torch.float32]}
    gather, scatter, pooled = (rec[k] for k in ("gather_rows", "apply_rows_sr",
                                                "fused_gather_combine"))
    print(f"phase 3 (kernels against their plain versions) took "
          f"{time.perf_counter() - t0:.1f} s")

    ckroot = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckroot, ignore_errors=True)
    try:
        p, batch, st, host = serve_phase(dev, full, LIVE_KEYS,
                                         os.path.join(ckroot, "full"), seed, batches,
                                         timed)
        gather["launches"] = st["launches"]
        pooled["launches"] = st["combine_launches"]
        print(f"serving: DLRM-DCN {full} restored in {st['restore_s']:.2f} s "
              f"(checkpoint written in {st['write_s']:.2f} s), "
              f"{st['requests']} requests, gather_rows launches {st['launches']} "
              f"({st['launches_per_request']} per request), fused_gather_combine "
              f"launches {st['combine_launches']} ({st['pooled']} per request), "
              f"{st['live_ids_checked']} looked-up ids checked row for row, "
              f"probe loop {st['probe_syncs']:.1f} host syncs per request")
        print(f"serving: predict latency at batch {batches[0]}: "
              f"p50 {st['p50_ms']} ms, p90 {st['p90_ms']} ms over {timed}; "
              f"peak device memory {st['peak_gb']} GB")
        if dev.type == "cuda":
            try:
                profile_predict(p, batch, st["p50_ms"])
            except Exception as e:  # a measurement, not a phase of the contract
                print(f"profile: not measured ({type(e).__name__}: {e})")

        mh = multi_hot_phase(dev, p, host, seed, multi)
        gather["launches"] += mh["launches"][0]
        pooled["launches"] += mh["launches"][1]
        pooled["max_abs_err"] = max(pooled["max_abs_err"], mh["err"])
        print(f"multi-hot serving: {mh['requests']} requests (bags of the MLPerf "
              f"multi-hot sizes padded to L = {max(MULTI_HOT)}; {mh['ids']} real ids in "
              f"the L = {max(MULTI_HOT)} feature of batch {multi['batch']}) launched "
              f"(gather_rows, fused_gather_combine) {mh['launches']} "
              f"({mh['per_request']} per request); probabilities finite in (0, 1); "
              f"{mh['bags_checked']} pooled bags bit-exact against numpy; p50 "
              f"{mh['p50_ms']:.3f} ms, p90 {mh['p90_ms']:.3f} ms at batch "
              f"{multi['batch']} over {multi['timed']}; {mh['seconds']:.1f} s")
        if "profile" in mh:
            wall, busy, kernels, rows, combine_us = mh["profile"]
            print(f"profile: {multi['profiled']} multi-hot predicts of batch "
                  f"{multi['batch']}: wall {wall / 1e3:.3f} ms/request, device busy "
                  f"{busy / 1e3:.3f} ms/request, idle share {1 - busy / wall:.3f} (of "
                  f"the p50 {1 - busy / 1e3 / mh['p50_ms']:.3f}), {kernels} "
                  f"kernels/request; fused_gather_combine {combine_us / 1e3:.3f} "
                  f"ms/request ({combine_us / busy:.3f} of the device time)")
            for dt, key, count in rows[:12]:
                print(f"profile:   {dt:10.1f} us/request  x{count:<4d} {key[:100]}")
        del p
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        probs, multi_probs = {}, {}
        for d in (dev, torch.device("cpu")):
            path = os.path.join(ckroot, f"small-{d.type}")
            q, b, _, small_host = serve_phase(d, small, SMALL_LIVE, path, seed, [256], 0)
            probs[d.type] = q.predict(b)
            multi_probs[d.type] = q.predict(make_multi_hot(
                q.model, small_host, 256, np.random.default_rng(seed + 43)))
            del q
        diff = float(np.abs(probs[dev.type] - probs["cpu"]).max())
        multi_diff = float(np.abs(multi_probs[dev.type] - multi_probs["cpu"]).max())
        print(f"agreement: capacity {small['capacity']} on {dev.type} vs cpu, "
              f"max |prob diff| {diff:.3g} one-hot, {multi_diff:.3g} multi-hot "
              f"(tolerance {PROB_ATOL})")
        if diff > PROB_ATOL or multi_diff > PROB_ATOL:
            raise AssertionError("card and CPU probabilities disagree")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        tst = run_training(dev, full, small, ckroot, seed, train)
        gather["launches"] += tst["launches"][1]
        scatter["launches"] = tst["launches"][0]
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        fst, f_rec, b_rec = fused_phase(dev, seed, fused)
        rec["fused_sparse_forward"], rec["fused_sparse_backward"] = f_rec, b_rec
        gather["launches"] += fst["launches"][2]
        scatter["launches"] += fst["launches"][3]
        print(f"fused bag step: {fst['groups']} bag-length groups of the MLPerf "
              f"multi-hot sizes, {fused['checked']} checked steps launched "
              f"(fused_sparse_forward, fused_sparse_backward, gather_rows, "
              f"apply_rows_sr) {fst['launches']} times; {fst['rows_compared']} "
              f"rows compared bit for bit")
        print(f"fused bag step: {fst['step_ms']:.3f} ms/step over {fused['timed']} "
              f"timed steps ({fst['examples_per_s']:.1f} examples/s); byte bound "
              f"forward {fst['bytes'][0] / HBM_BYTES_PER_S * 1e3:.5f} ms, backward "
              f"{fst['bytes'][1] / HBM_BYTES_PER_S * 1e3:.5f} ms per step; peak "
              f"device memory {fst['peak_gb']} GB on the main path, "
              f"{fst.get('peak_gb_checks')} GB with the checks' copies")
        if "profile" in fst:
            wall, busy, kernels, rows, _ = fst["profile"]
            print(f"profile: 2 fused steps: wall {wall / 1e3:.3f} ms/step, device "
                  f"busy {busy / 1e3:.3f} ms/step, idle share {1 - busy / wall:.3f} "
                  f"(of the timed step {1 - busy / 1e3 / fst['step_ms']:.3f}), "
                  f"{kernels} kernels/step")
            for dt, key, count in rows[:16]:
                print(f"profile:   {dt:10.1f} us/step  x{count:<4d} {key[:100]}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        bud = budget_phase(dev, full, seed, train)
        gather["launches"] += bud["launches"][1]
        scatter["launches"] += bud["launches"][0]
        fr = {b: r.get("unique_budget_fraction") for b, r in bud["report"].items()}
        print(f"budgeted training: DLRM-DCN {full}, Trainer(unique_budget='auto'), "
              f"batch {train['batch']}: unique fraction "
              f"{ {b: r.get('unique_fraction') for b, r in bud['report'].items()} }, "
              f"budget fraction {fr}, unique size (before, after update_budgets) "
              f"{bud['sizes']}; dedup_overflow 0; losses {bud['losses'][0]:.6f} .. "
              f"{bud['losses'][-1]:.6f}; launched (apply_rows_sr, gather_rows) "
              f"{bud['launches']}; hash-dedup probe loop "
              f"{bud['probe_syncs_per_step']:.1f} host syncs per step")
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        f_rec, b_rec = flash_phase(dev, seed, bst, flash_shapes)
        rec["flash_attention_fwd"], rec["flash_attention_bwd"] = f_rec, b_rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        st, sv = run_bst(dev, seed, bst, ckroot)
        f_rec["launches"] = st["flash"][0] + sv["launches"][0]
        b_rec["launches"] = st["flash"][1]
        gather["launches"] += st["rows"][1] + sv["launches"][1]
        scatter["launches"] += st["rows"][0]
        pooled["launches"] += sv["launches"][2]
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        for zs in zoo_phase(dev, seed, zoo, ckroot).values():
            gather["launches"] += zs["rows"][1] + zs["served"][0]
            scatter["launches"] += zs["rows"][0]
            pooled["launches"] += zs["served"][1]
            pooled["max_abs_err"] = max(pooled["max_abs_err"], zs["err"])
        print(f"phase 13 (the modelzoo) took {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
    # the bf16 launches of #3 and #5 on the main paths are #1's and #2's
    for pair, k in (("gather_rows_pair", gather), ("apply_rows_sr_pair", scatter)):
        rec[pair]["launches"] = PAIR_LAUNCHES[k["name"]]
        k["launches"] -= PAIR_LAUNCHES[k["name"]]
    print(f"main paths: bf16 launches (gather_rows, apply_rows_sr) "
          f"{(PAIR_LAUNCHES['gather_rows'], PAIR_LAUNCHES['apply_rows_sr'])}")
    return list(rec.values())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import deeprec_tpu_torch  # noqa: F401
        from deeprec_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the deeprec_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi)
        t1 = time.perf_counter()
        names = _build.build_all()
        print(f"build: {names} in {time.perf_counter() - t1:.1f} s")
        kernels = run(
            dev, args.seed,
            full=FULL, small=dict(FULL, capacity=SMALL_CAPACITY),
            kernel_shapes=[(26, 1 << 20, 128, 2048), (26, 1 << 20, 128, 1),
                           (26, 1 << 20, 128, 37), (4, 4096, 16, 2048),
                           (4, 4096, 3, 37)],
            batches=[2048] * 5 + [1, 37], timed=30,
        )
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
