#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deeprec_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which must pass:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the serving path from csrc/ (one nvcc per
     source, started together);
  3. each kernel against its plain PyTorch version on the card, bit-exact,
     at the serving path's shape (26 tables x 2^20 slots x 128, 2048 ids per
     table) and at edge shapes, with its time, the plain version's time,
     one PyTorch library call's time and the memory-bound least time;
  4. the serving main path at full width: MLPerf DLRM-DCN (emb_dim 128,
     26 x 2^20-slot tables, bottom 512-256-128, top 512-256-1, cross depth
     3) restored from a full checkpoint written with numpy from --seed
     (2^17 live keys per table), answering 5 requests of batch 2048 and one
     each of batch 1 and 37 (ids 90% live, 5% unseen, 5% pad). Live ids must
     return their checkpoint row bit for bit, unseen ids the blocked default,
     probabilities must be finite in (0, 1), and every kernel of the path
     must have launched during those requests;
  5. the same model at capacity 2^12 restored on the card and on the CPU,
     answering one batch within PROB_ATOL.

Prints the kernel table as one JSON line, then as the last line
{"ok": true, "device": {...}}. Exits non-zero, with no result line, when a
phase fails, when CUDA is absent, or when the package is missing.
"""
from __future__ import annotations

import argparse
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

FULL = dict(emb_dim=128, capacity=1 << 20, bottom=(512, 256, 128))
LIVE_KEYS = 1 << 17
SMALL_CAPACITY, SMALL_LIVE = 1 << 12, 1500


def _ms(fn, dev, reps=50):
    """Mean device time of fn() in ms: CUDA events around `reps` calls
    after a warm-up. None off the card (a CPU rehearsal measures nothing)."""
    if dev.type != "cuda":
        return None
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------ phase 3


def kernel_phase(dev, main_shape, edge_shapes, seed):
    """gather_rows against its plain version; returns the kernel record
    (timed at the main shape in f32, the serving table dtype)."""
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows, gather_rows_plain

    g = torch.Generator(device=dev).manual_seed(seed)
    record = None
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
            if record is None and (T, C, D, n) == tuple(main_shape):
                record = time_gather(values, n, g, err)
            del values
        del values32, ix
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record


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

    def cycled(fn, args):
        it = itertools.cycle(args)
        return _ms(lambda: fn(*next(it)), dev)

    return {
        "name": "gather_rows", "route": "cuda",
        "source": "deeprec_tpu_torch/csrc/gather_rows.cu",
        "replaces": "deeprec_tpu/ops/fused_lookup.py:367",
        "launches": 0, "max_abs_err": err,
        "ms": cycled(gather_rows, [(values, ix) for ix in ixs]),
        "plain_ms": cycled(gather_rows_plain, [(values, ix) for ix in ixs]),
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": cycled(torch.index_select, [(flat, 0, gi) for gi in gidx]),
    }


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


def serve_phase(dev, model_kw, live, ckdir, seed, batches, timed):
    """Write a checkpoint, restore it through Predictor and answer
    `batches` on the main path, counting kernel launches; then time
    `timed` more requests of the first batch. Returns (predictor, first
    batch, stats)."""
    from deeprec_tpu_torch.models import DLRMDCN
    from deeprec_tpu_torch.ops.fused_lookup import gather_rows
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

    gather_rows.launches = 0  # the main path's run starts here
    for b in reqs:
        probs = p.predict(b)
        n = len(next(iter(b.values())))
        if probs.shape != (n,) or not np.all(np.isfinite(probs)) or not (
                np.all(probs > 0) and np.all(probs < 1)):
            raise AssertionError(f"batch {n}: probabilities not finite in (0, 1)")
    launches = gather_rows.launches  # ... and ends here
    per_request = sum(1 if b.stacked else len(b.features)
                      for b in p._trainer.bundles.values())
    if dev.type == "cuda" and launches != per_request * len(reqs):
        raise AssertionError(
            f"gather_rows launched {launches} times on the main path, the path "
            f"implies {per_request * len(reqs)}")
    live_checked = check_rows(p, host, reqs[0])

    lat = []
    for _ in range(timed):
        t0 = time.perf_counter()
        p.predict(reqs[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    stats = {
        "write_s": write_s, "restore_s": restore_s, "launches": launches,
        "requests": len(reqs), "launches_per_request": per_request,
        "live_ids_checked": live_checked,
        "p50_ms": float(np.percentile(lat, 50)) if lat else None,
        "p90_ms": float(np.percentile(lat, 90)) if lat else None,
        "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                    if dev.type == "cuda" else None),
    }
    return p, reqs[0], stats


def profile_predict(p, batch, p50_ms, reps=5):
    """Device kernel time by name over `reps` predicts, and the share of
    wall time the device was idle: of the profiled wall time, and of the
    unprofiled p50 latency (the profiler slows the host, not the device).
    The first profiled window (CUPTI start-up) is discarded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for n in (1, reps):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                p.predict(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = [
        (e.self_device_time_total, e.key, e.count)
        for e in prof.key_averages()
        if getattr(e, "device_type", None) == DeviceType.CUDA
    ]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: {reps} predicts of batch {len(next(iter(batch.values())))}: "
          f"wall {wall_us / reps / 1e3:.3f} ms/request, device busy "
          f"{busy / reps / 1e3:.3f} ms/request, idle share "
          f"{1 - busy / wall_us:.3f} (of the p50 latency "
          f"{1 - busy / reps / 1e3 / p50_ms:.3f}), "
          f"{sum(r[2] for r in rows) // reps} kernels/request")
    for dt, key, count in rows[:12]:
        print(f"profile:   {dt / reps:10.1f} us/request  x{count // reps:<4d} {key[:100]}")


# ------------------------------------------------------------ main


def run(dev, seed, full, small, kernel_shapes, batches, timed):
    """Phases 3-5 on `dev`. Returns the kernel records."""
    record = kernel_phase(dev, kernel_shapes[0], kernel_shapes[1:], seed)

    ckroot = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckroot, ignore_errors=True)
    try:
        p, batch, st = serve_phase(dev, full, LIVE_KEYS,
                                   os.path.join(ckroot, "full"), seed, batches, timed)
        record["launches"] = st["launches"]
        print(f"serving: DLRM-DCN {full} restored in {st['restore_s']:.2f} s "
              f"(checkpoint written in {st['write_s']:.2f} s), "
              f"{st['requests']} requests, gather_rows launches {st['launches']} "
              f"({st['launches_per_request']} per request), "
              f"{st['live_ids_checked']} looked-up ids checked row for row")
        print(f"serving: predict latency at batch {batches[0]}: "
              f"p50 {st['p50_ms']} ms, p90 {st['p90_ms']} ms over {timed}; "
              f"peak device memory {st['peak_gb']} GB")
        if dev.type == "cuda":
            try:
                profile_predict(p, batch, st["p50_ms"])
            except Exception as e:  # a measurement, not a phase of the contract
                print(f"profile: not measured ({type(e).__name__}: {e})")
        del p
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        probs = {}
        for d in (dev, torch.device("cpu")):
            path = os.path.join(ckroot, f"small-{d.type}")
            q, b, _ = serve_phase(d, small, SMALL_LIVE, path, seed, [256], 0)
            probs[d.type] = q.predict(b)
            del q
        diff = float(np.abs(probs[dev.type] - probs["cpu"]).max())
        print(f"agreement: capacity {small['capacity']} on {dev.type} vs cpu, "
              f"max |prob diff| {diff:.3g} (tolerance {PROB_ATOL})")
        if diff > PROB_ATOL:
            raise AssertionError("card and CPU probabilities disagree")
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
    return [record]


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
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi)
        t0 = time.perf_counter()
        names = _build.build_all()
        print(f"build: {names} in {time.perf_counter() - t0:.1f} s")
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
