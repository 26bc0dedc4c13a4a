"""Time the fused bag step's kernels (#6 `fused_sparse_forward`, #7
`fused_sparse_backward`) of several checkouts of the port side by side on
one card, at chip_smoke.py's phase-8 shapes: 26 f32 tables of 2^20 x 128
with Adagrad(0.05) slots, grouped by the MLPerf multi-hot bag lengths
(12 groups), batch 2048 of zipf(1.2) ids over 10^6 (used as row indices),
10 % pads in multi-hot bags, combiner "sum".

    python3 tools/torch_fused_ab.py ROOT_A ROOT_B [...] [--rounds 2] [--groups]

Each ROOT is a checkout holding `deeprec_tpu_torch/` (its kernels build
into ROOT/build/ at first use). The checkouts are timed in turn, A B ...
then in reverse, for `--rounds` rounds, each in a process of its own that
imports the package from its ROOT and prints one JSON line: per 12-group
step, the device ms of all calls of #6 and of #7 (torch.profiler over 10
steps, chip_smoke's `_ms`) and their host ms (CUDA events around 10
back-to-back steps), `embedding_bag`'s device ms on the same bags, the
six kernels that take the most device time in each, and the device
operations of one call of each at the L = 100 and L = 1 groups; with
`--groups`, each group's three costliest kernels per call of each. Prints the card's name and power limit first, then one line per
checkout and round, then the medians. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_checkout(root, seed, groups=False):
    """Time one checkout (see the module docstring); returns a dict."""
    sys.path.insert(0, HERE)  # chip_smoke's timers and the phase-8 constants
    import chip_smoke as cs

    sys.path.insert(0, root)  # the package under test
    from deeprec_tpu_torch.ops import fused_lookup as fl
    from deeprec_tpu_torch.ops.dedup import resolve_size
    from deeprec_tpu_torch.optim import Adagrad

    dev = torch.device("cuda")
    cfg = cs.FUSED
    opt = Adagrad(lr=cfg["lr"])
    groups = cs.bag_groups(cs.MULTI_HOT)
    rng = np.random.default_rng(seed + 11)
    bags = cs.make_bags(rng, groups, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    items = []
    for L, members in groups.items():
        T, C, D = len(members), cfg["capacity"], cfg["dim"]
        values = torch.empty((T, C, D), device=dev).normal_(0, 0.05, generator=gen)
        slots = {"accum": torch.full((T, C, D), 0.1, device=dev)}
        row_ix = bags[L]
        U = resolve_size(row_ix.shape[1] * L, row_ix.shape[1] * L)
        res = fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)
        items.append((L, values, slots, row_ix, U, res, res.out * 0.25 + 1.0))
    torch.cuda.synchronize()

    def fwd():
        for L, values, _, row_ix, U, _, _ in items:
            fl.fused_sparse_forward(values, row_ix, combiner="sum", unique_size=U)

    def bwd():
        for L, values, slots, row_ix, _, res, grad in items:
            fl.fused_sparse_backward(values, slots, grad, row_ix, res, opt,
                                     combiner="sum", step=1, seed=1)

    lib_args = []
    for L, values, _, row_ix, _, _, _ in items:
        T, C, D = values.shape
        ok = row_ix >= 0
        flat = (torch.arange(T, device=dev)[:, None, None] * C + row_ix.long())[ok]
        per_bag = ok.sum(-1).flatten()
        lib_args.append((flat, values.view(T * C, D), torch.cumsum(per_bag, 0) - per_bag))

    def library():
        for i, w, o in lib_args:
            torch.nn.functional.embedding_bag(i, w, o, mode="sum")

    out = {"root": root}
    out["fwd_ms"], out["fwd_host_ms"] = cs._ms(fwd, dev, reps=10)
    out["bwd_ms"], out["bwd_host_ms"] = cs._ms(bwd, dev, reps=10)
    out["embedding_bag_ms"] = cs._ms(library, dev, reps=10)[0]
    for name, fn in (("fwd", fwd), ("bwd", bwd)):  # device us per step by kernel
        out[f"{name}_kernels"] = [(round(us, 2), key[:60], n)
                                  for us, key, n in cs.profile_device(fn, 3)[3][:6]]
    if groups:  # device us per call by kernel, group by group
        out["groups"] = {}
        for L, values, slots, row_ix, U, res, grad in items:
            calls = {
                "fwd": lambda: fl.fused_sparse_forward(values, row_ix, combiner="sum",
                                                       unique_size=U),
                "bwd": lambda: fl.fused_sparse_backward(values, slots, grad, row_ix, res,
                                                        opt, combiner="sum", step=1, seed=1)}
            out["groups"][L] = {name: [(round(us, 2), key[:40]) for us, key, _ in
                                       cs.profile_device(fn, 5)[3][:3]]
                                for name, fn in calls.items()}
    for L, values, slots, row_ix, U, res, grad in items:
        if L in cfg["compare"]:
            out[f"ops_L{L}"] = (
                cs.device_ops(lambda: fl.fused_sparse_forward(
                    values, row_ix, combiner="sum", unique_size=U)),
                cs.device_ops(lambda: fl.fused_sparse_backward(
                    values, slots, grad, row_ix, res, opt, combiner="sum", step=1,
                    seed=1)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", action="store_true",
                    help="also profile each bag-length group's calls")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_fused_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(time_checkout(os.path.abspath(args.one), args.seed, args.groups)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    roots = [os.path.abspath(r) for r in args.roots]
    results = {r: [] for r in roots}
    for k in range(args.rounds):
        for r in (roots if k % 2 == 0 else roots[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", r,
                                   "--seed", str(args.seed)]
                                  + (["--groups"] if args.groups else []),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            results[r].append(line)
            print(json.dumps(line))
    for r, lines in results.items():
        med = {k: statistics.median(x[k] for x in lines)
               for k in ("fwd_ms", "fwd_host_ms", "bwd_ms", "bwd_host_ms",
                         "embedding_bag_ms")}
        print(f"median over {len(lines)} runs: {r}: {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
