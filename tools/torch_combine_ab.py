"""Time the read-only pooling of kernel #4 (`fused_gather_combine`) of
several checkouts of the port side by side on one card, at each main
path's group of pooled features (chip_smoke.py's `combine_groups`): 26
one-hot features at D 128 (DLRM-DCN serving), 26 at D 16 (the modelzoo),
BST's 3 at D 16, and the 26 multi-hot features at the MLPerf bag lengths
padded to 100 (D 128); batch 2048, each feature's rows the U = N view of a
stacked [F, U, D] f32 table, 5 % of the real positions pads, mean pooling.

    python3 tools/torch_combine_ab.py ROOT_A ROOT_B [...] [--rounds 2]

Each ROOT is a checkout holding `deeprec_tpu_torch/` (its kernels build
into ROOT/build/ at first use). The checkouts are timed in turn, A B ...
then in reverse, for `--rounds` rounds, each in a process of its own that
imports the package from its ROOT and prints one JSON line. Per group, one
request's pooling as that checkout's read-only forward does it, from the
views (unique rows, inverse, mask) to the pooled [B, D] inputs: through
`combiners.combine_pooled_group` where the checkout has it, else
`combiners.combine_pooled` feature by feature. It reports #4's device ms
per request (the `gather_combine_kernel` launches alone, torch.profiler),
the device ms of every operation of the pooling, the host ms per request
(CUDA events around back-to-back requests: the host's launch interval
where that is longer than the device work), `embedding_bag`'s device ms
(one call per feature on the same rows and weights), and #4's device ms at
the multi-hot group's L = 100 feature alone. Prints the card's name and
power limit first, then one line per checkout and round, then the medians.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("kernel_ms", "pool_ms", "host_ms", "embedding_bag_ms")
SEED = 0  # as chip_smoke.py


def _views(name, D, lengths, B, g, dev):
    """Per feature (rows [U, D], inverse [B, Lp] int32, mask [B, Lp]) of a
    path's group: U = B * Lp rows of a stacked f32 table, distinct rows for
    the first L positions of each bag, 5 % of them pads, -1 past L."""
    U = B * lengths[0][1]
    table = torch.randn((len(lengths), U, D), generator=g, device=dev)
    views = []
    for t, (L, width) in enumerate(lengths):
        inverse = torch.zeros((B, width), dtype=torch.int32, device=dev)
        inverse[:, :L] = torch.randperm(U, generator=g, device=dev)[:B * L].view(B, L)
        mask = torch.zeros((B, width), dtype=torch.bool, device=dev)
        mask[:, :L] = torch.rand((B, L), generator=g, device=dev) >= 0.05
        views.append((table[t], inverse, mask))
    return views


def time_checkout(root):
    """Time one checkout (see the module docstring); returns a dict."""
    sys.path.insert(0, HERE)  # chip_smoke's timers and the path groups
    import chip_smoke as cs

    sys.path.insert(0, root)  # the package under test
    from deeprec_tpu_torch.embedding import combiners
    from deeprec_tpu_torch.ops.fused_lookup import fused_gather_combine

    dev = torch.device("cuda")
    B = cs.COMBINE["batch"]
    g = torch.Generator(device=dev).manual_seed(SEED)
    grouped = hasattr(combiners, "combine_pooled_group")
    out = {"root": root, "grouped": grouped}
    for name, D, lengths in cs.combine_groups():
        views = _views(name, D, lengths, B, g, dev)
        embs, inverses, masks = (list(x) for x in zip(*views))
        means = ["mean"] * len(views)
        if grouped:
            def pool():
                return combiners.combine_pooled_group(embs, inverses, masks, means)
        else:
            def pool():
                return [combiners.combine_pooled(e, i, m, "mean") for e, i, m in views]
        operands = [combiners.pooled_operands(i, m, "mean") for _, i, m in views]
        lib = [(ix.clamp(min=0), w) for ix, w in operands]

        def library():
            return [torch.nn.functional.embedding_bag(ix, e, per_sample_weights=w,
                                                      mode="sum")
                    for e, (ix, w) in zip(embs, lib)]

        pool_ms, host_ms = cs._ms(pool, dev, reps=50)
        rows = cs.profile_device(pool, 20)[3]
        out[name] = {
            "kernel_ms": sum(us for us, key, _ in rows if "gather_combine_kernel" in key)
            / 1e3,
            "pool_ms": pool_ms, "host_ms": host_ms,
            "embedding_bag_ms": cs._ms(library, dev, reps=50)[0],
            "ops": [(round(us, 2), key[:50], n) for us, key, n in rows[:6]],
        }
        if name == "multi-hot":
            t = lengths.index(max(lengths))
            (ix, w), e = operands[t], embs[t]
            out["L100_ms"] = cs._ms(lambda: fused_gather_combine(e, ix, w), dev, reps=50)[0]
        del views, embs, inverses, masks, operands, lib
        torch.cuda.empty_cache()
    return out


def _smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_combine_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(time_checkout(os.path.abspath(args.one))))
        return 0
    print(_smi("name,power.limit"))
    roots = [os.path.abspath(r) for r in args.roots]
    results = {r: [] for r in roots}
    for k in range(args.rounds):
        for r in (roots if k % 2 == 0 else roots[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", r],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            results[r].append(line)
            print(json.dumps(line))
            print(f"SM clock after: {_smi('clocks.sm,clocks_event_reasons.active')}")
    for r, lines in results.items():
        med = {name: {k: statistics.median(x[name][k] for x in lines) for k in KEYS}
               for name in lines[0] if isinstance(lines[0][name], dict)}
        med["L100_ms"] = statistics.median(x["L100_ms"] for x in lines)
        print(f"median over {len(lines)} runs: {r}: {json.dumps(med)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
