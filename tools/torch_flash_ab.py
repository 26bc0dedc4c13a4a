"""Time the flash-attention kernels (#8 forward; #9 backward: the dK/dV and
dQ launches and, where a checkout computes it apart, `delta`) of several
checkouts of the port side by side on one card, at BST's attention shape:
f32 [2048, 4, 256, 8] with BST's key mask (the inputs of chip_smoke.py's
phase 10, seed 0), not causal, blocks 128/128.

    python3 tools/torch_flash_ab.py ROOT_A ROOT_B [...] [--rounds 2]

Each ROOT is a checkout holding `deeprec_tpu_torch/` (its kernels build
into ROOT/build/ at first use). The checkouts are timed in turn, A B ...
then in reverse, for `--rounds` rounds, each in a process of its own that
imports the package from its ROOT and prints one JSON line:
- the forward wrapper's and the backward wrapper's device ms per call
  (chip_smoke's `_ms`: torch.profiler over 100 calls) and per-call ms
  (CUDA events around 100 back-to-back calls), and the device ms of each
  kernel the backward launches (dK/dV, dQ, and any `delta` reduction);
- each output's error against the plain versions, held to the flash
  tolerances (o and lse within 1e-5 * max(1, |plain|), gradients within
  1e-4 of the largest |plain| gradient);
- the forward's and the backward's device ms at the head widths OTHER
  (f32, D 32, 64 and 128, masks of lengths in [S/2, S], not causal), each
  output held to the same tolerances.
The backward runs from the plain forward's o and lse, so both sides get the
same inputs. The first round's outputs of each checkout are saved under
build/flash_ab/ and every checkout is held against the first one with the
same tolerances (the kernels are not bit-equal across designs).
`nvidia-smi --query-gpu=clocks.sm,clocks_throttle_reasons.active` is
printed before and after each round. Prints the card's name and power
limit first, then one line per checkout and round, then the medians; exits
1 on a failed check. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(HERE, "build", "flash_ab")
REPS, SEED = 100, 0
# (B, H, L, D): the other head widths, whose registers the kernels must hold
OTHER = ((128, 4, 256, 32), (64, 4, 256, 64), (32, 4, 256, 128))


def smi(query):
    """nvidia-smi's answer to --query-gpu=`query` (csv, no header), or its
    error message. The clock event reasons field was renamed in newer
    releases, so the old name is tried first and then the new one."""
    out = ""
    for name in ("clocks_throttle_reasons.active", "clocks_event_reasons.active"):
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query.replace('REASONS', name)}",
                            "--format=csv,noheader"], capture_output=True, text=True)
        out = (r.stdout if r.returncode == 0 else r.stdout + r.stderr).strip()
        if r.returncode == 0 or "REASONS" not in query:
            break
    return out


def kernel_ms(fn):
    """{kernel: device ms per call} of fn() over REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total:
            key = next((k for k in ("dkdv_kernel", "dq_kernel") if k in e.key), e.key[:60])
            out[key] = out.get(key, 0.0) + e.self_device_time_total / REPS / 1e3
    return out


def time_checkout(root, save):
    """Time one checkout (see the module docstring); returns a dict."""
    sys.path.insert(0, HERE)  # chip_smoke's timers, tolerances and inputs
    import chip_smoke as cs

    sys.path.insert(0, root)  # the package under test
    from deeprec_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask, do = cs._bst_attention_inputs(cs.BST_RUN, SEED, dev)
    scale = 1.0 / q.shape[-1] ** 0.5
    po, plse = fa.flash_forward_plain(q, k, v, mask, False, scale, 128, 128)
    pgrads = fa.flash_backward_plain(q, k, v, mask, False, scale, 128, 128, po, plse, do)

    def forward():
        return fa.flash_forward(q, k, v, mask, False, scale, 128, 128)

    def backward():
        return fa.flash_backward(q, k, v, mask, False, scale, 128, 128, po, plse, do)

    res = {"root": root, "real_keys": int(mask.sum())}
    for label, fn in (("fwd", forward), ("bwd", backward)):
        dev_ms, call_ms = cs._ms(fn, dev, reps=REPS)
        res[label] = {"device_ms": dev_ms, "call_ms": call_ms}
    res["bwd_kernels_ms"] = kernel_ms(backward)

    o, lse = forward()
    grads = backward()
    torch.cuda.synchronize()
    res["vs_plain"] = {}
    for name, a, b, grad in (("o", o, po, False), ("lse", lse, plse, False),
                             ("dq", grads[0], pgrads[0], True),
                             ("dk", grads[1], pgrads[1], True),
                             ("dv", grads[2], pgrads[2], True)):
        res["vs_plain"][name] = list(cs._flash_errs(a, b, grad))
    res["other"] = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    for Bw, Hw, Lw, Dw in OTHER:
        qw, kw, vw, dow = (torch.randn((Bw, Hw, Lw, Dw), generator=g, device=dev)
                           for _ in range(4))
        lengths = torch.randint(Lw // 2, Lw + 1, (Bw,), generator=g, device=dev)
        mw = torch.arange(Lw, device=dev)[None, :] < lengths[:, None]
        sw = 1.0 / Dw ** 0.5
        pw = fa.flash_forward_plain(qw, kw, vw, mw, False, sw, 128, 128)
        fw = lambda: fa.flash_forward(qw, kw, vw, mw, False, sw, 128, 128)
        bw = lambda: fa.flash_backward(qw, kw, vw, mw, False, sw, 128, 128, *pw, dow)
        errs = [cs._flash_errs(a, b, False) for a, b in zip(fw(), pw)]
        errs += [cs._flash_errs(a, b, True) for a, b in
                 zip(bw(), fa.flash_backward_plain(qw, kw, vw, mw, False, sw, 128, 128,
                                                   *pw, dow))]
        res["other"][f"[{Bw}, {Hw}, {Lw}, {Dw}]"] = {
            "fwd_ms": cs._ms(fw, dev, reps=20)[0], "bwd_ms": cs._ms(bw, dev, reps=20)[0],
            "within_tolerance": all(m <= t for _, m, t in errs)}
        del qw, kw, vw, dow, pw
    if save:
        torch.save({"o": o.cpu(), "lse": lse.cpu(), "dq": grads[0].cpu(),
                    "dk": grads[1].cpu(), "dv": grads[2].cpu()}, save)
    return res


def agree(path_a, path_b):
    """{output: [max abs err, measure, tolerance]} of B's outputs against
    A's, with the flash tolerances (chip_smoke._flash_errs)."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    a, b = torch.load(path_a), torch.load(path_b)
    return {name: list(cs._flash_errs(b[name].cuda(), a[name].cuda(), name[0] == "d"))
            for name in ("o", "lse", "dq", "dk", "dv")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(time_checkout(os.path.abspath(args.roots[0]), args.save)))
        return 0

    print(smi("name,power.limit"))
    os.makedirs(OUT_DIR, exist_ok=True)
    roots = [os.path.abspath(r) for r in args.roots]
    order = list(range(len(roots)))
    results = [[] for _ in roots]
    saved = {}
    failed = False
    for rnd in range(args.rounds):
        print(f"round {rnd} before: " + smi("clocks.sm,REASONS"))
        for i in order + order[::-1]:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", roots[i]]
            if i not in saved:
                saved[i] = os.path.join(OUT_DIR, f"side{i}.pt")
                cmd += ["--save", saved[i]]
            out = subprocess.run(cmd, capture_output=True, text=True)
            if out.returncode != 0:
                print(f"{roots[i]} failed:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
                return 1
            res = json.loads(out.stdout.strip().splitlines()[-1])
            results[i].append(res)
            print(json.dumps({"round": rnd, **res}))
            for name, (err, measure, tol) in res["vs_plain"].items():
                if not measure <= tol:
                    print(f"{roots[i]}: {name} off the plain version by {measure} "
                          f"(tolerance {tol})")
                    failed = True
            for shape, w in res["other"].items():
                if not w["within_tolerance"]:
                    print(f"{roots[i]}: {shape} off the plain version")
                    failed = True
        print(f"round {rnd} after: " + smi("clocks.sm,REASONS"))
    for i in order[1:]:
        errs = agree(saved[0], saved[i])
        print(f"{roots[i]} against {roots[0]}: "
              + ", ".join(f"{n} {e[0]:.3g} ({e[1]:.3g} <= {e[2]:.3g})"
                          for n, e in errs.items()))
        failed |= any(not e[1] <= e[2] for e in errs.values())

    print(f"medians over {args.rounds} rounds x 2, f32 [2048, 4, 256, 8], BST's mask:")
    for root, rs in zip(roots, results):
        med = {label: float(np.median([r[label]["device_ms"] for r in rs]))
               for label in ("fwd", "bwd")}
        kernels = {}
        for r in rs:
            for name, ms in r["bwd_kernels_ms"].items():
                kernels.setdefault(name, []).append(ms)
        med["bwd_kernels"] = {n: float(np.median(t)) for n, t in kernels.items()}
        med["other"] = {shape: {k: float(np.median([r["other"][shape][k] for r in rs]))
                                for k in ("fwd_ms", "bwd_ms")} for shape in rs[0]["other"]}
        print(f"{root}: {json.dumps(med)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
