"""Time versions of the port's flash-attention forward kernel (#8) side by
side on one card: f32 at BST's attention shape ([2048, 4, 256, 8], the
inputs of chip_smoke.py's phase 10).

    python3 tools/torch_flash_ab.py A.cu B.cu [...] [--rounds 3]

Each source is built with the port's nvcc flags (ops/_build.py) into
build/flash_ab/. A launcher with the trailing `int bf16` argument is called
with 0; an f32-only launcher without it is called as it is. The sources are
timed in turn, A B ... then in reverse, for `--rounds` rounds, each time
with chip_smoke's `_ms` (device time from torch.profiler over 20 launches,
and CUDA events around 20 back-to-back launches). Every source must give
the same o and lse bit for bit. Prints the card's name and power limit, one
line per source with its device times and their median, and exits 1 on a
build failure or a disagreement. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(src, out_dir):
    from deeprec_tpu_torch.ops import _build

    out = os.path.join(out_dir, f"lib{len(os.listdir(out_dir))}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    takes_dtype = "int bf16" in open(src).read()
    fn = lib.flash_attention_fwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 7
                   + [ctypes.c_int, ctypes.c_float]
                   + ([ctypes.c_int] if takes_dtype else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, takes_dtype


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    dev = torch.device("cuda")
    out_dir = os.path.join(ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    fns = [build(s, out_dir) for s in args.sources]

    q, k, v, mask, _ = chip_smoke._bst_attention_inputs(chip_smoke.BST_RUN, 0, dev)
    B, H, L, D = q.shape
    mask = mask.contiguous()
    scale = 1.0 / D ** 0.5
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for fn, takes_dtype in fns:
        o = torch.empty_like(q)
        lse = torch.empty((B, H, L), device=dev)
        call_args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), B, H, L, L, D, 128, 128, 0, scale]
        call_args += [0] if takes_dtype else []

        def launch(fn=fn, call_args=call_args):
            err = fn(*call_args, stream)
            if err:
                raise RuntimeError(f"launch failed (cudaError {err})")

        launch()
        torch.cuda.synchronize()
        outs.append((launch, o, lse))
    for i, (_, o, lse) in enumerate(outs[1:], 1):
        if not (torch.equal(o, outs[0][1]) and torch.equal(lse, outs[0][2])):
            print(f"{args.sources[i]} differs from {args.sources[0]}", file=sys.stderr)
            return 1
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for _ in range(args.rounds):
        for i in order + order[::-1]:
            times[i].append(chip_smoke._ms(outs[i][0], dev, reps=20))
    print(f"flash forward f32 [{B}, {H}, {L}, {D}], blocks 128/128, not causal; "
          f"o and lse equal bit for bit across sources")
    for src, ts in zip(args.sources, times):
        device = [t[0] for t in ts]
        print(f"{src}: device ms {device}, median {float(np.median(device))}; "
              f"per-call ms median {float(np.median([t[1] for t in ts]))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
