"""PyTorch + CUDA port of deeprec_tpu for NVIDIA Hopper (H100).

The package mirrors `deeprec_tpu`'s module layout and names so each
counterpart is easy to find; inside it is plain PyTorch (nn.Modules, tensor
functions, explicit devices). It imports torch and numpy only — never jax
and never anything of `deeprec_tpu`.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; without a card and without that explicit request they
raise (`resolve_device`). Kernel wrappers launch their hand-written CUDA
kernel for a CUDA tensor and use their plain PyTorch version only for a
CPU tensor.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, `cpu` only
    when asked for. Raises when CUDA is wanted but absent — there is no
    silent CPU fallback. On CUDA, float32 products run in full float32
    (TF32 off), which is what the JAX reference computes."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deeprec_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
