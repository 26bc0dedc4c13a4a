"""Flash attention — the port of `deeprec_tpu/ops/flash_attention.py`: the
Pallas forward `_pallas_forward` (#8) and the flash-2 backward
`_pallas_backward` (#9), as hand-written CUDA kernels
(`csrc/flash_attention_fwd.cu`, `csrc/flash_attention_bwd.cu`) behind
`flash_forward` / `flash_backward`, and `FlashAttention`, the
`torch.autograd.Function` that joins them (JAX's `custom_vjp`).

Each wrapper launches its kernel for CUDA tensors and counts the launch in
`<wrapper>.launches`; for CPU tensors it runs its plain PyTorch version,
which is also what `chip_smoke.py` holds the kernel against on the card.
Nothing falls back: a failed build or launch raises.

Semantics are the Pallas kernels', not the blockwise fallback's. `NEG_INF`
is the finite -1e30, so a query row whose visible keys are ALL masked (a
"dead row") takes exp(s - m) = 1 for every key of every K block that runs:
its output is the mean of v over those keys and its log-sum-exp is -1e30.
Under `causal`, a K block runs for a Q block only when
`kb * block_k <= (qb + 1) * block_q - 1`, at the CALLER's block sizes, so
a dead causal row averages only the keys of the blocks that were not
skipped. The backward zeroes every dead row's probabilities
(`_probs_from_lse`'s guard), so such rows add nothing to dq, dk or dv.

q, k, v (and the backward's do) are all f32 or all bf16, as the JAX
function takes either: every element is upcast on load and the math is f32
throughout; o, dq, dk and dv come back in the inputs' dtype (bf16 rounded
to nearest even, as JAX's `.astype`), lse in f32, and the backward's
`delta` is taken from the stored (rounded) o, as the JAX package takes it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
# Head widths the kernels are compiled for; a head of another width up to
# 128 is zero-padded to the next one (zero columns add nothing to a dot).
_HEAD_DIMS = (8, 16, 32, 64, 128)


# ------------------------------------------------------------ reference


def attention_reference(q, k, v, mask=None, causal: bool = False,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention over the whole [Lq, S] score matrix (the flash=False
    path of `nn.transformer_block_apply`). q [B, H, Lq, D]; k, v [B, H, S,
    D]; mask [B, S] bool, True = real key."""
    Lq, D = q.shape[2], q.shape[3]
    S = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    logits = torch.einsum("bhld,bhsd->bhls", q, k) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    if causal:
        qi = torch.arange(Lq, device=q.device)[:, None]
        ki = torch.arange(S, device=q.device)[None, :]
        logits = torch.where(ki <= qi, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhls,bhsd->bhld", p, v)


# ------------------------------------------------------------ plain versions


def _block_scores(qf, kf, mask, kb, block_k, sm_scale, causal):
    """Scaled q·kᵀ of K block `kb` with the padding and causal masks —
    `_masked_scores` of the JAX package over every query row at once.
    Returns s [B, H, Lq, block_k] f32."""
    Lq = qf.shape[2]
    ks = kf[:, :, kb * block_k:(kb + 1) * block_k]
    s = torch.einsum("bhld,bhsd->bhls", qf, ks) * sm_scale
    mk = mask[:, kb * block_k:(kb + 1) * block_k]
    s = torch.where(mk[:, None, None, :], s, NEG_INF)
    if causal:
        qpos = torch.arange(Lq, device=qf.device)[:, None]
        kpos = kb * block_k + torch.arange(block_k, device=qf.device)[None, :]
        s = torch.where(kpos <= qpos, s, NEG_INF)
    return s


def _block_runs(Lq, kb, block_q, block_k, causal, device):
    """[Lq, 1] bool: which query rows run K block `kb` — the Pallas grid's
    causal skip, `kb * block_k <= (qb + 1) * block_q - 1`, at the caller's
    block sizes (None when not causal: every block runs)."""
    if not causal:
        return None
    qb = torch.arange(Lq, device=device) // block_q
    return (kb * block_k <= (qb + 1) * block_q - 1)[:, None]


def flash_forward_plain(q, k, v, mask, causal: bool, sm_scale: float,
                        block_q: int, block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #8: the Pallas forward's online
    softmax over K blocks, with its running (m, l, acc), its causal skip
    and `l_safe = max(l, 1e-30)`. Returns (o [B, H, Lq, D] in q's dtype,
    lse [B, H, Lq] f32)."""
    B, H, Lq, D = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=torch.float32, device=q.device)  # noqa: DRT003 — keepdims accumulator of the plain version; the kernel keeps its own layout
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)  # noqa: DRT003 — keepdims accumulator, same contract as m above
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for kb in range(k.shape[2] // block_k):
        s = _block_scores(qf, kf, mask, kb, block_k, sm_scale, causal)
        vs = vf[:, :, kb * block_k:(kb + 1) * block_k]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("bhls,bhsd->bhld", p, vs)
        run = _block_runs(Lq, kb, block_q, block_k, causal, q.device)
        if run is None:
            m, l, acc = m_new, l_new, acc_new
        else:
            m = torch.where(run, m_new, m)
            l = torch.where(run, l_new, l)
            acc = torch.where(run, acc_new, acc)
    l_safe = torch.clamp(l, min=1e-30)
    o = (acc / l_safe).to(q.dtype)
    lse = m[..., 0] + torch.log(l_safe[..., 0])
    return o, lse


def _delta(o, do) -> torch.Tensor:
    """rowsum(do * o) in f32, [B, H, Lq], as the JAX package computes it
    outside its Pallas calls (the CUDA dQ kernel computes it per row)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_backward_plain(q, k, v, mask, causal: bool, sm_scale: float,
                         block_q: int, block_k: int, o, lse, do
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #9: exact gradients from the saved
    log-sum-exp, p = exp(s - lse) with the dead-row guard, the causal skip,
    dS = P ∘ (dO·Vᵀ − Δ)·scale. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    Lq = q.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = _delta(o, do)[..., None]
    dead = (lse <= NEG_INF * 0.5)[..., None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for kb in range(k.shape[2] // block_k):
        s = _block_scores(qf, kf, mask, kb, block_k, sm_scale, causal)
        p = torch.where(dead, 0.0, torch.exp(s - lse[..., None]))
        run = _block_runs(Lq, kb, block_q, block_k, causal, q.device)
        if run is not None:
            p = torch.where(run, p, 0.0)
        ks = kf[:, :, kb * block_k:(kb + 1) * block_k]
        vs = vf[:, :, kb * block_k:(kb + 1) * block_k]
        dvs.append(torch.einsum("bhls,bhld->bhsd", p, dof))
        dp = torch.einsum("bhld,bhsd->bhls", dof, vs)
        ds = p * (dp - delta) * sm_scale
        dq = dq + torch.einsum("bhls,bhsd->bhld", ds, ks)
        dks.append(torch.einsum("bhls,bhld->bhsd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


# ------------------------------------------------------------ wrappers


def _check(q, k, v, mask, block_q, block_k, extra=()):
    """Shapes, dtypes and devices the kernels and the JAX function take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: want q [B, H, Lq, D] and k, v [B, H, S, D]")
    B, H, Lq, D = q.shape
    S = k.shape[2]
    if (tuple(k.shape) != (B, H, S, D) or tuple(v.shape) != (B, H, S, D)
            or tuple(mask.shape) != (B, S)):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, mask {tuple(mask.shape)} do not agree")
    if block_q <= 0 or block_k <= 0 or Lq % block_q or S % block_k:
        raise ValueError(
            f"flash_attention: Lq={Lq} and S={S} must be multiples of "
            f"block_q={block_q} and block_k={block_k} (pad outside)")
    if D > _HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head dimension {D} above {_HEAD_DIMS[-1]}")
    if mask.dtype != torch.bool:
        raise TypeError(f"flash_attention: mask must be bool, got {mask.dtype}")
    tensors = (q, k, v, *extra)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(
            "flash_attention: q, k, v (and do) must share one dtype, float32 "
            f"or bfloat16; got {[str(t.dtype) for t in tensors]}")
    if any(t.device != q.device for t in (*tensors, mask)):
        raise ValueError("flash_attention: all tensors must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def _padded(x: torch.Tensor, dp: int) -> torch.Tensor:
    """x [..., D] contiguous, zero-padded to width dp, starting on a
    16-byte boundary (the kernels load tiles as float4)."""
    if x.shape[-1] != dp:
        return torch.nn.functional.pad(x, (0, dp - x.shape[-1])).contiguous()
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _head_bucket(D: int) -> int:
    return next(d for d in _HEAD_DIMS if d >= D)


def _launch(name: str, entry: str, device, *args) -> None:
    from deeprec_tpu_torch.ops import _build

    lib = _build.load(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def flash_forward(q, k, v, mask, causal: bool, sm_scale: float,
                  block_q: int = 128, block_k: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #8: (o [B, H, Lq, D] in q's dtype, lse [B, H, Lq] f32)."""
    _check(q, k, v, mask, block_q, block_k)
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, mask, causal, sm_scale, block_q, block_k)
    B, H, Lq, D = q.shape
    S = k.shape[2]
    dp = _head_bucket(D)
    qp, kp, vp = _padded(q, dp), _padded(k, dp), _padded(v, dp)
    mask = mask.contiguous()
    o = torch.empty((B, H, Lq, dp), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    if B * H * Lq == 0:
        return o[..., :D], lse
    _launch("flash_attention_fwd", "flash_attention_fwd_launch", q.device,
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), mask.data_ptr(),
            o.data_ptr(), lse.data_ptr(), B, H, Lq, S, dp, block_q, block_k,
            int(causal), float(sm_scale), int(q.dtype == torch.bfloat16))
    flash_forward.launches += 1
    return (o if dp == D else o[..., :D].contiguous()), lse


flash_forward.launches = 0


def flash_backward(q, k, v, mask, causal: bool, sm_scale: float,
                   block_q: int, block_k: int, o, lse, do
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel #9, two launches as the Pallas backward has two calls: dQ (one
    Q tile per block, real K rows streamed), which also writes `delta =
    rowsum(do * o)` per row from the stored o, then dK/dV (a group of the
    batch row's real keys per block, Q tiles streamed), counted in
    `.launches_dq` and `.launches_dkdv`."""
    _check(q, k, v, mask, block_q, block_k, extra=(do,))
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, mask, causal, sm_scale, block_q,
                                    block_k, o, lse, do)
    B, H, Lq, D = q.shape
    S = k.shape[2]
    if tuple(o.shape) != (B, H, Lq, D) or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(
            f"flash_backward: o {tuple(o.shape)} {o.dtype} on {o.device} must match "
            f"q {tuple(q.shape)} {q.dtype} on {q.device}")
    dp = _head_bucket(D)
    qp, kp, vp, dop, op = (_padded(t, dp) for t in (q, k, v, do, o))
    mask = mask.contiguous()
    lse = lse.to(torch.float32).contiguous()
    delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, H, Lq, dp), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, H, S, dp), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, H, S, dp), dtype=q.dtype, device=q.device)
    if B * H * Lq * S == 0:
        return dq[..., :D].zero_(), dk[..., :D].zero_(), dv[..., :D].zero_()
    args = (qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), mask.data_ptr(),
            dop.data_ptr(), lse.data_ptr())
    dims = (B, H, Lq, S, dp, block_q, block_k, int(causal), float(sm_scale),
            int(q.dtype == torch.bfloat16))
    _launch("flash_attention_bwd", "flash_attention_bwd_dq", q.device,
            *args, op.data_ptr(), dq.data_ptr(), delta.data_ptr(), *dims)
    flash_backward.launches_dq += 1
    _launch("flash_attention_bwd", "flash_attention_bwd_dkdv", q.device,
            *args, delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *dims)
    flash_backward.launches_dkdv += 1
    if dp != D:
        dq, dk, dv = (t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_backward.launches_dkdv = 0
flash_backward.launches_dq = 0


class FlashAttention(torch.autograd.Function):
    """flash_forward with flash_backward as its gradient; the mask and the
    static arguments get none."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, sm_scale, block_q, block_k):
        o, lse = flash_forward(q, k, v, mask, causal, sm_scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.static = (causal, sm_scale, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        causal, sm_scale, block_q, block_k = ctx.static
        dq, dk, dv = flash_backward(q, k, v, mask, causal, sm_scale, block_q,
                                    block_k, o, lse, do.contiguous())
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, mask, causal: bool = False,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Masked multi-head attention, O(L·block) memory, differentiable in q,
    k and v. q [B, H, Lq, D]; k, v [B, H, S, D]; mask [B, S] bool (True =
    real). Lq and S must be multiples of block_q and block_k (pad outside:
    padded keys masked; padded query rows give finite outputs to slice
    away). `sm_scale` defaults to 1/sqrt(D)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, mask, bool(causal), float(scale),
                                int(block_q), int(block_k))
