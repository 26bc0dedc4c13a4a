"""Ring attention: sequence-parallel exact attention over a mesh axis — the
port of `deeprec_tpu/parallel/ring_attention.py`.

A long sequence shards over the mesh: each position holds its slice of Q,
K, V and the key mask, and the K / V / mask blocks rotate around the ring
(`mesh.ppermute`) while each position accumulates its queries' attention
with an online softmax, so the result is exact attention over the whole
sequence with O(L / P) activation memory per position. Causal masking uses
the global positions of the queries and of the block in hand.

Plain PyTorch, as the JAX function is plain `jnp.einsum` (it calls no
Pallas kernel): `torch.einsum` on the blocks in float32. Differentiable
through the ring in the JAX manner: autograd runs the rotations backwards
(`ppermute`'s backward is the reverse rotation). The flash kernels #8 / #9
(`ops/flash_attention.py`) are its oracle on the card, not its body.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from deeprec_tpu_torch.parallel import mesh as M

NEG_INF = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor, mesh: "M.Mesh", axis: Optional[M.AxisSpec] = None,
                   causal: bool = False, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention of this position's queries q [B, H, Lq, D] over the
    whole sharded sequence; k, v [B, H, S, D] and mask [B, S] (bool, True =
    a real key) are this position's blocks. Returns [B, H, Lq, D] in q's
    dtype. Every position of `axis` (default the whole mesh) calls it."""
    axis = M.mesh_batch_axes(mesh) if axis is None else axis
    B, H, Lq, D = q.shape
    S = k.shape[2]
    P = M.axis_size(mesh, axis)
    me = M.axis_index(mesh, axis)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    qf = q.to(torch.float32)
    qpos = me * Lq + torch.arange(Lq, device=dev)[:, None]  # global query positions
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev)
    ks, vs, mk = k, v, mask
    src = me  # the position that owned the block in hand
    for r in range(P):
        kpos = (src * S + torch.arange(S, device=dev)[None, :] if causal
                else torch.zeros((0,), device=dev))
        m, l, acc = _Hop.apply(qf, ks, vs, m, l, acc, mk, kpos, qpos, scale)
        if r + 1 < P:  # rotate K, V and the mask one hop around the ring
            ks = M.ppermute(mesh, ks, axis)
            vs = M.ppermute(mesh, vs, axis)
            mk = M.ppermute(mesh, mk, axis)
            src = (src - 1) % P
    l_safe = torch.clamp(l, min=1e-30)
    return (acc / l_safe).to(q.dtype)


def _hop(qf, ks, vs, m, l, acc, mk, kpos, qpos, scale):
    """One block of the online softmax: the running (max, sum, output) of
    the queries after the keys `ks` (global positions `kpos`, empty = no
    causal mask)."""
    s = torch.einsum("bhld,bhsd->bhls", qf, ks.to(torch.float32)) * scale
    s = torch.where(mk[:, None, None, :], s, NEG_INF)
    if kpos.numel():
        s = torch.where((kpos <= qpos)[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new)
    l = l * corr + p.sum(-1, keepdim=True)
    acc = acc * corr + torch.einsum("bhls,bhsd->bhld", p, vs.to(torch.float32))
    return m_new, l, acc


class _Hop(torch.autograd.Function):
    """`_hop` whose [Lq, S] scores are recomputed in the backward, not kept:
    the activation memory stays O(L / P) per position."""

    @staticmethod
    def forward(ctx, qf, ks, vs, m, l, acc, mk, kpos, qpos, scale):
        ctx.save_for_backward(qf, ks, vs, m, l, acc, mk, kpos, qpos)
        ctx.scale = scale
        return _hop(qf, ks, vs, m, l, acc, mk, kpos, qpos, scale)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        xs = [t.detach().requires_grad_(need) for t, need
              in zip(saved[:6], ctx.needs_input_grad[:6])]
        with torch.enable_grad():
            # the vector-Jacobian product as the gradient of one scalar:
            # explicit grad_outputs make torch import its symbolic-shape
            # machinery (seconds) on the first backward
            vjp = sum((o * g).sum() for o, g in zip(_hop(*xs, *saved[6:], ctx.scale), grads))
        wrt = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(vjp, wrt, allow_unused=True) if wrt else ())
        return (*(next(got) if x.requires_grad else None for x in xs),
                None, None, None, None)


class _Shard(torch.autograd.Function):
    """This position's slice of a global tensor along `dim`; the backward
    gathers every position's gradient slice, so each position holds the
    whole gradient of the (replicated) global input."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return M.local_rows(x, M.axis_size(mesh, axis), M.axis_index(mesh, axis), dim).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, g.contiguous(), ctx.axis, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    """Every position's slice along `dim`, concatenated in rank order; the
    backward keeps this position's slice (the loss on the gathered output
    is the same on every position)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        n = M.axis_size(ctx.mesh, ctx.axis)
        return (M.local_rows(g, n, M.axis_index(ctx.mesh, ctx.axis), ctx.dim).contiguous(),
                None, None, None)


def _gather(mesh, x, axis, dim):
    parts = M.all_gather(mesh, x.contiguous(), axis)  # [n, *x.shape]
    return torch.cat(list(parts.unbind(0)), dim)


def ring_attention_sharded(mesh: "M.Mesh", q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mask: torch.Tensor,
                           axis: Optional[M.AxisSpec] = None, causal: bool = False,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """The JAX `ring_attention_sharded` over global tensors, as
    `ShardedTrainer` takes the global batch: every position passes the same
    q, k, v [B, H, L, D] and mask [B, L] (L divisible by the axis size),
    takes its sequence slice, runs the ring, and gets the global output
    [B, H, L, D] in rank order. Differentiable: the gradients of the global
    inputs come back whole on every position."""
    axis = M.mesh_batch_axes(mesh) if axis is None else axis
    n = M.axis_size(mesh, axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(f"sequence lengths {q.shape[2]}, {k.shape[2]} do not split over "
                         f"{n} positions")
    ql, kl, vl = (_Shard.apply(x, mesh, axis, 2) for x in (q, k, v))
    ml = M.local_rows(mask, n, M.axis_index(mesh, axis), 1)
    out = ring_attention(ql, kl, vl, ml, mesh, axis, causal=causal, sm_scale=sm_scale)
    return _Gather.apply(out, mesh, axis, 2)
