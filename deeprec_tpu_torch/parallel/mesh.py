"""The device mesh over `torch.distributed` — the port of
`deeprec_tpu/parallel/mesh.py`.

One process is one mesh position. `make_mesh(n)` is the world (or its first
n ranks) along the single `data` axis; `make_mesh_2d(intra, inter)` lays the
same ranks out host-major as ``(inter, intra)``: the flat rank
``g * intra + i`` of position ``(g, i)`` equals its 1-D position, so hash
ownership and checkpoints do not depend on the mesh's shape. A 2-D mesh
holds `new_group` subgroups for each tier: the `intra` group of a position
is its host group, the `inter` group the positions of its intra index
across the host groups.

The collectives the sharded exchanges need live here and take an axis spec
as the JAX ones do: the data axis or the ``(inter, intra)`` tuple (the
whole mesh, in flat rank order), or one tier's name. Every reduction is a
gather or all-to-all of the payload followed by a sum in rank order on the
receiving side, so a result's bits depend neither on the backend nor on the
mesh's shape.

The transport follows the group's backend, never a caught failure: NCCL
moves device tensors; gloo moves host tensors, so CUDA tensors go through
pinned host buffers and back (the only way to run several ranks on one
card). bf16 payloads travel as float16 bit patterns and bools as bytes
(collectives here only copy). A failed
NCCL init or collective raises.

`deeprec_tpu/parallel/compat.py`, the JAX package's version shim over
`shard_map`, has nothing to port: PyTorch runs each rank's program eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DATA_AXIS = "data"
INTRA_AXIS = "intra"  # cheap tier: same host group (NVLink)
INTER_AXIS = "inter"  # expensive tier: across host groups

AxisSpec = Union[str, Tuple[str, ...]]

# bf16 payloads move as float16 bit patterns (every backend moves float16;
# a gather or all-to-all only copies the bytes)
_BITS = {torch.bfloat16: torch.float16}


@dataclasses.dataclass
class Mesh:
    """Mesh positions = the ranks `ranks` of the default process group, in
    flat (host-major) order. `axis_names` / `shape` as the JAX Mesh;
    `groups` maps each axis spec this position collects over to
    (process group or None for the whole world, its size, this position's
    index in it). `device` is where this position's tensors live."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    device: torch.device
    groups: Dict[object, Tuple[object, int, int]]
    # the gloo transport's pinned host buffers, one per (dtype, role), grown
    # on demand and reused: every collective returns only after its copies
    staging: Dict[Tuple[torch.dtype, str], torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def index(self) -> int:
        """This process's flat mesh position."""
        return self.groups[_full_key(self)][2]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _rank_world() -> Tuple[int, int]:
    dist = _dist()
    return (dist.get_rank(), dist.get_world_size()) if dist else (0, 1)


def _default_device(device):
    from deeprec_tpu_torch import resolve_device

    if device is not None:
        return resolve_device(device)
    resolve_device(None)  # raises without CUDA
    return torch.device("cuda", torch.cuda.current_device())


def _full_key(mesh: Mesh):
    return mesh.axis_names[0] if len(mesh.axis_names) == 1 else mesh.axis_names


def _group(ranks: Sequence[int], world: int):
    """The process group of `ranks`: None (the world) when they are all of
    it. Every process must call this with the same ranks, in order."""
    dist = _dist()
    if dist is None or list(ranks) == list(range(world)):
        return None
    return dist.new_group(list(ranks))


def make_mesh(num_devices: Optional[int] = None, axis: str = DATA_AXIS,
              device=None) -> Mesh:
    """1-D mesh over the world, or over its first `num_devices` ranks
    (every rank must call it; a rank outside the mesh gets no position and
    must not use it). `device`: this rank's device (default: the current
    CUDA device, which the launcher pins)."""
    rank, world = _rank_world()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"mesh of {n} ranks, the world has {world}")
    g = _group(range(n), world)
    return Mesh((axis,), {axis: n}, tuple(range(n)), _default_device(device),
                {axis: (g, n, rank)})


def make_mesh_2d(intra: int, inter: Optional[int] = None, device=None) -> Mesh:
    """Two-tier mesh: axes ``(inter, intra)`` over ``inter * intra`` ranks,
    host-major (ranks ``g * intra .. g * intra + intra - 1`` form host group
    g). Every rank of the world must call it: it makes the tiers'
    subgroups."""
    rank, world = _rank_world()
    intra = int(intra)
    if inter is None:
        if world % intra:
            raise ValueError(f"intra={intra} does not divide world size {world}")
        inter = world // intra
    n = intra * int(inter)
    if n > world:
        raise ValueError(f"mesh {inter}x{intra} needs {n} ranks, the world has {world}")
    full = _group(range(n), world)
    groups: Dict[object, Tuple[object, int, int]] = {
        (INTER_AXIS, INTRA_AXIS): (full, n, rank)}
    g_me, i_me = divmod(rank, intra)
    for g in range(inter):  # the intra groups, then the inter groups
        grp = _group([g * intra + i for i in range(intra)], world)
        if g == g_me:
            groups[INTRA_AXIS] = (grp, intra, i_me)
    for i in range(intra):
        grp = _group([g * intra + i for g in range(inter)], world)
        if i == i_me:
            groups[INTER_AXIS] = (grp, int(inter), g_me)
    return Mesh((INTER_AXIS, INTRA_AXIS), {INTER_AXIS: int(inter), INTRA_AXIS: intra},
                tuple(range(n)), _default_device(device), groups)


def mesh_batch_axes(mesh: Mesh) -> AxisSpec:
    """The axis spec the batch splits over: the data axis of a 1-D mesh,
    the (inter, intra) tuple of a 2-D one."""
    return _full_key(mesh)


def axis_size(mesh: Mesh, axes: Optional[AxisSpec] = None) -> int:
    axes = mesh_batch_axes(mesh) if axes is None else axes
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def axis_index(mesh: Mesh, axis: AxisSpec) -> int:
    """This position's index along `axis` (a tier or the whole mesh)."""
    return _resolve(mesh, axis)[2]


def _resolve(mesh: Mesh, axis: AxisSpec):
    key = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if key not in mesh.groups:
        raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
    return mesh.groups[key]


# ------------------------------------------------------------- batches


def local_rows(x, n: int, index: int, dim: int = 0):
    """Rank `index`'s contiguous slice of n of `x` along `dim`."""
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"batch dimension {size} does not split over {n} ranks")
    per = size // n
    sl = [slice(None)] * x.ndim
    sl[dim] = slice(index * per, (index + 1) * per)
    return x[tuple(sl)]


def shard_batch(mesh: Mesh, batch: dict, axis: Optional[AxisSpec] = None,
                stacked: bool = False) -> dict:
    """This position's rank-order slice of a global batch (numpy arrays or
    tensors, as given): the batch dimension splits over `axis` (default the
    whole mesh); stacked=True takes a K-stacked [K, B, ...] window and
    splits dim 1. Every rank passes the same global batch."""
    _, n, index = _resolve(mesh, mesh_batch_axes(mesh) if axis is None else axis)
    dim = 1 if stacked else 0
    return {k: local_rows(v, n, index, dim) for k, v in batch.items()}


def put_global(x, mesh: Mesh) -> torch.Tensor:
    """A replicated value (the same on every rank) as this rank's tensor."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x
                           ).to(mesh.device)


def put_tiled_global(local, lead: tuple, mesh: Mesh) -> torch.Tensor:
    """What a rank holds of a value tiled identically along `lead` leading
    axes whose LAST axis is the shard axis: the template broadcast over the
    other lead axes (this rank's slice of the shard axis has size 1 and is
    dropped)."""
    local = torch.as_tensor(np.asarray(local) if not torch.is_tensor(local) else local)
    return local.expand(*lead[:-1], *local.shape).contiguous().to(mesh.device)


# ---------------------------------------------------------- collectives


def _backend(group) -> str:
    dist = _dist()
    return dist.get_backend(group) if dist is not None else "none"


def _pinned(mesh: Mesh, shape, dtype, role: str) -> torch.Tensor:
    n = 1
    for d in shape:
        n *= int(d)
    buf = mesh.staging.get((dtype, role))
    if buf is None or buf.numel() < n:
        buf = torch.empty(max(n, 1), dtype=dtype, pin_memory=True)
        mesh.staging[(dtype, role)] = buf
    return buf[:n].view(tuple(shape))


def _run(mesh: Mesh, group, x: torch.Tensor, out_shape, op) -> torch.Tensor:
    """op(out, inp) over `group` on its backend's transport: NCCL moves the
    device tensors; gloo moves host tensors, so a CUDA `x` is copied into a
    pinned buffer and the result back. Returns the result in x's dtype on
    x's device."""
    dtype = x.dtype
    w = x.contiguous()
    if dtype in _BITS:
        w = w.view(_BITS[dtype])
    elif dtype == torch.bool:
        w = w.to(torch.uint8)
    staged = w.is_cuda and _backend(group) == "gloo"
    if staged:
        inp = _pinned(mesh, w.shape, w.dtype, "in")
        inp.copy_(w)
        out = _pinned(mesh, out_shape, w.dtype, "out")
    else:
        inp, out = w, torch.empty(tuple(out_shape), dtype=w.dtype, device=w.device)
    op(out, inp)
    if staged:
        out = out.to(x.device)  # a synchronous copy: the buffer is free after it
    if dtype in _BITS:
        return out.view(dtype)
    return out.to(torch.bool) if dtype == torch.bool else out


def all_gather(mesh: Mesh, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
    """[n, *x.shape]: every position's `x` along `axis`, in its order."""
    group, n, _ = _resolve(mesh, axis)
    if _dist() is None:  # one position, no process group
        return x[None]
    dist = _dist()

    def op(out, inp):
        if _backend(group) == "gloo":
            dist.all_gather(list(out.unbind(0)), inp, group=group)
        else:
            dist.all_gather_into_tensor(out, inp, group=group)
    return _run(mesh, group, x, (n, *x.shape), op)


def all_to_all(mesh: Mesh, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
    """x [n, ...]: row j goes to position j; returns [n, ...] whose row j
    came from position j (equal splits)."""
    group, n, _ = _resolve(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {n} positions got {x.shape[0]} rows")
    if _dist() is None:
        return x
    dist = _dist()
    return _run(mesh, group, x, x.shape,
                lambda out, inp: dist.all_to_all_single(out, inp, group=group))


def broadcast(mesh: Mesh, x: torch.Tensor, axis: Optional[AxisSpec] = None) -> torch.Tensor:
    """Position 0's `x` along `axis` (default the whole mesh), on every
    position."""
    group, n, _ = _resolve(mesh, mesh_batch_axes(mesh) if axis is None else axis)
    if _dist() is None:
        return x
    dist = _dist()
    src = 0 if group is None else dist.get_global_rank(group, 0)

    def op(out, inp):
        out.copy_(inp)
        dist.broadcast(out, src=src, group=group)
    return _run(mesh, group, x, x.shape, op)


def all_to_all_uneven(mesh: Mesh, x: torch.Tensor, send_counts: Sequence[int],
                      axis: AxisSpec) -> Tuple[torch.Tensor, List[int]]:
    """x [sum(send_counts), ...]: the first send_counts[0] rows go to
    position 0, the next to 1, ... Returns (the rows received, sources in
    order, and the receive counts)."""
    group, n, _ = _resolve(mesh, axis)
    send = [int(c) for c in send_counts]
    if _dist() is None:
        return x, send
    counts = all_gather(mesh, torch.tensor(send, dtype=torch.int64, device=x.device),
                        axis)[:, _resolve(mesh, axis)[2]].tolist()
    dist = _dist()
    out = _run(mesh, group, x, (sum(counts), *x.shape[1:]),
               lambda out, inp: dist.all_to_all_single(
                   out, inp, output_split_sizes=counts, input_split_sizes=send, group=group))
    return out, counts


def _ppermute(mesh: Mesh, x: torch.Tensor, axis: AxisSpec, shift: int) -> torch.Tensor:
    group, n, me = _resolve(mesh, axis)
    if _dist() is None or n == 1:
        return x.clone()
    dist = _dist()
    flat = x.reshape(-1)
    send = [0] * n
    recv = [0] * n
    send[(me + shift) % n] = recv[(me - shift) % n] = flat.numel()
    out = _run(mesh, group, flat, flat.shape,
               lambda out, inp: dist.all_to_all_single(
                   out, inp, output_split_sizes=recv, input_split_sizes=send, group=group))
    return out.view(x.shape)


class _PPermute(torch.autograd.Function):
    """The ring rotation; its backward rotates the gradient the other way."""

    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ppermute(mesh, x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(ctx.mesh, g.contiguous(), ctx.axis, -ctx.shift), None, None, None


def ppermute(mesh: Mesh, x: torch.Tensor, axis: AxisSpec, shift: int = 1) -> torch.Tensor:
    """The ring rotation of the JAX `lax.ppermute` with the permutation
    i -> (i + shift) % n along `axis`: each position sends its `x` to
    position (i + shift) % n and receives position (i - shift) % n's (same
    shape and dtype everywhere). Differentiable: the gradient takes the
    reverse rotation. One all-to-all with a single nonzero split each way,
    on the group's transport as the other collectives."""
    return _PPermute.apply(x, mesh, axis, int(shift))


def rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts [n, ...] summed over the first axis in index order."""
    acc = parts[0]
    for j in range(1, parts.shape[0]):
        acc = acc + parts[j]
    return acc


def psum_scatter(mesh: Mesh, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
    """x [n, ...]: position j receives the rank-order sum over positions of
    their row j (the tiled reduce-scatter)."""
    return rank_order_sum(all_to_all(mesh, x, axis))


def psum(mesh: Mesh, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
    """The rank-order sum of `x` over `axis`, on every position: a
    reduce-scatter of n chunks (position c sums chunk c in rank order) and
    an all-gather of the sums, so each position moves about twice x's
    bytes; every element's sum is the rank-order sum."""
    group, n, _ = _resolve(mesh, axis)
    if _dist() is None:
        return x
    flat = x.reshape(-1)
    m = -(-flat.numel() // n)
    parts = torch.nn.functional.pad(flat, (0, m * n - flat.numel())).view(n, m)
    sums = psum_scatter(mesh, parts, axis)
    return all_gather(mesh, sums, axis).reshape(-1)[:flat.numel()].view(x.shape)


def pmean(mesh: Mesh, x: torch.Tensor, axis: AxisSpec) -> torch.Tensor:
    """`psum` divided by the axis size (the JAX pmean)."""
    return psum(mesh, x, axis) / float(_resolve(mesh, axis)[1])


def all_gather_object(mesh: Mesh, obj, axis: Optional[AxisSpec] = None) -> list:
    """Every position's picklable `obj` along `axis`, in order."""
    group, n, _ = _resolve(mesh, mesh_batch_axes(mesh) if axis is None else axis)
    if _dist() is None:
        return [obj]
    out = [None] * n
    _dist().all_gather_object(out, obj, group=group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every position of the mesh."""
    group, n, _ = _resolve(mesh, mesh_batch_axes(mesh))
    if _dist() is not None:
        _dist().barrier(group=group)
