"""NN layers for the modelzoo — the port of `deeprec_tpu/nn.py` (the layers
DLRM, DLRM-DCN, BST, WDL, DeepFM, DCN, DCNv2, MaskNet, DIN, DIEN, DSSM and
the multi-task models use).

Parameters keep the JAX package's layout (`w` is [in, out]) and names, so a
module's parameter tree is the JAX param tree: `param_tree` rebuilds it and
`jax_leaf_names` lists the leaves in `jax.tree_util` flatten order (dict
keys sorted, lists in order), the order of `dense.npz` in a checkpoint.

Numerics follow the JAX package: `dense_apply` rounds both operands to
bf16 and accumulates in f32 (the MXU's bf16-in / f32-out product). Products
of bf16 values are exact in f32, so rounding the operands and multiplying
in f32 computes the same thing; `torch.matmul` on bf16 tensors would round
the output to bf16 as well, which JAX does not. The cross network, the
transformer block's qkv and output projections (`matmul`) multiply in plain
f32; its attention runs through `ops/flash_attention.py`. DCN's vector
cross net multiplies in plain f32 too, FM sums in f32, and the GRU's gates
(`gru_apply`, DIEN) are plain f32 products.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.func
from torch import nn

from deeprec_tpu_torch.ops.flash_attention import attention_reference, flash_attention


class SeededModule(nn.Module):
    """Base of the modelzoo models, whose constructors draw every weight
    from a `torch.Generator` seeded with their `seed` argument. It records
    the keyword and positional arguments each instance was built with, so
    `reseeded(seed)` builds the same architecture with weights drawn from
    another seed (`Trainer.init(seed)`)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is None:
            return

        @functools.wraps(init)
        def recorded(self, *args, **kw):
            if "_init_args" not in self.__dict__:  # the outermost class's call
                object.__setattr__(self, "_init_args", (args, kw))
            init(self, *args, **kw)

        cls.__init__ = recorded

    def reseeded(self, seed: int) -> "SeededModule":
        """A new instance of this model's class, built with the arguments
        this one was built with and `seed` in place of its seed."""
        args, kw = self._init_args
        return type(self)(*args, **{**kw, "seed": int(seed)})


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _glorot(shape, generator: torch.Generator) -> torch.Tensor:
    lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * lim


# ----------------------------------------------------------------- dense / MLP


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A plain f32 product (JAX's `jnp.dot(..., preferred_element_type=f32)`
    on f32 operands; TF32 stays off on the card)."""
    return torch.matmul(x, w)


def dense_apply(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = bf16(x) @ bf16(w) accumulated in f32, plus b."""
    return torch.matmul(_bf16(x), _bf16(p["w"])) + p["b"]


def mlp_apply(layers: Sequence, x: torch.Tensor, activation=torch.relu,
              final_activation=None) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = dense_apply(layer, x)
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    return x


def crossnet_apply(layers: Sequence, x0: torch.Tensor) -> torch.Tensor:
    """DCNv2 cross layer: x_{l+1} = x0 * (x_l W + b) + x_l, in f32."""
    x = x0
    for layer in layers:
        x = x0 * (torch.matmul(x, layer["w"]) + layer["b"]) + x
    return x


def crossnet_v1_apply(layers: Sequence, x0: torch.Tensor) -> torch.Tensor:
    """Original DCN cross layer with VECTOR weights, in f32:
    x_{l+1} = x0 * (x_l . w) + b + x_l (rank-1 feature crossing)."""
    x = x0
    for layer in layers:
        x = x0 * torch.matmul(x, layer["w"])[:, None] + layer["b"] + x
    return x


def fm_apply(emb_stack: torch.Tensor) -> torch.Tensor:
    """Second-order FM interaction over [B, F, D] field embeddings:
    0.5 * ((sum v)^2 - sum v^2) summed over D -> [B, 1]. The difference is
    taken per column before the sum over D, as in the JAX package (the
    two terms cancel)."""
    s = torch.sum(emb_stack, dim=1)
    sq = torch.sum(emb_stack * emb_stack, dim=1)
    return 0.5 * torch.sum(s * s - sq, dim=1, keepdim=True)


def din_attention_apply(p, query: torch.Tensor, keys: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """DIN local activation unit: query [B, D] target item, keys [B, L, D]
    behavior sequence, mask [B, L] bool. Scores of the MLP over [q, k,
    q - k, q * k], filled with -1e9 where masked before the softmax over L
    and zeroed there after it; returns the weighted sum of keys [B, D]."""
    B, L, D = keys.shape
    q = query[:, None, :].expand(B, L, D)
    feats = torch.cat([q, keys, q - keys, q * keys], dim=-1)
    scores = mlp_apply(p["mlp"].layers, feats.reshape(B * L, 4 * D)).reshape(B, L)
    scores = torch.where(mask, scores, -1e9)
    w = torch.softmax(scores, dim=1)
    w = torch.where(mask, w, 0.0)
    return torch.einsum("bl,bld->bd", w, keys)


def dot_interaction(emb_stack: torch.Tensor, keep_diag: bool = False) -> torch.Tensor:
    """DLRM pairwise dot interactions over [B, F, D] -> [B, F*(F-1)/2]
    (upper triangle, row-major, as numpy's triu_indices)."""
    F = emb_stack.shape[1]
    z = torch.einsum("bfd,bgd->bfg", emb_stack, emb_stack)
    i, j = torch.triu_indices(F, F, offset=0 if keep_diag else 1,
                              device=emb_stack.device)
    return z[:, i, j]


def layernorm_apply(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(x - mean) * rsqrt(var + eps) * g + b over the last axis, with the
    population variance (jnp.var)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


# ----------------------------------------------------------------- GRU / AUGRU


def gru_init(in_dim: int, hid: int, generator: torch.Generator
             ) -> Dict[str, torch.Tensor]:
    """The JAX `gru_init` tree: wz, wr, wh [in + hid, hid] (glorot) and bz,
    br, bh [hid] = 0."""
    return {
        "wz": _glorot((in_dim + hid, hid), generator),
        "wr": _glorot((in_dim + hid, hid), generator),
        "wh": _glorot((in_dim + hid, hid), generator),
        "bz": torch.zeros(hid), "br": torch.zeros(hid), "bh": torch.zeros(hid),
    }


def gru_cell(p, h: torch.Tensor, x: torch.Tensor,
             att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the JAX package's GRU: the reset gate scales h BEFORE the
    candidate's one product over [x, r * h] (torch.nn.GRU and cuDNN scale
    `W_hn h + b_hn` instead, another cell). With `att` [B] (the AUGRU of
    DIEN) the attention score scales the update gate."""
    xh = torch.cat([x, h], dim=-1)
    z = torch.sigmoid(matmul(xh, p["wz"]) + p["bz"])
    r = torch.sigmoid(matmul(xh, p["wr"]) + p["br"])
    hh = torch.tanh(matmul(torch.cat([x, r * h], dim=-1), p["wh"]) + p["bh"])
    if att is not None:
        z = att[:, None] * z
    return (1.0 - z) * h + z * hh


def gru_apply(p, xs: torch.Tensor, mask: torch.Tensor,
              att: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a GRU (an AUGRU when `att` [B, L] is given) over xs [B, L, D]
    with mask [B, L] bool, from h0 = 0: the JAX `lax.scan` as an eager loop
    over L, one autograd graph, no host sync. A masked step carries the
    previous state. Returns (final state [B, H], every state [B, L, H])."""
    B, L, _ = xs.shape
    h = xs.new_zeros((B, p["bz"].shape[0]))
    hs = []
    for t in range(L):
        h_new = gru_cell(p, h, xs[:, t], None if att is None else att[:, t])
        h = torch.where(mask[:, t, None], h_new, h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


# ------------------------------------------------------------ transformer (BST)


def transformer_block_apply(p, x: torch.Tensor, mask: torch.Tensor, heads: int,
                            flash: bool = False) -> torch.Tensor:
    """Post-LN transformer encoder block with a padding mask: x [B, L, D],
    mask [B, L] bool. flash=True pads q, k, v and the mask to a multiple of
    128 and runs `flash_attention` (the hand-written CUDA kernels on the
    card); flash=False runs `attention_reference`. Positions the mask
    drops come out 0."""
    B, L, D = x.shape
    H = heads
    qkv = matmul(x, p["qkv"]).reshape(B, L, 3, H, D // H)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [B, H, L, Dh]
    if flash:
        blk = 128
        pad = -L % blk
        if pad:
            q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
            fmask = torch.cat([mask, mask.new_zeros((B, pad))], dim=1)
        else:
            q, k, v = (t.contiguous() for t in (q, k, v))
            fmask = mask
        out = flash_attention(q, k, v, fmask)[:, :, :L]
    else:
        out = attention_reference(q, k, v, mask)
    out = out.transpose(1, 2).reshape(B, L, D)
    x = layernorm_apply(p["ln1"], x + matmul(out, p["proj"]))
    ff = dense_apply(p["ff2"], torch.relu(dense_apply(p["ff1"], x)))
    x = layernorm_apply(p["ln2"], x + ff)
    return torch.where(mask[..., None], x, 0.0)


# ------------------------------------------------- sample-aware compression


def _tree_map(fn, tree):
    """fn over the tensor leaves of dicts, lists, tuples, NamedTuples and
    dataclasses (a model's `ModelInputs`); other leaves pass as they are."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


def group_compress(group_ids: torch.Tensor, num_groups: int):
    """Dedup rows by a group id (user id) for sample-aware compression: the
    port of the JAX `group_compress`. `num_groups` is the fixed number of
    groups per batch (the packer's G).

    Returns (first_ix [G], inverse [B], ok [B]): `x[first_ix]` is one
    representative row per group (the first row of each distinct id, in
    ascending id order; unused groups take row 0), `out[inverse]`
    broadcasts per-group results back to the batch, and `ok` marks rows
    whose group made the cut — rows of overflow groups MUST NOT silently
    receive another group's output."""
    group_ids = group_ids.reshape(-1)
    B = group_ids.shape[0]
    uniq, inverse = torch.unique(group_ids, sorted=True, return_inverse=True)
    first = torch.full((uniq.shape[0],), B, dtype=torch.int64,
                       device=group_ids.device).scatter_reduce_(
        0, inverse, torch.arange(B, device=group_ids.device), reduce="amin")
    first_ix = torch.zeros((num_groups,), dtype=torch.int64, device=group_ids.device)
    n = min(num_groups, uniq.shape[0])
    first_ix[:n] = first[:n]
    ok = inverse < num_groups
    return first_ix, torch.where(ok, inverse, 0), ok


def apply_grouped(fn, inputs, group_ids: torch.Tensor, num_groups: int):
    """Run `fn` once per distinct group and broadcast the results to the
    batch (the JAX `apply_grouped`): fn(tree with leading dim G) on rows
    deduped by group_ids [B]; output leaves regain leading dim B. Equal to
    fn(full batch) row for row when fn is row-independent, with G/B of the
    compute. Rows whose group overflowed num_groups come back as NaN."""
    first_ix, inverse, ok = group_compress(group_ids, num_groups)
    out = fn(_tree_map(lambda a: a[first_ix], inputs))

    def broadcast(a):
        rows = a[inverse]
        mask = ok.reshape(ok.shape + (1,) * (rows.dim() - 1))
        return torch.where(mask, rows, torch.full_like(rows, float("nan")))

    return _tree_map(broadcast, out)


def _leading_rows(tree) -> int:
    """The leading dimension of the first tensor leaf of `tree`."""
    found = []
    _tree_map(lambda a: found.append(a.shape[0]) or a, tree)
    if not found:
        raise ValueError("no tensor in the inputs")
    return found[0]


def fixed_rows(fn, inputs, rows: int):
    """fn(inputs) computed at exactly `rows` rows per call: the inputs'
    leading dimension is padded to a multiple of `rows` by repeating the
    last row, fn runs on each slice of `rows` rows, and the outputs are
    joined and cut back. Every call then sees one shape, so a row's result
    does not depend on how many rows it was batched with — which a BLAS
    that picks its algorithm by the row count does not give otherwise.
    fn must be row-independent."""
    B = _leading_rows(inputs)
    n = max(-(-B // rows), 1) * rows

    def pad(a):
        if a.shape[0] == n:
            return a
        return torch.cat([a, a[-1:].expand(n - a.shape[0], *a.shape[1:])])

    padded = _tree_map(pad, inputs)
    outs = [fn(_tree_map(lambda a: a[i:i + rows], padded)) for i in range(0, n, rows)]
    first = outs[0]
    if isinstance(first, dict):
        return {k: torch.cat([o[k] for o in outs])[:B] for k in first}
    return torch.cat(outs)[:B]


class _BoundMethod(nn.Module):
    """Calls one method of a module, so `functional_call` can run it over
    a parameter dict (its parameters sit under `m.`)."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.m = module
        self.name = name

    def forward(self, *args):
        return getattr(self.m, self.name)(*args)


def method_call(module: nn.Module, params: Dict[str, torch.Tensor], name: str,
                *args):
    """`module.<name>(*args)` with the module's parameters taken from
    `params` ({parameter name: tensor}, a TrainState's `dense`): the tower
    methods of a two-tower model (`user_vector`, `apply_with_user`) run on
    a served state as `functional_call` runs `forward`."""
    return torch.func.functional_call(
        _BoundMethod(module, name), {f"m.{k}": v for k, v in params.items()}, args)


# --------------------------------------------------------------- modules


class Dense(nn.Module):
    """One dense layer's parameters, JAX layout: w [in, out], b [out]."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(_glorot((in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class LayerNorm(nn.Module):
    """{"g" [dim] = 1, "b" [dim] = 0}."""

    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = nn.Parameter(torch.zeros(dim))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class TransformerBlock(nn.Module):
    """The JAX `transformer_block_init` tree: qkv [dim, 3 dim], proj [dim,
    dim] (glorot), ff1 Dense(dim, ff), ff2 Dense(ff, dim), ln1, ln2.
    `heads` stays an argument of `forward`, as in the JAX package."""

    def __init__(self, dim: int, ff: int, generator: torch.Generator):
        super().__init__()
        self.qkv = nn.Parameter(_glorot((dim, 3 * dim), generator))
        self.proj = nn.Parameter(_glorot((dim, dim), generator))
        self.ff1 = Dense(dim, ff, generator)
        self.ff2 = Dense(ff, dim, generator)
        self.ln1 = LayerNorm(dim)
        self.ln2 = LayerNorm(dim)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, x, mask, heads: int, flash: bool = False):
        return transformer_block_apply(self, x, mask, heads, flash)


class MLP(nn.Module):
    """{"layers": [Dense, ...]} — the JAX mlp param tree."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 generator: torch.Generator):
        super().__init__()
        dims = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            Dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:])
        )

    def forward(self, x, activation=torch.relu, final_activation=None):
        return mlp_apply(self.layers, x, activation, final_activation)


class CrossNet(nn.Module):
    """{"layers": [{"w" [dim, dim], "b" [dim]}, ...]} — DCNv2 cross net."""

    def __init__(self, dim: int, depth: int, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            Dense(dim, dim, generator) for _ in range(depth)
        )

    def forward(self, x0):
        return crossnet_apply(self.layers, x0)


class _CrossV1Layer(nn.Module):
    """{"w" [dim] (glorot of a [dim, 1] matrix), "b" [dim] = 0}."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(_glorot((dim, 1), generator)[:, 0])
        self.b = nn.Parameter(torch.zeros(dim))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


class CrossNetV1(nn.Module):
    """{"layers": [{"w" [dim], "b" [dim]}, ...]} — DCN's vector-weight
    cross net."""

    def __init__(self, dim: int, depth: int, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            _CrossV1Layer(dim, generator) for _ in range(depth))

    def forward(self, x0):
        return crossnet_v1_apply(self.layers, x0)


class DINAttention(nn.Module):
    """{"mlp": MLP(4 dim, hidden + [1])} — DIN's local activation unit."""

    def __init__(self, dim: int, hidden: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.mlp = MLP(4 * dim, [*hidden, 1], generator)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def forward(self, query, keys, mask):
        return din_attention_apply(self, query, keys, mask)


class GRU(nn.Module):
    """`gru_init`'s tree as parameters; `forward` is `gru_apply`."""

    def __init__(self, in_dim: int, hid: int, generator: torch.Generator):
        super().__init__()
        for name, t in gru_init(in_dim, hid, generator).items():
            setattr(self, name, nn.Parameter(t))

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def forward(self, xs, mask, att=None):
        return gru_apply(self, xs, mask, att)


# ------------------------------------------------------- JAX tree layout


def param_tree(named: Dict[str, torch.Tensor]):
    """Nested dict/list tree of a flat {"a.layers.0.w": tensor} mapping:
    dotted names become dict levels, all-digit levels become lists."""
    tree: dict = {}
    for name, t in named.items():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return listify(tree)


def _leaf_paths(node, prefix: str) -> List[str]:
    if isinstance(node, dict):
        return [p for k in sorted(node)
                for p in _leaf_paths(node[k], f"{prefix}{k}.")]
    if isinstance(node, list):
        return [p for i, v in enumerate(node)
                for p in _leaf_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def jax_leaf_names(module: nn.Module) -> List[str]:
    """Parameter names of `module` in `jax.tree_util` flatten order of the
    equivalent JAX param tree — leaf i of dense.npz is the parameter named
    jax_leaf_names(module)[i]. `named_parameters()` order differs (it
    follows construction order, `w` before `b`)."""
    return _leaf_paths(param_tree(dict(module.named_parameters())), "")
