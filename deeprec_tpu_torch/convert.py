"""Carry a JAX `TrainState` into the port's state.

The caller turns the JAX arrays into numpy (`np.asarray(leaf)`), so this
module needs no jax: tables move slot for slot (same keys at the same slots,
so both packages probe to the same rows) with their optimizer slots and
counters, the dense pytree's leaves, in `jax.tree_util` flatten order,
become the model's parameters, and the `optax.adam` state's leaves (count,
mu..., nu...) become the port's Adam state. The composite embeddings'
dense tables (`MultiHashTable`'s (q, r), `AdaptiveEmbedding`'s static
table) move as they are.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deeprec_tpu_torch.embedding.table import (
    COUNTERS, KEY_DTYPES, VALUE_DTYPES, TableState,
)
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.optim import dense as dense_optim
from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX
from deeprec_tpu_torch.training.trainer import Trainer, TrainState


def table_state_from_arrays(cfg, arrays: Dict[str, np.ndarray], num_tables: int,
                            device) -> TableState:
    """TableState from one JAX bundle's arrays (stacked [T, ...] or
    unstacked): `keys`, `values`, `meta`, and optionally `slots` ({name:
    array}), a CBF table's sketch `bloom` and the int32 counters
    `insert_fails`, `dedup_unique`, `dedup_ids`, `dedup_overflow` (zero
    when absent), and an int8 table's per-row scale `qscale`. Packed small-dim arrays ([C // P,
    P * w]) unpack by a reshape: the rows are row-major."""
    T = num_tables
    keys = np.asarray(arrays["keys"]).reshape(T, -1)
    C = keys.shape[1]
    values = np.asarray(arrays["values"], np.float32).reshape(T, C, cfg.dim)
    meta = np.asarray(arrays["meta"], np.int32).reshape(T, 3, C)
    slots = {}
    for name, arr in arrays.get("slots", {}).items():
        shape = (T, 1, 1) if name.startswith(SCALAR_PREFIX) else (T, C, -1)
        slots[name] = torch.tensor(np.asarray(arr, np.float32).reshape(shape),
                                   device=device)
    counters = {
        name: torch.tensor(np.asarray(arrays.get(name, np.zeros(T)), np.int32
                                      ).reshape(T), device=device)
        for name in COUNTERS
    }
    return TableState(
        keys=torch.tensor(keys, device=device, dtype=KEY_DTYPES[cfg.key_dtype]),
        values=torch.tensor(values, device=device,
                            dtype=VALUE_DTYPES[cfg.value_dtype]),
        meta=torch.tensor(meta, device=device),
        slots=slots,
        **counters,
        bloom=(None if arrays.get("bloom") is None else torch.tensor(
            np.asarray(arrays["bloom"], np.int32).reshape(T, -1), device=device)),
        qscale=(None if arrays.get("qscale") is None else torch.tensor(
            np.asarray(arrays["qscale"], np.float32).reshape(T, C), device=device)),
    )


def dense_from_leaves(model, leaves: Sequence[np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{parameter name: tensor} from the JAX param tree's leaves."""
    names = jax_leaf_names(model)
    if len(leaves) != len(names):
        raise ValueError(f"{len(leaves)} dense leaves, the model has {len(names)}")
    params = dict(model.named_parameters())
    out = {}
    for name, leaf in zip(names, leaves):
        leaf = np.asarray(leaf, np.float32)
        if leaf.shape != tuple(params[name].shape):
            raise ValueError(
                f"leaf for {name} has shape {leaf.shape}, want "
                f"{tuple(params[name].shape)}")
        out[name] = torch.tensor(leaf, device=device)
    return out


def train_state_from_arrays(trainer: Trainer, step: int,
                            tables: Dict[str, Dict[str, np.ndarray]],
                            dense_leaves: Sequence[np.ndarray],
                            opt_leaves: Optional[Sequence[np.ndarray]] = None,
                            ) -> TrainState:
    """The port's TrainState from a JAX TrainState's arrays: `tables` maps
    each bundle name to its arrays (see `table_state_from_arrays`),
    `opt_leaves` are `jax.tree_util.tree_leaves(opt_state)` of an
    `optax.adam` (a training trainer without them starts a fresh Adam
    state)."""
    dense = dense_from_leaves(trainer.model, dense_leaves, trainer.device)
    if opt_leaves is not None:
        opt_state = dense_optim.state_from_leaves(
            opt_leaves, jax_leaf_names(trainer.model), dense)
    elif trainer.sparse_opt is not None:
        opt_state = trainer.dense_opt.init(dense)
    else:
        opt_state = None
    return TrainState(
        step=int(step),
        tables={
            bname: table_state_from_arrays(
                b.table.cfg, tables[bname], b.num_tables, trainer.device)
            for bname, b in trainer.bundles.items()
        },
        dense=dense,
        opt_state=opt_state,
    )


def multihash_params_from_arrays(mh, arrays: Sequence[np.ndarray], device):
    """`MultiHashTable` params (q, r) from the JAX `MultiHashTable.create`
    pair (as numpy arrays), checked against the config's bucket counts."""
    q, r = (np.asarray(a, np.float32) for a in arrays)
    want = ((mh.cfg.num_buckets_q, mh.cfg.dim), (mh.cfg.num_buckets_r, mh.cfg.dim))
    if (q.shape, r.shape) != want:
        raise ValueError(f"multi-hash params have shapes {q.shape}, {r.shape}; want {want}")
    return tuple(torch.tensor(a, device=device) for a in (q, r))


def adaptive_static_from_array(ae, array: np.ndarray, device) -> torch.Tensor:
    """`AdaptiveEmbedding`'s static table from the JAX `create_static`
    array (as numpy), checked against [static_buckets, dim]."""
    a = np.asarray(array, np.float32)
    want = (ae.static_buckets, ae.table.cfg.dim)
    if a.shape != want:
        raise ValueError(f"static table has shape {a.shape}; want {want}")
    return torch.tensor(a, device=device)


def sharded_train_state_from_arrays(trainer, step: int, arrays: Dict[str, object],
                                    rank: int) -> TrainState:
    """Position `rank`'s TrainState of a `parallel.ShardedTrainer` from a JAX
    ShardedTrainer state's arrays: `arrays["tables"]` maps each bundle to its
    stacked leaves ([T, N, C / N, ...] for a stacked bundle, [N, C / N, ...]
    otherwise; the counters [T, N] / [N], `a2a_overflow`, `owner_arrivals`
    and `owner_unique` among them), of which the `rank` slice of the shard
    axis is taken; `arrays["dense"]` and `arrays["opt"]` are the replicated
    dense and `optax.adam` leaves (see `train_state_from_arrays`)."""
    from deeprec_tpu_torch.embedding.table import SHARD_COUNTERS

    def local(x, axis):
        if isinstance(x, dict):
            return {k: local(v, axis) for k, v in x.items()}
        return np.take(np.asarray(x), rank, axis=axis)

    tables = {}
    for bname, b in trainer.bundles.items():
        axis = 1 if b.stacked else 0
        tables[bname] = {k: local(v, axis) for k, v in arrays["tables"][bname].items()}
    st = train_state_from_arrays(trainer, step, tables, arrays["dense"], arrays.get("opt"))
    for bname, b in trainer.bundles.items():
        ts = st.tables[bname]
        for name in SHARD_COUNTERS:
            v = tables[bname].get(name)
            setattr(ts, name, torch.tensor(
                np.zeros(b.num_tables) if v is None else np.asarray(v), dtype=torch.int32,
                device=trainer.device).reshape(b.num_tables))
    return st
