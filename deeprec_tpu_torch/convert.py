"""Carry a JAX `TrainState`'s weights into the port's state.

The caller turns the JAX arrays into numpy (`np.asarray(leaf)`), so this
module needs no jax: tables move slot for slot (same keys at the same slots,
so both packages probe to the same rows) and the dense pytree's leaves, in
`jax.tree_util` flatten order, become the model's parameters.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from deeprec_tpu_torch.embedding.table import KEY_DTYPES, VALUE_DTYPES, TableState
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.training.trainer import Trainer, TrainState


def table_state_from_arrays(cfg, arrays: Dict[str, np.ndarray], num_tables: int,
                            device) -> TableState:
    """TableState from one JAX bundle's `keys`, `values` and `meta` arrays
    (stacked [T, ...] or unstacked). Packed small-dim values
    ([C // P, P * D]) unpack by a reshape: the rows are row-major."""
    T = num_tables
    keys = np.asarray(arrays["keys"]).reshape(T, -1)
    C = keys.shape[1]
    values = np.asarray(arrays["values"], np.float32).reshape(T, C, cfg.dim)
    meta = np.asarray(arrays["meta"], np.int32).reshape(T, 3, C)
    return TableState(
        keys=torch.tensor(keys, device=device, dtype=KEY_DTYPES[cfg.key_dtype]),
        values=torch.tensor(values, device=device,
                            dtype=VALUE_DTYPES[cfg.value_dtype]),
        meta=torch.tensor(meta, device=device),
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
                            dense_leaves: Sequence[np.ndarray]) -> TrainState:
    """The port's TrainState from a JAX TrainState's arrays: `tables` maps
    each bundle name to its {"keys", "values", "meta"} arrays."""
    return TrainState(
        step=int(step),
        tables={
            bname: table_state_from_arrays(
                b.table.cfg, tables[bname], b.num_tables, trainer.device)
            for bname, b in trainer.bundles.items()
        },
        dense=dense_from_leaves(trainer.model, dense_leaves, trainer.device),
    )
