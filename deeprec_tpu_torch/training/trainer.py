"""Read-only forward over (hash tables + dense params) — the serving subset
of `deeprec_tpu/training/trainer.py`.

Features whose tables share a config and id shape are bundled: their
states stack along the leading table axis [T] and one batched lookup serves
all of them (the JAX package vmaps over that axis; here every table op
takes it as a batch dimension). The dense parameters live in a flat
{name: tensor} dict and the model runs through `torch.func.functional_call`,
so a state is a self-contained snapshot that a serving reload can replace
atomically. Training (train_step, optimizers, budgets) waits for the
training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
from torch.func import functional_call

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch import resolve_device
from deeprec_tpu_torch.embedding import combiners
from deeprec_tpu_torch.embedding.table import KEY_DTYPES, EmbeddingTable, TableState
from deeprec_tpu_torch.features import SparseFeature


@dataclasses.dataclass
class TrainState:
    step: int
    tables: Dict[str, TableState]  # bundle name -> stacked table state
    dense: Dict[str, torch.Tensor]  # model parameter name -> tensor


@dataclasses.dataclass
class Bundle:
    """A set of features served by one table state. stacked=True: T member
    tables of one shared config on the leading axis; stacked=False: one
    table (T = 1), possibly shared by several features."""

    name: str
    table: EmbeddingTable
    features: List[SparseFeature]
    stacked: bool

    @property
    def num_tables(self) -> int:
        return len(self.features) if self.stacked else 1


def build_bundles(specs) -> Dict[str, Bundle]:
    """Group single-use tables by (config-sans-name, pad, pooling, max_len);
    keep shared tables as individual bundles. Same names and order as the
    JAX package, so checkpoints map bundle for bundle."""
    sparse = fcol.sparse_features(specs)
    by_table: Dict[str, List[SparseFeature]] = {}
    for f in sparse:
        by_table.setdefault(fcol.resolve_table_name(f), []).append(f)
    cfgs = fcol.table_configs(specs)

    bundles: Dict[str, Bundle] = {}
    groups: Dict[tuple, List[SparseFeature]] = {}
    for tname, feats in by_table.items():
        cfg = cfgs[tname]
        if len(feats) > 1:
            bundles[tname] = Bundle(tname, EmbeddingTable(cfg), feats, False)
        else:
            f = feats[0]
            key = (dataclasses.replace(cfg, name="_"), f.pad_value, f.pooling,
                   f.max_len)
            groups.setdefault(key, []).append(f)
    for i, (key, feats) in enumerate(sorted(groups.items(), key=lambda kv: kv[1][0].name)):
        if len(feats) == 1:
            tname = fcol.resolve_table_name(feats[0])
            bundles[tname] = Bundle(tname, EmbeddingTable(cfgs[tname]), feats, False)
        else:
            cfg = dataclasses.replace(key[0], name=f"group{i}")
            bundles[cfg.name] = Bundle(cfg.name, EmbeddingTable(cfg), feats, True)
    return bundles


@dataclasses.dataclass
class ModelInputs:
    """What the model's forward receives. Sequence features (pooling
    "none", the JAX package's `seq` field) wait for the models that use
    them."""

    pooled: Dict[str, torch.Tensor]  # feature -> [B, D]
    dense: Dict[str, torch.Tensor]  # feature -> [B, W]


def _prep_ids(ids: torch.Tensor) -> torch.Tensor:
    return ids[:, None] if ids.dim() == 1 else ids


class Trainer:
    """Serving subset of the JAX Trainer: bundles, the read-only lookup
    and the label-free forward. `model` is an nn.Module with `features`
    and `forward(inputs)`; its own parameters are only the template of
    `TrainState.dense`."""

    def __init__(self, model, device=None):
        self.model = model
        self.device = resolve_device(device)
        self.sparse_specs = fcol.sparse_features(model.features)
        self.dense_specs = fcol.dense_features(model.features)
        self.bundles = build_bundles(model.features)

    def init(self) -> TrainState:
        """Empty tables and the model's own parameters, on the device."""
        tables = {
            bname: b.table.create(b.num_tables, self.device)
            for bname, b in self.bundles.items()
        }
        dense = {
            n: p.detach().to(self.device, copy=True)
            for n, p in self.model.named_parameters()
        }
        return TrainState(step=0, tables=tables, dense=dense)

    def input_keys(self) -> frozenset:
        return frozenset(f.name for f in self.sparse_specs) | frozenset(
            f.name for f in self.dense_specs
        )

    def _ids(self, b: Bundle, batch, feats) -> torch.Tensor:
        """[T, B, L] id stack of `feats` in the table's key dtype (64-bit
        ids narrow as they do on the way into a 32-bit JAX table)."""
        ids = [_prep_ids(batch[f.name]) for f in feats]
        shapes = {f.name: tuple(i.shape) for f, i in zip(feats, ids)}
        if len(set(shapes.values())) > 1:
            raise ValueError(
                f"grouped features have mismatched id shapes {shapes}; "
                "declare distinct SparseFeature.max_len values to keep "
                "them in separate embedding groups"
            )
        return torch.stack(ids).to(KEY_DTYPES[b.table.cfg.key_dtype])

    def _lookup_all(self, tables, batch):
        """Every bundle's read-only lookup. Returns (per-feature views
        (embeddings [U, D], inverse [B, L], mask [B, L]), per-bundle
        results)."""
        views, bundle_res = {}, {}
        for bname, b in self.bundles.items():
            members = [b.features] if b.stacked else [[f] for f in b.features]
            for feats in members:
                ids = self._ids(b, batch, feats)
                pad = feats[0].pad_value
                res = b.table.lookup_unique(tables[bname], ids, pad_value=pad)
                masks = ids != pad
                for k, f in enumerate(feats):
                    views[f.name] = (res.embeddings[k], res.inverse[k], masks[k])
                if b.stacked:
                    bundle_res[bname] = res
                else:
                    bundle_res.setdefault(bname, {})[feats[0].name] = res
        return views, bundle_res

    def _build_inputs(self, embs, views, batch) -> ModelInputs:
        pooled = {}
        for f in self.sparse_specs:
            _, inverse, mask = views[f.name]
            pooled[f.name] = combiners.combine(embs[f.name], inverse, mask,
                                               f.pooling)
        dense = {f.name: batch[f.name] for f in self.dense_specs}
        return ModelInputs(pooled=pooled, dense=dense)

    @torch.no_grad()
    def forward_views(self, state: TrainState, batch):
        """Read-only lookup pass (no inserts or counters): per-feature
        views plus per-bundle results."""
        return self._lookup_all(state.tables, batch)

    @torch.no_grad()
    def probs_from_views(self, state: TrainState, views, batch):
        """Label-free forward: views -> (logits, sigmoid probabilities)."""
        embs = {n: v[0].to(torch.float32) for n, v in views.items()}
        inputs = self._build_inputs(embs, views, batch)
        logits = functional_call(self.model, state.dense, (inputs,))
        return logits, torch.sigmoid(logits)
