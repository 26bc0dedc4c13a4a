"""Full checkpoints in the JAX package's on-disk format — the port of
`deeprec_tpu/training/checkpoint.py`, full saves only.

Layout of one save, `<dir>/full-<step>/`:
  * `table_<bundle>_t<k>.npz` per member k of a stacked bundle
    (`table_<bundle>_t.npz` for an unstacked one): the live rows, compacted,
    as `keys`, `values` (f32 logical rows), `freqs`, `versions`, and the
    optimizer's `slot:<name>` arrays (per-row rows, compacted like the
    values; per-table scalars `slot:scalar/...` whole) and a CBF table's
    counting-Bloom sketch `bloom`, whole;
  * `dense.npz`: the dense parameters as `leaf_<i>` in `jax.tree_util`
    flatten order of the JAX param tree (nn.jax_leaf_names);
  * `opt.npz` (training states): the dense optimizer's state as `leaf_<i>`
    in optax's flatten order (count, mu..., nu...);
  * `manifest.json`, written last and atomically — its presence marks a
    complete save — with a crc32 digest of every array, checked on read.

Restore inserts each key by probing (so a checkpoint restores onto any
capacity: a table grown by `Trainer.maintain` restores at its new capacity
into the trainer that grew it) and writes its rows in place through the
row-scatter kernel:
exact into f32, stochastically rounded (seed 0, as the JAX package does)
into bf16 — rows that came out of a bf16 table are representable and stay
bit-identical. A serving trainer (no sparse optimizer) skips the slot rows
and `opt.npz`. Incremental chains, part files, quarantine of corrupt saves
and the async writer wait for a later slice.
"""
from __future__ import annotations

import json
import os
import re
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from deeprec_tpu_torch.embedding.table import (
    KEY_DTYPES, META_FREQ, META_VERSION, EmbeddingTable, TableState, empty_key,
)
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr
from deeprec_tpu_torch.optim import dense as dense_optim
from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX
from deeprec_tpu_torch.training.trainer import Trainer, TrainState

_ROW_ARRAYS = ("keys", "values", "freqs", "versions")
_SLOT = "slot:"


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed verification (missing file or array,
    unreadable npz, digest mismatch)."""


def _array_digest(arr: np.ndarray) -> str:
    """crc32 over the raw bytes plus dtype and shape — the JAX package's
    manifest digest, byte for byte."""
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(a.tobytes()) & 0xFFFFFFFF
    shape = "x".join(map(str, a.shape))
    return f"crc32:{crc:08x}:{a.dtype.str}:{shape}"


def table_file(bname: str, member: Optional[int]) -> str:
    return f"table_{bname}_{'t' if member is None else f't{member}'}.npz"


# ----------------------------------------------------------- table rows


def export_table_arrays(table: EmbeddingTable, state: TableState,
                        member: int) -> Dict[str, np.ndarray]:
    """The live rows of table `member` of a stacked state, compacted in
    ascending slot order, with its optimizer slots, as host arrays."""
    cfg = table.cfg
    keys = state.keys[member]
    occ = keys != empty_key(cfg)
    cf = cfg.ev.counter_filter
    if not cfg.ev.ckpt.save_filtered_features and cf is not None and cf.filter_freq > 0:
        occ = occ & (state.meta[member, META_FREQ] >= cf.filter_freq)
    idx = torch.nonzero(occ).flatten()
    out = {
        "keys": keys[idx].cpu().numpy(),
        "values": state.values[member, idx].to(torch.float32).cpu().numpy(),
        "freqs": state.meta[member, META_FREQ, idx].cpu().numpy(),
        "versions": state.meta[member, META_VERSION, idx].cpu().numpy(),
    }
    for name, arr in state.slots.items():
        sub = arr[member] if name.startswith(SCALAR_PREFIX) else arr[member, idx]
        out[_SLOT + name] = sub.cpu().numpy()
    if state.bloom is not None:
        out["bloom"] = state.bloom[member].cpu().numpy()
    return out


def import_rows(table: EmbeddingTable, state: TableState, member: int,
                rows: Dict[str, np.ndarray]) -> None:
    """Insert checkpointed rows into table `member` of `state`, IN PLACE:
    probe-insert the keys, then write values, freqs, versions and the
    `slot:*` rows present in `rows` at the slots they landed in, and a
    `bloom` sketch into a CBF table whole. Values and
    per-row slots go through the row-scatter kernel with seed 0 (bf16
    tables round stochastically, as the JAX package's restore does). Which
    slot a key wins in a claim race is free; the row a key reads back is
    not."""
    device = state.keys.device
    if "bloom" in rows and state.bloom is not None:
        state.bloom[member].copy_(torch.as_tensor(np.asarray(rows["bloom"], np.int32)))
    n = rows["keys"].shape[0]
    if n == 0:
        return
    keys = torch.as_tensor(rows["keys"]).to(device, KEY_DTYPES[table.cfg.key_dtype])
    slot_ix, _, failed = table._probe(
        state.keys[member:member + 1], keys[None],
        torch.ones((1, n), dtype=torch.bool, device=device),
    )
    if bool(failed.any()):
        raise RuntimeError(
            f"table {table.cfg.name}: {int(failed.sum())} keys failed to "
            "insert on restore — grow the capacity"
        )

    def put(target, name):
        r = torch.tensor(np.asarray(rows[name], np.float32), device=device)
        apply_rows_sr(target[member:member + 1], slot_ix,
                      r.reshape(1, n, -1), seed=0)

    put(state.values, "values")
    for name, arr in state.slots.items():
        if _SLOT + name not in rows:
            continue
        if name.startswith(SCALAR_PREFIX):
            arr[member].copy_(torch.tensor(
                np.asarray(rows[_SLOT + name], np.float32)).reshape(1, 1))
        else:
            put(arr, _SLOT + name)
    ok = slot_ix[0] >= 0  # a sentinel key places nowhere; its row is dropped
    ix = slot_ix[0][ok].long()

    def col(name):
        return torch.tensor(np.asarray(rows[name]), device=device)[ok].to(torch.int32)

    state.meta[member, META_FREQ, ix] = col("freqs")
    state.meta[member, META_VERSION, ix] = col("versions")


# ------------------------------------------------------------ writing


def _leaves_file(leaves: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"leaf_{i}": l for i, l in enumerate(leaves)}


def write_full(path: str, step: int, tables: Dict[str, Dict[str, np.ndarray]],
               dense_leaves: Sequence[np.ndarray],
               bundles: Dict[str, List[str]],
               opt_leaves: Optional[Sequence[np.ndarray]] = None) -> str:
    """Write one full checkpoint directory: every table file of `tables`
    ({file name: arrays}), `dense.npz` from `dense_leaves` (JAX flatten
    order), `opt.npz` from `opt_leaves` when given, then the manifest,
    atomically, last."""
    os.makedirs(path, exist_ok=True)
    mf = os.path.join(path, "manifest.json")
    if os.path.exists(mf):
        os.remove(mf)  # the directory is incomplete until the new manifest
    digests: Dict[str, Dict[str, str]] = {}
    files = dict(tables)
    files["dense.npz"] = _leaves_file(dense_leaves)
    if opt_leaves is not None:
        files["opt.npz"] = _leaves_file(opt_leaves)
    for fname, arrays in files.items():
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        np.savez(os.path.join(path, fname), **arrays)
        digests[fname] = {k: _array_digest(v) for k, v in arrays.items()}
    manifest = {
        "step": int(step), "kind": "full", "digests": digests,
        "routing": {b: "uniform" for b in bundles}, "bundles": bundles,
    }
    tmp = os.path.join(path, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mf)
    return path


# ------------------------------------------------------------ manager


class CheckpointManager:
    """Full save and restore for a Trainer (single device)."""

    def __init__(self, directory: str, trainer: Trainer):
        self.dir = directory
        self.trainer = trainer
        os.makedirs(directory, exist_ok=True)

    def _members(self):
        for bname, b in self.trainer.bundles.items():
            for k in range(b.num_tables):
                yield bname, b, k, table_file(bname, k if b.stacked else None)

    def save(self, state: TrainState) -> str:
        """Write a full checkpoint of `state`; returns its directory."""
        tables = {
            fname: export_table_arrays(b.table, state.tables[bname], k)
            for bname, b, k, fname in self._members()
        }
        names = jax_leaf_names(self.trainer.model)
        leaves = [state.dense[n].detach().cpu().numpy() for n in names]
        opt_leaves = (None if state.opt_state is None
                      else dense_optim.state_leaves(state.opt_state, names))
        bundles = {
            bname: [f.name for f in b.features]
            for bname, b in self.trainer.bundles.items()
        }
        path = os.path.join(self.dir, f"full-{int(state.step)}")
        return write_full(path, state.step, tables, leaves, bundles, opt_leaves)

    def latest_full(self) -> Optional[int]:
        """Step of the newest complete (manifest-bearing) full save."""
        pat = re.compile(r"^full-(\d+)$")
        return max((
            int(m.group(1)) for d in os.listdir(self.dir)
            if (m := pat.match(d))
            and os.path.exists(os.path.join(self.dir, d, "manifest.json"))
        ), default=None)

    @staticmethod
    def _manifest(path: str) -> dict:
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(f"checkpoint {path}: manifest: {e}") from e

    def verify(self, path: str) -> None:
        """Raise CheckpointCorrupt unless every array the manifest lists is
        present and matches its recorded digest."""
        for fname, arrays in self._manifest(path).get("digests", {}).items():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorrupt(f"checkpoint {path}: {fname} missing")
            try:
                with np.load(fpath) as z:
                    for aname, want in arrays.items():
                        if aname not in z.files:
                            raise CheckpointCorrupt(
                                f"checkpoint {path}: {fname}:{aname} absent")
                        got = _array_digest(z[aname])
                        if got != want:
                            raise CheckpointCorrupt(
                                f"checkpoint {path}: {fname}:{aname} digest "
                                f"mismatch ({got} != recorded {want})")
            except (OSError, ValueError, zlib.error) as e:
                raise CheckpointCorrupt(
                    f"checkpoint {path}: {fname} unreadable: {e}") from e

    def restore(self) -> TrainState:
        """The latest full checkpoint, verified, onto fresh tables of the
        trainer's configs and device."""
        step = self.latest_full()
        if step is None:
            raise FileNotFoundError(f"no full checkpoint under {self.dir}")
        path = os.path.join(self.dir, f"full-{step}")
        manifest = self._manifest(path)
        if manifest.get("format") == "parts":
            raise NotImplementedError("part-file checkpoints wait for a later slice")
        self.verify(path)
        state = self.trainer.init()
        declared = manifest.get("bundles", {})
        for bname, b, k, fname in self._members():
            fpath = os.path.join(path, fname)
            if not os.path.exists(fpath):
                if bname in declared:
                    raise CheckpointCorrupt(f"checkpoint {path}: {fname} missing")
                continue  # a table added after this checkpoint was written
            slots = state.tables[bname].slots
            with np.load(fpath) as z:
                rows = {name: z[name] for name in z.files
                        if name in _ROW_ARRAYS or name == "bloom"
                        or (name.startswith(_SLOT) and name[len(_SLOT):] in slots)}
            import_rows(b.table, state.tables[bname], k, rows)
        self._load_dense(state, os.path.join(path, "dense.npz"))
        opt_state = state.opt_state
        opath = os.path.join(path, "opt.npz")
        if opt_state is not None and os.path.exists(opath):
            with np.load(opath) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            opt_state = dense_optim.state_from_leaves(
                leaves, jax_leaf_names(self.trainer.model), state.dense)
        return TrainState(step=int(manifest.get("step", step)),
                          tables=state.tables, dense=state.dense,
                          opt_state=opt_state)

    def _load_dense(self, state: TrainState, fpath: str) -> None:
        names = jax_leaf_names(self.trainer.model)
        with np.load(fpath) as z:
            if len(z.files) != len(names):
                raise ValueError(
                    f"{fpath}: {len(z.files)} dense leaves, the model has "
                    f"{len(names)}")
            for i, name in enumerate(names):
                t = state.dense[name]
                leaf = np.asarray(z[f"leaf_{i}"], np.float32)
                if leaf.size != t.numel():
                    raise ValueError(
                        f"{fpath}: leaf_{i} has shape {leaf.shape}, parameter "
                        f"{name} has {tuple(t.shape)}")
                t.copy_(torch.from_numpy(leaf.reshape(tuple(t.shape))))
