"""Checkpoints in the JAX package's on-disk format — the port of
`deeprec_tpu/training/checkpoint.py` for the single-device Trainer: full
and incremental saves, verified chains with quarantine, restore over the
chain, part files (read), retention, stream positions and the async writer.

Layout of one save, `<dir>/<kind>-<step>/` (kind `full` or `incr`):
  * `table_<bundle>_t<k>.npz` per member k of a stacked bundle
    (`table_<bundle>_t.npz` for an unstacked one): the rows, compacted in
    ascending slot order, as `keys`, `values` (f32 logical rows), `freqs`,
    `versions` and the optimizer's `slot:<name>` arrays (per-row rows
    compacted like the values; per-table scalars `slot:scalar/...` whole)
    and a CBF table's counting-Bloom sketch `bloom`, whole. A full save
    holds every live row, a delta the rows dirtied since the previous save
    plus `live_keys`, every key the member held (restore drops the keys
    evicted in between); rows below a counter filter's threshold are
    dropped unless `save_filtered_features`;
  * `dense.npz`: the dense parameters as `leaf_<i>` in `jax.tree_util`
    flatten order of the JAX param tree (nn.jax_leaf_names);
  * `opt.npz` (training states): the dense optimizer's state as `leaf_<i>`
    in optax's flatten order (count, mu..., nu...);
  * `datasets.part00000.json` when the manager has `datasets=`: each input
    reader's position (`save()`), taken when the save was staged;
  * `manifest.json`, written last and atomically — its presence marks a
    complete save — with a crc32 digest of every array, `base` (the step
    the delta applies over) on a delta, `bundles` on a full save.

A save has two halves. The stage half reads the live state on the device:
it counts each member's live (full) or dirty (delta) rows, reads all the
counts back in one host copy, and compacts each member at a power-of-two
budget (`ops/compact.py`) through the row-gather kernel (#3 for f32 rows
and slots; its bf16 branch, #1, for bf16 values). The write half
truncates, filters, writes the files and commits the manifest, then ages
out old saves (`keep`). `save` / `save_incremental` run both on the
caller and return (state, path) with the dirty bits cleared (in place: the
port trains in place). `save_async` / `save_incremental_async` stage on
the caller, start the host copies into pinned memory on a side stream
behind an event, clear the dirty bits on the current stream (so after the
stage's reads in stream order) and write on a background thread that
waits on that event; training continues meanwhile. At most one save is in
flight, `wait()` drains it and re-raises a writer failure, and a failed
delta writer escalates the next save to a full one (its rows are clean but
in no file).

`transfer_bytes` in `last_save` counts what the JAX package's
`_tree_bytes` counts: for a delta the padded compacted arrays plus each
member's `[C]` keys (what crosses to the host), for a full save the whole
tables (`Trainer._state_bytes`), plus the dense leaves and the optimizer
state. The port's full saves move only the compacted live rows.

Restore verifies the chain — the newest intact full save, then the deltas
whose `base` links follow on — quarantines a corrupt link by renaming it
`*.quarantined[.N]`, and replays what is left: each key probed into place
(so a checkpoint restores onto any capacity), its rows written through the
row-scatter kernel (#5; its bf16 branch, #2, rounds stochastically with
seed 0 as the JAX restore does — rows that came out of a bf16 table are
representable and stay bit-identical). Part files (the JAX ShardedTrainer's
`sharded_io=True` format) are read and merged; a plain trainer imports no
sketch from them, as the JAX plain trainer does.

A `ShardedTrainer` (parallel/trainer.py) of N > 1 positions saves part
files: every position writes `table_<bundle>_<tag>.part<rank>.npz` with its
shard's rows (plus `partition_offset`, `shard_ids`, `num_shards` and a CBF
table's sketch as `bloom_parts`) and `datasets.part<rank>.json`; after a
barrier position 0 writes the dense state and the manifest (`format:
"parts"`, `parts`, `num_shards`, the digests of every part). A sharded
restore reads every part and keeps the rows its position owns
(`restore_owner`), whatever world size or mesh shape saved them; a CBF
sketch comes back exactly from `bloom_parts` when the shard count and
routing match, else is rebuilt from the imported rows' freqs.
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import itertools
import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeprec_tpu_torch.embedding.table import (
    COUNTERS, KEY_DTYPES, META_DIRTY, META_FREQ, META_VERSION, EmbeddingTable, TableState,
    SHARD_COUNTERS, empty_key, member_view, quantize_rows_int8,
)
from deeprec_tpu_torch.nn import jax_leaf_names
from deeprec_tpu_torch.obs import trace as obs_trace
from deeprec_tpu_torch.ops.compact import next_pow2, quantize_rows, rank_compact
from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows
from deeprec_tpu_torch.optim import dense as dense_optim
from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX
from deeprec_tpu_torch.training.trainer import Trainer, TrainState, _put_member

_log = logging.getLogger(__name__)

_SLOT = "slot:"


class CheckpointCorrupt(RuntimeError):
    """A committed checkpoint failed verification (missing file or array,
    torn manifest, unreadable npz, digest mismatch)."""


def _array_digest(arr: np.ndarray) -> str:
    """crc32 over the raw bytes plus dtype and shape — the JAX package's
    manifest digest, byte for byte."""
    a = np.ascontiguousarray(arr)
    crc = zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF  # the raw bytes, no copy
    shape = "x".join(map(str, a.shape))
    return f"crc32:{crc:08x}:{a.dtype.str}:{shape}"


def is_per_row(name: str) -> bool:
    """Per-row arrays (compacted, sliced, padded) by name; per-table ones
    (the sketch, scalar slots, `live_keys`) are carried whole."""
    if name in ("keys", "values", "freqs", "versions"):
        return True
    return name.startswith(_SLOT) and not name.startswith(_SLOT + SCALAR_PREFIX)


def table_file(bname: str, member: Optional[int]) -> str:
    return f"table_{bname}_{'t' if member is None else f't{member}'}.npz"


def _savez(digests: Dict[str, Dict[str, str]], path: str, fname: str,
           arrays: Dict[str, np.ndarray]) -> None:
    """np.savez plus the digest of every array, for the manifest."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    np.savez(os.path.join(path, fname), **arrays)
    digests[fname] = {k: _array_digest(v) for k, v in arrays.items()}


def _commit_manifest(path: str, manifest: dict) -> None:
    """Write the manifest atomically: a crash leaves none, never a torn one."""
    tmp = os.path.join(path, ".manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def _leaves_file(leaves: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
    return {f"leaf_{i}": l for i, l in enumerate(leaves)}


def write_full(path: str, step: int, tables: Dict[str, Dict[str, np.ndarray]],
               dense_leaves: Sequence[np.ndarray],
               bundles: Dict[str, List[str]],
               opt_leaves: Optional[Sequence[np.ndarray]] = None) -> str:
    """Write one full checkpoint directory from host arrays: every table
    file of `tables` ({file name: arrays}), `dense.npz` from `dense_leaves`
    (JAX flatten order), `opt.npz` from `opt_leaves` when given, then the
    manifest, atomically, last."""
    os.makedirs(path, exist_ok=True)
    mf = os.path.join(path, "manifest.json")
    if os.path.exists(mf):
        os.remove(mf)  # the directory is incomplete until the new manifest
    digests: Dict[str, Dict[str, str]] = {}
    for fname, arrays in tables.items():
        _savez(digests, path, fname, arrays)
    _savez(digests, path, "dense.npz", _leaves_file(dense_leaves))
    if opt_leaves is not None:
        _savez(digests, path, "opt.npz", _leaves_file(opt_leaves))
    _commit_manifest(path, {
        "step": int(step), "kind": "full", "digests": digests,
        "routing": {b: "uniform" for b in bundles}, "bundles": bundles,
    })
    return path


# ----------------------------------------------------------- table rows


def import_rows(table: EmbeddingTable, state: TableState, member: int,
                rows: Dict[str, np.ndarray], strict: bool = True,
                bucket: bool = False, chunk: Optional[int] = None) -> None:
    """Insert checkpointed rows into table `member` of `state`, IN PLACE:
    probe-insert the keys, then write values, freqs, versions and the
    `slot:*` rows present in `rows` at the slots they landed in, a scalar
    slot and a CBF table's `bloom` sketch whole. Values and per-row slots go
    through the row-scatter kernel with seed 0 (bf16 tables round
    stochastically, as the JAX package's restore does).

    As the JAX `import_rows`: `strict` raises when a key finds no slot
    (else the key is dropped); `bucket` pads the rows to the next power of
    two and `chunk` imports in slices of exactly `chunk` rows (the last one
    padded), re-applying the per-table entries with every slice. Pad keys
    hold the sentinel and place nowhere; the pads are made on the device,
    so only the real rows cross from the host. With no rows only the sketch is
    applied, as in the JAX package. Which slot a key wins in a claim race
    is free; the row a key reads back is not. An int8 table quantizes the
    rows on the way in (`quantize_rows_int8`) and writes each row's scale
    into `qscale`. `import_members` does the same for several members of a
    stacked state at once."""
    import_members(table, member_view(state, member), {0: rows}, strict=strict,
                   bucket=bucket, chunk=chunk)


def import_members(table: EmbeddingTable, state: TableState,
                   rows_by: Dict[int, Dict[str, np.ndarray]], strict: bool = True,
                   bucket: bool = False, chunk: Optional[int] = None) -> None:
    """`import_rows` for members {k: rows} of `state` [T, ...] at once: one
    probe over every member, one row-scatter launch per value or slot
    array, one metadata write. Each member's keys land where they would
    alone (members probe their own tables); the padded shape is the
    largest member's, so a bf16 table's rounding bits are drawn for
    [T, m, D]."""
    T = state.keys.shape[0]
    device = state.keys.device
    ns = {k: int(r["keys"].shape[0]) for k, r in rows_by.items()}
    n_max = max(ns.values(), default=0)
    if n_max == 0:
        for k, rows in rows_by.items():
            if "bloom" in rows and state.bloom is not None:
                state.bloom[k].copy_(torch.as_tensor(np.asarray(rows["bloom"], np.int32)))
        return
    if chunk is not None and n_max > chunk:
        for off in range(0, n_max, chunk):
            import_members(table, state, {
                k: {name: (v[off:off + chunk] if is_per_row(name) else v)
                    for name, v in rows.items()}
                for k, rows in rows_by.items() if ns[k] > off or off == 0},
                strict=strict, chunk=chunk)
        return
    m = chunk if chunk is not None else (next_pow2(n_max) if bucket else n_max)
    full = [k for k in rows_by if ns[k] > 0]
    # where each real row sits in the padded [T, m] layout
    t_of = np.repeat(np.asarray(full, np.int64), [ns[k] for k in full])
    i_of = np.concatenate([np.arange(ns[k]) for k in full])
    t_ix, i_ix = torch.as_tensor(t_of, device=device), torch.as_tensor(i_of, device=device)

    def flat(name, dtype):
        return torch.as_tensor(np.concatenate(
            [np.asarray(rows_by[k][name], dtype) for k in full])).to(device)

    kd = KEY_DTYPES[table.cfg.key_dtype]
    keys = torch.full((T, m), empty_key(table.cfg), dtype=kd, device=device)
    keys[t_ix, i_ix] = flat("keys", {torch.int32: np.int32, torch.int64: np.int64}[kd])
    slot_ix, _, failed = table._probe(
        state.keys, keys, torch.ones((T, m), dtype=torch.bool, device=device))
    if strict and bool(failed.any()):
        raise RuntimeError(
            f"table {table.cfg.name}: {int(failed.sum())} keys failed to "
            "insert on restore — grow the capacity"
        )
    placed = slot_ix[t_ix, i_ix]
    ok = placed >= 0  # failed keys place nowhere (nor do the pads)
    t_ok, ix = t_ix[ok], placed[ok].long()

    def put(target, name, have):
        """Scatter the members' `name` rows into `target` through the row
        kernel; members in `full` but not in `have` write nothing."""
        width = target.shape[-1]
        r = torch.as_tensor(np.concatenate([
            np.asarray(rows_by[k][name], np.float32).reshape(ns[k], width) if k in have
            else np.zeros((ns[k], width), np.float32) for k in full])).to(device)
        buf = r.new_zeros((T, m, width))
        buf[t_ix, i_ix] = r
        sel = slot_ix
        if len(have) < len(full):
            mask = torch.zeros((T, 1), dtype=torch.bool, device=device)
            mask[sorted(have)] = True
            sel = torch.where(mask, slot_ix, -1)
        apply_rows_sr(target, sel, buf, seed=0)

    if table.quantized:
        # quantize on import: the file keeps f32 rows, the residency int8
        # rows with their scale beside them (plain indexing: no kernel
        # writes int8)
        q, scale = quantize_rows_int8(flat("values", np.float32))
        state.values[t_ok, ix] = q[ok].to(torch.int8)
        state.qscale[t_ok, ix] = scale[ok]
    else:
        put(state.values, "values", set(full))
    for name, arr in state.slots.items():
        have = {k for k in full if _SLOT + name in rows_by[k]}
        if not have:
            continue
        if name.startswith(SCALAR_PREFIX):
            for k in sorted(have):
                arr[k].copy_(torch.tensor(
                    np.asarray(rows_by[k][_SLOT + name], np.float32)).reshape(1, 1))
        else:
            put(arr, _SLOT + name, have)
    for k, rows in rows_by.items():
        if "bloom" in rows and state.bloom is not None:
            state.bloom[k].copy_(torch.as_tensor(np.asarray(rows["bloom"], np.int32)))
    state.meta[t_ok, META_FREQ, ix] = flat("freqs", np.int32)[ok]
    state.meta[t_ok, META_VERSION, ix] = flat("versions", np.int32)[ok]


def _clone_table_state(ts: TableState) -> TableState:
    return dataclasses.replace(
        ts, keys=ts.keys.clone(), values=ts.values.clone(), meta=ts.meta.clone(),
        slots={n: a.clone() for n, a in ts.slots.items()},
        **{n: getattr(ts, n).clone() for n in COUNTERS},
        bloom=None if ts.bloom is None else ts.bloom.clone(),
        qscale=None if ts.qscale is None else ts.qscale.clone(),
        **{n: None if getattr(ts, n) is None else getattr(ts, n).clone()
           for n in SHARD_COUNTERS})


# ------------------------------------------------- the stage half (device)


def _row_counts(table: EmbeddingTable, ts: TableState, dirty: bool) -> torch.Tensor:
    """[T] int32 on the device: each member's live (dirty=True: live and
    dirty) rows."""
    occ = ts.keys != empty_key(table.cfg)
    if dirty:
        occ = occ & (ts.meta[:, META_DIRTY] != 0)
    return occ.sum(-1, dtype=torch.int32)


def _compact_member(table: EmbeddingTable, ts: TableState, k: int, size: int,
                    dirty: bool) -> Dict[str, torch.Tensor]:
    """Member k's live (dirty=True: live and dirty) rows at static budget
    `size`, in ascending slot order (the JAX `_compact_dirty_jit`): every
    output a fresh tensor, so training may go on writing the state. Rows
    past the true count are padding the write half truncates. Values and
    per-row slots go through the row-gather kernel; a delta carries every
    key of the member (`_all_keys`), and the sketch rides whole."""
    sent = empty_key(table.cfg)
    keys = ts.keys[k]
    occ = keys != sent
    if dirty:
        occ = occ & (ts.meta[k, META_DIRTY] != 0)
    idx, _, _ = rank_compact(occ, size)
    safe = torch.where(idx >= 0, idx, 0)
    sl = safe.long()
    out = {
        "keys": torch.where(idx >= 0, keys[sl], sent),
        "values": gather_rows(ts.values[k:k + 1], safe[None])[0],
        "freqs": ts.meta[k, META_FREQ, sl],
        "versions": ts.meta[k, META_VERSION, sl],
    }
    if dirty:
        out["_all_keys"] = keys.clone()
    for name, arr in ts.slots.items():
        out[_SLOT + name] = (arr[k].clone() if name.startswith(SCALAR_PREFIX)
                             else gather_rows(arr[k:k + 1], safe[None])[0])
    if ts.bloom is not None:
        out["bloom"] = ts.bloom[k].clone()
    return out


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@dataclasses.dataclass
class _SavePlan:
    """What the write half needs, detached from the live state: each
    member's compacted arrays (host tensors, landed once `event` has),
    the dense leaves and optimizer leaves, the positions taken at stage
    time and the manifest's ingredients."""

    path: str
    kind: str
    step: int
    # bundle -> [(member, {array name: tensor}, true row count)]
    tables: Dict[str, List[Tuple[int, Dict[str, torch.Tensor], int]]]
    dense: List[torch.Tensor]
    opt: Optional[List[torch.Tensor]]
    positions: Optional[Dict[str, dict]]
    cfgs: Dict[str, Any]  # bundle -> (TableConfig, stacked)
    bundles: Dict[str, List[str]]
    stats: Dict[str, float]
    event: Optional[torch.cuda.Event] = None


# threads that read and check a directory's files at once
_VERIFY_THREADS = 8


def _verify_file(path: str, fname: str, arrays: Dict[str, str]) -> Optional[str]:
    """None when file `fname` of directory `path` holds every array of
    `arrays` ({name: recorded digest}) with its recorded digest, else the
    reason."""
    fpath = os.path.join(path, fname)
    if not os.path.exists(fpath):
        return f"{fname}: missing from committed checkpoint"
    try:
        with np.load(fpath) as z:
            names = set(z.files)
            for aname, want in arrays.items():
                if aname not in names:
                    return f"{fname}:{aname}: array absent"
                got = _array_digest(z[aname])
                if got != want:
                    return f"{fname}:{aname}: digest mismatch ({got} != recorded {want})"
    except Exception as e:  # zip CRC, truncation, a bad header
        return f"{fname}: unreadable ({type(e).__name__}: {e})"
    return None


# -------------------------------------------------------- checkpoint manager


class CheckpointManager:
    """Save and restore for a single-device Trainer.

    Layout:
        <dir>/full-<step>/manifest.json, dense.npz, opt.npz, table_<bundle>_t<k>.npz
        <dir>/incr-<step>/...            (rows dirtied since the previous save)
    """

    def __init__(self, directory: str, trainer: Trainer, keep: int = 3,
                 sharded_io: Optional[bool] = None,
                 datasets: Optional[Dict[str, object]] = None):
        """keep: the full saves retention keeps (<= 0 keeps everything);
        deltas and quarantined directories older than the oldest kept full
        save go with it. datasets: {name: reader} of input-state carriers
        (anything with `save() -> dict` / `restore(dict)`), whose positions
        ride every save and rewind with `restore()`. sharded_io: part files
        per position, for a ShardedTrainer only; None = parts when its mesh
        has more than one position (the only format such a trainer can
        write: no position holds another's shard)."""
        self._sharded = hasattr(trainer, "mesh") and hasattr(trainer, "num_shards")
        if sharded_io and not self._sharded:
            raise ValueError(
                "CheckpointManager(sharded_io=True) writes the part files of a "
                "ShardedTrainer; a plain Trainer saves single files")
        n = trainer.num_shards if self._sharded else 1
        self._parts = self._sharded and (n > 1 if sharded_io is None else bool(sharded_io))
        if self._sharded and n > 1 and not self._parts:
            raise ValueError(
                "CheckpointManager: a ShardedTrainer over several positions saves "
                "part files (sharded_io=True); no position holds the whole table")
        self._rank = trainer.mesh.index if self._sharded else 0
        self.dir = directory
        self.trainer = trainer
        self.keep = keep
        self.datasets = dict(datasets or {})
        # the async writer: at most one save in flight; wait() drains it and
        # re-raises. on_write is a test seam run in the writer thread before
        # any file IO.
        self._writer: Optional[threading.Thread] = None
        self._writer_err: Optional[Tuple[BaseException, str]] = None
        self._force_full = False  # a failed delta writer: the next save is full
        self.on_write = None
        self._copy_stream = None  # the async host copies' stream, made at first use
        # directories that passed verification (committed files never change)
        self._verified: set = set()
        self._manifest_cache: Dict[str, dict] = {}
        self.quarantine_count = 0
        self.last_quarantined: Optional[str] = None
        # the caller's blocking time summed over saves, and the last save's
        # {kind, path, async, stall_ms, transfer_bytes, rows (live rows of a
        # full save, dirty rows of a delta, before the counter filter),
        # write_ms (async, once the writer finished)}
        self.ckpt_stall_ms: float = 0.0
        self.last_save: Dict[str, Any] = {}
        os.makedirs(directory, exist_ok=True)

    # ---------------------------------------------------------------- save

    def save(self, state: TrainState) -> Tuple[TrainState, str]:
        """Full checkpoint. Returns (state with its dirty bits cleared, in
        place; path)."""
        return self._save(state, "full")

    def save_incremental(self, state: TrainState) -> Tuple[TrainState, str]:
        """Delta checkpoint: the rows dirtied since the previous save,
        compacted on the device, so what crosses to the host scales with
        the dirty rows. Escalates to a full save after a failed delta
        writer or when a quarantined link left the chain a gap."""
        return self._save(state, "incr")

    def save_async(self, state: TrainState) -> Tuple[TrainState, str]:
        """`save` with the write half on a background thread: returns once
        the live rows are compacted and their host copies started; the
        checkpoint is durable only once `wait()` returns (until then its
        directory has no manifest, which restore ignores)."""
        return self._save_async(state, "full")

    def save_incremental_async(self, state: TrainState) -> Tuple[TrainState, str]:
        """`save_incremental` with the write half on a background thread."""
        return self._save_async(state, "incr")

    def _save(self, state: TrainState, kind: str) -> Tuple[TrainState, str]:
        self.wait()  # behind any in-flight async save
        kind = self._effective_kind(kind)
        t0 = time.perf_counter()
        plan = self._stage(state, kind, snapshot=False)
        self._write_plan(plan)
        if kind == "full":
            self._force_full = False
        self._clear_dirty(state)
        self._account(plan, t0, background=False)
        return state, plan.path

    def _save_async(self, state: TrainState, kind: str) -> Tuple[TrainState, str]:
        if self._parts:
            raise ValueError("part-file saves are synchronous (the positions meet "
                             "before the manifest): use save / save_incremental")
        self.wait()  # at most one save in flight
        kind = self._effective_kind(kind)
        t0 = time.perf_counter()
        plan = self._stage(state, kind, snapshot=True)
        # after the stage's reads in stream order; in place, as training is
        self._clear_dirty(state)
        # account before the writer starts: a fast writer stamps write_ms
        # into this save's record, never the previous one's
        record = self._account(plan, t0, background=True)
        self._writer = threading.Thread(
            target=self._writer_main, args=(plan, record), daemon=True,
            name=f"ckpt-writer-{kind}-{plan.step}")
        self._writer.start()
        return state, plan.path

    def _writer_main(self, plan: _SavePlan, record: Dict[str, Any]) -> None:
        try:
            if self.on_write is not None:
                self.on_write(plan.path)
            t0 = time.perf_counter()
            t0w = time.time()
            self._write_plan(plan)
            record["write_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            # obs timeline span of the background write (a no-op unless
            # DEEPREC_TRACE is configured)
            obs_trace.phase_span(f"ckpt_write_{plan.kind}", t0w, time.time(),
                                 cat="train")
            if plan.kind == "full":
                self._force_full = False  # the chain re-anchored durably
        except BaseException as e:  # raised again by wait()
            self._writer_err = (e, plan.kind)

    def wait(self) -> None:
        """Drain the in-flight async save, if any, and re-raise its writer's
        failure: its directory then has no manifest (restore ignores it) and,
        for a delta, the next save escalates to full — that delta's dirty
        bits were cleared when it was staged."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        err, self._writer_err = self._writer_err, None
        if err is not None:
            e, kind = err
            if kind == "incr":
                self._force_full = True
            raise RuntimeError(f"async checkpoint writer failed: {e}") from e

    def close(self) -> None:
        self.wait()

    def _effective_kind(self, kind: str) -> str:
        if kind != "incr":
            return kind
        if self._force_full or self._chain_has_gap():
            return "full"  # only a full save can re-anchor the chain
        return kind

    def _account(self, plan: _SavePlan, t0: float, background: bool) -> Dict[str, Any]:
        stall = (time.perf_counter() - t0) * 1e3
        self.ckpt_stall_ms += stall
        self.last_save = {"kind": plan.kind, "path": plan.path, "async": background,
                          "stall_ms": round(stall, 3), **plan.stats}
        return self.last_save

    @staticmethod
    def _clear_dirty(state: TrainState) -> None:
        for ts in state.tables.values():
            ts.meta[:, META_DIRTY].zero_()

    def _stage(self, state: TrainState, kind: str, snapshot: bool) -> _SavePlan:
        """The device half: every member's rows compacted (one host copy of
        all the row counts sizes them), and the host copies of everything
        the write half reads — blocking for a synchronous save; for
        snapshot=True the dense and optimizer leaves are cloned and the
        copies go to pinned memory on a side stream behind an event, so
        training may go on."""
        step = int(state.step)
        path = os.path.join(self.dir, f"{kind}-{step}")
        # the manifest at this path is about to change
        self._manifest_cache.pop(path, None)
        self._verified.discard(path)
        positions = ({name: r.save() for name, r in self.datasets.items()}
                     if self.datasets else None)
        incr = kind == "incr"
        bundles = self.trainer.bundles
        with torch.no_grad():
            counts = torch.cat([_row_counts(b.table, state.tables[bname], incr)
                                for bname, b in bundles.items()]).tolist()
            rows = sum(counts)
            counts = iter(counts)
            tables, transfer = {}, 0
            for bname, b in bundles.items():
                ts = state.tables[bname]
                pkgs = []
                for k in range(b.num_tables):
                    n = next(counts)
                    arrays = _compact_member(b.table, ts, k,
                                             quantize_rows(n, ts.keys.shape[1]), incr)
                    if incr:
                        transfer += _nbytes(arrays.values())
                    pkgs.append((k, arrays, n))
                tables[bname] = pkgs
                if not incr:
                    transfer += Trainer._state_bytes(ts)
            names = jax_leaf_names(self.trainer.model)
            dense = [state.dense[n].detach() for n in names]
            opt = None
            if state.opt_state is not None:
                o = state.opt_state
                opt = [o.count] + [o.mu[n] for n in names] + [o.nu[n] for n in names]
            transfer += _nbytes(dense) + (_nbytes(opt) if opt is not None else 0)
            if snapshot:  # the live leaves, which the next steps update in place
                dense = [t.clone() for t in dense]
                opt = None if opt is None else [t.clone() for t in opt]
            flat = [t for pkgs in tables.values() for _, a, _ in pkgs for t in a.values()]
            flat += dense + (opt or [])
            host, event = self._host_copies(flat, snapshot)
        host = iter(host)
        tables = {bname: [(k, {name: next(host) for name in a}, n) for k, a, n in pkgs]
                  for bname, pkgs in tables.items()}
        dense = [next(host) for _ in dense]
        opt = None if opt is None else [next(host) for _ in opt]
        return _SavePlan(
            path=path, kind=kind, step=step, tables=tables, dense=dense, opt=opt,
            positions=positions,
            cfgs={bname: (b.table.cfg, b.stacked) for bname, b in bundles.items()},
            bundles={bname: [f.name for f in b.features] for bname, b in bundles.items()},
            stats={"transfer_bytes": int(transfer), "rows": int(rows)}, event=event)

    def _host_copies(self, tensors: List[torch.Tensor], snapshot: bool):
        """Host copies of `tensors` (fresh tensors: gather outputs, clones)
        and the event that marks them landed. CPU tensors are their own host
        copies; CUDA ones are copied to the host, for snapshot=True into
        pinned buffers filled non-blocking on a side stream that first waits
        for the current one (the stage's gathers and clones) — the tensors
        are recorded on it so the allocator keeps them until the copies ran."""
        dev = tensors[0].device
        if dev.type != "cuda":
            return list(tensors), None
        if not snapshot:
            return [t.cpu() for t in tensors], None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        side = self._copy_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        out = []
        with torch.cuda.stream(side):
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
                out.append(h)
            event = torch.cuda.Event()
            event.record(side)
        return out, event

    def _write_plan(self, plan: _SavePlan) -> None:
        """The write half: truncate and filter each member's rows, write the
        files, commit the manifest last, then run retention. One writer at a
        time: `_save_async` drains the previous one and every reader waits
        first."""
        if plan.event is not None:
            plan.event.synchronize()
        if self._parts:
            return self._write_parts(plan)
        path, incr = plan.path, plan.kind == "incr"
        os.makedirs(path, exist_ok=True)
        mf = os.path.join(path, "manifest.json")
        if os.path.exists(mf):
            os.remove(mf)  # the directory is incomplete until the new manifest
        digests: Dict[str, Dict[str, str]] = {}
        for bname, pkgs in plan.tables.items():
            cfg, stacked = plan.cfgs[bname]
            for k, arrays, n in pkgs:
                _savez(digests, path, table_file(bname, k if stacked else None),
                       _materialize(cfg, arrays, n))
        self._write_positions(path, plan.positions)
        _savez(digests, path, "dense.npz", _leaves_file([t.numpy() for t in plan.dense]))
        if plan.opt is not None:
            _savez(digests, path, "opt.npz", _leaves_file([t.numpy() for t in plan.opt]))
        manifest = {"step": plan.step, "kind": plan.kind, "digests": digests,
                    "routing": {b: "uniform" for b in plan.tables}}
        if incr:
            # the save this delta applies over: restore replays a delta only
            # when its base is the previous link
            manifest["base"] = self._chain_tip(before=plan.step)
        else:
            manifest["bundles"] = plan.bundles
        _commit_manifest(path, manifest)
        self._gc()

    def _write_positions(self, path: str, positions: Optional[Dict[str, dict]]) -> None:
        """The readers' positions taken at stage time (an async writer must
        record where they were when the state was captured); one file per
        position."""
        if not positions:
            return
        with open(os.path.join(path, f"datasets.part{self._rank:05d}.json"), "w") as f:
            json.dump(positions, f)

    def _write_parts(self, plan: _SavePlan) -> None:
        """The write half of a part-file save, on every position: position 0
        clears the directory of a crashed earlier attempt (manifest first),
        every position writes its parts and positions, the digests meet on
        position 0, which writes the dense state and commits the manifest;
        a last barrier keeps every position behind the commit."""
        from deeprec_tpu_torch.parallel import mesh as M

        mesh = self.trainer.mesh
        path, incr, rank = plan.path, plan.kind == "incr", self._rank
        os.makedirs(path, exist_ok=True)
        if rank == 0:
            mf = os.path.join(path, "manifest.json")
            if os.path.exists(mf):
                os.remove(mf)
            for stale in (glob.glob(os.path.join(path, "table_*.npz"))
                          + glob.glob(os.path.join(path, "datasets.part*.json"))):
                os.remove(stale)
        M.barrier(mesh)
        digests: Dict[str, Dict[str, str]] = {}
        for bname, pkgs in plan.tables.items():
            cfg, stacked = plan.cfgs[bname]
            for k, arrays, n in pkgs:
                rows = _materialize(cfg, arrays, n)
                bloom = rows.pop("bloom", None)
                if bloom is not None:
                    rows["bloom_parts"] = bloom[None]
                rows["partition_offset"] = np.asarray([0, rows["keys"].shape[0]], np.int64)
                rows["shard_ids"] = np.asarray([rank], np.int64)
                rows["num_shards"] = np.asarray(self.trainer.num_shards, np.int64)
                fname = table_file(bname, k if stacked else None)
                _savez(digests, path, fname[:-4] + f".part{rank:05d}.npz", rows)
        self._write_positions(path, plan.positions)
        merged: Dict[str, Dict[str, str]] = {}
        for d in M.all_gather_object(mesh, digests):
            merged.update(d)
        if rank == 0:
            _savez(merged, path, "dense.npz", _leaves_file([t.numpy() for t in plan.dense]))
            if plan.opt is not None:
                _savez(merged, path, "opt.npz", _leaves_file([t.numpy() for t in plan.opt]))
            manifest = {"step": plan.step, "kind": plan.kind, "digests": merged,
                        "routing": {b: self.trainer.routing_fingerprint(b)
                                    for b in plan.tables},
                        "format": "parts", "parts": mesh.size,
                        "num_shards": self.trainer.num_shards}
            if incr:
                manifest["base"] = self._chain_tip(before=plan.step)
            else:
                manifest["bundles"] = plan.bundles
            _commit_manifest(path, manifest)
            self._gc()
        M.barrier(mesh)

    # -------------------------------------------------------------- listing

    def _list(self, kind: str) -> List[int]:
        pat = re.compile(rf"^{kind}-(\d+)$")
        out = []
        for d in os.listdir(self.dir):
            m = pat.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_full(self) -> Optional[int]:
        """Step of the newest complete (manifest-bearing) full save."""
        fulls = self._list("full")
        return fulls[-1] if fulls else None

    def _chain_tip(self, before: Optional[int] = None) -> int:
        """Step of the newest committed link the next delta applies over
        (-1 when there is none); `before` bounds the scan to steps below it."""
        steps = self._list("full") + self._list("incr")
        if before is not None:
            steps = [s for s in steps if s < before]
        return max(steps, default=-1)

    # ------------------------------------------------------ chain integrity

    def _manifest(self, path: str) -> dict:
        """The directory's manifest, cached per path; {} when it has none. A
        manifest that exists but does not parse is a torn write: ValueError."""
        if path not in self._manifest_cache:
            try:
                with open(os.path.join(path, "manifest.json")) as f:
                    self._manifest_cache[path] = json.load(f)
            except OSError:
                self._manifest_cache[path] = {}
            except ValueError as e:
                raise ValueError(
                    f"checkpoint {path}: manifest.json exists but is "
                    f"unparseable ({e}) — torn save; refusing to restore")
        return self._manifest_cache[path]

    def _verify_quiet(self, path: str) -> Optional[str]:
        """None when the committed directory is intact, else the reason: a
        torn or unreadable manifest, a missing file or array, an unreadable
        npz, a digest mismatch. A directory passes once (memoized). Its
        files are read and checked on a few threads at once (the reads and
        crc32 release the interpreter lock); the reason reported is the
        first failing file's in manifest order."""
        if path in self._verified:
            return None
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except OSError as e:
            return f"manifest unreadable: {e}"
        except ValueError as e:
            return f"manifest torn: {e}"
        items = list((manifest.get("digests") or {}).items())
        if items:
            with ThreadPoolExecutor(max_workers=min(_VERIFY_THREADS, len(items))) as ex:
                errs = list(ex.map(lambda it: _verify_file(path, *it), items))
            for err in errs:
                if err is not None:
                    return err
        self._verified.add(path)
        return None

    def verify(self, path: str) -> None:
        """Raise CheckpointCorrupt if `path` fails its integrity checks."""
        err = self._verify_quiet(path)
        if err is not None:
            raise CheckpointCorrupt(f"checkpoint {path}: {err}")

    def quarantine(self, path: str, reason: str) -> Optional[str]:
        """Rename a corrupt directory to `*.quarantined[.N]`, out of the
        chain's namespace. Returns the new path, or None when another
        consumer renamed it first."""
        dst = path + ".quarantined"
        i = 1
        while os.path.exists(dst):
            dst = f"{path}.quarantined.{i}"
            i += 1
        try:
            os.rename(path, dst)
        except OSError:
            return None
        self.quarantine_count += 1
        self.last_quarantined = dst
        self._manifest_cache.pop(path, None)
        self._verified.discard(path)
        _log.warning("checkpoint quarantined: %s -> %s (%s)", path, dst, reason)
        return dst

    def valid_chain(self) -> Tuple[List[str], int]:
        """The longest verified chain: (directories in replay order, tip
        step). The newest intact full save (a corrupt one is quarantined and
        the next older taken), then the deltas after it while each verifies
        (a corrupt one is quarantined and ends the chain) and its `base` is
        the previous link (a missing link ends the chain and leaves the later
        deltas alone). FileNotFoundError when no intact full save exists."""
        excluded: set = set()
        while True:
            fulls = [s for s in self._list("full") if s not in excluded]
            if not fulls:
                raise FileNotFoundError(f"no intact full checkpoint under {self.dir}")
            fs = fulls[-1]
            fpath = os.path.join(self.dir, f"full-{fs}")
            err = self._verify_quiet(fpath)
            if err is not None:
                self.quarantine(fpath, err)
                excluded.add(fs)
                continue
            chain, prev = [fpath], fs
            for s in self._list("incr"):
                if s <= fs:
                    continue
                p = os.path.join(self.dir, f"incr-{s}")
                err = self._verify_quiet(p)
                if err is not None:
                    self.quarantine(p, err)
                    break
                base = self._manifest(p).get("base")
                if base is not None and base != prev:
                    break
                chain.append(p)
                prev = s
            return chain, prev

    def chain_dirs(self) -> List[str]:
        """Basenames of the current valid chain (corrupt links quarantined
        on the way); empty when no intact full save exists."""
        try:
            chain, _ = self.valid_chain()
        except FileNotFoundError:
            return []
        return [os.path.basename(p) for p in chain]

    def _chain_has_gap(self) -> bool:
        """A quarantined directory newer than the latest full save: the next
        save must be full."""
        latest = self.latest_full()
        latest = -1 if latest is None else latest
        pat = re.compile(r"^(?:full|incr)-(\d+)\.quarantined")
        try:
            names = os.listdir(self.dir)
        except OSError:
            return False
        return any((m := pat.match(d)) is not None and int(m.group(1)) > latest
                   for d in names)

    # ------------------------------------------------------------- restore

    def restore(self, template: Optional[TrainState] = None,
                chunk: Optional[int] = None) -> TrainState:
        """The verified chain — the newest intact full save and the deltas
        after it — replayed onto `template` (left unchanged: its tables are
        copied first) or onto fresh tables of the trainer's configs and
        device, with the input readers rewound to the newest link that
        carries their positions. `chunk` imports rows in slices of that
        many. FileNotFoundError without a full save."""
        self.wait()  # an in-flight async save lands (or fails) first
        if not self._list("full"):
            raise FileNotFoundError(f"no full checkpoint under {self.dir}")
        chain, step = self.valid_chain()
        self._restore_datasets(chain)
        if template is None:
            state = self.trainer.init()
        else:
            state = dataclasses.replace(template, tables={
                b: _clone_table_state(ts) for b, ts in template.tables.items()})
        # every link's dense leaves and optimizer state replace the previous
        # link's whole: only the newest links that have them are read
        newest = {max((i for i, p in enumerate(chain)
                       if os.path.exists(os.path.join(p, f))), default=-1)
                  for f in ("dense.npz", "opt.npz")}
        for i, path in enumerate(chain):
            state = self._apply_ckpt(state, path, load_dense=i in newest, chunk=chunk)
        return TrainState(step=int(step), tables=state.tables, dense=state.dense,
                          opt_state=state.opt_state)

    def restore_into(self, state: TrainState, path: str, chunk: Optional[int] = None,
                     load_dense: bool = True) -> TrainState:
        """Replay ONE checkpoint directory (full or delta) onto `state` and
        return the result. `state` is never changed: a bundle the directory
        touches is copied before its rows are written, and the dense leaves
        are read into new tensors. The step advances to the manifest's step,
        never back."""
        out = self._apply_ckpt(state, path, load_dense=load_dense, chunk=chunk, copy=True)
        step = int(state.step)
        mf = os.path.join(path, "manifest.json")
        if os.path.exists(mf):
            with open(mf) as f:
                step = max(step, json.load(f)["step"])
        return TrainState(step=step, tables=out.tables, dense=out.dense,
                          opt_state=out.opt_state)

    def warm_replay(self, state: TrainState, chunk: int) -> None:
        """Run the delta replay's pieces once against `state`'s tables — a
        chunked import of sentinel rows (inert: they place nowhere) and an
        all-keep rebuild whose result is dropped — so the first live replay
        pays no first-use cost (kernel loads, allocator growth). Launches
        the row-scatter kernel with no row to write."""
        for bname, b in self.trainer.bundles.items():
            ts = state.tables[bname]
            cfg = b.table.cfg
            kd = {torch.int32: np.int32, torch.int64: np.int64}[ts.keys.dtype]
            rows = {
                "keys": np.full((chunk,), empty_key(cfg), kd),
                "values": np.zeros((chunk, cfg.dim), np.float32),
                "freqs": np.zeros((chunk,), np.int32),
                "versions": np.zeros((chunk,), np.int32),
            }
            for sname, arr in ts.slots.items():
                if is_per_row(_SLOT + sname):
                    rows[_SLOT + sname] = np.zeros((chunk,) + tuple(arr.shape[2:]), np.float32)
            import_rows(b.table, ts, 0, rows, strict=False, chunk=chunk)
            m = member_view(ts, 0)
            b.table.rebuild(m, keep=torch.ones_like(m.keys, dtype=torch.bool),
                            slot_fills=self._slot_fills(b))

    def _restore_datasets(self, chain: List[str]) -> None:
        """Rewind the registered readers to the newest chain directory that
        carries positions; directories without them are skipped."""
        if not self.datasets:
            return
        for path in reversed(chain):
            p = os.path.join(path, f"datasets.part{self._rank:05d}.json")
            if not os.path.exists(p):
                continue
            with open(p) as f:
                saved = json.load(f)
            for name, reader in self.datasets.items():
                if name in saved:
                    reader.restore(saved[name])
            return

    def _slot_fills(self, b) -> Tuple[Tuple[str, float], ...]:
        return self.trainer._slot_fills(b) if self.trainer.sparse_opt is not None else ()

    # -------------------------------------------------- reading the files

    @staticmethod
    def _part_files(path: str, bname: str, tag: str) -> List[str]:
        return sorted(glob.glob(os.path.join(path, f"table_{bname}_{tag}.part*.npz")))

    def _iter_part_rows(self, path: str, bname: str, tag: str):
        """Row dicts of one table in a directory, a file at a time: the
        single file, or every part file — refused when their count differs
        from the manifest's (a stale or partial save). No file at all is
        fine for a bundle the manifest does not declare."""
        mf = self._manifest(path)
        single = os.path.join(path, f"table_{bname}_{tag}.npz")
        if mf.get("format") != "parts" and os.path.exists(single):
            with np.load(single) as z:
                yield {k: z[k] for k in z.files}
            return
        files = self._part_files(path, bname, tag)
        expected = mf.get("parts")
        declared = bname in mf.get("bundles", {})
        if expected is not None and len(files) != expected and (files or declared):
            raise ValueError(
                f"checkpoint {path}: {len(files)} part files for table "
                f"{bname}/{tag} but manifest records {expected} — stale or "
                "partial save; refusing to merge")
        for pf in files:
            with np.load(pf) as z:
                yield {k: z[k] for k in z.files}

    def _load_rows(self, path: str, bname: str, tag: str) -> Optional[Dict[str, np.ndarray]]:
        """Every row source of one table merged into one dict: per-row
        arrays and `live_keys` concatenated over the parts, the per-table
        entries of the first part; the per-shard sketches (`bloom_parts`)
        in shard order. None when the table has no file."""
        chunks = list(self._iter_part_rows(path, bname, tag))
        if not chunks:
            return None
        if len(chunks) == 1:
            chunks[0].pop("shard_ids", None)
            chunks[0].pop("num_shards", None)
            return chunks[0]
        merged = {}
        for key in chunks[0]:
            if key in ("partition_offset", "shard_ids", "num_shards", "bloom_parts"):
                continue
            merged[key] = (np.concatenate([c[key] for c in chunks])
                           if is_per_row(key) or key == "live_keys" else chunks[0][key])
        if "bloom_parts" in chunks[0]:
            pairs = []
            for c in chunks:
                pairs.extend(zip(np.asarray(c["shard_ids"]).tolist(), c["bloom_parts"]))
            pairs.sort(key=lambda p: p[0])
            merged["bloom_parts"] = np.stack([b for _, b in pairs])
        return merged

    def _read_ahead(self, path: str, members):
        """(member, `_load_rows` of it) for each (bundle, k, tag) of
        `members`, in order, with up to _VERIFY_THREADS files read ahead on
        threads (file reads and the zip's crc32 release the interpreter
        lock); a failed read raises when its member's turn comes."""
        with ThreadPoolExecutor(max_workers=_VERIFY_THREADS) as ex:
            pending = collections.deque()
            todo = iter(members)
            for m in itertools.islice(todo, _VERIFY_THREADS):
                pending.append((m, ex.submit(self._load_rows, path, m[0], m[2])))
            while pending:
                m, fut = pending.popleft()
                nxt = next(todo, None)
                if nxt is not None:
                    pending.append((nxt, ex.submit(self._load_rows, path, nxt[0], nxt[2])))
                yield m, fut.result()

    def _apply_ckpt(self, state: TrainState, path: str, load_dense: bool,
                    chunk: Optional[int] = None, copy: bool = False) -> TrainState:
        """Import one directory's rows into `state`'s tables — in place, or
        into copies of the bundles it touches when `copy` — prune each
        member to a delta's `live_keys`, and read the dense leaves and the
        optimizer state into new tensors. A delta's rows pad to a power of
        two (`bucket`), as in the JAX package. The members' files are read
        a few ahead on threads (`_read_ahead`); a bundle's members import
        together (`import_members`) and prune together."""
        bucket = os.path.basename(path).startswith("incr-")
        tables = dict(state.tables)
        members = [(bname, k, f"t{k}" if b.stacked else "t")
                   for bname, b in self.trainer.bundles.items() for k in range(b.num_tables)]
        found: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
        for (bname, k, _), rows in self._read_ahead(path, members):
            if rows is not None:
                found.setdefault(bname, {})[k] = rows
        with torch.no_grad():
            for bname, rows_by in found.items():
                b = self.trainer.bundles[bname]
                ts = _clone_table_state(tables[bname]) if copy else tables[bname]
                live, rebuild = {}, {}
                for k, rows in rows_by.items():
                    rows.pop("partition_offset", None)
                    if "live_keys" in rows:
                        live[k] = rows.pop("live_keys")
                    if self._sharded:
                        rows_by[k], rebuild[k] = self._owned_rows(path, bname, k, rows)
                import_members(b.table, ts, rows_by, bucket=bucket, chunk=chunk)
                self._rebuild_sketches(b, ts, rows_by, rebuild)
                tables[bname] = self._prune_to_live(b, ts, live)
        dense, opt_state = state.dense, state.opt_state
        dpath, opath = os.path.join(path, "dense.npz"), os.path.join(path, "opt.npz")
        if load_dense and os.path.exists(dpath):
            dense = self._read_dense(state.dense, dpath)
        if load_dense and opt_state is not None and os.path.exists(opath):
            with np.load(opath) as z:
                leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
            opt_state = dense_optim.state_from_leaves(
                leaves, jax_leaf_names(self.trainer.model), dense)
        return TrainState(step=state.step, tables=tables, dense=dense, opt_state=opt_state)

    def _owned_rows(self, path: str, bname: str, k: int, rows: Dict[str, np.ndarray]):
        """The rows of member k this position owns under the trainer's
        routing, and whether its CBF sketch must be rebuilt from them: the
        saved per-shard sketch comes back exactly only when the saving
        shard count and routing match."""
        tr = self.trainer
        rows = dict(rows)
        parts = rows.pop("bloom_parts", None)
        merged = rows.pop("bloom", None)
        own = np.asarray(tr.restore_owner(bname, k, rows["keys"])) == tr.mesh.index
        out = {name: (v[own] if is_per_row(name) else v) for name, v in rows.items()}
        if tr.bundles[bname].table.cfg.ev.cbf_filter is None:
            return out, False
        mf = self._manifest(path)
        same = (mf.get("routing", {}).get(bname, "uniform") == tr.routing_fingerprint(bname))
        if parts is not None and same and int(mf.get("num_shards", parts.shape[0])) \
                == tr.num_shards and parts.shape[0] == tr.num_shards:
            out["bloom"] = parts[tr.mesh.index]
            return out, False
        if merged is not None and tr.num_shards == 1:
            out["bloom"] = merged
            return out, False
        return out, True

    @staticmethod
    def _rebuild_sketches(b, ts: TableState, rows_by, rebuild: Dict[int, bool]) -> None:
        """A re-sharded CBF sketch: zeros plus the imported rows' freqs (an
        admitted key keeps its count; sub-threshold keys restart), as the
        JAX package rebuilds it."""
        from deeprec_tpu_torch.embedding import filters

        cbf = b.table.cfg.ev.cbf_filter
        for k, again in rebuild.items():
            if not again or ts.bloom is None:
                continue
            bloom = ts.bloom[k:k + 1]
            bloom.zero_()
            keys = rows_by[k]["keys"]
            if keys.shape[0]:
                dev = ts.keys.device
                filters.cbf_add(cbf, bloom, torch.as_tensor(keys).to(dev, ts.keys.dtype)[None],
                                torch.as_tensor(np.asarray(rows_by[k]["freqs"], np.int32)
                                                ).to(dev)[None])

    def _prune_to_live(self, b, ts: TableState, live: Dict[int, np.ndarray]) -> TableState:
        """Drop each member k's keys absent from a delta's live set live[k]
        (evicted between the saves) by rebuilding the member, so probe
        chains heal and freed slot rows restart at the optimizer's init
        value; nothing to do for a member whose occupied keys are all live
        (one host read decides for every member)."""
        if not live:
            return ts
        keeps = {k: torch.isin(ts.keys[k], torch.as_tensor(np.asarray(v)).to(
            ts.keys.device, ts.keys.dtype)) for k, v in live.items()}
        empty = ts.keys == empty_key(b.table.cfg)
        stale = torch.stack([~(keep | empty[k]).all() for k, keep in keeps.items()]).tolist()
        for (k, keep), drop in zip(keeps.items(), stale):
            if drop:
                new = b.table.rebuild(member_view(ts, k), keep=keep[None],
                                      slot_fills=self._slot_fills(b))
                ts = _put_member(ts, k, new)
        return ts

    def _read_dense(self, dense: Dict[str, torch.Tensor], fpath: str) -> Dict[str, torch.Tensor]:
        """The dense leaves of `fpath` as new tensors on `dense`'s devices
        and shapes."""
        names = jax_leaf_names(self.trainer.model)
        with np.load(fpath) as z:
            if len(z.files) != len(names):
                raise ValueError(f"{fpath}: {len(z.files)} dense leaves, the model has "
                                 f"{len(names)}")
            out = dict(dense)
            for i, name in enumerate(names):
                t = dense[name]
                leaf = np.asarray(z[f"leaf_{i}"], np.float32)
                if leaf.size != t.numel():
                    raise ValueError(f"{fpath}: leaf_{i} has shape {leaf.shape}, "
                                     f"parameter {name} has {tuple(t.shape)}")
                out[name] = torch.from_numpy(leaf.reshape(tuple(t.shape))).to(
                    t.device, t.dtype)
        return out

    # ----------------------------------------------------------------- gc

    def _gc(self) -> None:
        """Keep the newest `keep` full saves; the deltas and quarantined
        directories at or before the oldest kept one go too (a delta only
        ever replays over a full save older than itself)."""
        if self.keep <= 0:
            return
        fulls = self._list("full")
        for s in fulls[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"full-{s}"), ignore_errors=True)
        fulls = fulls[-self.keep:]
        if not fulls:
            return
        for i in self._list("incr"):
            if i <= fulls[0]:
                shutil.rmtree(os.path.join(self.dir, f"incr-{i}"), ignore_errors=True)
        pat = re.compile(r"^(?:full|incr)-(\d+)\.quarantined")
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for d in names:
            m = pat.match(d)
            if m and int(m.group(1)) <= fulls[0]:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)


def _materialize(cfg, arrays: Dict[str, torch.Tensor], n: int) -> Dict[str, np.ndarray]:
    """One member's staged compaction as the file's arrays (the JAX
    `_materialize_pkg`): per-row arrays truncated to the true count `n`,
    values as f32, rows below a counter filter's threshold dropped unless
    `save_filtered_features`, then the scalar slots, the sketch and a
    delta's `live_keys` (its occupied keys)."""
    arrays = dict(arrays)
    all_keys = arrays.pop("_all_keys", None)
    bloom = arrays.pop("bloom", None)
    per_table = {k: v.numpy() for k, v in arrays.items() if not is_per_row(k)}
    rows = {k: (v[:n].float() if k == "values" else v[:n]).numpy()
            for k, v in arrays.items() if is_per_row(k)}
    cf = cfg.ev.counter_filter
    if not cfg.ev.ckpt.save_filtered_features and cf is not None and cf.filter_freq > 0:
        keep = rows["freqs"] >= cf.filter_freq
        rows = {k: v[keep] for k, v in rows.items()}
    out = {**rows, **per_table}
    if bloom is not None:
        out["bloom"] = bloom.numpy()
    if all_keys is not None:
        keys = all_keys.numpy()
        out["live_keys"] = keys[keys != empty_key(cfg)]
    return out
