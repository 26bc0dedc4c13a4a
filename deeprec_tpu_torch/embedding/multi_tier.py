"""Multi-tier embedding storage: a fixed-capacity device tier over a native
host-DRAM store and a log-structured disk store — the port of
`deeprec_tpu/embedding/multi_tier.py` (`DiskKV`, `_spill_dim`,
`TierStats`, `MultiTierTable`).

The device table is the hot tier. `sync` runs between windows, off the
train step: it promotes device rows that were re-created while a tier copy
of their key exists (the tier copy restores the values AND the per-row
optimizer slots, packed side by side in one host row, and the freq merges),
demotes the coldest rows (LFU by freq, LRU by version) to the host store
once occupancy passes the high watermark, and spills the host store's
coldest rows to the disk log past `host_capacity`. Per-table scalar slots
are not per-row state and stay on the device.

A `MultiTierTable` serves ONE table: every state it takes and returns is a
[1, ...] TableState (a stacked bundle's trainer hands it one member's view
and writes the result back). Rows move through the port's kernel wrappers:
the demoted rows are gathered on the device by `gather_rows` (kernel #3,
#1 for bf16 values) and only those [n, W] rows cross to the host; promoted
and folded rows are written by `apply_rows_sr` (kernel #5, #2 for bf16
values: a bf16 row that went out exact comes back exact). `rebuild` moves
the survivors by plain indexing.

The port trains IN PLACE, so whatever a background round reads is a copy
taken at the boundary: `sync_async` gathers the demoted rows and clones
(keys, freq, version) on the device, starts their copy into pinned host
memory on the current stream and records an event; the worker thread waits
on that event before it touches numpy and launches no CUDA work. The next
train step, queued behind the copies, cannot change what the round reads.

`row_cache_bytes` puts the serving row cache (`serving/reuse.ReuseCache`,
keyed by id and tier revision) in front of the stores'
`lookup_with_fallback` reads. Every sync round and fold publishes the JAX
package's obs-plane counters and gauges, labelled by table
(`deeprec_tier_demoted_rows`, `_promoted_rows`, `_spilled_rows`,
`_host_rows`, `_device_rows`, `_sync_stall_ms`, `_prefetch_probed`,
`_prefetch_hits`, `_prefetch_folds`, `_prefetch_stale_dropped`,
`_prefetch_fold_lag_ms`). As in the JAX package, only the fold totals
that `Trainer.tier_paging_stats` reads (and `sync_stall_ms`) are attributes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from deeprec_tpu_torch.analysis.annotations import not_thread_safe
from deeprec_tpu_torch.config import StorageType
from deeprec_tpu_torch.embedding.table import (
    META_DIRTY, META_FREQ, META_VERSION, EmbeddingTable, TableState, empty_key, member_view,
)
from deeprec_tpu_torch.native import HostKV
from deeprec_tpu_torch.ops.compact import quantize_rows
from deeprec_tpu_torch.ops.fused_lookup import apply_rows_sr, gather_rows
from deeprec_tpu_torch.optim.sparse import SCALAR_PREFIX


@not_thread_safe
class DiskKV:
    """Log-structured on-disk row store, the SSD tier. Rows append to a flat
    record log (key i64, freq i32, version i32, value f32[dim]) after an
    8-byte header (magic u32 0xD15C0001, dim u32); an in-memory index maps
    key -> record offset, so an update is an append and a repoint. `save()`
    writes the index sidecar `<path>.idx` (JSON with the log length
    `_len`); a reopen reads it and scans the log's tail past `_len`, or
    scans the whole log without one. The same format as the JAX package's
    DiskKV, so a log written by either opens in the other. Not
    thread-safe."""

    MAGIC = 0xD15C_0001

    def __init__(self, path: str, dim: Optional[int] = None):
        """dim=None reopens an existing log at its header's row width."""
        self.path = path
        exists = os.path.exists(path) and os.path.getsize(path) >= 8
        if exists:
            with open(path, "rb") as f:
                magic, hdim = np.frombuffer(f.read(8), "<u4")
            if int(magic) != self.MAGIC:
                raise ValueError(f"{path}: not a DiskKV log (bad magic {magic:#x})")
            if dim is not None and int(hdim) != dim:
                raise ValueError(
                    f"{path}: log rows are {int(hdim)} wide but this table/"
                    f"optimizer layout needs {dim} — the log was written "
                    "under a different configuration")
            dim = int(hdim)
        elif dim is None:
            raise FileNotFoundError(
                f"{path}: dim=None requires an existing log to read the width from")
        self.dim = dim
        self.rec_bytes = 8 + 4 + 4 + 4 * dim
        self.index: dict = {}
        self.last_reads = 0  # coalesced read runs of the last get()
        self._dtype = np.dtype([("key", "<i8"), ("freq", "<i4"), ("ver", "<i4"),
                                ("val", "<f4", (dim,))])
        self._f = open(path, "r+b" if exists else "w+b")
        if not exists:
            np.asarray([self.MAGIC, dim], "<u4").tofile(self._f)
            self._f.flush()
        log_len = self._f.seek(0, 2)
        if log_len > 8 and os.path.exists(path + ".idx"):
            with open(path + ".idx") as f:
                saved = json.load(f)
            self.index = {int(k): int(v) for k, v in saved.get("index", {}).items()}
            # records appended after the last save() (a crash): scan the
            # tail past the sidecar's recorded length
            tail_from = int(saved.get("_len", 8))
            if log_len > tail_from:
                self._scan_index(tail_from)
        elif log_len > 8:
            self._scan_index(8)

    def _scan_index(self, from_offset: int) -> None:
        """Index the records at or after `from_offset` (later records
        win)."""
        end = self._f.seek(0, 2)
        start = 8 + ((max(from_offset, 8) - 8) // self.rec_bytes) * self.rec_bytes
        n = (end - start) // self.rec_bytes
        self._f.seek(start)
        recs = np.fromfile(self._f, self._dtype, n)
        for i, k in enumerate(recs["key"]):
            self.index[int(k)] = start + i * self.rec_bytes

    def __len__(self) -> int:
        return len(self.index)

    def _log_records(self) -> int:
        return (self._f.seek(0, 2) - 8) // self.rec_bytes

    def compact(self, min_records: int = 1024, garbage_factor: float = 2.0,
                force: bool = False) -> bool:
        """Rewrite the live records into a fresh log once dead records
        (updates and erases) dominate. Returns True if it rewrote."""
        total = self._log_records()
        live = len(self.index)
        if not force and (total < min_records or total <= garbage_factor * max(live, 1)):
            return False
        tmp = self.path + ".compact"
        offs = sorted(self.index.items(), key=lambda kv: kv[1])
        with open(tmp, "wb") as out:
            np.asarray([self.MAGIC, self.dim], "<u4").tofile(out)
            new_index = {}
            for k, off in offs:
                self._f.seek(off)
                rec = np.fromfile(self._f, self._dtype, 1)
                new_index[k] = out.tell()
                rec.tofile(out)
        # the old sidecar holds the old log's offsets: remove it before the
        # swap, so a crash in between reopens by a full scan
        had_sidecar = os.path.exists(self.path + ".idx")
        if had_sidecar:
            os.remove(self.path + ".idx")
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "r+b")
        self.index = new_index
        if had_sidecar:
            self.save()
        return True

    def put(self, keys, values, freqs=None, versions=None) -> None:
        n = len(keys)
        recs = np.zeros(n, self._dtype)
        recs["key"] = np.asarray(keys, np.int64)
        recs["freq"] = 0 if freqs is None else np.asarray(freqs, np.int32)
        recs["ver"] = 0 if versions is None else np.asarray(versions, np.int32)
        recs["val"] = np.asarray(values, np.float32).reshape(n, self.dim)
        self._f.seek(0, 2)
        base = self._f.tell()
        recs.tofile(self._f)
        self._f.flush()
        for i, k in enumerate(recs["key"]):
            self.index[int(k)] = base + i * self.rec_bytes
        self.compact()

    def get(self, keys):
        """-> (values [n, dim], freqs, versions, found). Hits are read in
        log order, adjacent records coalesced into one read each."""
        keys = np.asarray(keys, np.int64)
        n = len(keys)
        vals = np.zeros((n, self.dim), np.float32)
        freqs = np.zeros(n, np.int32)
        vers = np.zeros(n, np.int32)
        found = np.zeros(n, bool)
        if not self.index or n == 0:
            return vals, freqs, vers, found
        idx_keys = np.fromiter(self.index.keys(), np.int64, len(self.index))
        hit_ix = np.nonzero(np.isin(keys, idx_keys))[0]
        if len(hit_ix) == 0:
            return vals, freqs, vers, found
        offs = np.fromiter((self.index[int(keys[i])] for i in hit_ix), np.int64,
                           len(hit_ix))
        order = np.argsort(offs, kind="stable")
        sorted_offs = offs[order]
        starts = np.nonzero(np.diff(sorted_offs) != self.rec_bytes)[0] + 1
        bounds = np.concatenate([[0], starts, [len(sorted_offs)]])
        self.last_reads = len(bounds) - 1
        for a, b in zip(bounds[:-1], bounds[1:]):
            self._f.seek(int(sorted_offs[a]))
            recs = np.fromfile(self._f, self._dtype, int(b - a))
            ii = hit_ix[order[a:b]]
            vals[ii] = recs["val"]
            freqs[ii] = recs["freq"]
            vers[ii] = recs["ver"]
            found[ii] = True
        return vals, freqs, vers, found

    def erase(self, keys) -> None:
        for k in np.asarray(keys, np.int64):
            self.index.pop(int(k), None)

    def save(self) -> None:
        self._f.flush()
        log_len = self._f.seek(0, 2)
        with open(self.path + ".idx", "w") as f:
            json.dump({"_len": log_len, "index": self.index}, f)

    def close(self) -> None:
        self.save()
        self._f.close()


def _spill_dim(path: str) -> int:
    """Row width in a host-store spill file's header (magic u64
    0xDEE99EC0011, dim u64, n u64; or an .npz spill's values array)."""
    if os.path.exists(path):
        with open(path, "rb") as f:
            head = f.read(16)
        if len(head) == 16:
            magic, dim = np.frombuffer(head, "<u8")
            if magic == 0xDEE99EC0011:
                return int(dim)
    npz = path if path.endswith(".npz") else path + ".npz"
    if os.path.exists(npz):
        return int(np.load(npz)["values"].shape[1])
    raise FileNotFoundError(path)


@dataclasses.dataclass
class TierStats:
    demoted: int = 0
    promoted: int = 0
    host_size: int = 0
    device_size: int = 0
    spilled: int = 0  # host -> disk this sync
    disk_size: int = 0


def _meta_write(state: TableState, row: int, ix: torch.Tensor, vals: torch.Tensor,
                add: bool) -> None:
    """meta[0, row, ix] += vals (add) or = vals, IN PLACE, through the flat
    meta tensor (ix unique)."""
    flat = state.meta.view(-1)
    at = ix.long() + row * state.keys.shape[1]
    vals = vals.to(flat.dtype)
    if add:
        flat.index_add_(0, at, vals)
    else:
        flat.index_copy_(0, at, vals)


def _host_copy(tensors: dict):
    """Copies of `tensors` on the host, started now: on CUDA into pinned
    buffers with non_blocking on the current stream, with the event that
    marks them landed (the reader synchronizes on it); on the CPU plain
    clones and no event."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        return {k: v.clone() for k, v in tensors.items()}, None
    out = {}
    for k, v in tensors.items():
        h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        h.copy_(v, non_blocking=True)
        out[k] = h
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(first.device))
    return out, event


class MultiTierTable:
    """An EmbeddingTable's device tier over a host tier (and, for
    HBM_DRAM_SSD, a disk tier). Call `sync(state, step)` (or `sync_async`)
    from the host loop between windows; lookups and applies stay the plain
    table ops. Every state is a [1, ...] TableState; `sync` may update the
    state it is given in place (promoted rows) and returns the state to
    use from then on (a rebuild when it demoted)."""

    def __init__(self, table: EmbeddingTable, high_watermark: float = 0.8,
                 low_watermark: float = 0.6, storage_path: Optional[str] = None,
                 slot_fills: Optional[tuple] = None, scan_diet: bool = True,
                 row_cache_bytes: int = 0):
        cfg = table.cfg
        self.table = table
        self.high = high_watermark
        self.low = low_watermark
        self.cache_strategy = cfg.ev.storage.cache_strategy
        self.storage_path = storage_path or cfg.ev.storage.storage_path
        self.host_capacity = cfg.ev.storage.host_capacity
        # Tier stores are made at the first sync: the row width is D plus
        # the per-row optimizer slots', which only the live state knows.
        self.host: Optional[HostKV] = None
        self.disk: Optional[DiskKV] = None
        self._slot_layout: Optional[tuple] = None  # ((name, width), ...)
        self._packed_dim = 0
        # (name, init) of the optimizer's slots: freed rows of a rebuild
        # restart from them
        self.slot_fills = tuple(slot_fills or ())
        # sync_async: one background round in flight; `_pending` holds the
        # promotion candidates it found, applied at the next boundary. The
        # worker never erases tier rows. sync_stall_ms is the caller's
        # blocking time; on_io is a test seam run in the worker before IO.
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        self._pending: Optional[dict] = None
        self._spilled_bg = 0
        self.sync_stall_ms = 0.0
        self.on_io = None
        # Every store access (the pump's probe_rows, the worker round, the
        # training thread's boundaries) holds this lock; the training thread
        # takes it only after _settle(), so it never waits behind a round.
        self._store_lock = threading.RLock()
        # Tier revision: bumped at every boundary that changes the stores.
        # Gather generation: bumped only where rows are WRITTEN (demote,
        # load); a package gathered at an older generation is dead.
        self._tier_rev = 0
        # Serving row cache: a byte-bounded LRU over the D-wide value slice
        # of host/disk-resident rows, keyed (id, tier revision). Off by
        # default — lookup_with_fallback then reads the stores every time.
        self.row_cache = None
        if row_cache_bytes > 0:
            from deeprec_tpu_torch.serving.reuse import ReuseCache

            self.row_cache = ReuseCache(
                int(row_cache_bytes), f"tier_rows_{cfg.name}",
                version_fn=lambda: self._tier_rev)
        self._gather_gen = 0
        # fold erases deferred while a round owns the stores
        self._pending_erase: list = []
        # Promote-scan diet: a tier copy of a device key exists only if the
        # key was looked up after its demotion, so scanning the rows touched
        # since the last round (version >= watermark) plus the retry set of
        # deliberately kept keys finds every candidate.
        self.scan_diet = scan_diet
        self._scan_watermark: Optional[int] = None  # None = full scan
        self._retry_keys: set = set()
        # paging accounting (Trainer.tier_paging_stats)
        self.fold_stall_ms = 0.0
        self.folded_rows = 0
        self.fold_bytes = 0
        self.fold_writes = 0  # fold chunks that wrote rows (#5 / #2 launches)
        # the obs plane's per-table counters and gauges (no-op singletons
        # when DEEPREC_OBS=off)
        self._init_obs(cfg.name)

    def _init_obs(self, name: str) -> None:
        from deeprec_tpu_torch.obs import metrics as obs_metrics

        reg = obs_metrics.default_registry()
        lab = {"table": name}
        self._m_demoted = reg.counter("deeprec_tier_demoted_rows", "device→host demotions", lab)
        self._m_promoted = reg.counter("deeprec_tier_promoted_rows",
                                       "host/disk→device promotions", lab)
        self._m_spilled = reg.counter("deeprec_tier_spilled_rows", "host→disk spills", lab)
        self._m_host_size = reg.gauge("deeprec_tier_host_rows", "host-tier resident rows", lab)
        self._m_device_size = reg.gauge("deeprec_tier_device_rows", "device-tier live rows",
                                        lab)
        self._m_stall = reg.gauge("deeprec_tier_sync_stall_ms",
                                  "cumulative caller-side tier sync stall", lab)
        self._m_pf_probed = reg.counter(
            "deeprec_tier_prefetch_probed",
            "unique upcoming ids probed against the tier stores", lab)
        self._m_pf_hits = reg.counter("deeprec_tier_prefetch_hits",
                                      "probed ids found resident in the host/disk tiers", lab)
        self._m_pf_folds = reg.counter("deeprec_tier_prefetch_folds",
                                       "prefetched tier rows folded into the device table",
                                       lab)
        self._m_pf_stale = reg.counter(
            "deeprec_tier_prefetch_stale_dropped",
            "prefetched rows dropped by fold revalidation "
            "(stale revision or device row trained past the copy)", lab)
        self._m_pf_lag = reg.gauge("deeprec_tier_prefetch_fold_lag_ms",
                                   "gather-to-fold latency of the last folded package", lab)

    def _publish(self, stats: TierStats) -> None:
        """Fold one sync round's TierStats into the obs plane: values the
        round already computed, no device traffic."""
        self._m_demoted.inc(stats.demoted)
        self._m_promoted.inc(stats.promoted)
        self._m_spilled.inc(stats.spilled)
        self._m_host_size.set(stats.host_size)
        self._m_device_size.set(stats.device_size)
        self._m_stall.set(self.sync_stall_ms)

    # --------------------------------------------------------- packed rows

    @staticmethod
    def _check_member(state: TableState) -> None:
        if state.keys.dim() != 2 or state.keys.shape[0] != 1:
            raise ValueError(
                f"MultiTierTable serves one table: want a [1, C] state, got keys "
                f"{tuple(state.keys.shape)}")

    def _ensure_tiers(self, state: TableState) -> None:
        self._check_member(state)
        if self._slot_layout is not None:
            return
        cfg = self.table.cfg
        C = state.keys.shape[1]
        self._slot_layout = tuple(
            (name, arr.numel() // C) for name, arr in sorted(state.slots.items())
            if not name.startswith(SCALAR_PREFIX))
        width = cfg.dim + sum(w for _, w in self._slot_layout)
        self._packed_dim = width
        if self.host is not None:  # made by load(): the widths must agree
            if self.host.dim != width:
                raise ValueError(
                    f"loaded tier rows are {self.host.dim} wide but this "
                    f"optimizer's packed layout needs {width} (values "
                    f"{cfg.dim} + slots {self._slot_layout}) — the spill "
                    "was written under a different optimizer")
        else:
            self.host = HostKV(dim=width, initial_capacity=cfg.capacity)
        if self.disk is not None and self.disk.dim != width:
            raise ValueError(
                f"existing disk-tier log rows are {self.disk.dim} wide but "
                f"this optimizer's packed layout needs {width} — the log "
                "was written under a different optimizer")
        if self.disk is None and cfg.ev.storage.storage_type == StorageType.HBM_DRAM_SSD:
            if self.storage_path:
                path = self.storage_path + ".ssd"
            else:
                # no path: a private log per run, never a previous run's rows
                fd, path = tempfile.mkstemp(prefix=f"deeprec_{cfg.name}_",
                                            suffix=".ssd")
                os.close(fd)
            self.disk = DiskKV(path, width)

    def _gather_packed(self, state: TableState, ix: torch.Tensor) -> torch.Tensor:
        """[n, W] f32 packed rows at slots ix [n] int32 (values, then the
        per-row slots by name), gathered on the state's device."""
        cols = [gather_rows(state.values, ix[None])[0].to(torch.float32)]
        for name, w in self._slot_layout:
            cols.append(gather_rows(state.slots[name], ix[None])[0].reshape(-1, w))
        return torch.cat(cols, dim=1)

    def _unpack_rows(self, state: TableState, ix: torch.Tensor,
                     packed: torch.Tensor) -> None:
        """Write packed rows [n, W] back at slots ix [n] int32 (< 0 skips),
        values AND per-row slots, IN PLACE."""
        D = self.table.cfg.dim
        ix = ix[None]
        apply_rows_sr(state.values, ix, packed[None, :, :D], seed=0)
        off = D
        for name, w in self._slot_layout:
            apply_rows_sr(state.slots[name], ix, packed[None, :, off:off + w], seed=0)
            off += w

    def _fills(self, slot_fills) -> tuple:
        return tuple(slot_fills) if slot_fills else self.slot_fills

    # ------------------------------------------------------------------ sync

    def sync(self, state: TableState, step: int, slot_fills: Optional[tuple] = None,
             force: bool = False) -> tuple[TableState, TierStats]:
        """Promote, demote and spill at a boundary (see the module
        docstring). force=True demotes down to the low watermark even below
        the high one, and rebuilds (healing probe chains and resetting
        insert_fails) when there is nothing to demote."""
        stats = TierStats()
        # serialize behind an in-flight round; its candidates drop, and the
        # scan below rediscovers them in full
        self._settle()
        full_scan = self._pending is not None
        self._pending = None
        stats.spilled += self._take_spilled()
        self._drain_pending_erase()
        self._ensure_tiers(state)
        device = state.keys.device
        sent = empty_key(self.table.cfg)
        # host copies taken now (a CPU tensor's numpy view would follow the
        # promote's in-place freq add): the demote below ranks the freqs
        # as they were before the promote, as the JAX package does
        keys = state.keys[0].cpu().numpy().copy()
        meta = state.meta[0].cpu().numpy().copy()
        freq, version = meta[META_FREQ], meta[META_VERSION]
        occ = keys != sent

        # promote: device rows re-created while a host (or disk) copy exists
        occ_nz = np.nonzero(occ)[0]
        dev_keys_all = keys[occ].astype(np.int64)
        scan = self._scan_mask(dev_keys_all, version[occ], self._take_retry(),
                               self._scan_watermark, full_scan)
        dev_keys = dev_keys_all[scan]
        if len(dev_keys):
            with self._store_lock:
                h_vals, h_freq, h_ver, found = self.host.get(dev_keys)
                if self.disk is not None and (~found).any():
                    # the disk tier's hits re-enter the device directly
                    miss = ~found
                    d_vals, d_freq, d_ver, d_found = self.disk.get(dev_keys[miss])
                    if d_found.any():
                        mix = np.nonzero(miss)[0][d_found]
                        h_vals[mix] = d_vals[d_found]
                        h_freq[mix] = d_freq[d_found]
                        h_ver[mix] = d_ver[d_found]
                        found[mix] = True
                        self.disk.erase(dev_keys[mix])
            dev_ix = occ_nz[scan][found]
            if dev_ix.size:
                hf = h_freq[found]
                # freshly re-created rows have a device freq at most the host's
                refreshed = freq[dev_ix] <= hf
                if refreshed.any():
                    ix = torch.as_tensor(dev_ix[refreshed].astype(np.int32), device=device)
                    self._unpack_rows(state, ix, torch.as_tensor(
                        h_vals[found][refreshed], device=device))
                    _meta_write(state, META_FREQ, ix,
                                torch.as_tensor(hf[refreshed], device=device), add=True)
                    stats.promoted = int(refreshed.sum())
                # either way the host copy is now stale
                with self._store_lock:
                    self.host.erase(dev_keys[found])

        # demote: bring occupancy under the low watermark
        C = state.keys.shape[1]
        live = int(occ.sum())
        threshold = int((self.low if force else self.high) * C)
        if live > threshold:
            n_out = live - int(self.low * C)
            occ_ix = np.nonzero(occ)[0]
            if self.cache_strategy == "lru":
                order = np.argsort(version[occ_ix])  # oldest-touched first
            else:
                order = np.argsort(freq[occ_ix])  # coldest first
            out_ix = occ_ix[order[:n_out]]
            packed = self._gather_packed(
                state, torch.as_tensor(out_ix.astype(np.int32), device=device)).cpu().numpy()
            with self._store_lock:
                self.host.put(keys[out_ix].astype(np.int64), packed, freq[out_ix],
                              version[out_ix])
            keep = np.ones(C, bool)
            keep[out_ix] = False
            state = self.table.rebuild(state, keep=torch.as_tensor(keep, device=device)[None],
                                       slot_fills=self._fills(slot_fills))
            stats.demoted = int(n_out)
        elif force:
            # nothing to demote under capacity pressure: heal the chains
            state = self.table.rebuild(state, slot_fills=self._fills(slot_fills))

        # spill: a bounded host tier overflows to the disk tier
        if self.disk is not None and self.host_capacity and len(self.host) > self.host_capacity:
            with self._store_lock:
                stats.spilled += self._spill()

        stats.host_size = len(self.host)
        stats.device_size = int(self.table.size(state).sum())
        if self.disk is not None:
            stats.disk_size = len(self.disk)
        self._tier_rev += 1
        self._gather_gen += 1  # demotes wrote rows: in-flight gathers are dead
        self._scan_watermark = int(step)
        self._publish(stats)
        return state, stats

    def _spill(self) -> int:
        """Move the host tier's coldest rows past host_capacity to the disk
        tier (caller holds the store lock). Returns the rows moved."""
        n_spill = len(self.host) - self.host_capacity
        ks, vs, fs, vers = self.host.export()  # noqa: DRT004 — spill export, round-exclusive ownership (or the caller's, after _settle)
        order = np.argsort(vers) if self.cache_strategy == "lru" else np.argsort(fs)
        out = order[:n_spill]
        self.disk.put(ks[out], vs[out], fs[out], vers[out])  # noqa: DRT004 — spill write, round-exclusive ownership
        self.host.erase(ks[out])  # noqa: DRT004 — spill erase, round-exclusive ownership
        return int(n_spill)

    # ------------------------------------------------------ overlapped sync

    def _demote_extract(self, state: TableState, size: int, n_out: int) -> dict:
        """Device half of a demotion: the `n_out` coldest (LFU) or oldest
        (LRU) occupied rows by a stable argsort of the masked score, their
        packed rows gathered at the static size `size`, and the rebuild's
        keep mask. Every output is a fresh tensor."""
        C = state.keys.shape[1]
        device = state.keys.device
        sent = empty_key(self.table.cfg)
        occ = state.keys[0] != sent
        score = state.meta[0, META_VERSION if self.cache_strategy == "lru" else META_FREQ]
        masked = torch.where(occ, score, torch.iinfo(torch.int32).max)
        take = torch.argsort(masked, stable=True)[:size].to(torch.int32)
        valid = torch.arange(size, device=device) < n_out
        keep = torch.ones(C, dtype=torch.bool, device=device)
        keep[take[:n_out].long()] = False
        t = take.long()
        return {"keys": torch.where(valid, state.keys[0, t], sent),
                "rows": self._gather_packed(state, take),
                "freqs": state.meta[0, META_FREQ, t],
                "versions": state.meta[0, META_VERSION, t],
                "keep": keep}

    def sync_async(self, state: TableState, step: int, slot_fills: Optional[tuple] = None,
                   pending_slots: Optional[torch.Tensor] = None
                   ) -> tuple[TableState, TierStats]:
        """Overlapped migration: the caller pays the device half (apply the
        last round's promotions, the demote selection, gather and rebuild,
        the copies to the host), and a background round does the store IO
        (the demoted rows' put, the promote scan, the spill). Promotions it
        finds land at the NEXT sync_async/drain boundary, checked again
        against the device freq then. Rounds serialize. `pending_slots`:
        the last round's candidates' slots, probed already
        (`probe_members`)."""
        t0 = time.perf_counter()
        stats = TierStats()
        self._ensure_tiers(state)
        state, stats.promoted = self._apply_pending(state, pending_slots)
        stats.spilled = self._take_spilled()
        self._drain_pending_erase()
        C = state.keys.shape[1]
        live = int(self.table.size(state).sum())  # the one host read
        demote = None
        if live > int(self.high * C):
            n_out = live - int(self.low * C)
            ext = self._demote_extract(state, quantize_rows(n_out, C), n_out)
            keep = ext.pop("keep")
            state = self.table.rebuild(state, keep=keep[None],
                                       slot_fills=self._fills(slot_fills))
            demote = (ext, n_out)
            stats.demoted = n_out
        snap = {"keys": state.keys[0].clone(),
                "freq": state.meta[0, META_FREQ].clone(),
                "version": state.meta[0, META_VERSION].clone()}
        if demote is not None:
            snap.update({f"demote_{k}": v for k, v in demote[0].items()})
        host, event = _host_copy(snap)
        # sizes at the boundary, read before the worker changes the stores
        stats.host_size = len(self.host)
        stats.device_size = live - stats.demoted
        if self.disk is not None:
            stats.disk_size = len(self.disk)
        self._tier_rev += 1
        self._gather_gen += 1  # the round demotes: in-flight gathers are dead
        retry = self._take_retry()
        watermark = self._scan_watermark
        self._scan_watermark = int(step)
        self._worker = threading.Thread(
            target=self._worker_main,
            args=(host, event, demote[1] if demote else 0, retry, watermark),
            daemon=True, name=f"tier-io-{self.table.cfg.name}-{step}")
        self._worker.start()
        self.sync_stall_ms += (time.perf_counter() - t0) * 1e3
        self._publish(stats)
        return state, stats

    def join(self) -> None:
        """Wait for the in-flight round without applying its promotions
        (they stay queued for the next boundary)."""
        t = self._worker
        if t is not None:
            t.join()
            self._worker = None

    def _settle(self) -> None:
        """join(), then raise a worker failure."""
        self.join()
        err, self._worker_err = self._worker_err, None
        if err is not None:
            raise RuntimeError(f"tier IO worker failed: {err}") from err

    def _take_spilled(self) -> int:
        n, self._spilled_bg = self._spilled_bg, 0
        return n

    # ------------------------------------------------- paging coordination

    def _take_retry(self) -> np.ndarray:
        """Consume the retry set (training thread): keys whose tier copy was
        kept because the device row trained past it mid-flight."""
        taken, self._retry_keys = self._retry_keys, set()
        return np.fromiter(taken, np.int64, len(taken))

    def _scan_mask(self, occ_keys: np.ndarray, occ_version: np.ndarray,
                   retry: np.ndarray, watermark: Optional[int], full: bool) -> np.ndarray:
        """The promote scan's rows: touched since `watermark`, plus the
        retry set (everything when full, without the diet or a watermark)."""
        if full or not self.scan_diet or watermark is None:
            return np.ones(len(occ_keys), bool)
        m = occ_version >= watermark
        if len(retry):
            m |= np.isin(occ_keys, retry)
        return m

    def _erase_tier_rows(self, keys: np.ndarray, disk_keys: np.ndarray) -> None:
        """Erase folded rows' tier copies, deferred to the next boundary
        while a round owns the stores."""
        if self._worker is not None and self._worker.is_alive():
            self._pending_erase.append((keys, disk_keys))
            return
        with self._store_lock:
            self.host.erase(keys)
            if self.disk is not None and len(disk_keys):
                self.disk.erase(disk_keys)
        self._tier_rev += 1

    def _drain_pending_erase(self) -> None:
        """Apply the deferred fold erases (after _settle, before the next
        promote scan)."""
        if not self._pending_erase:
            return
        pend, self._pending_erase = self._pending_erase, []
        hk = np.concatenate([p[0] for p in pend])
        dk = np.concatenate([p[1] for p in pend])
        with self._store_lock:
            self.host.erase(hk)
            if self.disk is not None and len(dk):
                self.disk.erase(dk)
        self._tier_rev += 1

    def drain(self, state: TableState) -> tuple[TableState, TierStats]:
        """Finish the in-flight round and apply its promotions now
        (checkpoint and serving boundaries). No-op when idle."""
        t0 = time.perf_counter()
        stats = TierStats()
        state, stats.promoted = self._apply_pending(state)
        stats.spilled = self._take_spilled()
        self._drain_pending_erase()
        stats.host_size = len(self.host) if self.host is not None else 0
        stats.device_size = int(self.table.size(state).sum())
        if self.disk is not None:
            stats.disk_size = len(self.disk)
        self.sync_stall_ms += (time.perf_counter() - t0) * 1e3
        self._publish(stats)
        return state, stats

    def _worker_main(self, host: dict, event, n_out: int, retry, watermark) -> None:
        """Background round: wait for the boundary's copies, put the demoted
        rows, scan for promotion candidates against the post-rebuild
        snapshot, spill. Read-only on promotion sources (erasure happens at
        apply time on the training thread). Holds the store lock for the
        whole round."""
        try:
            if event is not None:
                event.synchronize()
            if self.on_io is not None:
                self.on_io()
            h = {k: v.numpy() for k, v in host.items()}
            with self._store_lock:
                if n_out:
                    self.host.put(h["demote_keys"][:n_out].astype(np.int64),  # noqa: DRT004 — worker owns the tier stores until _settle(); every other path drains first
                                  h["demote_rows"][:n_out], h["demote_freqs"][:n_out],
                                  h["demote_versions"][:n_out])
                occ = h["keys"] != empty_key(self.table.cfg)
                dev_all = h["keys"][occ].astype(np.int64)
                scan = self._scan_mask(dev_all, h["version"][occ], retry, watermark, False)
                dev_keys = dev_all[scan]
                pending = None
                if len(dev_keys):
                    h_vals, h_freq, h_ver, found = self.host.get(dev_keys)  # noqa: DRT004 — read-only promote scan under the same round-exclusive ownership
                    from_disk = np.zeros(len(dev_keys), bool)
                    if self.disk is not None and (~found).any():
                        miss = ~found
                        d_vals, d_freq, d_ver, d_found = self.disk.get(dev_keys[miss])  # noqa: DRT004 — disk second-chance read, round-exclusive ownership
                        if d_found.any():
                            mix = np.nonzero(miss)[0][d_found]
                            h_vals[mix] = d_vals[d_found]
                            h_freq[mix] = d_freq[d_found]
                            h_ver[mix] = d_ver[d_found]
                            found[mix] = True
                            from_disk[mix] = True
                    if found.any():
                        pending = {"keys": dev_keys[found], "rows": h_vals[found],
                                   "freqs": h_freq[found],
                                   "snap_freq": h["freq"][occ][scan][found],
                                   "from_disk": from_disk[found]}
                self._pending = pending
                if (self.disk is not None and self.host_capacity
                        and len(self.host) > self.host_capacity):
                    self._spilled_bg = self._spill()
        except BaseException as e:
            self._worker_err = e

    def _pending_keys(self) -> Optional[np.ndarray]:
        """Settle the round; the keys of its promotion candidates (None:
        nothing pending)."""
        self._settle()
        return None if not self._pending else self._pending["keys"]

    def _apply_pending(self, state: TableState, slot_ix: Optional[torch.Tensor] = None
                       ) -> tuple[TableState, int]:
        """Settle the round and apply its candidates, checked against the
        CURRENT device freq: promoted -> tier copies dropped; the device
        already newer at the snapshot -> the stale copy dropped; trained
        past the copy during the overlap -> the copy kept and the key
        retried at the next scan. `slot_ix`: the candidates' slots from a
        read-only probe already run (`probe_members`)."""
        self._settle()
        r, self._pending = self._pending, None
        if not r:
            return state, 0
        keys = r["keys"]
        device = state.keys.device
        if slot_ix is None:
            kt = torch.as_tensor(keys, device=device).to(state.keys.dtype)
            slot_ix = self.table._probe(state.keys, kt[None])[0][0]
        present = (slot_ix >= 0).cpu().numpy()
        freq_now = state.meta[0, META_FREQ][slot_ix.clamp(min=0).long()].cpu().numpy()
        refreshed = present & (freq_now <= r["freqs"])
        stale = present & ~refreshed & (r["snap_freq"] > r["freqs"])
        k = int(refreshed.sum())
        if k:
            ix = slot_ix[torch.as_tensor(refreshed, device=device)]
            self._unpack_rows(state, ix, torch.as_tensor(r["rows"][refreshed], device=device))
            _meta_write(state, META_FREQ, ix,
                        torch.as_tensor(r["freqs"][refreshed], device=device), add=True)
        drop = refreshed | stale
        if drop.any():
            with self._store_lock:
                self.host.erase(keys[drop])
                if self.disk is not None and (r["from_disk"] & drop).any():
                    self.disk.erase(keys[r["from_disk"] & drop])
            self._tier_rev += 1
        ambiguous = present & ~drop
        if ambiguous.any():
            self._retry_keys.update(int(x) for x in keys[ambiguous])
        return state, k

    # ------------------------------------------------------ paging engine

    def probe_rows(self, ids) -> Optional[dict]:
        """Gather half of tier paging (the TierPrefetcher thread): dedup the
        ids and read their host/disk-resident packed rows, freq and
        version. Read-only on the stores. None when nothing was ever
        demoted or nothing hit; otherwise a package stamped with the gather
        generation."""
        if self.host is None and self.disk is None:
            return None
        uniq = np.unique(np.asarray(ids).reshape(-1).astype(np.int64))
        if not len(uniq):
            return None
        t0 = time.perf_counter()
        with self._store_lock:
            rev = self._gather_gen
            if self.host is not None:
                vals, freqs, vers, found = self.host.get(uniq)
            else:
                vals = np.zeros((len(uniq), self.disk.dim), np.float32)
                freqs = np.zeros(len(uniq), np.int32)
                vers = np.zeros(len(uniq), np.int32)
                found = np.zeros(len(uniq), bool)
            vers = np.asarray(vers, np.int32).copy()
            from_disk = np.zeros(len(uniq), bool)
            if self.disk is not None and (~found).any():
                miss = ~found
                d_vals, d_freq, d_ver, d_found = self.disk.get(uniq[miss])
                if d_found.any():
                    mix = np.nonzero(miss)[0][d_found]
                    vals[mix] = d_vals[d_found]
                    freqs[mix] = d_freq[d_found]
                    vers[mix] = d_ver[d_found]
                    found[mix] = True
                    from_disk[mix] = True
        self._m_pf_probed.inc(len(uniq))
        hits = int(found.sum())
        if not hits:
            return None
        self._m_pf_hits.inc(hits)
        return {"keys": uniq[found], "rows": vals[found], "freqs": freqs[found],
                "vers": vers[found], "from_disk": from_disk[found], "rev": rev, "ts": t0}

    def _fold_package(self, cand: dict) -> Optional[dict]:
        """The arrays of a package to fold: as gathered, or gathered again
        at the current generation when a row-writing boundary ran since.
        None when it drops whole (a round owns the stores, or nothing is
        resident any more)."""
        n_all = len(cand["keys"])
        if cand["rev"] != self._gather_gen:
            idle = self._worker is None or not self._worker.is_alive()
            fresh = self.probe_rows(cand["keys"]) if idle else None
            if fresh is None:
                self._m_pf_stale.inc(n_all)
                return None
            self._m_pf_stale.inc(n_all - len(fresh["keys"]))
            cand = fresh
            n_all = len(cand["keys"])
        return {"keys": np.asarray(cand["keys"], np.int64),
                "rows": np.asarray(cand["rows"], np.float32),
                "freqs": np.asarray(cand["freqs"], np.int32),
                "vers": np.asarray(cand.get("vers", np.zeros(n_all, np.int32)), np.int32),
                "from_disk": np.asarray(cand["from_disk"], bool), "ts": cand["ts"],
                "out": []}

    def _fold_resolve(self, state: TableState, pkg: dict, part: slice,
                      slot_ix: torch.Tensor, created: torch.Tensor) -> None:
        """One chunk of a fold after its insert probe (slot_ix, created: [n]
        on the device), IN PLACE: the revalidation `freq_now <= tier freq`
        (a key the probe created always passes), the scatter of the passing
        rows' values and slots, and the meta merge (inserted rows take the
        tier freq and version and the dirty bit; re-created rows add the
        tier freq). A key past max_probes is skipped whole. Records (part,
        refreshed, present) in pkg["out"]."""
        device = state.keys.device
        freqs, vers = pkg["freqs"][part], pkg["vers"][part]
        present = slot_ix >= 0
        freq_now = torch.where(created, 0, state.meta[0, META_FREQ][slot_ix.clamp(min=0).long()])
        out = torch.stack([present, created, freq_now <= torch.as_tensor(freqs, device=device)])
        present, created, passes = out.cpu().numpy()
        refreshed = present & passes
        if refreshed.any():
            ix = slot_ix[torch.as_tensor(refreshed, device=device)]
            self._unpack_rows(state, ix, torch.as_tensor(pkg["rows"][part][refreshed],
                                                         device=device))
            f = torch.as_tensor(freqs[refreshed], device=device)
            old = torch.as_tensor(~created[refreshed], device=device)
            _meta_write(state, META_FREQ, ix[old], f[old], add=True)
            new = ~old
            _meta_write(state, META_FREQ, ix[new], f[new], add=False)
            _meta_write(state, META_VERSION, ix[new],
                        torch.as_tensor(vers[refreshed], device=device)[new], add=False)
            _meta_write(state, META_DIRTY, ix[new], torch.ones_like(f[new]), add=False)
            self.fold_writes += 1
        pkg["out"].append((part, refreshed, present))

    def _fold_finish(self, pkg: dict, t0: float, stall_ms: float) -> tuple[int, int]:
        """Erase the folded rows' tier copies, retry the dropped keys, count.
        Returns (folded, dropped)."""
        keys, from_disk = pkg["keys"], pkg["from_disk"]
        folded = dropped = 0
        erase_h, erase_d = [], []
        for part, refreshed, present in pkg["out"]:
            folded += int(refreshed.sum())
            ambiguous = present & ~refreshed
            dropped += int(ambiguous.sum())
            if ambiguous.any():
                self._retry_keys.update(int(x) for x in keys[part][ambiguous])
            if refreshed.any():
                erase_h.append(keys[part][refreshed])
                erase_d.append(keys[part][refreshed & from_disk[part]])
        if folded:
            self._erase_tier_rows(np.concatenate(erase_h), np.concatenate(erase_d))
            self.folded_rows += folded
            self.fold_bytes += folded * pkg["rows"].shape[1] * 4
            self._m_pf_folds.inc(folded)
            self._m_promoted.inc(folded)
        if dropped:
            self._m_pf_stale.inc(dropped)
        self._m_pf_lag.set((t0 - pkg["ts"]) * 1e3)
        self.fold_stall_ms += stall_ms
        return folded, dropped

    def fold_candidates(self, state: TableState, cand: dict, chunk: int = 256
                        ) -> tuple[TableState, int, int]:
        """Fold a gathered package into the device table at a dispatch
        boundary (training thread), `chunk` candidates at a time, IN PLACE.
        Folded rows' tier copies are erased; a key whose device row trained
        past its tier copy is dropped and retried at the next promote scan.
        A package of an older gather generation is gathered again first
        (dropped whole while a round owns the stores). Returns (state,
        folded, dropped)."""
        self._ensure_tiers(state)
        (folded, dropped), = fold_members(self.table, state, [(0, self, cand)], chunk)
        return state, folded, dropped

    def warm_fold(self, state: TableState, chunk: int = 256) -> None:
        """Make the tier stores and run one all-sentinel chunk through the
        fold (a no-op on the state: no key is real), so the first real fold
        pays no set-up."""
        self._ensure_tiers(state)
        z = np.zeros(chunk, np.int32)
        pkg = {"keys": np.full(chunk, empty_key(self.table.cfg), np.int64),
               "rows": np.zeros((chunk, self._packed_dim), np.float32), "freqs": z,
               "vers": z, "from_disk": np.zeros(chunk, bool), "out": []}
        _fold_packages(self.table, state, [(0, self, pkg)], chunk)

    # ------------------------------------------------------------- serving

    @torch.no_grad()
    def lookup_with_fallback(self, state: TableState, ids) -> torch.Tensor:
        """Read-only lookup (rows [*ids.shape, D] in the value dtype, on the
        state's device) that serves a device miss from the host tier, then
        the disk tier: one store probe over the distinct ids. With
        `row_cache_bytes`, the row cache serves hot demoted rows without
        touching the stores; its entries are keyed (id, tier revision), so
        a row is never served across a boundary that changed the tiers.
        Both paths give the same rows."""
        self._settle()  # a running round owns the stores
        ids_t = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids) else ids)
        emb = self.table.lookup_readonly(state, ids_t.to(state.keys.device)[None])[0]
        if self.host is None and self.disk is None:
            return emb
        D = self.table.cfg.dim
        flat_ids = ids_t.reshape(-1).cpu().numpy().astype(np.int64)
        uniq, inv = np.unique(flat_ids, return_inverse=True)
        n = len(uniq)
        u_vals = np.zeros((n, D), np.float32)
        u_found = np.zeros(n, bool)
        need = np.ones(n, bool)
        cache = self.row_cache
        if cache is not None:
            for j in range(n):
                hit = cache.get_current(int(uniq[j]).to_bytes(8, "little", signed=True))
                if hit is not None:
                    u_vals[j] = hit[0]
                    u_found[j] = True
                    need[j] = False
        probe = uniq[need]
        if len(probe):
            with self._store_lock:
                rev = self._tier_rev
                if self.host is not None:
                    h_vals, _, _, found = self.host.get(probe)
                else:
                    h_vals = np.zeros((len(probe), self.disk.dim), np.float32)
                    found = np.zeros(len(probe), bool)
                if self.disk is not None and (~found).any():
                    miss = ~found
                    d_vals, _, _, d_found = self.disk.get(probe[miss])
                    if d_found.any():
                        mix = np.nonzero(miss)[0][d_found]
                        h_vals[mix] = d_vals[d_found]
                        found[mix] = True
            if found.any():
                pix = np.nonzero(need)[0][found]
                rows = h_vals[found][:, :D]  # packed rows: values first
                u_vals[pix] = rows
                u_found[pix] = True
                if cache is not None:
                    for j, v in zip(pix, rows):
                        cache.put(int(uniq[j]).to_bytes(8, "little", signed=True),
                                  rev, np.array(v))
        if u_found.any():
            sel = u_found[inv]
            pos = torch.as_tensor(np.nonzero(sel)[0], device=emb.device)
            rows = torch.as_tensor(u_vals[inv[sel]], device=emb.device)
            flat = emb.reshape(len(flat_ids), D)
            flat[pos] = rows.to(flat.dtype)
            emb = flat.reshape(emb.shape)
        return emb

    # ----------------------------------------------------------- spill/load

    def spill(self, path: Optional[str] = None) -> None:
        """Persist the host tier (and the disk tier's index)."""
        self._settle()
        with self._store_lock:
            if self.host is not None:
                self.host.save(path or self.storage_path or "host_tier.bin")
            if self.disk is not None:
                self.disk.save()

    def load(self, path: Optional[str] = None) -> None:
        """Restore spilled tiers into a fresh instance (the serving flow). A
        missing host spill is an empty tier; an existing disk log reopens at
        its header's width. The first sync checks both widths."""
        p = path or self.storage_path or "host_tier.bin"
        try:
            width = _spill_dim(p)
        except FileNotFoundError:
            width = None
        with self._store_lock:
            if width is not None:
                if self.host is None:
                    self.host = HostKV(dim=width, initial_capacity=self.table.cfg.capacity)
                self.host.load(p)
            if self.disk is None and self.storage_path:
                ssd = self.storage_path + ".ssd"
                if os.path.exists(ssd) and os.path.getsize(ssd) >= 8:
                    self.disk = DiskKV(ssd)
        # fresh contents: retire gathers, and scan in full next time (the
        # touch history did not travel with the spill)
        self._tier_rev += 1
        self._gather_gen += 1
        self._scan_watermark = None
        self._retry_keys = set()


def _fold_packages(table: EmbeddingTable, state: TableState, folds: list, chunk: int
                   ) -> None:
    """Chunk by chunk, one insert probe over every member's next `chunk`
    keys ([T, chunk], sentinel-padded), then each member's `_fold_resolve`
    on its view. folds: [(member index, MultiTierTable, package)]."""
    device = state.keys.device
    sent = empty_key(table.cfg)
    n_max = max(len(p["keys"]) for _, _, p in folds)
    for off in range(0, n_max, chunk):
        kp = np.full((state.keys.shape[0], chunk), sent, np.int64)
        live = []
        for k, mt, p in folds:
            part = slice(off, min(off + chunk, len(p["keys"])))
            if part.start < part.stop:
                kp[k, :part.stop - part.start] = p["keys"][part]
                live.append((k, mt, p, part))
        kt = torch.as_tensor(kp, device=device).to(state.keys.dtype)
        slot_ix, created, _ = table._probe(state.keys, kt, kt != sent)
        for k, mt, p, part in live:
            n = part.stop - part.start
            mt._fold_resolve(member_view(state, k), p, part, slot_ix[k, :n], created[k, :n])


def fold_members(table: EmbeddingTable, state: TableState, folds: list,
                 chunk: int = 256) -> list:
    """`fold_candidates` of several members of one stacked state at once:
    per chunk one insert probe over every member. A member's row of the
    probe reads and claims only that member's keys, so per key this is the
    member-by-member fold, with one probe loop instead of one per member.
    folds: [(member index, MultiTierTable, candidate package)], whose
    stores the caller has made (`_ensure_tiers`). Returns [(folded,
    dropped)] in that order; the members' fold_stall_ms share the time."""
    t0 = time.perf_counter()
    pkgs = [(k, mt, mt._fold_package(cand)) for k, mt, cand in folds]
    live = [(k, mt, p) for k, mt, p in pkgs if p is not None]
    if live:
        _fold_packages(table, state, live, chunk)
    share = (time.perf_counter() - t0) * 1e3 / max(len(live), 1)
    return [mt._fold_finish(p, t0, share) if p is not None else (0, len(cand["keys"]))
            for (k, mt, p), (_, _, cand) in zip(pkgs, folds)]


def probe_members(table: EmbeddingTable, state: TableState, tiers: list) -> list:
    """Settle every member's background round and find the slots of its
    promotion candidates in one read-only probe over the members ([T, n],
    sentinel-padded). tiers: the MultiTierTable of each member, in order.
    Returns per member the [n] slot tensor (None: nothing pending), the
    `pending_slots` of its `sync_async`."""
    keys = [mt._pending_keys() for mt in tiers]
    n = max((len(k) for k in keys if k is not None), default=0)
    if not n:
        return [None] * len(tiers)
    kp = np.full((len(tiers), n), empty_key(table.cfg), np.int64)
    for i, k in enumerate(keys):
        if k is not None:
            kp[i, :len(k)] = k
    slot_ix = table._probe(state.keys, torch.as_tensor(kp, device=state.keys.device)
                           .to(state.keys.dtype))[0]
    return [None if k is None else slot_ix[i, :len(k)] for i, k in enumerate(keys)]
