"""Full-corpus two-tower retrieval — the port of
`deeprec_tpu/serving/retrieval.py`: the blocked top-k over a resident,
quantized item matrix.

  * **Corpus residency** — the item tower's output vectors live on the
    device as ONE `[Cp, H]` matrix (a power-of-two count of `block_rows`
    blocks), int8 with a per-row scale, bf16, or f32. Items are ingested
    explicitly (`upsert_items`); the item tower runs in fixed chunks of
    `chunk` rows, so every encode sees one shape (on the card a row's vector
    then does not depend on the rows it was encoded with).
  * **Asymmetric data flow** — the user tower runs once per request row; the
    corpus side is a sweep (`ops/topk.blocked_topk`): score tiles merged
    into a streaming `[B, k]` top-k carry, the `[B, C]` score matrix never
    stored. On the card the user tower runs at the Predictor's `read_rows`
    rows per call (`nn.fixed_rows`) and every sweep product at `QUERY_ROWS`
    query rows, so a coalesced request's answer equals its solo answer bit
    for bit.
  * **Freshness rides delta replay** — `Predictor.poll_updates` notifies
    the engine (`on_model_update`) after each publish; it maps the delta's
    changed item-table keys onto corpus rows (`np.isin` against the stored
    item feature columns) and re-encodes exactly those rows, so a newly
    trained item vector is retrievable within one poll round. A move of the
    item tower's dense parameters escalates to a full re-encode.
  * **Scale-out rides the fleet** — with `num_shards > 1` an engine keeps
    only the items whose id hashes to its shard (`hash_shard_np`, bit for
    bit the JAX package's); the frontend fans a RETR op to every member and
    merges the per-shard top-k at the edge (`merge_shard_topk`).

`RetrievalServer` is the micro-batching front of the lane: concurrent
requests share one user-tower batch and one corpus sweep, accounted into
the `retrieval` stage histogram and the candidates-scanned counter of
`ServingStats`.

Threads and streams: the engine runs the Predictor's per-thread model
replica (`Predictor._module`), never the shared module. `on_model_update`
runs on the updater thread inside the Predictor's update stream; a new
`_Corpus` is published only after that stream is synchronised.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from deeprec_tpu_torch import features as fcol
from deeprec_tpu_torch import nn as dnn
from deeprec_tpu_torch.embedding.table import quantize_rows_int8
from deeprec_tpu_torch.ops import topk as _topk
from deeprec_tpu_torch.ops import traffic
from deeprec_tpu_torch.serving.predictor import BadRequest
from deeprec_tpu_torch.serving.stats import ServingStats
from deeprec_tpu_torch.utils.hashing import hash_shard_np
from deeprec_tpu_torch.utils.ragged import pad_rect

# On the card every sweep product runs at this many query rows
# (`blocked_topk(query_rows=)`): with the user tower at the Predictor's
# `read_rows`, a coalesced request's answer then equals its solo answer bit
# for bit. `RetrievalServer`'s default `max_batch` is two such groups.
QUERY_ROWS = 64


class RetrievalResult(NamedTuple):
    """One retrieval answer: per user row, the top-k item ids and their
    scores (desc), the model version that served the whole request, a
    partial flag (a fleet merge missing dead shards), and the candidate
    rows scanned to produce it."""

    ids: np.ndarray  # [B, k] int64 item ids, -1 past the valid corpus
    scores: np.ndarray  # [B, k] float32, -inf where ids == -1
    version: int
    partial: bool
    scanned: int


# Residency grammar shared with Predictor(quantize=): storage dtype per mode.
_QUANT_MODES = {
    None: "float32", "fp32": "float32", "float32": "float32",
    "bf16": "bfloat16", "bfloat16": "bfloat16", "int8": "int8",
}
_STORE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
}


def fill_missing_item_features(predictor, feats: Dict) -> Dict:
    """Retrieval requests carry USER features only — the item side is the
    resident corpus. `parse_features` demands the model's full feature set,
    so every absent item feature is filled with its pad value (one column;
    the parser pads to the declared max_len). Sparse pads are the feature's
    pad_value (a masked non-key), dense pads are 0."""
    if not isinstance(feats, dict) or not feats:
        raise BadRequest("missing 'features' object")
    item_feats = set(getattr(predictor.model, "item_feats", ()))
    if not item_feats:
        return feats
    v = next(iter(feats.values()))
    rows = len(v) if isinstance(v, list) else int(np.asarray(v).shape[0])
    specs = {f.name: f for f in predictor._trainer.sparse_specs}
    dtypes = predictor.feature_dtypes
    out = dict(feats)
    for name in item_feats - set(feats):
        want = dtypes.get(name)
        if want is None:
            continue
        if want.kind in "iu":
            out[name] = np.full((rows, 1), specs[name].pad_value, want)
        else:
            out[name] = np.zeros((rows, 1), np.float32)
    return out


def merge_shard_topk(
    ids: List[np.ndarray], scores: List[np.ndarray], k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-shard top-k answers into one global top-k (the frontend's
    edge merge). Total order: score desc, then item id asc — ties resolve
    the same way whatever the number of shards or the order they answered
    in. Entries with id -1 (a shard with fewer than k valid rows) lose."""
    allv = np.concatenate([np.asarray(s, np.float32) for s in scores], axis=1)
    alli = np.concatenate([np.asarray(i, np.int64) for i in ids], axis=1)
    allv = np.where(alli < 0, -np.inf, allv)
    # lexsort: the last key is primary — by -score, ties by id
    order = np.lexsort((alli, -allv), axis=-1)[:, :k]
    out_i = np.take_along_axis(alli, order, axis=1)
    out_v = np.take_along_axis(allv, order, axis=1)
    out_i = np.where(np.isfinite(out_v), out_i, -1)
    return out_i, out_v


class _Corpus(NamedTuple):
    """One immutable published corpus snapshot: readers grab ONE reference
    and sweep it; ingest and folds build replacements and swap."""

    vecs: torch.Tensor  # [Cp, H] storage dtype, on the device
    scale: Optional[torch.Tensor]  # [Cp] f32 (int8 residency only)
    valid: torch.Tensor  # [Cp] bool
    ids: np.ndarray  # [Cp] int64 host mirror (-1 where empty)
    rows: int  # live item count


class RetrievalEngine:
    """Device-resident item corpus and the blocked top-k sweep over it.

    Needs a two-tower model (`user_feats` / `item_feats` / `user_vector` /
    `item_vectors`, DSSM's surface). The engine hangs off a live
    `Predictor`: it encodes through the Predictor's current snapshot and
    registers for its model-update notifications, so delta replay keeps the
    corpus fresh without a second poller.
    """

    def __init__(self, predictor, *, quantize: str = "int8",
                 block_rows: int = 4096, chunk: int = 1024,
                 shard_index: int = 0, num_shards: int = 1):
        model = predictor.model
        for attr in ("user_feats", "item_feats", "user_vector", "item_vectors"):
            if not hasattr(model, attr):
                raise ValueError(
                    f"{type(model).__name__} has no two-tower split "
                    f"(retrieval needs user_feats/item_feats/user_vector/"
                    f"item_vectors)")
        if quantize not in _QUANT_MODES:
            raise ValueError(f"unknown retrieval residency {quantize!r}")
        if block_rows & (block_rows - 1):
            raise ValueError(f"block_rows must be a power of two, got {block_rows}")
        self._pred = predictor
        self._trainer = predictor._trainer
        self.device = predictor.device
        self.model = model
        self.quantize = _QUANT_MODES[quantize]
        self._store_dtype = _STORE_DTYPES[self.quantize]
        self.block_rows = int(block_rows)
        self.chunk = int(chunk)
        self.shard_index = int(shard_index)
        self.num_shards = int(num_shards)
        self.query_rows = QUERY_ROWS if self.device.type == "cuda" else None
        self._lock = threading.RLock()
        # one pad row per feature, so encode and retrieve batches carry the
        # model's FULL input signature (the other tower's features ride as
        # inert pad columns)
        self._templates: Dict[str, np.ndarray] = {}
        specs = {f.name: f for f in self._trainer.sparse_specs}
        for name, want in predictor.feature_dtypes.items():
            if want.kind in "iu":
                f = specs[name]
                self._templates[name] = np.full((1, f.max_len or 1), f.pad_value, want)
            else:
                self._templates[name] = np.zeros((1, 1), np.float32)
        # item feature -> (table, bundle, member tag): where a delta's
        # changed keys of that feature's table are read from
        self._item_tables = []
        for bname, b in self._trainer.bundles.items():
            for kx, f in enumerate(b.features):
                if f.name in model.item_feats:
                    tag = f"t{kx}" if b.stacked else "t"
                    self._item_tables.append(
                        (f.name, fcol.resolve_table_name(f), bname, tag))
        # Host mirrors: the stored rows and scale (exactly what the device
        # holds: a mass rebuild is one upload, no recompute; a CPU tensor,
        # as numpy has no bfloat16), the item feature columns (the fold's
        # isin target), the id map.
        self._h_feats: Dict[str, np.ndarray] = {}
        self._h_vecs: Optional[torch.Tensor] = None
        self._h_scale: Optional[np.ndarray] = None
        self._h_valid: Optional[np.ndarray] = None
        self._h_ids: Optional[np.ndarray] = None
        self._sid = np.zeros((0,), np.int64)  # sorted live ids
        self._srow = np.zeros((0,), np.int64)  # their corpus rows
        self._rows = 0
        # the last delta fold (wall time, rows re-encoded, model version)
        self.last_fold: Optional[Dict] = None
        self.folds = 0
        self.rows_folded = 0
        # Corpus revision: bumps whenever resident vectors change without a
        # model publish (ingest re-encodes rows at the same version). With
        # the model version it is the candidate cache's version key;
        # attached ReuseCaches invalidate on every bump.
        self.corpus_rev = 0
        self._reuse_caches: List = []
        # learn H off one pad chunk, then allocate the first (empty) block
        state = predictor._snap.state
        rows_dev, _ = self._encode(state, self._pad_chunk_batch())
        self._dim = int(rows_dev.shape[1])
        self._alloc(self.block_rows)
        self._publish(full=True)
        # Item-tower dense fingerprint: the targeted fold is only sound
        # while the dense half of the item tower is unchanged (sparse-only
        # online updates); a moved tower invalidates every vector.
        self._dense_ref = self._dense_fp(state)
        predictor.attach_retrieval(self)

    # ----------------------------------------------------------- plumbing

    @property
    def dim(self) -> int:
        return self._dim

    def _pad_chunk_batch(self) -> Dict[str, np.ndarray]:
        return {k: np.repeat(v, self.chunk, axis=0) for k, v in self._templates.items()}

    @torch.no_grad()
    def _encode(self, state, batch):
        """Item tower over one fixed-size chunk -> (storage-typed rows,
        per-row scale for int8 or None): quantize on encode."""
        inputs = self._pred._inputs(state, self._pred._device_batch(batch))
        item_in = torch.cat([inputs.pooled[n].to(torch.float32)
                             for n in self.model.item_feats], dim=-1)
        m = self._pred._module()
        vecs = dnn.method_call(m, state.dense, "item_vectors", item_in).to(torch.float32)
        if self.quantize == "int8":
            q, scale = quantize_rows_int8(vecs)
            return q.to(torch.int8), scale
        return vecs.to(self._store_dtype), None

    @torch.no_grad()
    def _user(self, state, batch) -> torch.Tensor:
        """User tower once per request row — the asymmetric half; at
        `read_rows` rows per call where the Predictor sets it."""
        inputs = self._pred._inputs(state, self._pred._device_batch(batch))
        m = self._pred._module()
        return self._pred._dense_call(
            lambda x: dnn.method_call(m, state.dense, "user_vector", x),
            inputs).to(torch.float32)

    def _dense_fp(self, state) -> int:
        """crc32 of the dense parameters the item tower reads (the model's
        `item_tower_params(dense)` where it has one, else the whole dense
        dict). An update-cadence host copy of a small tree."""
        fn = getattr(self.model, "item_tower_params", None)
        tree = fn(state.dense) if fn is not None else state.dense
        h = 0
        for name in sorted(tree):
            h = zlib.crc32(tree[name].detach().cpu().numpy().tobytes(), h)
        return h

    def _sync(self) -> None:
        """Wait for the calling thread's stream (an update's, or the
        caller's own) before a new corpus becomes visible to readers."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ----------------------------------------------------- corpus storage

    def _alloc(self, capacity: int) -> None:
        self._h_vecs = torch.zeros((capacity, self._dim), dtype=self._store_dtype)
        self._h_scale = np.zeros((capacity,), np.float32) if self.quantize == "int8" else None
        self._h_valid = np.zeros((capacity,), bool)
        self._h_ids = np.full((capacity,), -1, np.int64)

    @property
    def capacity(self) -> int:
        return 0 if self._h_ids is None else int(self._h_ids.shape[0])

    def _grow_to(self, need: int) -> None:
        """Double the power-of-two block count until `need` rows fit; the
        mirrors are re-padded on the host and the next publish uploads."""
        cap = self.capacity
        while cap < need:
            cap *= 2
        if cap == self.capacity:
            return
        pad = cap - self.capacity
        self._h_vecs = torch.cat(
            [self._h_vecs, torch.zeros((pad, self._dim), dtype=self._store_dtype)])
        if self._h_scale is not None:
            self._h_scale = np.concatenate([self._h_scale, np.zeros((pad,), np.float32)])
        self._h_valid = np.concatenate([self._h_valid, np.zeros((pad,), bool)])
        self._h_ids = np.concatenate([self._h_ids, np.full((pad,), -1, np.int64)])
        for name, col in self._h_feats.items():
            self._h_feats[name] = np.concatenate(
                [col, np.zeros((pad,) + col.shape[1:], col.dtype)])

    def _publish(self, full: bool = False, chunks=None) -> None:
        """Swap in a fresh `_Corpus`. `full` uploads the host mirrors whole
        (mass ingest, growth, full reload); else the encoded `chunks` [(row
        indices, rows, scale)] are written into a COPY of the current device
        arrays (readers of the old snapshot never see a half-written one)."""
        cur = getattr(self, "_corpus", None)
        if full or cur is None or cur.vecs.shape[0] != self.capacity:
            vecs = self._h_vecs.to(self.device)
            scale = (torch.as_tensor(self._h_scale).to(self.device)
                     if self._h_scale is not None else None)
            valid = torch.as_tensor(self._h_valid).to(self.device)
        else:
            vecs, scale, valid = cur.vecs, cur.scale, cur.valid
            if chunks:
                vecs = vecs.clone()
                scale = scale.clone() if scale is not None else None
                valid = valid.clone()
                for ix, rows_new, scale_new in chunks:
                    vecs[ix] = rows_new
                    if scale is not None:
                        scale[ix] = scale_new
                    valid[ix] = True
        self._sync()
        self._corpus = _Corpus(vecs=vecs, scale=scale, valid=valid,
                               ids=self._h_ids.copy(), rows=self._rows)

    def _refresh_rows(self, rows_ix: np.ndarray, state) -> None:
        """Re-encode the given corpus rows in fixed-size chunks; write them
        into the device arrays when the dirty set is small, upload the
        mirrors when it is not."""
        rows_ix = np.asarray(rows_ix, np.int64)
        if rows_ix.size == 0:
            self._publish(full=False, chunks=[])
            return
        mass = rows_ix.size > max(self.chunk, self.capacity // 8)
        chunks = []
        for off in range(0, rows_ix.size, self.chunk):
            sl = rows_ix[off:off + self.chunk]
            n = sl.size
            ix = np.zeros((self.chunk,), np.int64)
            ix[:n] = sl
            batch = {}
            for name, tmpl in self._templates.items():
                if name in self._h_feats:
                    batch[name] = self._h_feats[name][ix]
                else:
                    batch[name] = np.repeat(tmpl, self.chunk, axis=0)
            rows_dev, scale_dev = self._encode(state, batch)
            self._h_vecs[torch.as_tensor(sl)] = rows_dev[:n].cpu()
            if self._h_scale is not None:
                self._h_scale[sl] = scale_dev[:n].cpu().numpy()
            self._h_valid[sl] = True
            if not mass:
                # the device rows feed the copy-and-write of _publish
                chunks.append((torch.as_tensor(sl, device=self.device), rows_dev[:n],
                               scale_dev[:n] if scale_dev is not None else None))
        self._publish(full=mass, chunks=chunks)

    # ------------------------------------------------------------- ingest

    def _coerce_item_col(self, name: str, v) -> np.ndarray:
        """Item feature column -> the stored [N, L] shape (the pad and trim
        rules of `parse_features`, without the ragged-list path: ingest is a
        bulk array interface)."""
        want = self._pred.feature_dtypes[name]
        arr = np.asarray(v)
        if want.kind in "iu":
            f = next(f for f in self._trainer.sparse_specs if f.name == name)
            return pad_rect(arr, f.max_len or 1, f.pad_value, want)
        arr = arr.astype(np.float32)
        return arr[:, None] if arr.ndim == 1 else arr

    def upsert_items(self, ids, features: Dict[str, np.ndarray]) -> int:
        """Ingest (or refresh) items: assign corpus rows, store the item
        feature columns, encode through the CURRENT model snapshot, and
        publish. Items hashing to another shard are skipped (a broadcast
        ingest partitions itself); returns the rows this shard accepted.
        Duplicate ids within one call keep the LAST occurrence; re-ingesting
        an existing id re-encodes its row."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return 0
        cols = {}
        for name in self.model.item_feats:
            if name not in features:
                raise BadRequest(f"ingest missing item feature {name!r}", feature=name)
            col = self._coerce_item_col(name, features[name])
            if col.shape[0] != ids.size:
                raise BadRequest(
                    f"item feature {name!r} has {col.shape[0]} rows for {ids.size} ids")
            cols[name] = col
        if self.num_shards > 1:
            keep = np.asarray(hash_shard_np(ids, self.num_shards)) == self.shard_index
            ids = ids[keep]
            cols = {k: v[keep] for k, v in cols.items()}
            if ids.size == 0:
                return 0
        # last-occurrence dedup within the call
        _, last = np.unique(ids[::-1], return_index=True)
        keep_ix = np.sort(ids.size - 1 - last)
        ids = ids[keep_ix]
        cols = {k: v[keep_ix] for k, v in cols.items()}
        with self._lock:
            rows_ix = np.empty(ids.shape, np.int64)
            exists = np.zeros(ids.shape, bool)
            if self._sid.size:
                pos = np.clip(np.searchsorted(self._sid, ids), 0, self._sid.size - 1)
                exists = self._sid[pos] == ids
                rows_ix[exists] = self._srow[pos[exists]]
            n_new = int((~exists).sum())
            if n_new:
                self._grow_to(self._rows + n_new)
                rows_ix[~exists] = self._rows + np.arange(n_new)
                self._rows += n_new
            for name, col in cols.items():
                if name not in self._h_feats:
                    self._h_feats[name] = np.zeros((self.capacity,) + col.shape[1:], col.dtype)
                elif self._h_feats[name].shape[0] < self.capacity:
                    old = self._h_feats[name]
                    padn = self.capacity - old.shape[0]
                    self._h_feats[name] = np.concatenate(
                        [old, np.zeros((padn,) + old.shape[1:], old.dtype)])
                self._h_feats[name][rows_ix] = col
            self._h_ids[rows_ix] = ids
            order = np.argsort(self._h_ids[:self._rows], kind="stable")
            self._sid = self._h_ids[:self._rows][order]
            self._srow = order.astype(np.int64)
            self._refresh_rows(rows_ix, self._pred._snap.state)
            self.corpus_rev += 1
        for c in self._reuse_caches:
            c.invalidate_stale()
        return int(ids.size)

    # ---------------------------------------------------------- freshness

    def on_model_update(self, dirnames: Optional[List[str]], full: bool) -> None:
        """Model-update hook, called by the Predictor after every published
        update inside its updater lock (and its update stream): fold the
        update into the corpus. A full reload re-encodes every row; a delta
        replay re-encodes only the rows whose item feature ids are among the
        delta's changed table keys, read from the delta files the replay
        just consumed."""
        t0 = time.time()
        with self._lock:
            state = self._pred._snap.state
            fp = self._dense_fp(state)
            drift = fp != self._dense_ref
            if drift:
                # the item tower's dense half moved: every vector is stale,
                # whatever keys the delta carried
                full = True
            self._dense_ref = fp
            if self._rows == 0:
                return
            if full or not dirnames:
                dirty = np.nonzero(self._h_valid[:self._rows])[0]
            else:
                changed: Dict[str, List[np.ndarray]] = {}
                for d in dirnames:
                    path = os.path.join(self._pred._ck.dir, d)
                    for fname, _tname, bname, tag in self._item_tables:
                        try:
                            rows = self._pred._ck._load_rows(path, bname, tag)
                        except Exception:
                            continue  # quarantined or missing: nothing to fold
                        if rows is None or "keys" not in rows:
                            continue
                        changed.setdefault(fname, []).append(np.asarray(rows["keys"]))
                if not changed:
                    return
                mask = np.zeros((self._rows,), bool)
                for fname, key_lists in changed.items():
                    col = self._h_feats.get(fname)
                    if col is None:
                        continue
                    keys = np.unique(np.concatenate(key_lists))
                    mask |= np.isin(col[:self._rows], keys).reshape(
                        self._rows, -1).any(axis=1)
                dirty = np.nonzero(mask & self._h_valid[:self._rows])[0]
                if dirty.size == 0:
                    return
            self._refresh_rows(dirty, state)
            self.folds += 1
            self.corpus_rev += 1
            self.rows_folded += int(dirty.size)
            self.last_fold = {
                "time": time.time(),
                "seconds": round(time.time() - t0, 6),
                "rows": int(dirty.size),
                "version": self._pred._snap.version,
                "full": bool(full or not dirnames),
                "dense_drift": drift,
            }

    # ------------------------------------------------------------ retrieve

    @staticmethod
    def _bucket(n: int, lo: int = 4) -> int:
        return max(lo, 1 << max(int(n) - 1, 0).bit_length())

    def warmup(self, example: Dict[str, np.ndarray], k: int = 128) -> int:
        """Run the user tower at each row bucket up to the example's and
        the sweep once per bucket before live traffic (in eager PyTorch:
        loads the kernels, grows the allocator's pools)."""
        n = 0
        one = {key: np.asarray(v)[:1] for key, v in example.items()}
        b = 4
        while True:
            batch = {key: np.repeat(v, b, axis=0) for key, v in one.items()}
            self.retrieve(batch, k)
            n += 1
            if b >= self._bucket(len(next(iter(example.values())))):
                break
            b <<= 1
        return n

    def retrieve(self, batch: Dict[str, np.ndarray], k: int) -> RetrievalResult:
        """Score the WHOLE resident corpus for each user row of `batch` (a
        parsed full-signature batch; item columns are inert pads) and return
        the top-k item ids and scores: one user-tower evaluation, one
        blocked sweep, shared across the batch's rows."""
        if k < 1:
            raise BadRequest(f"k must be >= 1, got {k}")
        snap = self._pred._snap  # one atomic model snapshot
        corpus = self._corpus  # one atomic corpus snapshot
        B = int(np.asarray(next(iter(batch.values()))).shape[0])
        if B == 0:
            raise BadRequest("empty retrieval batch")
        Bp = self._bucket(B)
        jb = {}
        for name, v in batch.items():
            a = np.asarray(v)
            if Bp > B:
                a = np.concatenate([a, np.repeat(a[-1:], Bp - B, axis=0)])
            jb[name] = a
        uvec = self._user(snap.state, jb)
        kb = self._bucket(k, lo=1)
        vals, rows = _topk.blocked_topk(
            uvec, corpus.vecs, corpus.valid, kb, block_rows=self.block_rows,
            scale=corpus.scale, query_rows=self.query_rows)
        vals = vals.cpu().numpy()[:B, :k]
        rows = rows.cpu().numpy()[:B, :k]
        ids = np.where(rows >= 0, corpus.ids[np.clip(rows, 0, None)], -1)
        return RetrievalResult(ids=ids.astype(np.int64), scores=vals.astype(np.float32),
                               version=snap.version, partial=False,
                               scanned=corpus.rows * B)

    def attach_reuse_cache(self, cache) -> None:
        """Register a ReuseCache for corpus-edge invalidation: every ingest
        or fold that moves resident vectors bumps `corpus_rev` and drops the
        cache's stale entries."""
        self._reuse_caches.append(cache)

    # ----------------------------------------------------------- accounting

    def corpus_rows(self) -> int:
        return self._rows

    def corpus_bytes(self) -> int:
        """Measured resident bytes of the sweep's read set, from the device
        tensors' shapes (no sync): what `ops/traffic.retrieval_sweep_bytes`
        models."""
        c = self._corpus
        total = c.vecs.numel() * c.vecs.element_size()
        if c.scale is not None:
            total += c.scale.numel() * c.scale.element_size()
        total += c.valid.numel() * c.valid.element_size()
        return int(total)

    def sweep_info(self) -> Dict:
        """Measured against modeled bytes per sweep, and the f32 baseline."""
        cap = self.capacity
        return {
            "quantize": self.quantize,
            "corpus_rows": self._rows,
            "corpus_capacity": cap,
            "dim": self._dim,
            "block_rows": self.block_rows,
            "measured_bytes": self.corpus_bytes(),
            "modeled_bytes": traffic.retrieval_sweep_bytes(
                corpus_rows=cap, dim=self._dim, value_dtype=self.quantize,
                block_rows=self.block_rows),
            "fp32_bytes": traffic.retrieval_sweep_bytes(
                corpus_rows=cap, dim=self._dim, value_dtype="float32",
                block_rows=self.block_rows),
        }

    def host_vectors(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids [N], vectors [N, H] float32) of the live corpus — the exact
        scan's reference (f32 engines return their stored vectors, quantized
        ones the dequantized rows the sweep scores)."""
        with self._lock:
            n = self._rows
            vecs = self._h_vecs[:n].to(torch.float32).numpy()
            if self._h_scale is not None:
                vecs = vecs * self._h_scale[:n, None]
            return self._h_ids[:n].copy(), vecs


class RetrievalServer:
    """Micro-batching front of the retrieval lane: concurrent requests
    coalesce into ONE user-tower batch and ONE corpus sweep, and each
    request's rows are sliced back out. Accounts into the shared
    `ServingStats` (`retrieval` stage histogram, candidates-scanned
    counter) and registers the corpus gauges on its registry."""

    def __init__(self, engine: RetrievalEngine, *, max_batch: int = 128,
                 max_wait_ms: float = 1.0, stats: Optional[ServingStats] = None,
                 reuse_cache_bytes: int = 0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1000.0
        self.stats = stats if stats is not None else ServingStats()
        r = self.stats.registry
        if r is not None:
            r.register_callback("deeprec_retrieval_corpus_rows", engine.corpus_rows,
                                "live items resident in this shard's corpus matrix")
            r.register_callback("deeprec_retrieval_corpus_bytes", engine.corpus_bytes,
                                "resident bytes of the corpus sweep's read set")
        # Candidate cache (serving/reuse.py, opt-in): answers keyed (user fp
        # + k, (model version, corpus_rev)), so a hit never serves across a
        # model publish nor an item ingest or fold.
        self.reuse = None
        if reuse_cache_bytes > 0:
            from deeprec_tpu_torch.serving.reuse import ReuseCache

            self.reuse = ReuseCache(
                reuse_cache_bytes, "retrieve", registry=r,
                version_fn=lambda: (engine._pred._snap.version, engine.corpus_rev))
            engine.attach_reuse_cache(self.reuse)
            engine._pred.attach_reuse_cache(self.reuse)
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="retrieval-batcher")
        self._worker.start()

    def submit(self, features: Dict[str, np.ndarray], k: int,
               no_cache: bool = False) -> "queue.Queue":
        reply: "queue.Queue" = queue.Queue(maxsize=1)
        rows = int(np.asarray(next(iter(features.values()))).shape[0])
        fp = None
        if self.reuse is not None and not no_cache:
            from deeprec_tpu_torch.serving import reuse as _reuse

            # k is part of the key: one user at k=10 and k=100 are two answers
            fp = _reuse.request_fingerprint(features, extra=b"k%d" % int(k))
            hit = self.reuse.get_current(fp)
            if hit is not None:
                reply.put(hit[0])
                return reply
        self._q.put((features, rows, int(k), reply, time.monotonic(), fp))
        return reply

    def request_versioned(self, features: Dict[str, np.ndarray], k: int,
                          timeout: float = 30.0, no_cache: bool = False) -> RetrievalResult:
        t0 = time.monotonic()
        out = self.submit(features, k, no_cache=no_cache).get(timeout=timeout)
        self.stats.record_stage("retrieval", time.monotonic() - t0)
        if isinstance(out, Exception):
            raise out
        return out

    def warmup(self, example: Dict[str, np.ndarray], k: int = 128) -> int:
        return self.engine.warmup(example, k=k)

    def _run(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            pending = [first]
            rows = first[1]
            deadline = time.monotonic() + self.max_wait
            while rows < self.max_batch:
                left = deadline - time.monotonic()
                try:
                    nxt = self._q.get_nowait() if left <= 0 else self._q.get(timeout=left)
                except queue.Empty:
                    break
                pending.append(nxt)
                rows += nxt[1]
            self._serve(pending)

    def _serve(self, pending):
        try:
            # in-window memoisation: identical in-flight requests (the
            # fingerprint covers the features AND k) share one sweep slice
            leaders = pending
            dups: Dict[bytes, List] = {}
            if self.reuse is not None:
                seen: Dict[bytes, bool] = {}
                leaders = []
                for p in pending:
                    fp = p[5]
                    if fp is not None and fp in seen:
                        dups.setdefault(fp, []).append(p)
                        continue
                    if fp is not None:
                        seen[fp] = True
                    leaders.append(p)
            reqs = [p[0] for p in leaders]
            sizes = [p[1] for p in leaders]
            kmax = max(p[2] for p in leaders)
            batch = {key: np.concatenate([np.asarray(r[key]) for r in reqs])
                     for key in reqs[0]}
            rev0 = self.reuse.current_version() if self.reuse is not None else None
            res = self.engine.retrieve(batch, kmax)
            off = 0
            per_row_scan = res.scanned // max(sum(sizes), 1)
            # store only when (model version, corpus_rev) held across the
            # sweep and matches the answer's stamp
            storable = (rev0 is not None and rev0 == self.reuse.current_version()
                        and rev0[0] == res.version)
            for p, n in zip(leaders, sizes):
                k_i, reply = p[2], p[3]
                out = RetrievalResult(ids=res.ids[off:off + n, :k_i],
                                      scores=res.scores[off:off + n, :k_i],
                                      version=res.version, partial=False,
                                      scanned=per_row_scan * n)
                reply.put(out)
                if p[5] is not None:
                    for d in dups.get(p[5], ()):
                        d[3].put(out)
                    if storable:
                        self.reuse.put(p[5], rev0, RetrievalResult(
                            ids=np.ascontiguousarray(out.ids),
                            scores=np.ascontiguousarray(out.scores),
                            version=out.version, partial=False, scanned=out.scanned))
                off += n
            self.stats.record_retrieval(len(pending), res.scanned)
        except Exception as e:
            self.stats.record_error(len(pending))
            for p in pending:
                p[3].put(e)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=2)
