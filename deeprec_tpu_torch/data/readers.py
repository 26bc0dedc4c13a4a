"""Columnar input readers — the port's copy of `deeprec_tpu/data/readers.py`
(the ParquetDataset / CSV path of DeepRec). Host-side, feeding the staged
prefetcher.

`CriteoCSVReader` reads through the native parser only (the JAX package
falls back to pandas when its library is missing; the port raises).
`criteo_block_parse` is the vectorised numpy parser of the parallel
pipeline, and the plain reference the native parser is held against.

Criteo layout: label \\t I1..I13 \\t C1..C26 (categorical as hex strings).
Categorical values are hashed to the table key space with the same mix used
by the embedding engine, so readers and tables agree on id semantics.
"""
from __future__ import annotations

import threading
import zlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

def criteo_hash_salts(num_cat: int = 26) -> Dict[str, int]:
    """The per-column id salts of the CSV/stream readers, keyed by column
    name. Pass to ``ParquetReader(hash_salts=...)`` so parquet-stored
    categorical strings hash to the SAME ids as the TSV path (the format
    parity gate, tests/test_input_pipeline.py)."""
    return {f"C{i}": i * 0x9E3779B9 & 0x7FFFFFFF
            for i in range(1, num_cat + 1)}


class RecordErrors:
    """Structured per-record error counter — the first line of the
    model-quality firewall (guard/): malformed input is rejected or
    clamped HERE, counted by kind, instead of propagating NaN/garbage
    into the trainer where only the step sentinel can still catch it.

    Kinds are a BOUNDED set (DRT007 discipline — they also become the
    ``kind=`` label of ``deeprec_record_errors``): ``bad_label`` /
    ``bad_float`` (unparseable text), ``nonfinite_float`` (parsed but
    inf/NaN), ``bad_id`` (negative/out-of-range id clamped to pad),
    ``oversized_bag`` (id bag trimmed), ``oversized_frame`` (stream
    frame skipped by the bounded resync), ``undecodable`` (record
    dropped entirely)."""

    KINDS = ("bad_label", "bad_float", "nonfinite_float", "bad_id",
             "oversized_bag", "oversized_frame", "undecodable")

    def __init__(self, metrics: bool = True):
        self.counts: Dict[str, int] = {}
        self._metrics = metrics
        # Parallel pipeline workers (data/pipeline.py) share one instance;
        # the read-modify-write below needs the lock to stay exact.
        self._lock = threading.Lock()

    def count(self, kind: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self.counts[kind] = self.counts.get(kind, 0) + int(n)
        if self._metrics:
            from deeprec_tpu_torch.obs import metrics as obs_metrics

            if obs_metrics.metrics_enabled():
                obs_metrics.default_registry().counter(
                    "deeprec_record_errors",
                    "malformed input records rejected/clamped by kind",
                    {"kind": kind},
                ).inc(n)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


def sanitize_batch(batch: Dict[str, np.ndarray],
                   errors: Optional[RecordErrors] = None,
                   pad_value: int = -1,
                   max_id: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Clamp a parsed numpy batch in place of trusting it: non-finite
    floats become 0 (counted ``nonfinite_float``), negative ids other
    than the pad value — and ids past ``max_id`` when given — become the
    pad value (counted ``bad_id``). Label keys clamp non-finite to 0
    too. Returns the batch (arrays copied only when dirty)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            bad = ~np.isfinite(a)
            if bad.any():
                if errors is not None:
                    errors.count("nonfinite_float", int(bad.sum()))
                a = np.where(bad, np.zeros((), a.dtype), a)
        elif np.issubdtype(a.dtype, np.integer) and not k.startswith("label"):
            bad = (a < 0) & (a != pad_value)
            if max_id is not None:
                bad = bad | (a > max_id)
            if bad.any():
                if errors is not None:
                    errors.count("bad_id", int(bad.sum()))
                a = np.where(bad, np.asarray(pad_value, a.dtype), a)
        out[k] = a
    return out


def _hash_strings(col: "np.ndarray", salt: int) -> np.ndarray:
    """String -> int32 id (crc32-based; stable across runs). Memoized per
    call: real id columns are heavily repeated (zipf), so the crc is paid
    once per DISTINCT value. The block parser goes further (np.unique over
    an S-dtype column); this path keeps exact semantics for object arrays
    with None/NaN holes."""
    out = np.empty(len(col), np.int32)
    cache: Dict[str, int] = {}
    for i, v in enumerate(col):
        if v is None or v == "" or (isinstance(v, float) and np.isnan(v)):
            out[i] = -1
        else:
            s = str(v)
            h = cache.get(s)
            if h is None:
                cache[s] = h = (zlib.crc32(s.encode()) ^ salt) & 0x7FFFFFFF
            out[i] = h
    return out


def _parse_float_col(col: np.ndarray, errors: Optional[RecordErrors],
                     kind: str) -> np.ndarray:
    """One S-dtype text column -> float32, with `criteo_line_parser` float
    semantics: empty -> 0.0 silently, unparseable -> 0.0 counted under
    `kind`. Non-finite values pass through (the caller clamps + counts
    them block-wide, same as the line parser's post-loop sweep)."""
    filled = np.where(col == b"", b"0", col)
    try:
        vals = filled.astype(np.float64)  # numpy's parser == float() here
    except ValueError:
        vals = np.empty(len(filled), np.float64)
        nbad = 0
        for i, v in enumerate(filled):
            try:
                vals[i] = float(v)
            except (TypeError, ValueError):
                vals[i] = 0.0
                nbad += 1
        if errors is not None:
            errors.count(kind, nbad)
    return vals.astype(np.float32)


def _crc_table() -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
        t[i] = np.uint32(c)
    return t


_CRC_T = _crc_table()  # the zlib crc32 polynomial table, vectorizable


def _hash_bytes_col(col: np.ndarray, salt: int) -> np.ndarray:
    """S-dtype column -> int32 ids via np.unique: crc paid once per
    DISTINCT value, scatter back through the inverse index. Matches
    `_hash_strings` bit-for-bit on utf-8-clean, NUL-free bytes (the block
    parser falls back to the per-line path otherwise)."""
    u, inv = np.unique(col, return_inverse=True)
    hu = np.empty(len(u), np.int32)
    for k, v in enumerate(u):
        hu[k] = -1 if v == b"" else (zlib.crc32(v) ^ salt) & 0x7FFFFFFF
    return hu[inv.reshape(col.shape)]


def _cube_parse_into(arr: np.ndarray, n: int, F: int, num_dense: int,
                     num_cat: int, labels, dense, cats,
                     errors: Optional[RecordErrors]) -> bool:
    """The no-Python-objects fast lane of `criteo_block_parse`: field
    boundaries from one separator scan, every field gathered into a
    fixed-width [n, F, w] byte cube, float columns bulk-astype'd through
    an S-dtype view, id columns hashed by a table-driven crc32 that
    iterates over BYTE POSITIONS (w of them) instead of rows. Requires
    uniform arity (the caller checked tabs == F-1 per line). Declines
    (returns False) when the widest field would make the cube silly —
    the caller then takes the S-matrix route."""
    sep = np.flatnonzero((arr == 9) | (arr == 10))
    ends = sep.reshape(n, F)
    starts = np.empty_like(ends)
    starts[:, 1:] = ends[:, :-1] + 1
    starts[0, 0] = 0
    starts[1:, 0] = ends[:-1, -1] + 1
    lens = ends - starts
    w = int(lens.max()) if n else 0
    if w == 0 or w > 128:
        return w == 0  # all-empty parses trivially; huge fields decline
    idx = starts[..., None] + np.arange(w)
    cube = arr[np.minimum(idx, len(arr) - 1)]
    cube[~(np.arange(w)[None, None, :] < lens[..., None])] = 0
    nf = 1 + num_dense
    fcols = np.ascontiguousarray(cube[:, :nf, :]).reshape(
        n * nf, w).view(f"|S{w}").reshape(n, nf)
    labels[:] = _parse_float_col(fcols[:, 0], errors, "bad_label")
    try:  # one astype for the whole dense block; per-column on garbage
        filled = np.where(fcols[:, 1:] == b"", b"0", fcols[:, 1:])
        dense[:] = filled.astype(np.float64).astype(np.float32)
    except ValueError:
        for i in range(num_dense):
            dense[:, i] = _parse_float_col(fcols[:, 1 + i], errors,
                                           "bad_float")
    cc = cube[:, nf:, :].reshape(n * num_cat, w)
    clens = lens[:, nf:].reshape(-1)
    crc = np.full(n * num_cat, 0xFFFFFFFF, np.uint32)
    for j in range(w):
        nxt = (crc >> np.uint32(8)) ^ _CRC_T[(crc ^ cc[:, j])
                                             & np.uint32(0xFF)]
        crc = np.where(clens > j, nxt, crc)
    crc = (crc ^ np.uint32(0xFFFFFFFF)).reshape(n, num_cat)
    salts = (np.arange(1, num_cat + 1, dtype=np.uint64) * 0x9E3779B9
             & 0x7FFFFFFF).astype(np.uint32)
    ids = ((crc ^ salts[None, :]) & np.uint32(0x7FFFFFFF)).astype(np.int32)
    ids[lens[:, nf:] == 0] = -1
    for c in range(num_cat):
        cats[c][:] = ids[:, c]
    return True


def criteo_block_parse(data: bytes, num_dense: int = 13, num_cat: int = 26,
                       errors: Optional[RecordErrors] = None
                       ) -> Dict[str, np.ndarray]:
    """Vectorized Criteo block parser — the parallel pipeline's hot loop.

    Takes a buffer of '\\n'-terminated TSV lines and produces the column
    dict (label [n] f32, I* [n,1] f32, C* [n] i32) in a handful of numpy
    ops: one split into an [n, F] S-dtype field matrix, bulk astype for
    the float columns, np.unique + crc32-of-distinct for the id columns.
    Bit-identical to `criteo_line_parser` applied to the decoded lines —
    including the RecordErrors clamp accounting, now counted per block —
    pinned by tests/test_input_pipeline.py. Lines that can't take the
    fast path (wrong field count, NUL bytes, non-utf8) are parsed
    per-line with the exact line-parser semantics and scattered back by
    row index, so one garbage record never slows the block around it."""
    if data and not data.endswith(b"\n"):
        data = data + b"\n"
    n = data.count(b"\n")
    F = 1 + num_dense + num_cat
    labels = np.zeros(n, np.float32)
    dense = np.zeros((n, num_dense), np.float32)
    cats = [np.full(n, -1, np.int32) for _ in range(num_cat)]
    if n == 0:
        return _criteo_assemble(labels, dense, cats, num_dense, num_cat)

    clean = b"\x00" not in data
    if clean:
        try:  # raw-bytes crc == crc of str.encode() only for valid utf-8
            data.decode("utf-8")
        except UnicodeDecodeError:
            clean = False

    arr = np.frombuffer(data, np.uint8)
    nl = np.flatnonzero(arr == 10)
    ctab = np.cumsum(arr == 9, dtype=np.int64)
    tabs_at_end = ctab[nl]
    tabs = np.diff(tabs_at_end, prepend=0)
    good = (tabs == F - 1) if clean else np.zeros(n, bool)

    if good.all() and _cube_parse_into(arr, n, F, num_dense, num_cat,
                                       labels, dense, cats, errors):
        m = None
        good_rows = np.empty(0, np.intp)
        good = np.ones(n, bool)
    elif good.all():
        fields = data[:-1].replace(b"\n", b"\t").split(b"\t")
        m = np.array(fields, dtype="S").reshape(n, F)
        good_rows = None
    elif good.any():
        lines = data.split(b"\n")[:-1]
        good_rows = np.flatnonzero(good)
        gdata = b"\n".join([lines[i] for i in good_rows])
        fields = gdata.replace(b"\n", b"\t").split(b"\t")
        m = np.array(fields, dtype="S").reshape(len(good_rows), F)
    else:
        m = None
        good_rows = np.empty(0, np.intp)

    if m is not None:
        rows = slice(None) if good_rows is None else good_rows
        labels[rows] = _parse_float_col(m[:, 0], errors, "bad_label")
        for i in range(num_dense):
            dense[rows, i] = _parse_float_col(m[:, 1 + i], errors,
                                              "bad_float")
        for c in range(num_cat):
            cats[c][rows] = _hash_bytes_col(
                m[:, 1 + num_dense + c],
                salt=(c + 1) * 0x9E3779B9 & 0x7FFFFFFF)

    if not good.all():
        lines = data.split(b"\n")[:-1]
        for r in np.flatnonzero(~good):
            _criteo_parse_line_into(
                lines[r].decode("utf-8", errors="replace"), r,
                labels, dense, cats, num_dense, num_cat, errors)

    # Non-finite sweep, block-wide — same ordering/kinds as the line
    # parser's post-loop clamp ("1e999" parses to inf, then clamps here).
    bad_label = ~np.isfinite(labels)
    if bad_label.any():
        labels[bad_label] = 0.0
        if errors is not None:
            errors.count("nonfinite_float", int(bad_label.sum()))
    bad = ~np.isfinite(dense)
    if bad.any():
        dense[bad] = 0.0
        if errors is not None:
            errors.count("nonfinite_float", int(bad.sum()))
    return _criteo_assemble(labels, dense, cats, num_dense, num_cat)


def _criteo_parse_line_into(line: str, r: int, labels, dense, cats,
                            num_dense: int, num_cat: int,
                            errors: Optional[RecordErrors]) -> None:
    """Exact `criteo_line_parser` semantics for ONE line (the block
    parser's slow lane): missing fields read as "", unparseable text
    clamps to 0 and counts, extra fields are ignored."""
    parts = line.split("\t")
    try:
        labels[r] = float(parts[0] or 0)
    except (TypeError, ValueError):
        labels[r] = 0.0
        if errors is not None:
            errors.count("bad_label")
    for i in range(num_dense):
        v = parts[1 + i] if len(parts) > 1 + i else ""
        try:
            dense[r, i] = float(v) if v else 0.0
        except (TypeError, ValueError):
            dense[r, i] = 0.0
            if errors is not None:
                errors.count("bad_float")
    for c in range(num_cat):
        j = 1 + num_dense + c
        v = parts[j] if len(parts) > j else ""
        salt = (c + 1) * 0x9E3779B9 & 0x7FFFFFFF
        cats[c][r] = (
            -1 if v == "" else (zlib.crc32(v.encode()) ^ salt) & 0x7FFFFFFF
        )


def _criteo_assemble(labels, dense, cats, num_dense, num_cat
                     ) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {"label": labels}
    for i in range(num_dense):
        out[f"I{i+1}"] = dense[:, i:i + 1]
    for c in range(num_cat):
        out[f"C{c+1}"] = cats[c]
    return out


class CriteoCSVReader:
    """Batched reader for Criteo-format TSV files, over the port's native
    parser (`native/csv_parser.cpp`, built with g++ at first use; a failed
    build raises — there is no pandas path).

    `byte_range=(lo, hi)` restricts reading to that line-aligned span of a
    SINGLE file (WorkQueue file-slice sharding: path#k/n items) — streamed
    in place, no copy of the slice."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int = 2048,
        num_dense: int = 13,
        num_cat: int = 26,
        drop_remainder: bool = True,
        byte_range: Optional[tuple] = None,
    ):
        self.paths = list(paths)
        self.B = batch_size
        self.num_dense = num_dense
        self.num_cat = num_cat
        self.drop_remainder = drop_remainder
        self.byte_range = byte_range
        # Firewall: every yielded batch passes sanitize_batch (non-finite
        # floats -> 0, negative ids -> pad), counted here by kind.
        self.errors = RecordErrors()
        if byte_range is not None and len(self.paths) != 1:
            raise ValueError("byte_range applies to exactly one file")

    def _iter_native(self) -> Iterator[Dict[str, np.ndarray]]:
        """Stream batches through the C++ parser — one pass over raw
        bytes, no DataFrame. Id hashing is `_hash_strings`'."""
        from deeprec_tpu_torch.native import criteo_parse_native

        CHUNK = max(1 << 20, self.B * 512)
        for path in self.paths:
            with open(path, "rb") as f:
                remaining = None
                if self.byte_range is not None:
                    lo, hi = self.byte_range
                    f.seek(lo)
                    remaining = hi - lo
                pending = b""
                while True:
                    want = (
                        CHUNK if remaining is None
                        else min(CHUNK, remaining)
                    )
                    fresh = f.read(want)
                    if remaining is not None:
                        remaining -= len(fresh)
                    data = pending + fresh
                    if not data:
                        break
                    at_eof = len(fresh) < CHUNK
                    if at_eof and not data.endswith(b"\n"):
                        # Terminate the final line so the parser consumes it.
                        data += b"\n"
                    rows, labels, dense, cats, consumed = criteo_parse_native(
                        data, self.B, self.num_dense, self.num_cat
                    )
                    if rows < self.B and not at_eof:
                        pending = data  # need more bytes for a full batch
                        continue
                    pending = data[consumed:]
                    if rows == 0:
                        if at_eof:
                            break
                        continue
                    if rows < self.B and self.drop_remainder:
                        break
                    batch: Dict[str, np.ndarray] = {
                        "label": labels[:rows]
                    }
                    for i in range(self.num_dense):
                        batch[f"I{i+1}"] = dense[:rows, i : i + 1]
                    for i in range(self.num_cat):
                        batch[f"C{i+1}"] = cats[:rows, i]
                    yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for batch in self._iter_native():
            yield sanitize_batch(batch, self.errors)


class ParquetReader:
    """Arrow-backed parquet batch reader (ParquetDataset parity). Columns map
    1:1 to batch keys; string/categorical columns are hashed to int32 ids."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int = 2048,
        columns: Optional[Sequence[str]] = None,
        hash_columns: Sequence[str] = (),
        drop_remainder: bool = True,
        hash_salts: Optional[Dict[str, int]] = None,
    ):
        """hash_salts: per-column salt override for the id hashing. The
        default (crc32 of the column NAME) is self-describing but does
        not match the positional salts of the CSV/stream readers — pass
        `criteo_hash_salts()` when the parquet files hold the same
        records as a TSV path and the id streams must be bit-identical
        (the pipeline's format parity gate)."""
        self.paths = list(paths)
        self.B = batch_size
        self.columns = list(columns) if columns else None
        self.hash_columns = set(hash_columns)
        self.drop_remainder = drop_remainder
        self.hash_salts = dict(hash_salts or {})

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import pyarrow.parquet as pq

        buf: Dict[str, List[np.ndarray]] = {}
        count = 0
        for path in self.paths:
            pf = pq.ParquetFile(path)
            for rb in pf.iter_batches(batch_size=self.B, columns=self.columns):
                cols = {}
                for name, col in zip(rb.schema.names, rb.columns):
                    arr = col.to_numpy(zero_copy_only=False)
                    if name in self.hash_columns or arr.dtype == object:
                        salt = self.hash_salts.get(
                            name, zlib.crc32(name.encode()))
                        arr = _hash_strings(arr, salt=salt)
                    cols[name] = arr
                for name, arr in cols.items():
                    buf.setdefault(name, []).append(arr)
                count += len(next(iter(cols.values())))
                while count >= self.B:
                    batch, buf, count = _take(buf, self.B)
                    yield batch
        if count and not self.drop_remainder:
            batch, buf, count = _take(buf, count)
            yield batch


def _take(buf, n):
    joined = {k: np.concatenate(v) for k, v in buf.items()}
    batch = {k: v[:n] for k, v in joined.items()}
    rest = {k: [v[n:]] for k, v in joined.items()}
    remaining = len(next(iter(rest.values()))[0])
    return batch, rest, remaining
