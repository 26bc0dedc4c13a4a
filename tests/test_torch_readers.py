"""The port's Criteo readers held against the JAX package on the CPU: the
vectorised `criteo_block_parse` (the cube fast path, the garbage matrix,
non-UTF-8 input, fields too wide for the cube) with its error counts; the
port's native parser (its own copy of csv_parser.cpp, built by g++ into
build/deeprec_tpu_torch/) single- and multi-threaded against
`criteo_block_parse` and against the JAX `CriteoCSVReader`; byte ranges
and an unterminated last line; `sanitize_batch` and `RecordErrors` with the
`deeprec_record_errors` counter; `ParquetReader` against the JAX one and
against the TSV path; and a failed build raising instead of falling back.

Everything here is exact: the readers hash the same tokens with the same
crc32 and salts and parse the same integer text."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprec_tpu.data import readers as jrd
from deeprec_tpu.data.stream import criteo_line_parser as jax_line_parser
from deeprec_tpu_torch import native
from deeprec_tpu_torch.data import readers as trd
from deeprec_tpu_torch.data.stream import criteo_line_parser

torch.set_num_threads(1)

ND, NC = 13, 26
REPO = Path(__file__).resolve().parents[1]


def _row(rng, missing=0.1, cat_missing=0.1):
    cols = [str(rng.integers(0, 2))]
    cols += ["" if rng.random() < missing else str(rng.integers(0, 1000)) for _ in range(ND)]
    cols += ["" if rng.random() < cat_missing else f"{rng.integers(0, 1 << 24):x}"
             for _ in range(NC)]
    return "\t".join(cols)


def write_tsv(path, rows, seed=0, terminate=True, **kw):
    rng = np.random.default_rng(seed)
    text = "\n".join(_row(rng, **kw) for _ in range(rows)) + ("\n" if terminate else "")
    with open(path, "w") as f:
        f.write(text)
    return str(path)


def assert_batches_equal(got, want, msg=""):
    assert len(got) == len(want), f"{msg}: {len(got)} vs {len(want)} batches"
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b), msg
        for k in b:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, (msg, i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg}: batch {i} {k}")


def _garbage_block():
    rng = np.random.default_rng(7)
    rows = [_row(rng, cat_missing=0.0) for _ in range(150)]
    rows += [
        "x\t" + "\t".join(["1"] * 13 + ["aa"] * 26),  # bad label
        "1\tzz\t" + "\t".join(["2"] * 12 + ["bb"] * 26),  # bad float
        "1\t" + "\t".join(["1e999"] * 13 + ["cc"] * 26),  # inf -> clamp
        "0\t" + "\t".join(["nan"] * 13 + [""] * 26),  # nan, no cats
        "1\t1\t2",  # short row
        "\t".join(["5"] * 45),  # long row
        "",  # empty line
        "1\t  3  \t" + "\t".join(["4"] * 12 + ["dd"] * 26),  # whitespace float
    ]
    rng.shuffle(rows)
    return ("\n".join(rows) + "\n").encode()


BLOCKS = {
    "clean": lambda: ("\n".join(_row(np.random.default_rng(s)) for s in range(300))
                      + "\n").encode(),
    "garbage": _garbage_block,
    "non_utf8_tail": lambda: (b"1\t" + b"\t".join([b"2"] * 13 + [b"ad"] * 26) + b"\n"
                              + b"0\t" + b"\t".join([b"3"] * 13 + [b"\xff\xfe"] * 26)),
    "wide_fields": lambda: ("\t".join(["1"] + ["7"] * 13 + ["f" * 200] * 26) + "\n").encode() * 5,
    "empty": lambda: b"",
}


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_block_parse_matches_jax(case):
    """The block parser gives the JAX one's batch and error counts bit for
    bit, and equals the port's own line parser on the decoded lines."""
    data = BLOCKS[case]()
    e1, e2, e3 = (trd.RecordErrors(metrics=False), jrd.RecordErrors(metrics=False),
                  trd.RecordErrors(metrics=False))
    got = trd.criteo_block_parse(data, errors=e1)
    want = jrd.criteo_block_parse(data, errors=e2)
    assert_batches_equal([got], [want], case)
    assert e1.counts == e2.counts
    if data:
        lines = data.decode("utf-8", errors="replace")
        lines = lines[:-1].split("\n") if lines.endswith("\n") else lines.split("\n")
        assert_batches_equal([got], [criteo_line_parser(errors=e3)(lines)], case)
        assert e3.counts == e1.counts


def test_block_parse_clean_block_takes_the_cube_path(monkeypatch):
    calls = []
    real = trd._cube_parse_into
    monkeypatch.setattr(trd, "_cube_parse_into",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    trd.criteo_block_parse(BLOCKS["clean"]())
    assert calls == [1]


def test_line_parser_matches_jax():
    lines = _garbage_block().decode().split("\n")[:-1]
    e1, e2 = trd.RecordErrors(metrics=False), jrd.RecordErrors(metrics=False)
    assert_batches_equal([criteo_line_parser(errors=e1)(lines)],
                         [jax_line_parser(errors=e2)(lines)])
    assert e1.counts == e2.counts and e1.counts["bad_label"] >= 1


def test_hashing_and_salts_match_jax():
    assert trd.criteo_hash_salts() == jrd.criteo_hash_salts()
    assert trd.criteo_hash_salts(5) == jrd.criteo_hash_salts(5)
    col = np.array(["a1", "", None, "ff00", float("nan"), "a1", "zz"], object)
    for salt in (0, 0x9E3779B9 & 0x7FFFFFFF, 12345):
        np.testing.assert_array_equal(trd._hash_strings(col, salt), jrd._hash_strings(col, salt))


@pytest.mark.parametrize("threads", [1, 2, 4, 0])
def test_native_parser_matches_block_parse(threads):
    """criteo_parse (threads=1) and criteo_parse_mt give criteo_block_parse's
    rows bit for bit and stop before a trailing partial line."""
    rng = np.random.default_rng(5)
    text = "\n".join(_row(rng) for _ in range(2000)) + "\n"
    buf = text.encode() + b"0\tpartial"
    rows, labels, dense, cats, consumed = native.criteo_parse_native(buf, 2500, threads=threads)
    want = trd.criteo_block_parse(text.encode())
    assert rows == 2000 and consumed == len(text)
    np.testing.assert_array_equal(labels[:rows], want["label"])
    for i in range(ND):
        np.testing.assert_array_equal(dense[:rows, i], want[f"I{i + 1}"][:, 0])
    for c in range(NC):
        np.testing.assert_array_equal(cats[:rows, c], want[f"C{c + 1}"])
    assert cats.dtype == np.int32 and labels.dtype == dense.dtype == np.float32


def test_native_parser_stops_at_max_rows():
    text = "\n".join(_row(np.random.default_rng(s)) for s in range(10)) + "\n"
    rows, *_, consumed = native.criteo_parse_native(text.encode(), 4, threads=1)
    assert rows == 4 and consumed == sum(len(line) + 1 for line in text.split("\n")[:4])


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("batch_size", [128, 512, 3000])
def test_csv_reader_matches_jax(tmp_path, batch_size, drop_remainder):
    p = write_tsv(tmp_path / "day.tsv", 2500, seed=3)
    got = list(trd.CriteoCSVReader([p], batch_size=batch_size, drop_remainder=drop_remainder))
    want = list(jrd.CriteoCSVReader([p], batch_size=batch_size, drop_remainder=drop_remainder))
    assert_batches_equal(got, want, f"B={batch_size}")
    assert sum(len(b["label"]) for b in got) == (2500 // batch_size * batch_size
                                                 if drop_remainder else 2500)


def test_csv_reader_unterminated_last_line_and_byte_range(tmp_path):
    p = write_tsv(tmp_path / "day.tsv", 10, terminate=False)
    got = list(trd.CriteoCSVReader([p], batch_size=4, drop_remainder=False))
    want = list(jrd.CriteoCSVReader([p], batch_size=4, drop_remainder=False))
    assert_batches_equal(got, want, "unterminated")
    assert sum(len(b["label"]) for b in got) == 10
    p2 = write_tsv(tmp_path / "big.tsv", 600, seed=9)
    size = os.path.getsize(p2)
    from deeprec_tpu.data import WorkQueue as JaxWorkQueue

    for k in range(3):
        rng_ = JaxWorkQueue._slice_range(p2, k, 3)
        got = list(trd.CriteoCSVReader([p2], 64, drop_remainder=False, byte_range=rng_))
        want = list(jrd.CriteoCSVReader([p2], 64, drop_remainder=False, byte_range=rng_))
        assert_batches_equal(got, want, f"slice {k}")
    with pytest.raises(ValueError, match="exactly one file"):
        trd.CriteoCSVReader([p, p2], byte_range=(0, size))


def test_csv_reader_garbage_is_sanitized_and_counted(tmp_path):
    p = tmp_path / "bad.tsv"
    p.write_bytes(_garbage_block())
    r, jr = trd.CriteoCSVReader([str(p)], 16), jrd.CriteoCSVReader([str(p)], 16)
    got, want = list(r), list(jr)
    assert_batches_equal(got, want, "garbage")
    assert r.errors.counts == jr.errors.counts
    for b in got:
        assert np.isfinite(b["label"]).all() and all(
            np.isfinite(b[f"I{i + 1}"]).all() for i in range(ND))


SANITIZE = {
    "clean": {"label": np.array([1.0, 0.0], np.float32), "I1": np.array([[1.0], [2.0]], np.float32),
              "C1": np.array([3, -1], np.int32)},
    "nonfinite": {"label": np.array([1.0, np.nan], np.float32),
                  "I1": np.array([[np.inf], [2.0]], np.float32), "C1": np.array([5, -7], np.int32)},
    "ids_past_max": {"C1": np.array([5, 2000, -1, -3], np.int64),
                     "label_ctr": np.array([-5, 1], np.int32)},
}


@pytest.mark.parametrize("case", sorted(SANITIZE))
@pytest.mark.parametrize("max_id", [None, 1000])
def test_sanitize_batch_matches_jax(case, max_id):
    e1, e2 = trd.RecordErrors(metrics=False), jrd.RecordErrors(metrics=False)
    got = trd.sanitize_batch(dict(SANITIZE[case]), e1, pad_value=-1, max_id=max_id)
    want = jrd.sanitize_batch(dict(SANITIZE[case]), e2, pad_value=-1, max_id=max_id)
    assert_batches_equal([got], [want], case)
    assert e1.counts == e2.counts


def test_record_errors_reach_the_port_registry():
    """`RecordErrors.count` writes `deeprec_record_errors{kind=}` to the
    port's own metrics registry, as the JAX one writes to its registry."""
    from deeprec_tpu.obs import metrics as jm
    from deeprec_tpu_torch.obs import metrics as tm

    def value(mod, kind):
        return mod.default_registry().counter(
            "deeprec_record_errors", "", {"kind": kind}).value

    before = (value(tm, "bad_id"), value(jm, "bad_id"))
    trd.RecordErrors().count("bad_id", 3)
    jrd.RecordErrors().count("bad_id", 3)
    assert (value(tm, "bad_id") - before[0], value(jm, "bad_id") - before[1]) == (3, 3)
    quiet = trd.RecordErrors(metrics=False)
    quiet.count("bad_id", 2)
    quiet.count("bad_float", 0)
    assert value(tm, "bad_id") - before[0] == 3 and quiet.snapshot() == {"bad_id": 2}
    assert quiet.total == 2


def _to_parquet(tsv, dst, row_group_size=50):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    cols = {"label": [], **{f"I{i}": [] for i in range(1, ND + 1)},
            **{f"C{i}": [] for i in range(1, NC + 1)}}
    with open(tsv) as f:
        for line in f.read().split("\n")[:-1]:
            parts = line.split("\t")
            cols["label"].append(float(parts[0]))
            for i in range(ND):
                cols[f"I{i + 1}"].append(float(parts[1 + i]) if parts[1 + i] else 0.0)
            for c in range(NC):
                v = parts[1 + ND + c]
                cols[f"C{c + 1}"].append(v if v else None)
    pq.write_table(pa.table(cols), str(dst), row_group_size=row_group_size)
    return str(dst)


@pytest.mark.parametrize("salts", ["names", "criteo"])
def test_parquet_reader_matches_jax(tmp_path, salts):
    pq_path = _to_parquet(write_tsv(tmp_path / "d.tsv", 300, seed=4), tmp_path / "d.parquet")
    kw = dict(batch_size=64, drop_remainder=False)
    if salts == "criteo":
        kw["hash_salts"] = trd.criteo_hash_salts()
    assert_batches_equal(list(trd.ParquetReader([pq_path], **kw)),
                         list(jrd.ParquetReader([pq_path], **kw)), salts)


def test_parquet_ids_equal_the_tsv_ids(tmp_path):
    """With criteo_hash_salts the parquet copy of a TSV file hashes every
    token to the TSV reader's id."""
    tsv = write_tsv(tmp_path / "d.tsv", 256, seed=8)
    pq_path = _to_parquet(tsv, tmp_path / "d.parquet")
    got = list(trd.ParquetReader([pq_path], batch_size=64, hash_salts=trd.criteo_hash_salts()))
    want = list(trd.CriteoCSVReader([tsv], batch_size=64))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["label"], b["label"])
        for c in range(NC):
            np.testing.assert_array_equal(a[f"C{c + 1}"], b[f"C{c + 1}"])
        np.testing.assert_array_equal(a["I3"], b["I3"][:, 0])


def test_parquet_reader_names_pyarrow_when_missing(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        list(trd.ParquetReader([str(tmp_path / "none.parquet")]))


def test_csv_library_built_from_the_port_source_and_a_failed_build_raises(tmp_path, monkeypatch):
    """The parser is build/deeprec_tpu_torch/libcsv_parser-<digest>.so,
    built from deeprec_tpu_torch/native/csv_parser.cpp; a source that does
    not compile raises, and the reader has no other parser to fall to."""
    lib = native.load_csv_library()
    path = native._lib_path(native.CSV_SOURCE)
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libcsv_parser-")
    assert native.CSV_SOURCE == Path(native.__file__).parent / "csv_parser.cpp"
    assert lib is native.load_csv_library()
    p = write_tsv(tmp_path / "d.tsv", 20)
    bad = tmp_path / "csv_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSV_SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_csv_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        list(trd.CriteoCSVReader([p], batch_size=4))


def test_the_port_imports_neither_jax_nor_pandas():
    code = ("import sys; import deeprec_tpu_torch.data, deeprec_tpu_torch.embedding.compose, "
            "deeprec_tpu_torch.obs, deeprec_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pandas', 'deeprec_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fractional_labels_truncate_in_the_native_parser_as_in_the_reference():
    """The native parser reads a label with strtol (the reference's
    csv_parser.cpp does the same): "0.5" is 0 there, while
    criteo_block_parse and the line parser read 0.5. The port keeps both."""
    import deeprec_tpu.native as jn

    text = "".join(f"{lab}\t" + "\t".join(["1"] * ND + ["ab"] * NC) + "\n"
                   for lab in ("0.5", "1.7", "-2.5", "1", "0"))
    rows, labels, *_ = native.criteo_parse_native(text.encode(), 8, threads=1)
    np.testing.assert_array_equal(labels[:rows], [0.0, 1.0, -2.0, 1.0, 0.0])
    np.testing.assert_array_equal(trd.criteo_block_parse(text.encode())["label"],
                                  np.float32([0.5, 1.7, -2.5, 1.0, 0.0]))
    jax_native = jn.criteo_parse_native(text.encode(), 8, threads=1)
    if jax_native is not None:  # the JAX package's own build of the same source
        np.testing.assert_array_equal(jax_native[1][:rows], labels[:rows])
