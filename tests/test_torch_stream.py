"""The port's stream readers held against the JAX package on the CPU:
`FileTailReader` (streaming, offsets, partial lines, a record longer than
the read window), `TCPStreamReader` over `FileStreamServer` (exactly-once
save / restore across a crash and appended records, reconnects without
duplicates, a refused bounded consume, the reconnect counters, oversized
and undecodable frames skipped and counted, offsets past skipped frames),
each reader's batches equal to the JAX reader's on the same stream, the two
packages' servers and readers talking to each other, and the copied
`utils/backoff` policy equal to the JAX one."""
import random
import socket
import threading
import time

import numpy as np
import pytest
import torch

from deeprec_tpu.data import FileStreamServer as JaxServer
from deeprec_tpu.data import FileTailReader as JaxTail
from deeprec_tpu.data import TCPStreamReader as JaxTCP
from deeprec_tpu.utils import backoff as jbackoff
from deeprec_tpu_torch.data import FileStreamServer, FileTailReader, TCPStreamReader
from deeprec_tpu_torch.utils import backoff

from test_torch_readers import assert_batches_equal, write_tsv  # noqa: E402  (shared helpers)

torch.set_num_threads(1)

ND, NC = 2, 2


def _line(label="1", dense=("1.5", "2.0"), cats=("tokA", "tokB")):
    return "\t".join([label, *dense, *cats])


def _serve(tmp_path, content, server=FileStreamServer, name="log.tsv"):
    p = tmp_path / name
    p.write_bytes(content)
    return server(str(p), follow=False).start()


def _rows(batches):
    return np.concatenate([b["rows"] for b in batches]).tolist() if batches else []


ROWS = lambda lines: {"rows": np.asarray(lines, object)}  # noqa: E731


@pytest.mark.parametrize("batch_size", [32, 100, 2048])
def test_file_tail_reader_matches_jax(tmp_path, batch_size):
    p = write_tsv(tmp_path / "s.tsv", 500, seed=5)
    got = list(FileTailReader(p, batch_size=batch_size, stop_at_eof=True))
    want = list(JaxTail(p, batch_size=batch_size, stop_at_eof=True))
    assert_batches_equal(got, want, f"B={batch_size}")
    assert sum(len(b["label"]) for b in got) == 500


def test_file_tail_reader_streams_and_resumes(tmp_path):
    p = str(tmp_path / "stream.tsv")

    def write_rows(n, start=0):
        with open(p, "a") as f:
            for i in range(start, start + n):
                f.write(f"{i % 2}\t" + "\t".join("1" for _ in range(13)) + "\t"
                        + "\t".join(f"{i + j:x}" for j in range(26)) + "\n")

    write_rows(64)
    r = FileTailReader(p, batch_size=32, stop_at_eof=True)
    assert len(list(r)) == 2
    state = r.save()
    jr = JaxTail(p, batch_size=32, stop_at_eof=True)
    list(jr)
    assert state == jr.save()
    write_rows(32, start=64)
    r2 = FileTailReader(p, batch_size=32, stop_at_eof=True)
    r2.restore(state)
    jr2 = JaxTail(p, batch_size=32, stop_at_eof=True)
    jr2.restore(state)
    new = list(r2)
    assert_batches_equal(new, list(jr2), "resumed")
    assert len(new) == 1 and float(new[0]["label"][0]) == 0.0
    with pytest.raises(ValueError, match="offset checkpoint"):
        FileTailReader(str(tmp_path / "other.tsv"), 32).restore(state)
    FileTailReader(str(tmp_path / "other.tsv"), 32).restore(state, allow_path_mismatch=True)


def test_file_tail_reader_partial_line_and_offset_exactness(tmp_path):
    p = str(tmp_path / "s.tsv")
    row = "1\t" + "\t".join("1" for _ in range(13)) + "\t" + "\t".join("a" for _ in range(26))
    with open(p, "w") as f:
        f.write((row + "\n") * 48 + row)  # 48 rows and an unterminated partial
    r = FileTailReader(p, batch_size=32, stop_at_eof=True)
    it = iter(r)
    assert next(it)["label"].shape == (32,)
    mid = r.save()
    assert sum(b["label"].shape[0] for b in it) == 16
    r2 = FileTailReader(p, batch_size=32, stop_at_eof=True)
    r2.restore(mid)
    assert sum(b["label"].shape[0] for b in r2) == 16
    assert r.offset == r2.offset == 48 * (len(row) + 1)  # the partial line stays unconsumed


def test_file_tail_reader_grows_window_past_giant_record(tmp_path):
    giant = "x" * (3 << 20)
    parser = lambda lines: {"n": np.array([len(x) for x in lines])}  # noqa: E731
    for case, lines in enumerate(([giant, "short"], ["short", giant])):
        p = str(tmp_path / f"log{case}.tsv")
        with open(p, "w") as f:
            f.write("\n".join(lines) + "\n")
        r = FileTailReader(p, batch_size=2, stop_at_eof=True, parser=parser)
        lens = np.concatenate([b["n"] for b in r])
        assert sorted(lens.tolist()) == [5, 3 << 20], case


def test_tcp_reader_matches_jax_on_criteo_rows(tmp_path):
    p = write_tsv(tmp_path / "s.tsv", 300, seed=6)
    srv = FileStreamServer(p).start()
    try:
        got = list(TCPStreamReader("127.0.0.1", srv.port, batch_size=64, stop_at_eof=True))
        want = list(JaxTCP("127.0.0.1", srv.port, batch_size=64, stop_at_eof=True))
    finally:
        srv.stop()
    assert_batches_equal(got, want, "tcp")
    assert [len(b["label"]) for b in got] == [64] * 4 + [44]


@pytest.mark.parametrize("server,reader", [(FileStreamServer, JaxTCP), (JaxServer, TCPStreamReader)])
def test_servers_and_readers_interoperate(tmp_path, server, reader):
    srv = _serve(tmp_path, b"".join(f"row{i:04d}\n".encode() for i in range(70)), server)
    try:
        r = reader("127.0.0.1", srv.port, batch_size=32, parser=ROWS, stop_at_eof=True)
        assert _rows(list(r)) == [f"row{i:04d}" for i in range(70)]
    finally:
        srv.stop()


def test_tcp_stream_reader_exactly_once_resume(tmp_path):
    p = tmp_path / "log.tsv"
    p.write_text("".join(f"row{i:04d}\n" for i in range(100)))
    srv = FileStreamServer(str(p), follow=False).start()
    try:
        r1 = TCPStreamReader("127.0.0.1", srv.port, batch_size=32, parser=ROWS, stop_at_eof=True)
        it = iter(r1)
        got = [next(it), next(it)]
        ckpt = r1.save()
        assert ckpt["offset"] == 64 * 8
        it.close()
        with open(p, "a") as f:
            f.write("".join(f"row{i:04d}\n" for i in range(100, 120)))
        r2 = TCPStreamReader("127.0.0.1", srv.port, batch_size=32, parser=ROWS, stop_at_eof=True)
        r2.restore(ckpt)
        got += list(r2)
        # the JAX reader restored from the port's position reads the same rest
        j2 = JaxTCP("127.0.0.1", srv.port, batch_size=32, parser=ROWS, stop_at_eof=True)
        j2.restore(ckpt)
        assert _rows(list(j2)) == _rows(got[2:])
    finally:
        srv.stop()
    assert _rows(got) == [f"row{i:04d}" for i in range(120)]


def test_tcp_stream_reconnect_does_not_duplicate(tmp_path):
    p = tmp_path / "log.tsv"
    p.write_text("".join(f"row{i:04d}\n" for i in range(50)))
    srv = FileStreamServer(str(p), follow=False).start()
    try:
        r = TCPStreamReader("127.0.0.1", srv.port, batch_size=32, parser=ROWS,
                            stop_at_eof=False, reconnect_secs=0.05)
        it = iter(r)
        got = [next(it)]
        with open(p, "a") as f:
            f.write("".join(f"row{i:04d}\n" for i in range(50, 70)))
        got.append(next(it))
        assert r.reconnects >= 1
        it.close()
    finally:
        srv.stop()
    assert _rows(got) == [f"row{i:04d}" for i in range(64)]


def _dead_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_tcp_stream_connect_refused_raises():
    with pytest.raises(OSError):
        list(TCPStreamReader("127.0.0.1", _dead_port(), batch_size=8, stop_at_eof=True))


def test_tcp_reader_counts_reconnect_attempts(tmp_path):
    port = _dead_port()
    r = TCPStreamReader("127.0.0.1", port, batch_size=4, reconnect_secs=0.01,
                        reconnect_max_secs=0.03)
    threading.Thread(target=lambda: next(iter(r), None), daemon=True).start()
    deadline = time.time() + 10
    while r.consecutive_connect_failures < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert r.consecutive_connect_failures >= 3 and r.connect_attempts >= 3
    p = tmp_path / "log.tsv"
    p.write_text("".join(f"r{i}\n" for i in range(8)))
    srv = FileStreamServer(str(p), port=port, follow=True).start()
    try:
        deadline = time.time() + 10
        while r.consecutive_connect_failures != 0 and time.time() < deadline:
            time.sleep(0.01)
        assert r.consecutive_connect_failures == 0
    finally:
        srv.stop()


def test_tcp_backoff_delay_is_the_shared_policy():
    r = TCPStreamReader("127.0.0.1", 1, reconnect_secs=0.5, reconnect_max_secs=8.0)
    jr = JaxTCP("127.0.0.1", 1, reconnect_secs=0.5, reconnect_max_secs=8.0)
    for attempt in (0, 1, 2, 3, 5, 50):
        assert r.backoff_delay(attempt) == backoff.backoff_delay(attempt, 0.5, 8.0) \
            == jr.backoff_delay(attempt)


@pytest.mark.parametrize("case", [
    dict(giant=b"X" * 5000, at=4, n=8, B=4, cap=2048, tail=False),
    dict(giant=b"Y" * 100_000, at=2, n=4, B=2, cap=1024, tail=False),
    dict(giant=b"Q" * 50_000, at=3, n=3, B=2, cap=1024, tail=True),
], ids=["terminated", "unterminated", "tail_at_eof"])
def test_tcp_reader_skips_oversized_frames_like_jax(tmp_path, case):
    good = [_line(dense=(f"{i}.0", "1.0")).encode() for i in range(case["n"])]
    if case["tail"]:
        content = b"\n".join(good) + b"\n" + case["giant"]
    else:
        content = b"\n".join(good[:case["at"]] + [case["giant"]] + good[case["at"]:]) + b"\n"
    srv = _serve(tmp_path, content)
    try:
        kw = dict(batch_size=case["B"], num_dense=ND, num_cat=NC, stop_at_eof=True,
                  max_record_bytes=case["cap"])
        r, jr = TCPStreamReader("127.0.0.1", srv.port, **kw), JaxTCP("127.0.0.1", srv.port, **kw)
        got, want = list(r), list(jr)
    finally:
        srv.stop()
    assert_batches_equal(got, want, "oversized")
    assert sum(b["label"].shape[0] for b in got) == case["n"]
    assert r.oversized_frames == jr.oversized_frames == 1
    assert r.record_errors.counts == jr.record_errors.counts == {"oversized_frame": 1}
    assert r.offset == jr.offset == len(content)


def test_tcp_reader_undecodable_record_counted_not_fatal(tmp_path):
    rows = [_line().encode(), "1\tbad\tworse\t\x00\t\x01".encode(), _line().encode(),
            _line().encode()]
    srv = _serve(tmp_path, b"\n".join(rows) + b"\n")
    try:
        kw = dict(batch_size=4, num_dense=ND, num_cat=NC, stop_at_eof=True)
        r, jr = TCPStreamReader("127.0.0.1", srv.port, **kw), JaxTCP("127.0.0.1", srv.port, **kw)
        got, want = list(r), list(jr)
    finally:
        srv.stop()
    assert_batches_equal(got, want, "undecodable")
    assert r.record_errors.counts == jr.record_errors.counts and r.record_errors.total >= 1


def test_tcp_reader_offsets_resume_past_skipped_frames(tmp_path):
    good = [_line(dense=(f"{i}.0", "1.0")).encode() for i in range(6)]
    content = b"\n".join(good[:2] + [b"Z" * 4000] + good[2:]) + b"\n"
    srv = _serve(tmp_path, content)
    try:
        kw = dict(batch_size=2, num_dense=ND, num_cat=NC, stop_at_eof=True,
                  max_record_bytes=1024)
        r1 = TCPStreamReader("127.0.0.1", srv.port, **kw)
        it = iter(r1)
        assert next(it)["I1"][:, 0].tolist() == [0.0, 1.0]
        saved = r1.save()
        it.close()
        r2 = TCPStreamReader("127.0.0.1", srv.port, **kw)
        r2.restore(saved)
        rest = np.concatenate([b["I1"][:, 0] for b in r2])
    finally:
        srv.stop()
    assert sorted(rest.tolist()) == [2.0, 3.0, 4.0, 5.0]


@pytest.mark.parametrize("args", [(1, 0.5, 8.0), (2, 0.5, 8.0), (5, 0.5, 8.0), (0, 0.5, 8.0),
                                  (-3, 0.5, 8.0), (10 ** 6, 0.25, 30.0), (9, 0.2, 1e9, 8),
                                  (4, 2.0, 1e9, 10)])
def test_backoff_delay_matches_jax(args):
    assert backoff.backoff_delay(*args) == jbackoff.backoff_delay(*args)


def test_backoff_jitter_and_seeded_rng_match_jax():
    for attempt in (1, 3, 7, 40):
        assert backoff.jittered_backoff(attempt, 0.5, 8.0, random.Random(3)) == \
            jbackoff.jittered_backoff(attempt, 0.5, 8.0, random.Random(3))
    vals = [backoff.jittered(10.0, random.Random(i)) for i in range(500)]
    assert all(5.0 <= v < 15.0 for v in vals) and max(vals) - min(vals) > 8.0
    assert backoff.seeded_rng("h", 1).random() == jbackoff.seeded_rng("h", 1).random()
    assert backoff.seeded_rng("h", 1, pid=9).random() != backoff.seeded_rng("h", 1).random()
    assert backoff.MAX_EXPONENT == jbackoff.MAX_EXPONENT
