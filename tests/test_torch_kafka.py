"""The port's Kafka consumer held against the JAX package on the CPU, over
tests/test_kafka.py's scripted broker (real Kafka frames on a real
socket): `parse_records` on both record encodings, `KafkaClient`'s
ApiVersions / Metadata / ListOffsets / Fetch answers equal to the JAX
client's, and `KafkaStreamReader` yielding the JAX reader's batches with
its exactly-once save / restore, group commit and resume, the bounded
`topic:partition:offset:limit` spec, leader resolution and failover, and
the retention gap (raise, or reset to earliest)."""
import numpy as np
import pytest
import torch

from deeprec_tpu.data import kafka as jk
from deeprec_tpu_torch.data import kafka as tk

from test_kafka import TOPIC, BrokerStub, message_set_v1, record_batch_v2, tsv_rows  # noqa: E402
from test_torch_readers import assert_batches_equal  # noqa: E402  (shared helpers)

torch.set_num_threads(1)

KW = dict(stop_at_eof=True, num_dense=2, num_cat=2)


def _both(broker_port, spec, **kw):
    """(port batches, JAX batches, port reader state) of one consume."""
    out = []
    for mod in (tk, jk):
        r = mod.KafkaStreamReader(f"127.0.0.1:{broker_port}", spec, **dict(KW, **kw))
        out.append(list(r))
        state = r.save() if mod is tk else state
        r.close()
    return out[0], out[1], state


@pytest.mark.parametrize("encoding", ["v1", "v2"])
def test_parse_records_matches_jax(encoding):
    enc = message_set_v1 if encoding == "v1" else record_batch_v2
    blob = enc(tsv_rows(9), 40) + enc(tsv_rows(3), 49)
    assert tk.parse_records(blob) == jk.parse_records(blob)
    assert [o for o, _, _ in tk.parse_records(blob)] == list(range(40, 52))


def test_compressed_batch_raises():
    blob = bytearray(record_batch_v2([b"x"], 0))
    blob[21], blob[22] = 0, 1  # gzip
    with pytest.raises(ValueError, match="compress"):
        tk.parse_records(bytes(blob))


@pytest.mark.parametrize("encoding", ["v1", "v2"])
def test_client_matches_jax(encoding):
    broker = BrokerStub(tsv_rows(20), encoding=encoding, page=20)
    try:
        c, jc = tk.KafkaClient("127.0.0.1", broker.port), jk.KafkaClient("127.0.0.1", broker.port)
        assert c.api_versions() == jc.api_versions() and 1 in c.api_versions()
        assert c.metadata([TOPIC]) == jc.metadata([TOPIC])
        assert c.metadata([TOPIC])[1][TOPIC]["partitions"][0]["leader"] == 0
        assert (c.list_offsets(TOPIC, 0, -2), c.list_offsets(TOPIC, 0, -1)) == (0, 20)
        hw, recs = c.fetch(TOPIC, 0, 5)
        assert (hw, recs) == jc.fetch(TOPIC, 0, 5)
        assert [o for o, _, _ in recs] == list(range(5, 20)) and recs[0][2] == tsv_rows(20)[5]
        c.close()
        jc.close()
    finally:
        broker.stop()


@pytest.mark.parametrize("encoding,page", [("v2", 7), ("v1", 100)])
def test_reader_matches_jax_and_resumes_exactly_once(encoding, page):
    rows = tsv_rows(100)
    broker = BrokerStub(rows, encoding=encoding, page=page)
    try:
        got, want, state = _both(broker.port, f"{TOPIC}:0:0", batch_size=16)
        assert_batches_equal(got, want, "full consume")
        assert state["offset"] == 100
        r = tk.KafkaStreamReader(f"127.0.0.1:{broker.port}", f"{TOPIC}:0:0", batch_size=16, **KW)
        it = iter(r)
        head = [next(it) for _ in range(3)]
        state = r.save()
        assert state["offset"] == 48
        r.close()
        r2 = tk.KafkaStreamReader(f"127.0.0.1:{broker.port}", f"{TOPIC}:0:0", batch_size=16, **KW)
        r2.restore(state)
        rest = list(r2)
        r2.close()
        j2 = jk.KafkaStreamReader(f"127.0.0.1:{broker.port}", f"{TOPIC}:0:0", batch_size=16, **KW)
        j2.restore(state)
        assert_batches_equal(rest, list(j2), "resumed")
        j2.close()
        assert_batches_equal(head + rest, want, "head + rest")
        assert rest[0]["I1"][0, 0] == 48.5
    finally:
        broker.stop()


def test_reader_group_commit_resume():
    broker = BrokerStub(tsv_rows(40), encoding="v1", page=40)
    try:
        reader = tk.KafkaStreamReader(f"127.0.0.1:{broker.port}", topic=TOPIC, offset=0,
                                      batch_size=10, group="trainers", **KW)
        it = iter(reader)
        next(it)
        next(it)
        reader.commit()
        assert broker.committed["trainers"] == 20
        reader.close()
        got, want, _ = _both(broker.port, None, topic=TOPIC, offset=-1, batch_size=10,
                             group="trainers")
        assert_batches_equal(got, want, "group resume")
        assert sum(b["label"].shape[0] for b in got) == 20 and got[0]["I1"][0, 0] == 20.5
    finally:
        broker.stop()


def test_reader_limit_matches_reference_spec():
    broker = BrokerStub(tsv_rows(50), encoding="v2", page=50)
    try:
        got, want, _ = _both(broker.port, f"{TOPIC}:0:10:30", batch_size=8)
        assert_batches_equal(got, want, "limit")
        assert sum(b["label"].shape[0] for b in got) == 20 and got[0]["I1"][0, 0] == 10.5
    finally:
        broker.stop()


def test_reader_resolves_partition_leader_via_metadata():
    leader = BrokerStub(tsv_rows(30), encoding="v2", page=30)
    boot = BrokerStub([], fetch_err=6, leader_addr=("127.0.0.1", leader.port))
    try:
        reader = tk.KafkaStreamReader(f"127.0.0.1:{boot.port}", f"{TOPIC}:0:0", batch_size=10,
                                      **KW)
        out = list(reader)
        reader.close()
        assert sum(b["label"].shape[0] for b in out) == 30
        assert 1 not in [k for k, _ in boot.requests]
        assert any(k == 1 for k, _ in leader.requests)
    finally:
        boot.stop()
        leader.stop()


def test_reader_reresolves_leader_on_not_leader_error():
    rows = tsv_rows(40)
    new_leader = BrokerStub(rows, encoding="v2", page=40)
    old_leader = BrokerStub(rows, encoding="v2", page=10)
    try:
        reader = tk.KafkaStreamReader(f"127.0.0.1:{old_leader.port}", f"{TOPIC}:0:0",
                                      batch_size=10, reconnect_secs=0.01, **KW)
        it = iter(reader)
        assert next(it)["I1"][0, 0] == 0.5
        old_leader.fetch_err = 6
        old_leader.leader_addr = ("127.0.0.1", new_leader.port)
        rest = list(it)
        reader.close()
        assert sum(b["label"].shape[0] for b in rest) == 30 and rest[0]["I1"][0, 0] == 10.5
    finally:
        old_leader.stop()
        new_leader.stop()


def test_reader_offset_out_of_range_raises_or_resets():
    broker = BrokerStub(tsv_rows(50), encoding="v2", page=50, earliest=20)
    try:
        reader = tk.KafkaStreamReader(f"127.0.0.1:{broker.port}", f"{TOPIC}:0:5",
                                      batch_size=10, **KW)
        with pytest.raises(tk.KafkaOffsetGapError, match="retention"):
            list(reader)
        reader.close()
        got, want, _ = _both(broker.port, f"{TOPIC}:0:5", batch_size=10, offset_reset="earliest")
        assert_batches_equal(got, want, "reset earliest")
        assert sum(b["label"].shape[0] for b in got) == 30 and got[0]["I1"][0, 0] == 20.5
    finally:
        broker.stop()


def test_error_types_and_codes_match_jax():
    assert issubclass(tk.KafkaError, RuntimeError) and issubclass(tk.KafkaOffsetGapError,
                                                                   RuntimeError)
    for name in ("API_FETCH", "API_LIST_OFFSETS", "API_METADATA", "API_OFFSET_COMMIT",
                 "API_OFFSET_FETCH", "API_VERSIONS", "ERR_OFFSET_OUT_OF_RANGE", "ERR_NOT_LEADER"):
        assert getattr(tk, name) == getattr(jk, name)
    assert np.array_equal(tk.parse_records(b""), jk.parse_records(b""))
