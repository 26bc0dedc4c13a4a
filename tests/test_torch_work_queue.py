"""The port's `WorkQueue` held against the JAX package on the CPU: the same
items for every epoch, shuffle seed and slice count; `parse_slice`;
`input_dataset` over the port's native `CriteoCSVReader` delivering the
JAX queue's batches bit for bit (sliced files covered exactly once);
save / restore within and across the two packages (the cursor is recorded
at take time, as in the reference); the fcntl-coordinated mode with
disjoint takers; and the torn-write tests of the coordination file."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from deeprec_tpu.data import WorkQueue as JaxWorkQueue
from deeprec_tpu.data import parse_slice as jax_parse_slice
from deeprec_tpu_torch.data import CriteoCSVReader, WorkQueue, parse_slice

from test_torch_readers import assert_batches_equal, write_tsv  # noqa: E402  (shared helpers)

torch.set_num_threads(1)


@pytest.mark.parametrize("epochs,shuffle,slices,seed", [
    (1, False, 1, 0), (2, True, 2, 3), (3, True, 1, 7), (1, True, 4, 11)])
def test_items_match_jax(epochs, shuffle, slices, seed):
    works = ["a", "b", "c", "d/e.tsv"]
    q = WorkQueue(works, num_epochs=epochs, shuffle=shuffle, num_slices=slices, seed=seed)
    jq = JaxWorkQueue(works, num_epochs=epochs, shuffle=shuffle, num_slices=slices, seed=seed)
    assert q.size() == jq.size() == epochs * slices * len(works)
    items = list(q)
    assert items == list(jq)
    assert q.take() is None and q.size() == 0
    for item in items:
        assert parse_slice(item) == jax_parse_slice(item)
        path, k, n = parse_slice(item)
        assert path in works and n == slices and 0 <= k < n


def test_parse_slice():
    assert parse_slice("x/y.tsv") == ("x/y.tsv", 0, 1)
    assert parse_slice("a#b.tsv#2/5") == ("a#b.tsv", 2, 5)


@pytest.mark.parametrize("slices", [1, 3])
def test_input_dataset_matches_jax_and_covers_the_file(tmp_path, slices):
    p = write_tsv(tmp_path / "day0.tsv", 300, seed=2)
    got = list(WorkQueue([p], shuffle=False, num_slices=slices).input_dataset(batch_size=32))
    want = list(JaxWorkQueue([p], shuffle=False, num_slices=slices).input_dataset(batch_size=32))
    assert_batches_equal(got, want, f"slices={slices}")
    assert sum(len(b["label"]) for b in got) == 300
    full = np.concatenate([b["label"] for b in CriteoCSVReader([p], 32, drop_remainder=False)])
    np.testing.assert_array_equal(np.concatenate([b["label"] for b in got]), full)


def test_input_dataset_drop_remainder_per_item(tmp_path):
    paths = [write_tsv(tmp_path / f"d{i}.tsv", 250, seed=i) for i in range(2)]
    got = list(WorkQueue(paths, num_slices=2, seed=1).input_dataset(64, drop_remainder=True))
    want = list(JaxWorkQueue(paths, num_slices=2, seed=1).input_dataset(64, drop_remainder=True))
    assert_batches_equal(got, want, "drop_remainder")
    assert all(len(b["label"]) == 64 for b in got)


def test_save_restore_and_across_packages():
    q = WorkQueue(["a", "b", "c"], shuffle=False)
    assert q.take() == "a"
    st = q.save()
    assert q.take() == "b"
    q.restore(st)
    assert q.take() == "b"
    # a JAX position restores into the port and back (same JSON)
    jq = JaxWorkQueue(["x"], shuffle=False)
    jq.restore(json.loads(json.dumps(q.save())))
    assert jq.take() == "c"
    q2 = WorkQueue(["y"], shuffle=False)
    q2.restore(JaxWorkQueue(["a", "b", "c"], shuffle=False).save())
    assert list(q2) == ["a", "b", "c"]


def test_save_records_the_cursor_at_take_time(tmp_path):
    """An item handed to input_dataset counts as taken when its reader
    starts: a save mid-item resumes at the NEXT item (the rest of the item
    in flight is not replayed) — the reference's behaviour, kept."""
    paths = [write_tsv(tmp_path / f"d{i}.tsv", 200, seed=i) for i in range(3)]
    for mod in (WorkQueue, JaxWorkQueue):
        q = mod(paths, shuffle=False)
        it = q.input_dataset(batch_size=50)
        next(it)
        st = q.save()
        assert st["cursor"] == 1
        q2 = mod(paths, shuffle=False)
        q2.restore(st)
        assert list(q2) == paths[1:]


def test_file_coordinated_takers_are_disjoint(tmp_path):
    coord = str(tmp_path / "wq.json")
    items = [f"f{i}" for i in range(30)]
    queues = [WorkQueue(items, shuffle=False, coordination_file=coord),
              WorkQueue(items, shuffle=False, coordination_file=coord),
              JaxWorkQueue(items, shuffle=False, coordination_file=coord)]
    taken = [[] for _ in queues]

    def worker(i):
        while True:
            item = queues[i].take()
            if item is None:
                return
            taken[i].append(item)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(queues))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    got = [x for t in taken for x in t]
    assert sorted(got) == sorted(items) and len(set(got)) == len(items)
    assert queues[0].size() == 0
    assert queues[0].save() == queues[2].save()
    queues[1].restore({"cursor": 28, "items": items})
    assert queues[2].take() == "f28"


def test_torn_cursor_write_never_observed(tmp_path):
    coord = str(tmp_path / "wq.json")
    items = [f"f{i}" for i in range(6)]
    wq1 = WorkQueue(items, shuffle=False, coordination_file=coord)
    assert wq1.take() == "f0"

    def torn(f, data):
        f.write(data[: len(data) // 3])
        raise KeyboardInterrupt("injected kill mid-write")

    wq1.on_coord_write = torn
    with pytest.raises(KeyboardInterrupt):
        wq1.take()
    with open(coord) as f:
        assert json.load(f)["cursor"] == 1
    assert not list(tmp_path.glob(".wq-*.tmp"))
    wq2 = WorkQueue(items, shuffle=False, coordination_file=coord)
    assert wq2.take() == "f1"
    wq1.on_coord_write = None
    assert wq1.take() == "f2"


def test_torn_writes_with_concurrent_takers(tmp_path):
    coord = str(tmp_path / "wq.json")
    items = [f"f{i}" for i in range(40)]
    torn_count = [0]
    wq_a, wq_b, wq_evil = (WorkQueue(items, shuffle=False, coordination_file=coord)
                           for _ in range(3))

    def torn(f, data):
        torn_count[0] += 1
        f.write(data[:7])
        raise KeyboardInterrupt("injected")

    wq_evil.on_coord_write = torn
    taken = [[], []]
    stop = threading.Event()

    def taker(i, wq):
        while True:
            item = wq.take()
            if item is None:
                return
            taken[i].append(item)
            time.sleep(0.001)

    def saboteur():
        while not stop.is_set():
            try:
                wq_evil.take()
            except KeyboardInterrupt:
                pass
            time.sleep(0.002)

    ts = [threading.Thread(target=taker, args=(0, wq_a)),
          threading.Thread(target=taker, args=(1, wq_b))]
    tsab = threading.Thread(target=saboteur, daemon=True)
    for t in ts:
        t.start()
    tsab.start()
    for t in ts:
        t.join(timeout=60)
    stop.set()
    tsab.join(timeout=5)
    assert torn_count[0] >= 1
    got = taken[0] + taken[1]
    assert sorted(got) == sorted(items)
    assert not (set(taken[0]) & set(taken[1]))
