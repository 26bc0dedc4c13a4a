"""The initializer rows of a fresh process: in several fresh CPU processes
(4 intra-op threads each), the first `EmbeddingTable._init_rows` call of
the process at [26, 128] ids x 16 equals a second call bit for bit. On a CPU
with AVX512 dispatch the first vector ops of a process gave one chunk other
bits about 1 process in 40-200 (the op varied); the port holds a CPU
computation of the rows against a second one until the process has computed
rows that large, and a third breaks a tie. The second call here is past that
size, so it is computed once."""
import os
import subprocess
import sys

import pytest
import torch

from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.embedding import table as table_mod
from deeprec_tpu_torch.embedding.table import EmbeddingTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import torch
torch.set_num_threads(4)
from deeprec_tpu_torch.config import TableConfig
from deeprec_tpu_torch.embedding import table as table_mod
from deeprec_tpu_torch.embedding.table import EmbeddingTable
g = torch.Generator().manual_seed(%d)
uids = torch.randint(0, 10**6, (26, 128), generator=g).to(torch.int32)
t = EmbeddingTable(TableConfig(name="x", dim=16, capacity=1024))
a = t._init_rows(uids, torch.arange(26) * 7 + 1)
assert table_mod._cpu_rows_checked == a.numel()
b = t._init_rows(uids, torch.arange(26) * 7 + 1)
print("same" if torch.equal(a, b) else "DIFF")
"""


def test_first_init_rows_equal_the_second_in_fresh_processes():
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", CODE % i], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(8)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e[-2000:] for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["same"] * 8


def _scripted(monkeypatch, results):
    """A table whose f32 rows come from `results` in turn; returns (table,
    the list of calls made)."""
    calls = []

    def rows(self, uids, salt):
        calls.append(1)
        return results[len(calls) - 1]

    monkeypatch.setattr(EmbeddingTable, "_normal_rows", rows)
    return EmbeddingTable(TableConfig(name="x", dim=4, capacity=64)), calls


@pytest.mark.parametrize("seq, want", [("aa", "a"), ("aba", "a"), ("abb", "b"),
                                       ("abc", None)])
def test_cpu_rows_check_votes(monkeypatch, seq, want):
    """Two equal computations are taken; where they differ the third decides
    by agreeing with one; three different ones raise."""
    monkeypatch.setattr(table_mod, "_cpu_rows_checked", 0)
    vals = {c: torch.full((1, 3, 4), float(i)) for i, c in enumerate("abc")}
    t, calls = _scripted(monkeypatch, [vals[c] for c in seq])
    uids = torch.arange(3, dtype=torch.int64)[None]
    if want is None:
        with pytest.raises(RuntimeError, match="disagree"):
            t._init_rows(uids)
    else:
        assert torch.equal(t._init_rows(uids), vals[want])
        assert table_mod._cpu_rows_checked == 12
    assert len(calls) == len(seq)


def test_cpu_rows_checked_until_the_size_was_seen(monkeypatch):
    """Rows no larger than the largest checked ones are computed once; a
    larger call is checked again."""
    monkeypatch.setattr(table_mod, "_cpu_rows_checked", 12)
    small, large = torch.zeros((1, 3, 4)), torch.ones((1, 5, 4))
    t, calls = _scripted(monkeypatch, [small, large, large])
    assert torch.equal(t._init_rows(torch.arange(3)[None]), small)
    assert len(calls) == 1
    assert torch.equal(t._init_rows(torch.arange(5)[None]), large)
    assert len(calls) == 3 and table_mod._cpu_rows_checked == 20
