"""deeprec_tpu_torch.analysis: the port's lint rules on fixture sources in
the port's idiom (positive, negative and suppressed per rule), one
counterpart for each test of tests/test_analysis.py; DRT004-DRT007, which
do not depend on the framework, give the same findings (rule, line,
column) as the JAX package's linter on the same source. Then the checked-in
baseline's integrity, the noqa / baseline gate on the port's own tree, and
the runtime trace-guard over `ops/_build.py`'s build and load counters
(there is no nvcc here: a build is finished through `_build._finish` with a
finished process stand-in, a load goes through `_build.load` on the C
library)."""
import ast
import ctypes
import ctypes.util
import io
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from deeprec_tpu.analysis import lint as jax_lint
from deeprec_tpu_torch.analysis import (
    TraceGuardViolation,
    annotations,
    compile_count,
    trace_count,
    trace_guard,
)
from deeprec_tpu_torch.analysis import lint
from deeprec_tpu_torch.ops import _build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- lint harness


def lint_files(tmp_path, files, rules=None, module=lint):
    """Write {relpath: source} under a temp root, lint it with `module`,
    return (all findings, active findings)."""
    targets = set()
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        targets.add(rel.split("/")[0] if "/" in rel else rel)
    mods = module.collect_modules(str(tmp_path), sorted(targets))
    findings = module.run_rules(mods, rules)
    active, _ = module.split_suppressed(mods, findings)
    return findings, active


def codes(findings):
    return [f.rule for f in findings]


def both(tmp_path, files, rules):
    """The port's and the JAX package's active findings on the same source
    (rule, line, column), asserted equal; returns the port's."""
    _, got = lint_files(tmp_path / "port", files, rules)
    _, want = lint_files(tmp_path / "jax", files, rules, module=jax_lint)
    assert [(f.rule, f.line, f.col) for f in got] == [(f.rule, f.line, f.col) for f in want]
    return got


# ------------------------------------------------------------ DRT001 rule


def test_drt001_flags_per_call_compile_of_lambda_and_closure(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        import torch

        def hot(x):
            f = torch.compile(lambda v: v + 1)   # fresh wrapper per call
            def inner(v):
                return v * 2
            g = torch.jit.script(inner)          # nested closure per call
            return f(x) + g(x)
    """}, rules=["DRT001"])
    assert codes(active) == ["DRT001", "DRT001"]


def test_drt001_flags_per_call_compile_of_module_level_function(tmp_path):
    """Scripting or tracing a STABLE module function per call is the same
    hazard: each call makes a new wrapper and compiles it again."""
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        import torch
        from torch.jit import trace

        def prune(state):
            return state

        def poll(state):
            a = torch.jit.script(prune)(state)   # fresh wrapper per poll
            return trace(prune, (state,))(state)
    """}, rules=["DRT001"])
    assert codes(active) == ["DRT001", "DRT001"]
    assert all("fresh wrapper" in f.message for f in active)


def test_drt001_negative_module_scope_decorator_and_init(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        import torch
        from functools import partial

        top = torch.compile(lambda v: v + 1)     # module scope: compiles once

        @torch.compile
        def decorated(v):
            return v * 2

        @partial(torch.compile, dynamic=False)
        def decorated2(v):
            return v * 3

        class T:
            def __init__(self):
                # idiomatic per-instance compile — allowed
                self._step = torch.compile(self._impl)

            def _impl(self, v):
                return v
    """}, rules=["DRT001"])
    assert active == []


def test_drt001_bound_method_rebuilder_flagged_and_suppressable(tmp_path):
    files = {"pkg/m.py": """
        import torch

        class T:
            def rebuild(self):
                self._step = torch.compile(self._impl)

            def _impl(self, v):
                return v
    """}
    _, active = lint_files(tmp_path, files, rules=["DRT001"])
    assert codes(active) == ["DRT001"]
    files["pkg/m.py"] = files["pkg/m.py"].replace(
        "self._step = torch.compile(self._impl)",
        "self._step = torch.compile(self._impl)  # noqa: DRT001 — deliberate",
    )
    _, active = lint_files(tmp_path, files, rules=["DRT001"])
    assert active == []


def test_drt001_nested_decorator_is_flagged(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        import torch

        def outer(x):
            @torch.compile
            def body(v):
                return v + 1
            return body(x)
    """}, rules=["DRT001"])
    assert codes(active) == ["DRT001"] and "nested" in active[0].message


# ------------------------------------------------------------ DRT002 rule


HOT_PKG = {"pkg/m.py": """
    import numpy as np
    import torch

    class T:
        def train_step(self, state, batch):
            return self._helper(state)

        def _helper(self, state):
            n = state.loss.item()
            rows = state.rows.tolist()
            host = state.keys.cpu()
            torch.cuda.synchronize()
            return float(n), rows, host, bool(state.done)

    def cold(state):
        return np.asarray(state), state.keys.numpy()   # unreachable from any root
"""}


def test_drt002_call_graph_reaches_helper_not_cold(tmp_path):
    _, active = lint_files(tmp_path, HOT_PKG, rules=["DRT002"])
    whats = sorted(f.message.split(" forces")[0] for f in active)
    assert whats == sorted([".item()", ".tolist()", ".cpu()", "torch.cuda.synchronize()",
                            "float()", "bool()"])
    assert all(f.scope == "T._helper" for f in active)


def test_drt002_nested_step_body_is_reachable(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        import numpy as np

        def train_steps(state, batches):
            def body(carry, b):
                host = np.asarray(b)         # sync inside the step body
                return carry, host
            return body(state, batches)
    """}, rules=["DRT002"])
    assert codes(active) == ["DRT002"]
    assert "train_steps" in active[0].message


def test_drt002_suppressed_site_is_inactive_but_reported(tmp_path):
    all_f, active = lint_files(tmp_path, {"pkg/m.py": """
        def predict(probs):
            return probs.cpu()  # noqa: DRT002 — the answer's device-to-host copy
    """}, rules=["DRT002"])
    assert codes(all_f) == ["DRT002"] and active == []


def test_drt002_the_probe_loop_sync_is_a_baselined_finding():
    """The probe loop's `bool(pending.any())` and all_to_all_uneven's count
    reads are real host syncs: baselined, not suppressed."""
    base = "\n".join(lint.load_baseline(lint.default_baseline_path()))
    assert "DRT002|deeprec_tpu_torch/embedding/table.py|EmbeddingTable._probe|" \
           "if not bool(pending.any()):" in base
    assert "DRT002|deeprec_tpu_torch/parallel/mesh.py|all_to_all_uneven|" in base


# ------------------------------------------------------------ DRT003 rule


def test_drt003_small_trailing_dim_and_nonpow2_in_ops_only(tmp_path):
    _, active = lint_files(tmp_path, {
        "pkg/ops/k.py": """
            import torch

            def f(C):
                bad_layout = torch.zeros((C, 3))      # 12-byte rows
                bad_varargs = torch.empty(C, 2)       # 8-byte rows
                good_layout = torch.zeros((3, C))
                bad_bucket = torch.zeros(24)          # non-pow2 static
                good_bucket = torch.full((32,), 0.0)
                return bad_layout, bad_varargs, good_layout, bad_bucket, good_bucket
        """,
        # identical code OUTSIDE ops//embedding/ is not layout-lintable
        "pkg/serving/k.py": """
            import torch

            def f(C):
                return torch.zeros((C, 3)), torch.zeros(24)
        """,
    }, rules=["DRT003"])
    assert codes(active) == ["DRT003"] * 3
    assert all("ops/k.py" in f.path for f in active)
    assert "cannot use one vector load" in active[0].message
    assert "TPU" not in active[0].message and "lane" not in active[0].message


def test_drt003_numpy_host_arrays_not_flagged(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/ops/k.py": """
        import numpy as np

        def f(C):
            return np.zeros((C, 3)), np.zeros((24,))   # host memory: fine
    """}, rules=["DRT003"])
    assert active == []


# ------------------------------------------------------------ DRT004 rule


THREADED_PKG = {"pkg/m.py": """
    import threading
    from deeprec_tpu_torch.analysis.annotations import guarded_by, not_thread_safe

    @not_thread_safe
    class Store:
        def put(self, k, v):
            pass

    @guarded_by("_lock")
    class Stats:
        def __init__(self):
            self._lock = threading.Lock()
            self.count = 0

        def bump(self):
            with self._lock:
                self.count += 1

    class Owner:
        def __init__(self):
            self.store = Store()
            self.stats = Stats()
            self._t = threading.Thread(target=self._worker)

        def _worker(self):
            self.store.put(1, 2)             # NTS from a thread: flagged
            self.stats.bump()                # guarded METHOD call: fine
            self.stats.count = 5             # guarded FIELD write: flagged
            with self.stats._lock:
                self.stats.count = 6         # lock held: fine

        def main_thread_path(self):
            self.store.put(3, 4)             # not a thread entry: fine
"""}


def test_drt004_thread_entry_vs_main_and_lock_semantics(tmp_path):
    active = both(tmp_path, THREADED_PKG, ["DRT004"])
    assert codes(active) == ["DRT004", "DRT004"]
    assert all(f.scope == "Owner._worker" for f in active)
    msgs = " / ".join(f.message for f in active)
    assert "not_thread_safe" in msgs and "guarded_by" in msgs


def test_drt004_nts_access_flagged_even_under_an_unrelated_lock(tmp_path):
    pkg = dict(THREADED_PKG)
    pkg["pkg/m.py"] = pkg["pkg/m.py"].replace(
        "self.store.put(1, 2)             # NTS from a thread: flagged",
        "with self.stats._lock:\n"
        "                self.store.put(1, 2)  # wrong lock: still flagged",
    )
    active = both(tmp_path, pkg, ["DRT004"])
    assert [f.rule for f in active if "not_thread_safe" in f.message] == ["DRT004"]


def test_drt004_annotated_method_call_from_writer_thread(tmp_path):
    active = both(tmp_path, {"pkg/m.py": """
        import threading
        from deeprec_tpu_torch.analysis.annotations import not_thread_safe

        class CK:
            def save_async(self):
                t = threading.Thread(target=self._writer_main)
                t.start()

            def _writer_main(self):
                self._write_plan()           # flagged

            @not_thread_safe
            def _write_plan(self):
                pass

            def save_sync(self):
                self._write_plan()           # main thread: fine
    """}, ["DRT004"])
    assert codes(active) == ["DRT004"]
    assert active[0].scope == "CK._writer_main"


# ------------------------------------------------- DRT005 / DRT006 hygiene


def test_drt005_unused_import_pos_neg_and_init_exempt(tmp_path):
    active = both(tmp_path, {
        "pkg/m.py": """
            import os
            import torch

            def f():
                return torch.zeros(2)
        """,
        "pkg/__init__.py": "from pkg.m import f\nimport os\n",  # re-export surface
    }, ["DRT005"])
    assert codes(active) == ["DRT005"]
    assert "'os'" in active[0].message and "m.py" in active[0].path


def test_drt006_param_shadowing(tmp_path):
    active = both(tmp_path, {"pkg/m.py": """
        import torch

        def f(id, torch, name):
            return id, torch, name
    """}, ["DRT006"])
    assert sorted(f.message for f in active) == [
        "parameter 'id' shadows a builtin",
        "parameter 'torch' shadows a module import",
    ]


# ------------------------------------------------------------ DRT007 rule


def test_drt007_flags_per_request_label_values(tmp_path):
    active = both(tmp_path, {"pkg/m.py": """
        def serve(reg, metric, user_id, raw_key, fn):
            reg.counter("hits", "h", {"user": user_id}).inc()
            reg.gauge("g", "h", labels={"key": f"k-{raw_key}"}).set(1)
            reg.histogram("lat", "h", {"who": str(user_id)})
            reg.register_callback("cb", fn, "h", {"req": raw_key})
            metric.labels(user=user_id).inc()
    """}, ["DRT007"])
    assert codes(active) == ["DRT007"] * 5
    assert all("unbounded" in f.message for f in active)


def test_drt007_negatives_bounded_label_sets(tmp_path):
    active = both(tmp_path, {"pkg/m.py": """
        STAGES = ("queue", "pad", "device", "post")

        def wire(reg, tname, labels):
            reg.counter("ok", "h", {"stage": "queue"}).inc()
            for s in STAGES:
                reg.histogram("lat", "h", {"stage": s})
            for i in range(8):
                reg.gauge("xb", "h", {"table": tname, "shard": str(i)})
            reg.counter("opaque", "h", labels)   # not a literal: skip
    """}, ["DRT007"])
    assert active == []


def test_drt007_suppressable_and_repo_is_clean(tmp_path):
    _, active = lint_files(tmp_path, {"pkg/m.py": """
        def serve(reg, user_id):
            reg.counter("hits", "h", {"user": user_id}).inc()  # noqa: DRT007 — bounded: user_id is a 4-way experiment arm
    """}, rules=["DRT007"])
    assert active == []
    mods = lint.collect_modules(lint.repo_root(), lint.DEFAULT_TARGETS)
    repo_active, _ = lint.split_suppressed(mods, lint.run_rules(mods, ["DRT007"]))
    assert repo_active == []


# ------------------------------------------- repo baseline + gate mechanics


def test_repo_check_is_green():
    """The port's tree passes its own gate."""
    buf = io.StringIO()
    assert lint.check(out=buf) == 0, buf.getvalue()


def test_cli_check_exits_zero_and_lint_imports_no_framework():
    """`python -m deeprec_tpu_torch.analysis --check` exits 0; lint.py
    imports neither torch nor jax, and the package neither jax nor the JAX
    package."""
    r = subprocess.run([sys.executable, "-m", "deeprec_tpu_torch.analysis", "--check"],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "analysis: ok" in r.stdout
    tree = ast.parse(open(lint.__file__, encoding="utf-8").read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert not names & {"torch", "jax", "deeprec_tpu"}, names
    pkg = os.path.dirname(lint.__file__)
    for f in os.listdir(pkg):
        if f.endswith(".py"):
            src = open(os.path.join(pkg, f), encoding="utf-8").read()
            assert "import jax" not in src and "from deeprec_tpu." not in src \
                and "from deeprec_tpu import" not in src, f


def test_baseline_parses_and_every_entry_is_current():
    import re

    base = lint.load_baseline(lint.default_baseline_path())
    assert base, "baseline should carry the pre-existing DRT002 sites"
    gram = re.compile(r"^DRT\d{3}\|[^|]+\.py\|[^|]+\|.*$")
    for entry in base:
        assert gram.match(entry), f"malformed baseline entry: {entry}"
    mods = lint.collect_modules(lint.repo_root(), lint.DEFAULT_TARGETS)
    active, _ = lint.split_suppressed(mods, lint.run_rules(mods))
    current = set(lint.fingerprints(active))
    stale = set(base) - current
    assert not stale, f"stale baseline entries: {sorted(stale)[:5]}"


def test_removing_a_known_noqa_fails_the_check():
    """The suppressed sites are live gates: stripping one justification
    noqa from the port's source flips the check to nonzero."""
    path = "deeprec_tpu_torch/embedding/multi_tier.py"
    src = open(os.path.join(lint.repo_root(), path), encoding="utf-8").read()
    marker = ("  # noqa: DRT004 — worker owns the tier stores until "
              "_settle(); every other path drains first")
    assert marker in src, "known suppressed site moved — update this pin"
    buf = io.StringIO()
    rc = lint.check(source_overrides={path: src.replace(marker, "", 1)}, out=buf)
    assert rc != 0
    assert "DRT004" in buf.getvalue() and "_worker_main" in buf.getvalue()


def test_new_violation_fails_and_fix_baseline_would_accept(tmp_path):
    """A brand-new hot-path sync in the port's source fails --check, naming
    the file and rule; --fix-baseline into another file accepts it."""
    path = "deeprec_tpu_torch/serving/predictor.py"
    src = open(os.path.join(lint.repo_root(), path), encoding="utf-8").read()
    anchor = ("    def predict(self, batch: Dict[str, np.ndarray], group_users: bool = False):\n"
              '        """Probabilities [B] (numpy) for one batch; a {task: probabilities}\n'
              '        dict for a multi-task model."""\n')
    assert anchor in src
    over = {path: src.replace(anchor, anchor + "        _ = np.asarray(batch)\n", 1)}
    buf = io.StringIO()
    assert lint.check(source_overrides=over, out=buf) != 0
    out = buf.getvalue()
    assert "NEW finding" in out and "DRT002" in out and "predictor.py" in out
    fixed = tmp_path / "baseline.txt"
    assert lint.check(source_overrides=over, baseline_path=str(fixed), fix_baseline=True,
                      out=io.StringIO()) == 0
    assert lint.check(source_overrides=over, baseline_path=str(fixed), out=io.StringIO()) == 0


def test_stale_baseline_entry_fails_check(tmp_path):
    stale_baseline = tmp_path / "baseline.txt"
    base = lint.load_baseline(lint.default_baseline_path())
    stale_baseline.write_text(
        "\n".join(base + ["DRT002|deeprec_tpu_torch/gone.py|f|x = y.item()"]) + "\n")
    buf = io.StringIO()
    assert lint.check(baseline_path=str(stale_baseline), out=buf) != 0
    assert "STALE" in buf.getvalue()


def test_annotations_runtime_metadata():
    @annotations.not_thread_safe
    class A:
        pass

    @annotations.guarded_by("_lock")
    class B:
        pass

    assert annotations.is_not_thread_safe(A)
    assert not annotations.is_not_thread_safe(B)
    assert annotations.guard_lock_of(B) == "_lock"
    assert annotations.guard_lock_of(A) is None
    # the port's own markers, where the JAX package places them
    from deeprec_tpu_torch.embedding.multi_tier import DiskKV
    from deeprec_tpu_torch.native import HostKV
    from deeprec_tpu_torch.serving.stats import ServingStats
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    assert annotations.is_not_thread_safe(DiskKV) and annotations.is_not_thread_safe(HostKV)
    assert annotations.is_not_thread_safe(CheckpointManager._write_plan)
    assert annotations.guard_lock_of(ServingStats) == "_lock"


# ----------------------------------------------------------- trace guard


class _Done:
    """A finished nvcc process."""

    returncode = 0

    def communicate(self):
        return b"", None


def _fake_build(tmp_path, i):
    """One build through `_build._finish` (the library file moved into
    place and counted), without nvcc."""
    tmp = tmp_path / f"lib{i}.tmp.so"
    tmp.write_bytes(b"")
    _build._finish("fake", (_Done(), tmp, tmp_path / f"lib{i}.so"))


def test_trace_guard_steady_state_training_is_build_free():
    """A warmed K-step window builds and loads nothing (on the CPU the
    wrappers run their plain versions: there is nothing to build)."""
    from deeprec_tpu_torch.data import SyntheticCriteo
    from deeprec_tpu_torch.models import WDL
    from deeprec_tpu_torch.optim import Adagrad
    from deeprec_tpu_torch.training.trainer import Trainer

    tr = Trainer(WDL(emb_dim=4, capacity=512, hidden=(8,), num_cat=3, num_dense=2),
                 Adagrad(lr=0.1), device="cpu")
    gen = SyntheticCriteo(batch_size=32, num_cat=3, num_dense=2, vocab=300, seed=7)
    batches = [gen.batch() for _ in range(4)]
    state = tr.init(0)
    state, _ = tr.train_steps(state, batches[:2])
    with trace_guard(max_compiles=0, note="steady-state K-step") as g:
        for _ in range(2):
            state, mets = tr.train_steps(state, batches[2:])
    assert g.compiles == 0 and g.traces == 0
    assert torch.isfinite(mets["loss"]).all()


def test_trace_guard_catches_a_build_inside_the_region(tmp_path):
    """A kernel built inside a guarded region (a source left unbuilt at
    set-up) is CAUGHT, with the count on the exception."""
    with pytest.raises(TraceGuardViolation) as ei:
        with trace_guard(max_compiles=0, note="build regression"):
            for i in range(3):
                _fake_build(tmp_path, i)
    assert ei.value.compiles == 3 and ei.value.max_compiles == 0
    assert "build regression" in str(ei.value)


def test_trace_guard_budget_and_measure_only_modes(tmp_path, monkeypatch):
    with trace_guard(max_compiles=2) as g:
        _fake_build(tmp_path, 0)
    assert g.compiles == 1
    # a first library load counts as a trace, not a build
    monkeypatch.setitem(_build._SIGNATURES, "fake", {"abs": [ctypes.c_int]})
    monkeypatch.setattr(_build, "_lib_path", lambda name: ctypes.util.find_library("c"))
    monkeypatch.setattr(_build, "_start", lambda name: None)
    try:
        with trace_guard(max_compiles=0) as g:
            _build.load("fake")
            _build.load("fake")  # loaded once
        assert (g.compiles, g.traces) == (0, 1)
    finally:
        _build._libs.pop("fake", None)
    # measure only: never raises however many builds land
    with trace_guard(max_compiles=None) as g:
        _fake_build(tmp_path, 1)
        _fake_build(tmp_path, 2)
    assert g.compiles == 2
    assert compile_count() >= g.compiles and trace_count() >= 1


def test_trace_guard_does_not_mask_body_exceptions(tmp_path):
    with pytest.raises(ValueError, match="body failed"):
        with trace_guard(max_compiles=0):
            _fake_build(tmp_path, 0)  # would violate
            raise ValueError("body failed")
