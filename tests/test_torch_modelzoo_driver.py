"""The port's modelzoo driver (`deeprec_tpu_torch/modelzoo/`) against
`modelzoo/common.py` on the CPU: `run()` at small widths from one step-0
checkpoint written by the JAX trainer and copied to both (per-step losses
within test_torch_training's RTOL, the final AUC within AUC_ATOL), the flag
surface and its defaults, every registry name's model and per-model
defaults against `modelzoo/<model>/train.py`, `make_data`'s batches for
every data kind against the JAX driver's, `--sharded` refused naming ROADMAP
queue A item 6, the CUDA default refused off CUDA, and the
`python -m deeprec_tpu_torch.modelzoo` command line.

AUC_ATOL: both AUCs come from the same 200-bin histogram over probabilities
that agree within PROB_ATOL (tests/test_torch_serving.py), so a prediction
next to a bin edge can move one bin: 2e-3 over 128 eval rows."""
import ast
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeprec_tpu.models import registry as jregistry
from deeprec_tpu_torch.modelzoo import common as zoo

from test_torch_readers import assert_batches_equal, write_tsv  # noqa: E402
from test_torch_training import RTOL  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO_DIR = os.path.join(REPO, "modelzoo")
AUC_ATOL = 2e-3
ALIASES = {"wdl": "wide_and_deep", "dlrm_dcn": "mlperf"}


@pytest.fixture(scope="module")
def jax_zoo():
    """The JAX driver, `modelzoo/common.py`, imported from its directory."""
    sys.path.insert(0, ZOO_DIR)
    try:
        import common as jcommon
    finally:
        sys.path.remove(ZOO_DIR)
    assert os.path.dirname(jcommon.__file__) == ZOO_DIR
    return jcommon


def _train_py(name):
    """(data kind, defaults) of `main(...)` in modelzoo/<name>/train.py, and
    the model class its model_fn builds, read from the source."""
    with open(os.path.join(ZOO_DIR, name, "train.py")) as f:
        tree = ast.parse(f.read())
    kind, defaults, cls = None, {}, None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "main":
            kind = ast.literal_eval(node.args[2])
            for kw in node.keywords:
                if kw.arg == "defaults":
                    defaults = ast.literal_eval(kw.value)
        if isinstance(node, ast.ImportFrom) and node.module == "deeprec_tpu.models":
            cls = node.names[0].name
    return kind, defaults, cls


def test_flags_match_the_jax_driver(jax_zoo):
    """The 32 flags of modelzoo/common.py with their defaults (the trace
    directory under the temporary directory), plus --model and --device."""
    jp, pp = jax_zoo.build_argparser("x"), zoo.build_argparser("x")
    jflags = {a.dest: a.default for a in jp._actions if a.dest != "help"}
    pflags = {a.dest: a.default for a in pp._actions if a.dest != "help"}
    assert len(jflags) == 32
    assert set(pflags) == set(jflags) | {"model", "device"}
    for k, v in jflags.items():
        if k != "timeline_dir":
            assert pflags[k] == v, k
    assert pflags["device"] == "cuda"
    jchoices = {a.dest: a.choices for a in jp._actions}
    assert {a.dest: a.choices for a in pp._actions if a.dest in jchoices} == jchoices


@pytest.mark.parametrize("name", sorted(jregistry.REGISTRY))
def test_every_registry_name_builds_and_parses(name):
    """Each of the 18 names parses with its train.py's defaults and data
    kind and builds the class that train.py builds (the registry's class
    for the aliases), at its emb_dim and capacity."""
    kind, defaults, cls = _train_py(ALIASES.get(name, name))
    assert zoo.MODELS[name] == (kind, defaults)
    p = zoo.build_argparser(name)
    p.set_defaults(model=name, **zoo.MODELS[name][1])
    args = p.parse_args(["--capacity", "256", "--filter_freq", "2"])
    for k, v in defaults.items():
        assert getattr(args, k) == v
    model = zoo.model_fn(name, args)
    assert type(model).__name__ == cls == jregistry.REGISTRY[name].__name__
    tables = [f.table for f in model.features if getattr(f, "table", None) is not None]
    assert tables and all(t.dim == 16 and t.capacity == 256 for t in tables)
    assert all(t.ev.counter_filter.filter_freq == 2 for t in tables)


def test_sharded_raises_naming_item_6():
    """`--sharded` is ported (queue A item 6a): in one process without a
    launcher it trains a ShardedTrainer of one position, whose losses stay
    within 1e-3 of the unsharded run's (the bf16 exchange wire rounds the
    embeddings); several ranks run under the launcher
    (tests/test_torch_launch.py)."""
    argv = ["--model", "wide_and_deep", "--batch_size", "64", "--steps", "3", "--emb_dim",
            "4", "--capacity", "1024", "--vocab", "1000", "--log_every", "1", "--eval_every",
            "0", "--eval_batches", "1", "--device", "cpu"]
    losses = {}
    for extra in ([], ["--sharded", "--comm", "a2a"]):
        args = zoo.build_argparser().parse_args(argv + extra)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            zoo.run(zoo.model_fn("wide_and_deep", args), args, "criteo")
        losses[bool(extra)] = _losses(out.getvalue())
    assert sorted(losses[True]) == [1, 2, 3]
    for s in losses[False]:
        np.testing.assert_allclose(losses[True][s], losses[False][s], rtol=1e-3)


def test_device_is_required_off_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        zoo.main(["--model", "wdl", "--steps", "1"])


def _args(parser_of, argv, defaults=None):
    p = parser_of("x")
    if defaults:
        p.set_defaults(**defaults)
    return p.parse_args(argv)


@pytest.mark.parametrize("kind", ["criteo", "multitask", "behavior", "twotower"])
def test_make_data_synthetic_matches_jax(jax_zoo, kind):
    argv = ["--batch_size", "32", "--vocab", "500", "--seed", "3"]
    got = zoo.make_data(_args(zoo.build_argparser, argv), kind)
    want = jax_zoo.make_data(_args(jax_zoo.build_argparser, argv), kind)
    assert_batches_equal([next(got) for _ in range(2)], [next(want) for _ in range(2)], kind)


def test_make_data_criteo_stats_matches_jax(jax_zoo):
    argv = ["--batch_size", "32", "--data", "criteo_stats", "--seed", "2"]
    pa, ja = _args(zoo.build_argparser, argv), _args(jax_zoo.build_argparser, argv)
    got, want = zoo.make_data(pa, "criteo"), jax_zoo.make_data(ja, "criteo")
    assert_batches_equal([next(got) for _ in range(2)], [next(want) for _ in range(2)])
    assert_batches_equal([next(pa._eval_iter)], [next(ja._eval_iter)], "eval split")
    assert list(pa._datasets) == list(ja._datasets) == ["criteo_stats"]
    with pytest.raises(ValueError, match="criteo_stats"):
        zoo.make_data(pa, "behavior")


@pytest.mark.parametrize("workqueue", [False, True])
def test_make_data_tsv_matches_jax(jax_zoo, tmp_path, workqueue):
    """A TSV glob read straight and through --workqueue (2 slices a file):
    the same batches as the JAX driver's, the queue registered for
    checkpoints."""
    for i in range(2):
        write_tsv(tmp_path / f"day_{i}.tsv", 150, seed=i)
    argv = ["--batch_size", "32", "--data", str(tmp_path / "day_*.tsv")]
    if workqueue:
        argv += ["--workqueue", "--num_slices", "2"]
    pa, ja = _args(zoo.build_argparser, argv), _args(jax_zoo.build_argparser, argv)
    got = list(zoo.make_data(pa, "criteo"))
    want = list(jax_zoo.make_data(ja, "criteo"))
    assert_batches_equal(got, want, f"workqueue={workqueue}")
    if workqueue:
        assert list(pa._datasets) == ["workqueue"]
    with pytest.raises(FileNotFoundError):
        zoo.make_data(_args(zoo.build_argparser, ["--data", str(tmp_path / "none*.tsv")]),
                      "criteo")


def _metric_losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step (\d+) loss ([0-9.eE+-]+) global_step/sec:", text)}


# name, extra flags: a Criteo model with an admission filter, and a
# multi-task model (one AUC per task) with micro-batches
RUN_CASES = [("wide_and_deep", ["--filter_freq", "2"]),
             ("esmm", ["--micro_batch", "2"])]


@pytest.mark.parametrize("name,extra", RUN_CASES, ids=[c[0] for c in RUN_CASES])
def test_run_matches_jax_run_from_a_shared_checkpoint(jax_zoo, tmp_path, name, extra):
    """Both drivers restore one step-0 checkpoint written by the JAX trainer
    and train 3 steps (the horizon RTOL is set for) of the same synthetic
    stream (batch 64, emb 4, 1024 slots), with a delta at step 1, a full
    save at 2 and evals at 2 and the end: per-step losses (the metrics
    files' full floats) within RTOL, every AUC within AUC_ATOL, the eval
    loss within RTOL, and the same checkpoint directories."""
    from deeprec_tpu.training import Trainer as JaxTrainer
    from deeprec_tpu.training.checkpoint import CheckpointManager as JaxCkpt

    kind, defaults, _ = _train_py(name)
    argv = ["--batch_size", "64", "--steps", "3", "--emb_dim", "4", "--capacity", "1024",
            "--vocab", "1000", "--log_every", "1", "--eval_every", "2", "--eval_batches", "2",
            "--incremental_save_steps", "1", "--save_steps", "2", "--seed", "0", *extra]
    jargs = _args(jax_zoo.build_argparser, argv, defaults)
    jmodel = jregistry.REGISTRY[name](emb_dim=4, capacity=1024,
                                      ev=jax_zoo.ev_option(jargs))
    sparse_opt, dense_opt = jax_zoo.make_optimizers(jargs)
    jtr = JaxTrainer(jmodel, sparse_opt, dense_opt)
    JaxCkpt(str(tmp_path / "seed"), jtr).save(jtr.init(0))
    for who in ("jax", "port"):
        shutil.copytree(tmp_path / "seed", tmp_path / who)

    jargs = _args(jax_zoo.build_argparser, argv + ["--checkpoint", str(tmp_path / "jax"),
                                                   "--metrics_file", str(tmp_path / "j.jsonl")],
                  defaults)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jev = jax_zoo.run(jmodel, jargs, kind)
    jtext = out.getvalue()

    pargs = _args(zoo.build_argparser, argv + ["--checkpoint", str(tmp_path / "port"),
                                               "--metrics_file", str(tmp_path / "p.jsonl"),
                                               "--device", "cpu"], defaults)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        pev = zoo.run(zoo.model_fn(name, pargs), pargs, kind)
    ptext = out.getvalue()

    assert "restored from step 0" in jtext and "restored from step 0" in ptext
    assert sorted(_losses(jtext)) == sorted(_losses(ptext)) == [1, 2, 3]
    jl, pl = _metric_losses(tmp_path / "j.jsonl"), _metric_losses(tmp_path / "p.jsonl")
    assert sorted(jl) == sorted(pl) == [1, 2, 3]
    for s in jl:
        np.testing.assert_allclose(pl[s], jl[s], rtol=RTOL, err_msg=f"step {s}")
    assert pev.keys() == jev.keys()
    for k in pev:
        if k.startswith("auc"):
            assert abs(pev[k] - float(jev[k])) <= AUC_ATOL, (k, pev[k], jev[k])
        else:
            np.testing.assert_allclose(pev[k], float(jev[k]), rtol=RTOL)
    assert len(re.findall("Eval AUC:", ptext)) == len(re.findall("Eval AUC:", jtext)) > 0
    listing = lambda d: sorted(x for x in os.listdir(d) if "-" in x)  # noqa: E731
    assert listing(tmp_path / "port") == listing(tmp_path / "jax")


def test_command_line_prints_the_scraped_lines(tmp_path):
    """`python -m deeprec_tpu_torch.modelzoo` with --device cpu: exit code
    0, `global_step/sec:` and `Eval AUC:` lines, a final checkpoint."""
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "deeprec_tpu_torch.modelzoo", "--model", "wide_and_deep",
           "--steps", "4", "--eval_every", "2", "--log_every", "2", "--device", "cpu",
           "--batch_size", "64", "--capacity", "1024", "--vocab", "1000", "--eval_batches",
           "2", "--checkpoint", str(tmp_path / "ck"),
           "--metrics_file", str(tmp_path / "m.jsonl")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "global_step/sec:" in r.stdout and "Eval AUC:" in r.stdout
    assert "saved final checkpoint" in r.stdout
    assert sorted(_metric_losses(tmp_path / "m.jsonl")) == [2, 4]
