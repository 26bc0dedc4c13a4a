"""`python -m deeprec_tpu_torch.launch` on the CPU: two processes joined over
gloo through a file:// rendezvous run a script that sums over the mesh; the
modelzoo driver's `--sharded --comm a2a` trains under the launcher on two
ranks, saves part files and resumes from them on one; and without CUDA the
launcher's default device refuses to start."""
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}

SCRIPT = '''
import json, os, sys
import torch
import torch.distributed as dist
from deeprec_tpu_torch.parallel import make_mesh, mesh as M
mesh = make_mesh(device=os.environ["DEEPREC_DEVICE"])
x = torch.full((2,), float(dist.get_rank() + 1))
out = dict(rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
           device=os.environ["DEEPREC_DEVICE"], psum=M.psum(mesh, x, "data").tolist(),
           argv=sys.argv[1:], jax="jax" in sys.modules or "deeprec_tpu" in sys.modules)
with open(os.path.join(sys.argv[1], f"out{dist.get_rank()}.json"), "w") as f:
    json.dump(out, f)
'''


def _launch(tmp_path, world, tail, tag, timeout=240):
    """`world` launcher processes; returns their (rc, output)."""
    url = f"file://{tmp_path}/rdzv_{tag}_{time.time_ns()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "deeprec_tpu_torch.launch", "--init_method", url,
         "--num_processes", str(world), "--process_id", str(r), "--device", "cpu", "--",
         *tail], cwd=REPO, env=ENV, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        return [(p.wait(timeout=timeout), p.stdout.read()) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def test_two_processes_run_a_script_over_gloo(tmp_path):
    script = tmp_path / "script.py"
    script.write_text(SCRIPT)
    res = _launch(tmp_path, 2, [str(script), str(tmp_path), "--flag"], "script")
    assert all(rc == 0 for rc, _ in res), res
    for r in range(2):
        out = json.loads((tmp_path / f"out{r}.json").read_text())
        assert out["rank"] == r and out["world"] == 2 and out["backend"] == "gloo"
        assert out["device"] == "cpu" and out["psum"] == [3.0, 3.0]
        assert out["argv"] == [str(tmp_path), "--flag"] and not out["jax"]
        assert f"process {r}/2 up on cpu (gloo)" in res[r][1]


def _losses(text):
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step (\d+) loss ([0-9.eE+-]+) global_step/sec:", text)}


def test_modelzoo_sharded_under_the_launcher_and_resume_at_one(tmp_path):
    """2 ranks of `-m deeprec_tpu_torch.modelzoo --sharded --comm a2a`: the
    same losses on both, part files of both ranks in the final save; one
    rank then restores them and trains on."""
    ck = tmp_path / "ck"
    flags = ["-m", "deeprec_tpu_torch.modelzoo", "--model", "wide_and_deep", "--sharded",
             "--comm", "a2a", "--device", "cpu", "--batch_size", "64", "--capacity", "1024",
             "--vocab", "1000", "--emb_dim", "4", "--log_every", "1", "--eval_every", "0",
             "--eval_batches", "1", "--save_steps", "0", "--checkpoint", str(ck)]
    res = _launch(tmp_path, 2, flags + ["--steps", "3"], "zoo2")
    assert all(rc == 0 for rc, _ in res), res[0][1][-3000:]
    l0, l1 = _losses(res[0][1]), _losses(res[1][1])
    assert sorted(l0) == [1, 2, 3] and l0 == l1
    names = os.listdir(ck / "full-3")
    assert {"manifest.json", "dense.npz", "opt.npz"} <= set(names)
    assert any(n.endswith(".part00000.npz") for n in names)
    assert any(n.endswith(".part00001.npz") for n in names)
    assert json.loads((ck / "full-3" / "manifest.json").read_text())["format"] == "parts"
    (rc, text), = _launch(tmp_path, 1, flags + ["--steps", "5"], "zoo1")
    assert rc == 0, text[-3000:]
    assert "restored from step 3" in text and sorted(_losses(text)) == [4, 5]


def test_default_device_needs_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("CUDA is present: the default device is valid here")
    r = subprocess.run([sys.executable, "-m", "deeprec_tpu_torch.launch", "--init_method",
                        f"file://{tmp_path}/r", "--num_processes", "1", "--process_id", "0",
                        "--", str(tmp_path / "none.py")], cwd=REPO, env=ENV,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr
