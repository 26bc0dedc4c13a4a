"""One rank of a multi-process run of the port's sharded trainer, for the
tests (`tests/test_torch_sharded.py`, `tests/test_torch_mesh.py`).

    python tests/torch_sharded_rank.py SPEC.json RANK

Imports torch, numpy and the port only (never jax, never the JAX
package): the spawned ranks stay light and prove the import rule. The spec
names the process group (`init`: a file:// URL, `world`, `backend`), the
model (`model`: DLRMDCN keyword arguments, `lr`, `dense_lr`, `value_dtype`),
the global batches (`batches`: an .npz of b<i>_<key> arrays) and a list of
jobs run in order; each job builds a mesh and a ShardedTrainer, starts from
a carried JAX state (`state`: an .npz, see `load_state`), a seed or a
checkpoint (`restore`), trains (`steps` train_step calls, or `window` K-step
train_steps windows), optionally saves part files (`save`) and takes one
more step (`after`: a batch index), and writes what
the tests compare to `out.<rank>.npz`: losses and accuracies, the local
shard's rows per (member, key), the counters, the dense parameters, the
route budgets and the global dedup statistics.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(spec, job):
    from deeprec_tpu_torch.features import SparseFeature
    from deeprec_tpu_torch.models import DLRMDCN

    model = DLRMDCN(**spec["model"])
    over = {k: job[k] for k in ("value_dtype", "exchange_dtype") if job.get(k)}
    if over:
        model.features = [
            dataclasses.replace(f, table=dataclasses.replace(f.table, **over))
            if isinstance(f, SparseFeature) and f.table is not None else f
            for f in model.features]
    return model


def _mesh(job, device):
    from deeprec_tpu_torch.parallel import make_mesh, make_mesh_2d, plan_mesh_after_rescale

    shape = job.get("mesh", [None])
    if job.get("rescale_from"):  # the old mesh's (intra, inter)
        intra, inter = job["rescale_from"]

        class Old:
            axis_names = ("inter", "intra") if inter > 1 else ("data",)
            shape = {"inter": inter, "intra": intra} if inter > 1 else {"data": intra}

        return plan_mesh_after_rescale(dist_world(), Old, device=device)
    if len(shape) == 2:
        return make_mesh_2d(shape[0], shape[1], device=device)
    return make_mesh(shape[0], device=device)


def dist_world() -> int:
    import torch.distributed as dist

    return dist.get_world_size()


def load_state(trainer, path, rank):
    """A carried JAX ShardedTrainer state: t:<bundle>:<leaf>[:<slot>] table
    leaves, d<i> dense leaves, o<i> Adam leaves, `step`."""
    from deeprec_tpu_torch import convert

    z = np.load(path)
    tables = {}
    for key in z.files:
        if key.startswith("t:"):
            _, b, leaf, *rest = key.split(":")
            t = tables.setdefault(b, {})
            if leaf == "slots":
                t.setdefault("slots", {})[rest[0]] = z[key]
            else:
                t[leaf] = z[key]
    dense = [z[f"d{i}"] for i in range(sum(k.startswith("d") for k in z.files))]
    opt = [z[f"o{i}"] for i in range(sum(k.startswith("o") for k in z.files))]
    return convert.sharded_train_state_from_arrays(
        trainer, int(z["step"]), {"tables": tables, "dense": dense, "opt": opt}, rank)


def _rows(trainer, st):
    """The local shard's live rows: member index, key, value, accumulator,
    meta (freq, version, dirty)."""
    from deeprec_tpu_torch.embedding.table import empty_key

    out = {}
    for bname, b in trainer.bundles.items():
        ts = st.tables[bname]
        keys = ts.keys.cpu()
        occ = keys != empty_key(b.table.cfg)
        t_ix, c_ix = torch.nonzero(occ, as_tuple=True)
        out[f"r:{bname}:member"] = t_ix.numpy()
        out[f"r:{bname}:key"] = keys[t_ix, c_ix].numpy()
        out[f"r:{bname}:value"] = ts.values.float().cpu()[t_ix, c_ix].numpy()
        out[f"r:{bname}:accum"] = ts.slots["accum"].cpu()[t_ix, c_ix].numpy()
        out[f"r:{bname}:meta"] = ts.meta.cpu().permute(0, 2, 1)[t_ix, c_ix].numpy()
        for name in ("insert_fails", "dedup_unique", "dedup_ids", "dedup_overflow",
                     "a2a_overflow", "owner_arrivals", "owner_unique"):
            out[f"c:{bname}:{name}"] = getattr(ts, name).cpu().numpy().copy()
    return out


def run_job(spec, job, rank, device, batches):
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.parallel import ShardedTrainer
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    mesh = _mesh(job, device)
    trainer = ShardedTrainer(
        _model(spec, job), Adagrad(lr=spec["lr"]), adam(spec["dense_lr"]), mesh=mesh,
        comm=job.get("comm", "allgather"), pipeline_mode=job.get("mode", "off"),
        pipeline_chunks=job.get("chunks", 4), unique_budget=job.get("unique_budget"),
        a2a_slack=job.get("slack", 2.0))
    if job.get("restore"):
        st = CheckpointManager(job["restore"], trainer).restore()
    elif job.get("state"):
        st = load_state(trainer, job["state"], mesh.index)
    else:
        st = trainer.init(job.get("seed", 0))
    first = job.get("first", 0)
    losses, accs = [], []
    if job.get("window"):
        K = job["window"]
        for w in range(job["steps"] // K):
            win = batches[first + w * K:first + (w + 1) * K]
            st, m = trainer.train_steps(st, win if w % 2 else
                                        {k: np.stack([b[k] for b in win]) for k in win[0]})
            losses += m["loss"].tolist()
            accs += m["accuracy"].tolist()
    else:
        for i in range(job.get("steps", 0)):
            st, m = trainer.train_step(st, batches[first + i])
            losses.append(float(m["loss"]))
            accs.append(float(m["accuracy"]))
    out = {"losses": np.asarray(losses, np.float64), "accs": np.asarray(accs, np.float64),
           "step": np.asarray(int(st.step)), "mesh_size": np.asarray(mesh.size)}
    if job.get("eval"):
        ev = trainer.evaluate(st, batches[job["eval"][0]:job["eval"][1]])
        out["eval_loss"], out["eval_auc"] = np.asarray(ev["loss"]), np.asarray(ev["auc"])
    if job.get("save"):
        st, _ = CheckpointManager(job["save"], trainer, sharded_io=True).save(st)
    out.update(_rows(trainer, st))
    for name, t in st.dense.items():
        out[f"d:{name}"] = t.detach().cpu().numpy().copy()
    if job.get("after") is not None:  # one more step after the save
        st, m = trainer.train_step(st, batches[job["after"]])
        out["after_loss"] = np.asarray(float(m["loss"]))
    out["a2a_overflow_total"] = np.asarray(trainer.a2a_overflow(st))
    stats = trainer.dedup_stats(st)
    out["dedup_stats"] = np.asarray(json.dumps(stats))
    for bname, sh in trainer.sharded.items():
        if sh.last_a2a_bucket is not None:
            out[f"bucket:{bname}"] = np.asarray(sh.last_a2a_bucket)
    np.savez(job["out"] + f".{rank}.npz", **out)


def collectives_job(job, rank):
    """The mesh's collectives on fixed inputs (float32 from a seed, bf16,
    bool, int): what every position received, for the test to recompute."""
    from deeprec_tpu_torch.parallel import mesh as M

    out = {}
    for tag, mesh in (("1d", M.make_mesh(device="cpu")),
                      ("2d", M.make_mesh_2d(2, device="cpu"))):
        me = mesh.index
        x = torch.from_numpy(np.random.default_rng(100 + me).standard_normal(
            (4, 3, 5)).astype(np.float32))
        full = M.mesh_batch_axes(mesh)
        out[f"{tag}:gather"] = M.all_gather(mesh, x, full).numpy()
        out[f"{tag}:psum_scatter"] = M.psum_scatter(mesh, x, full).numpy()
        out[f"{tag}:psum"] = M.psum(mesh, x, full).numpy()
        out[f"{tag}:pmean"] = M.pmean(mesh, x, full).numpy()
        out[f"{tag}:a2a"] = M.all_to_all(mesh, x, full).numpy()
        out[f"{tag}:a2a_bf16"] = M.all_to_all(mesh, x.to(torch.bfloat16), full).float().numpy()
        out[f"{tag}:gather_bool"] = M.all_gather(mesh, x > 0, full).numpy()
        send = [(me + j) % 3 for j in range(mesh.size)]
        rows = torch.cat([torch.full((c, 2), 10 * me + j, dtype=torch.int64)
                          for j, c in enumerate(send)])
        got, counts = M.all_to_all_uneven(mesh, rows, send, full)
        out[f"{tag}:uneven"], out[f"{tag}:uneven_counts"] = got.numpy(), np.asarray(counts)
        out[f"{tag}:objects"] = np.asarray(M.all_gather_object(mesh, {"me": me}) ==
                                           [{"me": j} for j in range(mesh.size)])
        out[f"{tag}:index"] = np.asarray(me)
        batch = {"a": np.arange(16).reshape(8, 2), "b": np.arange(24).reshape(3, 8)}
        out[f"{tag}:shard"] = M.shard_batch(mesh, {"a": batch["a"]})["a"]
        out[f"{tag}:shard_stacked"] = M.shard_batch(mesh, {"b": batch["b"]}, stacked=True)["b"]
        if tag == "2d":
            for ax in (M.INTRA_AXIS, M.INTER_AXIS):
                out[f"2d:{ax}:gather"] = M.all_gather(mesh, x[:2], ax).numpy()
                out[f"2d:{ax}:index"] = np.asarray(M.axis_index(mesh, ax))
                out[f"2d:{ax}:psum_scatter"] = M.psum_scatter(mesh, x[:2], ax).numpy()
        M.barrier(mesh)
    np.savez(job["out"] + f".{rank}.npz", **out)


def spawn(tmp_path, world, jobs, tag, batches=None, timeout=240, **spec):
    """Run `jobs` on `world` gloo ranks, each a process running this file,
    meeting through a file:// rendezvous under tmp_path. Returns {job name:
    [each rank's outputs]}. `spec` adds the model entries (model, lr,
    dense_lr)."""
    import subprocess
    import time

    d = str(tmp_path)
    if batches is not None:
        spec["batches"] = os.path.join(d, f"batches_{tag}.npz")
        np.savez(spec["batches"], **{f"b{i}_{k}": v for i, b in enumerate(batches)
                                     for k, v in b.items()})
    for job in jobs:
        job["out"] = os.path.join(d, f"{tag}_{job['name']}")
    spec.update(init=f"file://{d}/rdzv_{tag}_{time.time_ns()}", world=world, jobs=jobs)
    spath = os.path.join(d, f"spec_{tag}.json")
    with open(spath, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), spath, str(r)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-4000:]
    return {job["name"]: [dict(np.load(f"{job['out']}.{r}.npz")) for r in range(world)]
            for job in jobs}


def main():
    spec = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    import torch.distributed as dist

    dist.init_process_group(spec.get("backend", "gloo"), init_method=spec["init"],
                            world_size=spec["world"], rank=rank)
    z = np.load(spec["batches"]) if spec.get("batches") else {"files": []}
    files = z.files if spec.get("batches") else []
    n = len({k.split("_", 1)[0] for k in files})
    batches = [{k.split("_", 1)[1]: z[k] for k in files if k.startswith(f"b{i}_")}
               for i in range(n)]
    device = spec.get("device", "cpu")
    try:
        for job in spec["jobs"]:
            if job.get("kind") == "collectives":
                collectives_job(job, rank)
            else:
                run_job(spec, job, rank, device, batches)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
