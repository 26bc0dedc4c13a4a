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
    from deeprec_tpu_torch import config
    from deeprec_tpu_torch.features import SparseFeature
    from deeprec_tpu_torch.models import DLRMDCN, WDL

    kw = dict(spec["model"], **job.get("model_kw", {}))
    model = (WDL if spec.get("model_name") == "wdl" else DLRMDCN)(**kw)
    over = {k: job[k] for k in ("value_dtype", "exchange_dtype") if job.get(k)}
    if job.get("cbf"):
        over["ev"] = config.EmbeddingVariableOption(cbf_filter=config.CBFFilter(**job["cbf"]))
    if job.get("storage"):  # on the tables of features `storage_on` (default all)
        over["ev"] = config.EmbeddingVariableOption(
            storage=config.StorageOption(**job["storage"]))
    on = job.get("storage_on")
    if over:
        sparse = [f for f in model.features if isinstance(f, SparseFeature)
                  and f.table is not None]
        pick = {id(f) for i, f in enumerate(sparse) if on is None or i in on}
        model.features = [
            dataclasses.replace(f, table=dataclasses.replace(f.table, **over))
            if id(f) in pick else f for f in model.features]
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




# ----------------------------------------------- placement, async, ring


def _plans_json(trainer):
    """{bundle: [[offset, hot keys, hot owners] per member]} of the active
    plans."""
    return json.dumps({b: [[p.offset, list(p.hot_keys), list(p.hot_owners)] for p in bp.plans]
                       for b, bp in trainer._plans.items()})


def _gauges():
    """{metric: {labels: value}} of the shard gauges in this process."""
    from deeprec_tpu_torch.obs import metrics as OM

    snap = OM.default_registry().snapshot()["metrics"]
    out = {}
    for name in ("deeprec_shard_imbalance", "deeprec_shard_exchange_bytes"):
        out[name] = {json.dumps(sorted(s["labels"].items())): s["value"]
                     for s in snap.get(name, {}).get("series", [])}
    return out


def _sharded(spec, job, rank, device, placement="uniform", cls=None, **over):
    from deeprec_tpu_torch.optim import Adagrad, adam
    from deeprec_tpu_torch.parallel import ShardedTrainer
    from deeprec_tpu_torch.parallel import placement as P

    cls = cls or ShardedTrainer
    opt = dict(comm=job.get("comm", "allgather"), pipeline_mode=job.get("mode", "off"),
               placement=placement, placement_hot_budget=job.get("hot_budget", 64),
               replan=P.ReplanConfig(**job["replan"]) if job.get("replan") else None)
    opt.update(over)
    return cls(_model(spec, job), Adagrad(lr=job.get("lr", spec["lr"])),
               adam(job.get("dense_lr", spec["dense_lr"])), mesh=_mesh(job, device), **opt)


def _start(trainer, job, rank):
    if job.get("state"):
        return load_state(trainer, job["state"], trainer.mesh.index)
    return trainer.init(job.get("seed", 0))


def _pre(prefix, d):
    return {f"{prefix}{k}": v for k, v in d.items()}


def placement_job(spec, job, rank, device, batches):
    """The placement scenarios of tests/test_torch_placement.py:
    force (3 steps from a carried state, update_placement(force=True), 3
    more), overflow (a migration one rank cannot hold), drift (a plan and a
    uniform trainer over the drifting stream with maintain() after each
    window of 2, then one train_steps window of 3), amortize (a horizon of 0
    defers, a longer one adopts) and ckpt (a part-file save under a
    drift-made plan restored into uniform, into another plan and into the
    same plan)."""
    from deeprec_tpu_torch.parallel import placement as P

    out = {}
    sc = job["scenario"]
    if sc == "force":
        tr = _sharded(spec, job, rank, device, "plan")
        st = _start(tr, job, rank)
        losses = []
        for i in range(3):
            st, m = tr.train_step(st, batches[i])
            losses.append(float(m["loss"]))
        stats = tr.dedup_stats(st)
        out["gauges"] = np.asarray(json.dumps(_gauges()))
        out["per_shard"] = np.asarray(json.dumps({t: r.get("per_shard") for t, r in
                                                  stats.items() if t != "__placement__"}))
        out.update(_pre("pre.", _rows(tr, st)))
        st, rep = tr.update_placement(st, force=True)
        out["report"] = np.asarray(json.dumps(rep))
        out["last"] = np.asarray(json.dumps(tr.last_placement))
        out["plans"] = np.asarray(_plans_json(tr))
        out["stats"] = np.asarray(json.dumps(tr._replan_stats))
        out.update(_pre("post.", _rows(tr, st)))
        # the device route of every live key against the host mirror
        for bname, bp in tr._plans.items():
            b = tr.bundles[bname]
            ks = torch.as_tensor(out[f"post.r:{bname}:key"])
            mem = out[f"post.r:{bname}:member"]
            dev_owner = np.concatenate([
                P.plan_owner(ks[mem == t][None], tr.num_shards,
                             {k: v[t] if b.stacked else v
                              for k, v in tr._plan_leaves[bname].items()})[0].numpy()
                for t in range(b.num_tables)])
            host_owner = np.concatenate([bp.member(t).owner_np(ks[mem == t].numpy())
                                         for t in range(b.num_tables)])
            out[f"owner_dev:{bname}"], out[f"owner_host:{bname}"] = dev_owner, host_owner
        for i in range(3, 6):
            st, m = tr.train_step(st, batches[i])
            losses.append(float(m["loss"]))
        out["losses"] = np.asarray(losses)
        out["budgets"] = np.asarray(json.dumps({b: np.asarray(sh.last_a2a_budgets).tolist()
                                                for b, sh in tr.sharded.items()}))
        out["a2a_overflow_total"] = np.asarray(tr.a2a_overflow(st))
    elif sc == "overflow":
        tr = _sharded(spec, job, rank, device, "plan")
        st = _start(tr, job, rank)
        for i in range(3):
            st, _ = tr.train_step(st, batches[i])
        real = P.build_plans

        def all_to_zero(num_shards, members, **kw):
            """The placer's plans, with every live key routed to shard 0."""
            plans, rep = real(num_shards, members, **kw)
            for m in members:
                plans[(m.bundle, m.member)] = P.ShardPlan(
                    num_shards=num_shards, sentinel=m.sentinel,
                    hot_keys=tuple(int(k) for k in m.keys),
                    hot_owners=(0,) * len(m.keys))
            return plans, rep

        out.update(_pre("pre.", _rows(tr, st)))
        P.build_plans = all_to_zero
        try:
            st, rep = tr.update_placement(st, force=True)
        finally:
            P.build_plans = real
        out["report"] = np.asarray(json.dumps(rep))
        out["plans"] = np.asarray(_plans_json(tr))
        out["leaves"] = np.asarray(len(tr._plan_leaves))
        out["stats"] = np.asarray(json.dumps(tr._replan_stats))
        out.update(_pre("post.", _rows(tr, st)))
        st, m = tr.train_step(st, batches[3])
        out["after_loss"] = np.asarray(float(m["loss"]))
    elif sc == "drift":
        tu = _sharded(spec, job, rank, device, "uniform")
        tp = _sharded(spec, job, rank, device, "plan")
        su, sp = tu.init(0), tp.init(0)
        lu, lp, i = [], [], 0
        reps = []
        for w in range(job["windows"]):
            for _ in range(job["per_window"]):
                su, mu = tu.train_step(su, batches[i])
                sp, mp = tp.train_step(sp, batches[i])
                lu.append(float(mu["loss"]))
                lp.append(float(mp["loss"]))
                i += 1
            sp, rep = tp.maintain(sp)
            su, _ = tu.maintain(su)
            reps.append({b: r.get("placement") for b, r in rep.items()})
        win = batches[i:i + 3]
        su, mu = tu.train_steps(su, win)
        sp, mp = tp.train_steps(sp, win)
        lu += mu["loss"].tolist()
        lp += mp["loss"].tolist()
        out["losses_u"], out["losses_p"] = np.asarray(lu), np.asarray(lp)
        out["reports"] = np.asarray(json.dumps(reps))
        out["stats"] = np.asarray(json.dumps(tp.dedup_stats(sp)["__placement__"]))
        out["a2a_overflow_total"] = np.asarray(tp.a2a_overflow(sp))
        out.update(_pre("u.", _rows(tu, su)))
        out.update(_pre("p.", _rows(tp, sp)))
    elif sc == "amortize":
        tr = _sharded(spec, job, rank, device, "plan")
        st = tr.init(0)
        for i in range(3):
            st, _ = tr.train_step(st, batches[i])
        st, rep0 = tr.update_placement(st, horizon_steps=0)
        last0 = dict(tr.last_placement)
        stats0 = dict(tr._replan_stats)
        for i in range(3, 5):
            st, _ = tr.train_step(st, batches[i])
        st, rep1 = tr.update_placement(st, horizon_steps=last0["amortize_steps"] * 4 + 4)
        out["reports"] = np.asarray(json.dumps([rep0, rep1]))
        out["last"] = np.asarray(json.dumps([last0, tr.last_placement]))
        out["stats"] = np.asarray(json.dumps([stats0, tr._replan_stats]))
    elif sc == "ckpt":
        from deeprec_tpu_torch.training.checkpoint import CheckpointManager

        tr = _sharded(spec, job, rank, device, "plan")
        st = tr.init(0)
        for i in range(job["steps"]):
            st, _ = tr.train_step(st, batches[i])
            if (i + 1) % 2 == 0:
                st, _ = tr.maintain(st)
        if not tr._plans:  # the drift made no plan: place once
            st, _ = tr.update_placement(st, force=True)
        st, _ = CheckpointManager(job["save"], tr, sharded_io=True).save(st)
        out.update(_pre("saved.", _rows(tr, st)))
        out["saved.fp"] = np.asarray(json.dumps({b: tr.routing_fingerprint(b) for b in tr._plans}))
        for b, ts in st.tables.items():
            out[f"saved.bloom:{b}"] = ts.bloom.cpu().numpy().copy()
        nxt = batches[job["steps"]]
        st, m = tr.train_step(st, nxt)
        out["next_loss"] = np.asarray(float(m["loss"]))
        plan_a = dict(tr._plans)
        for tag in ("uniform", "planB", "planA"):
            rt = _sharded(spec, job, rank, device, "uniform" if tag == "uniform" else "plan")
            if tag == "planB":
                for b, bp in plan_a.items():
                    rt._set_plan(b, P.BundlePlan(tuple(
                        dataclasses.replace(p, offset=(p.offset + 1) % p.num_shards,
                                            hot_keys=(), hot_owners=()) for p in bp.plans)))
            elif tag == "planA":
                for b, bp in plan_a.items():
                    rt._set_plan(b, bp)
            rs = CheckpointManager(job["save"], rt).restore()
            out.update(_pre(f"{tag}.", _rows(rt, rs)))
            out[f"{tag}.fp"] = np.asarray(json.dumps({b: rt.routing_fingerprint(b)
                                                      for b in rt.bundles}))
            for b, ts in rs.tables.items():
                out[f"{tag}.bloom:{b}"] = ts.bloom.cpu().numpy().copy()
                # a sketch rebuilt from this shard's restored rows
                from deeprec_tpu_torch.embedding import filters
                from deeprec_tpu_torch.embedding.table import META_FREQ, empty_key

                cbf = rt.bundles[b].table.cfg.ev.cbf_filter
                rebuilt = torch.zeros_like(ts.bloom)
                for t in range(ts.keys.shape[0]):
                    occ = ts.keys[t] != empty_key(rt.bundles[b].table.cfg)
                    filters.cbf_add(cbf, rebuilt[t:t + 1], ts.keys[t][occ][None],
                                    ts.meta[t, META_FREQ][occ][None])
                out[f"{tag}.rebuilt:{b}"] = rebuilt.cpu().numpy()
            if tag == "planA":
                rs, m = rt.train_step(rs, nxt)
                out["planA.next_loss"] = np.asarray(float(m["loss"]))
    np.savez(job["out"] + f".{rank}.npz", **out)


def async_job(spec, job, rank, device, batches):
    """`AsyncShardedTrainer`: `bootstrap` on batch 0, then `steps` single
    async steps (batches 1..) and, from a second trainer on the same
    start, the same steps as one `train_steps_async` window; with lr0 the
    sync trainer's eval losses of batches 0.. after the same lookups."""
    from deeprec_tpu_torch.parallel import AsyncShardedTrainer

    out = {}
    n = job["steps"]
    tr = _sharded(spec, job, rank, device, cls=AsyncShardedTrainer)
    st = _start(tr, job, rank)
    ast = tr.bootstrap(st, batches[0])
    losses = []
    for t in range(1, n + 1):
        ast, m = tr.train_step_async(ast, batches[t])
        losses.append(float(m["loss"]))
    out["losses"] = np.asarray(losses)
    out.update(_rows(tr, ast.inner))
    for name, t in ast.inner.dense.items():
        out[f"d:{name}"] = t.detach().cpu().numpy().copy()
    if job.get("window"):
        tw = _sharded(spec, job, rank, device, cls=AsyncShardedTrainer)
        aw = tw.bootstrap(_start(tw, job, rank), batches[0])
        aw, m = tw.train_steps_async(aw, batches[1:n + 1])
        out["window_losses"] = m["loss"].numpy()
        out.update(_pre("w.", _rows(tw, aw.inner)))
        for name, t in aw.inner.dense.items():
            out[f"w.d:{name}"] = t.detach().cpu().numpy().copy()
    if job.get("sync_eval"):  # lr 0: the sync trainer after t-1 steps evaluates batch t-1
        ts_ = _sharded(spec, job, rank, device)
        ss = _start(ts_, job, rank)
        ev = []
        for t in range(1, n + 1):
            ss, _ = ts_.train_step(ss, batches[t - 1])
            loss, _ = ts_.eval_step(ss, batches[t - 1])
            ev.append(float(loss))
        out["sync_eval"] = np.asarray(ev)
    np.savez(job["out"] + f".{rank}.npz", **out)


def ring_job(spec, job, rank, device, batches):
    """`ring_attention_sharded` on the global q, k, v, mask of job["inputs"]
    (an .npz), causal or not: the output, the gradients of sum(o^2), and
    `ppermute` forward and backward on a rank-stamped tensor."""
    from deeprec_tpu_torch.parallel import (
        make_mesh, mesh_batch_axes, ppermute, ring_attention_sharded)

    mesh = make_mesh(device=device)
    z = np.load(job["inputs"])
    out = {}
    for causal in job.get("causal", (False, True)):
        grads = job.get("grads", True)
        q, k, v = (torch.tensor(z[n], requires_grad=grads) for n in ("q", "k", "v"))
        o = ring_attention_sharded(mesh, q, k, v, torch.as_tensor(z["mask"]), causal=causal)
        tag = "causal" if causal else "full"
        out[f"{tag}:o"] = o.detach().numpy()
        if grads:
            (o ** 2).sum().backward()
            for n, x in (("q", q), ("k", k), ("v", v)):
                out[f"{tag}:d{n}"] = x.grad.numpy()
    x = torch.full((3,), float(mesh.index), requires_grad=True)
    y = ppermute(mesh, x, mesh_batch_axes(mesh), shift=1)
    (y * torch.arange(1.0, 4.0) * (mesh.index + 1)).sum().backward()
    out["pp:y"], out["pp:grad"] = y.detach().numpy(), x.grad.numpy()
    np.savez(job["out"] + f".{rank}.npz", **out)


# ------------------------------------------------------ tiers, async saves


def tier_record(trainer, st, report=None):
    """What a tier scenario compares after a maintain: the rows and
    counters (`_rows`), the report, and each of this position's member
    tiers' host-store export and disk-log contents (by key), keyed
    <bundle>:<index>."""
    out = _rows(trainer, st)
    if report is not None:
        out["report"] = np.asarray(json.dumps(report, sort_keys=True))
    for (bname, idx), mt in sorted(trainer._tiers.items()):
        tag = f"{bname}:{'_'.join(map(str, idx))}"
        if mt.host is not None:
            k, v, f, ver = mt.host.export()
            out[f"host:{tag}:keys"], out[f"host:{tag}:rows"] = k, v
            out[f"host:{tag}:meta"] = np.stack([f, ver], 1) if len(k) else np.zeros((0, 2))
        if mt.disk is not None:
            keys = np.sort(np.fromiter(mt.disk.index, np.int64, len(mt.disk.index)))
            v, f, ver, found = mt.disk.get(keys)
            assert found.all()
            out[f"disk:{tag}:keys"], out[f"disk:{tag}:rows"] = keys, v
            out[f"disk:{tag}:meta"] = np.stack([f, ver], 1) if len(keys) else np.zeros((0, 2))
            out[f"disk:{tag}:path"] = np.asarray(os.path.basename(mt.disk.path))
    return out


def tiers_job(spec, job, rank, device, batches):
    """A tier scenario: `ops` in order — load (a carried JAX state), steps
    (n train steps from batch `first`, losses kept), maintain (its keyword
    arguments; the report and `tier_record` under the op's tag), drain
    (every member tier drained into the state, the summed TierStats under
    the tag), record (`tier_record` under the tag), paging (whether
    enable_tier_paging raises NotImplementedError), place
    (update_placement(force=True): its report, the plans left, the
    fingerprints)."""
    from deeprec_tpu_torch.embedding.table import member_view
    from deeprec_tpu_torch.training.trainer import _put_member

    tr = _sharded(spec, job, rank, device, job.get("placement", "uniform"))
    st = tr.init(0)
    out = {}
    for op in job["ops"]:
        kind, tag = op["op"], op.get("tag", "")
        if kind == "load":
            st = load_state(tr, op["state"], tr.mesh.index)
        elif kind == "steps":
            losses = []
            for i in range(op["n"]):
                st, m = tr.train_step(st, batches[op["first"] + i])
                losses.append(float(m["loss"]))
            out[f"{tag}losses"] = np.asarray(losses, np.float64)
        elif kind == "maintain":
            st, rep = tr.maintain(st, **op.get("kw", {}))
            out.update(_pre(tag, tier_record(tr, st, rep)))
        elif kind == "drain":
            total = {}
            for bname, b in tr.bundles.items():
                ts = st.tables[bname]
                for k in range(b.num_tables):
                    mt = tr._tiers.get((bname, tr._tier_index(b, k)))
                    if mt is None:
                        continue
                    m, stats = mt.drain(member_view(ts, k))
                    ts = _put_member(ts, k, m)
                    for name, v in dataclasses.asdict(stats).items():
                        total[name] = total.get(name, 0) + v
                st.tables[bname] = ts
            out[f"{tag}drain"] = np.asarray(json.dumps(total, sort_keys=True))
            out.update(_pre(tag, tier_record(tr, st)))
        elif kind == "record":
            out.update(_pre(tag, tier_record(tr, st)))
        elif kind == "paging":
            try:
                tr.enable_tier_paging()
                out["paging"] = np.asarray("no raise")
            except NotImplementedError as e:
                out["paging"] = np.asarray(f"NotImplementedError: {e}")
        elif kind == "place":
            st, rep = tr.update_placement(st, force=True)
            out["place"] = np.asarray(json.dumps(rep, sort_keys=True))
            out["plans"] = np.asarray(len(tr._plans))
            out["fingerprints"] = np.asarray(json.dumps(
                {b: tr.routing_fingerprint(b) for b in tr.bundles}))
    np.savez(job["out"] + f".{rank}.npz", **out)


def ckpt_async_job(spec, job, rank, device, batches):
    """Async part-file saves at this world: two runs of the same steps from
    the same init, one saving with save / save_incremental, the other with
    save_async / save_incremental_async (a full save after `steps`, one
    more step, a delta); each run's live rows, its saves'
    `last_save["async"]` and kinds, and its directory restored into a fresh
    trainer."""
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    out = {}
    for tag in ("sync", "async"):
        tr = _sharded(spec, job, rank, device)
        st = tr.init(0)
        for i in range(job["steps"]):
            st, _ = tr.train_step(st, batches[i])
        ck = CheckpointManager(os.path.join(job["dir"], tag), tr, sharded_io=True)
        flags, kinds = [], []
        for save in ("full", "incr"):
            if save == "incr":
                st, _ = tr.train_step(st, batches[job["steps"]])
            if tag == "sync":
                st, _ = ck.save(st) if save == "full" else ck.save_incremental(st)
            else:
                st, _ = ck.save_async(st) if save == "full" else ck.save_incremental_async(st)
                ck.wait()
            flags.append(ck.last_save["async"])
            kinds.append(ck.last_save["kind"])
        out[f"{tag}.flags"], out[f"{tag}.kinds"] = np.asarray(flags), np.asarray(kinds)
        out.update(_pre(f"{tag}.live.", _rows(tr, st)))
        rt = _sharded(spec, job, rank, device)
        rs = CheckpointManager(os.path.join(job["dir"], tag), rt, sharded_io=True).restore()
        out.update(_pre(f"{tag}.restored.", _rows(rt, rs)))
        out[f"{tag}.step"] = np.asarray(int(rs.step))
    np.savez(job["out"] + f".{rank}.npz", **out)


JOBS = {"placement": placement_job, "async": async_job, "ring": ring_job,
        "tiers": tiers_job, "ckpt_async": ckpt_async_job}


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
            elif job.get("kind") in JOBS:
                JOBS[job["kind"]](spec, job, rank, device, batches)
            else:
                run_job(spec, job, rank, device, batches)
            dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
