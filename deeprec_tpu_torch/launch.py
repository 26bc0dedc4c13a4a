"""Multi-process launcher: `python -m deeprec_tpu_torch.launch [...] -- script.py args`
— the port of `deeprec_tpu/launch.py`.

One invocation per process, as in the JAX package. The cluster comes from
flags or from the environment (`DEEPREC_COORDINATOR` host:port,
`DEEPREC_NUM_PROCESSES`, `DEEPREC_PROCESS_ID`; `--init_method` takes any
`torch.distributed` URL instead, e.g. `file://...`). The launcher runs
`torch.distributed.init_process_group` with the backend of `--backend`
(nccl by default on CUDA, gloo with `--device cpu`), pins the process to
`cuda:{local_rank % device_count}` (`DEEPREC_LOCAL_RANK`, else the process
id) unless `--device cpu`, exports the device as `DEEPREC_DEVICE`, and then
runs the script in-process (`runpy`), so `parallel.make_mesh()` spans every
process. Several processes on one card need `--backend gloo` (NCCL refuses
two ranks on one device); the backend is never switched behind the caller's
back, and a failed init raises.

The script may also be a module: `... -- -m deeprec_tpu_torch.modelzoo
--model mlperf --sharded`. `--elastic_dir` runs the single-host elastic supervisor (respawn the worker
set at the plan's size after `EXIT_RESCALE`), `--supervised` one worker under
liveness supervision (`online.Supervisor`).
"""
from __future__ import annotations

import argparse
import os
import runpy
import sys
from typing import Optional

import torch


def initialize(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[str] = None, init_method: Optional[str] = None
               ) -> torch.device:
    """Join the process group (a no-op when this process already has one)
    and pin this process's device. Returns the device."""
    import torch.distributed as dist

    from deeprec_tpu_torch import resolve_device

    coordinator = coordinator or os.environ.get("DEEPREC_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DEEPREC_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("DEEPREC_PROCESS_ID", "0"))
    device = device or os.environ.get("DEEPREC_DEVICE") or "cuda"
    dev = resolve_device(torch.device(device).type)  # raises without CUDA
    if dev.type == "cuda":
        local = int(os.environ.get("DEEPREC_LOCAL_RANK", process_id))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        url = init_method or (f"tcp://{coordinator}" if coordinator else None)
        if url is None:
            raise ValueError("launch: pass --coordinator host:port (or "
                             "DEEPREC_COORDINATOR) or --init_method")
        dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                                rank=int(process_id))
    os.environ["DEEPREC_DEVICE"] = str(dev)
    return dev


def supervise_elastic(script: str, script_args, num_processes: int, elastic_dir: str,
                      max_generations: int = 100, env_extra: Optional[dict] = None,
                      launch_args=()) -> int:
    """Single-host elastic supervisor: spawn `num_processes` workers running
    `script` under this launcher; when all exit with `EXIT_RESCALE` (having
    saved and acked the plan), respawn at the plan's target and bump
    `DEEPREC_ELASTIC_EPOCH`. A zero exit from all workers ends the job."""
    import subprocess

    from deeprec_tpu_torch.parallel.elastic import EXIT_RESCALE, ElasticCoordinator

    coord = ElasticCoordinator(elastic_dir)
    n = num_processes
    epoch_done = coord.plan()[0]
    for _generation in range(max_generations):
        port = _free_port()
        procs = []
        for pid in range(n):
            env = dict(os.environ)
            env.update(env_extra or {})
            env.update(DEEPREC_COORDINATOR=f"127.0.0.1:{port}", DEEPREC_NUM_PROCESSES=str(n),
                       DEEPREC_PROCESS_ID=str(pid), DEEPREC_ELASTIC_DIR=elastic_dir,
                       DEEPREC_ELASTIC_EPOCH=str(epoch_done))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deeprec_tpu_torch.launch", *launch_args, script]
                + list(script_args), env=env))
        rcs = [q.wait() for q in procs]
        if all(rc == 0 for rc in rcs):
            return 0
        if all(rc == EXIT_RESCALE for rc in rcs):
            epoch, target = coord.wait_acked_after(epoch_done, n)
            print(f"deeprec_tpu_torch.launch: elastic rescale {n} -> {target} "
                  f"(plan epoch {epoch})", flush=True)
            n, epoch_done = target, epoch
            continue
        bad = [(i, rc) for i, rc in enumerate(rcs) if rc not in (0, EXIT_RESCALE)]
        raise RuntimeError(f"elastic workers failed: {bad}")
    raise RuntimeError("elastic: max_generations exceeded")


def supervise_worker(script: str, script_args, heartbeat: Optional[str] = None,
                     lease_secs: float = 30.0, max_restarts: int = 5,
                     env_extra: Optional[dict] = None, launch_args=()) -> int:
    """ONE worker under liveness supervision (`online.Supervisor`): restart
    on a crash or a wedged heartbeat lease within a restart budget, respawn
    `EXIT_RESCALE` exits for free. Returns 0 when done, 1 when the budget
    ran out."""
    from deeprec_tpu_torch.online.supervisor import ProcessSpec, Supervisor

    def env():
        # a fresh one-process group per (re)spawn: the old port died with it
        e = {"DEEPREC_COORDINATOR": f"127.0.0.1:{_free_port()}",
             "DEEPREC_NUM_PROCESSES": "1", "DEEPREC_PROCESS_ID": "0", **(env_extra or {})}
        if heartbeat:
            e["DEEPREC_HEARTBEAT_FILE"] = heartbeat
        return e

    spec = ProcessSpec(
        name="worker",
        argv=[sys.executable, "-m", "deeprec_tpu_torch.launch", *launch_args, script]
        + list(script_args),
        heartbeat_path=heartbeat, lease_secs=lease_secs if heartbeat else None,
        max_restarts=max_restarts, env=env)
    sup = Supervisor([spec])
    sup.run()
    return 0 if sup.stats()["worker"]["done"] else 1


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    p = argparse.ArgumentParser(
        description="deeprec_tpu_torch multi-process launcher",
        usage="python -m deeprec_tpu_torch.launch [flags] -- script.py [args...]")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--init_method", default=None,
                   help="a torch.distributed init URL instead (tcp://, file://)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on CUDA, gloo with --device cpu")
    p.add_argument("--device", default=None,
                   help="cuda (default): cuda:{local rank %% device count} | cpu")
    p.add_argument("--elastic_dir", default=None,
                   help="run as elastic SUPERVISOR: spawn --num_processes workers and "
                        "respawn the set at the plan's size on rescale exits")
    p.add_argument("--supervised", action="store_true",
                   help="run ONE worker under liveness supervision")
    p.add_argument("--heartbeat", default=None,
                   help="heartbeat lease file for --supervised (DEEPREC_HEARTBEAT_FILE)")
    p.add_argument("--lease_secs", type=float, default=30.0)
    p.add_argument("--max_restarts", type=int, default=5)
    p.add_argument("script", help="training script to run after init (or -m, then a "
                                  "module)")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    passed = [f for name in ("backend", "device") if getattr(args, name)
              for f in (f"--{name}", getattr(args, name))]

    if args.elastic_dir:
        sys.exit(supervise_elastic(args.script, args.script_args, args.num_processes or 1,
                                   args.elastic_dir, launch_args=passed))
    if args.supervised:
        sys.exit(supervise_worker(args.script, args.script_args, heartbeat=args.heartbeat,
                                  lease_secs=args.lease_secs,
                                  max_restarts=args.max_restarts, launch_args=passed))

    dev = initialize(args.coordinator, args.num_processes, args.process_id, args.backend,
                     args.device, args.init_method)
    import torch.distributed as dist

    print(f"deeprec_tpu_torch.launch: process {dist.get_rank()}/{dist.get_world_size()} up "
          f"on {dev} ({dist.get_backend()})", flush=True)
    try:
        if args.script == "-m":  # -- -m package.module args
            mod, *rest = args.script_args
            sys.argv = [mod] + rest
            runpy.run_module(mod, run_name="__main__", alter_sys=True)
        else:
            sys.argv = [args.script] + list(args.script_args)
            runpy.run_path(args.script, run_name="__main__")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
