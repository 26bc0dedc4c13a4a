"""Elastic re-scaling — the port of `deeprec_tpu/parallel/elastic.py`:
move live training state between topologies, and the file-based control
plane of a rescale.

DeepRec's elastic training re-partitions PS-resident EVs through a gRPC
scaling protocol (IsReadyScaling polled by workers, ReadyToUpdate,
UpdateServerDef with the new cluster). The same choreography here:

  * `reshard` — the state move: checkpoints restore by re-probing keys, so
    any saved state loads into any capacity, trainer or mesh. A world size
    changes only between process sets, through part files: save at N
    (`CheckpointManager`, sharded_io), exit with `EXIT_RESCALE`, respawn at
    M, `plan_mesh_after_rescale`, restore.
  * `ElasticCoordinator` — the control plane over a shared filesystem. An
    autoscaler posts a plan (`request_scale`); workers poll at step
    boundaries (`should_scale`, one decision for every process of a
    `torch.distributed` group: rank 0's view is broadcast); `ack_rescale`
    is the ReadyToUpdate barrier.
  * exit code `EXIT_RESCALE` tells `online.Supervisor` to respawn the
    worker (at the new size) without charging its restart budget.
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
import time
from typing import Optional, Tuple

#: exit code a worker uses to tell the supervisor "respawn me at the new
#: size" (any other nonzero exit aborts the job).
EXIT_RESCALE = 42


def factorize_mesh(n: int, prefer_intra: int) -> Tuple[int, int]:
    """An `(intra, inter)` factorization for `n` surviving devices: the
    largest divisor of `n` that is `<= prefer_intra` with co-factor `>= 2`,
    else the 1-D degrade `(n, 1)` (prime counts, n < 4)."""
    if n < 1:
        raise ValueError(f"factorize_mesh: n must be >= 1, got {n}")
    for cand in range(min(int(prefer_intra), n // 2), 1, -1):
        if n % cand == 0:
            return cand, n // cand
    return n, 1  # 1-D degrade


def plan_mesh_after_rescale(n: int, old_mesh=None, device=None):
    """The mesh for `n` surviving positions (the first n ranks of the
    world), keeping the old mesh's hierarchy where one exists: a 1-D old
    mesh (or None) gives a 1-D mesh; a 2-D one the `factorize_mesh` shape
    seeded with its intra width, degrading to 1-D when `n` has no valid
    factorization. `old_mesh` is anything with `axis_names` and `shape`
    (a `Mesh` of the previous generation, as its process recorded it).
    Restore is mesh-shape independent, so the state loads whichever shape
    comes back. Every rank must call it (it may make subgroups)."""
    from deeprec_tpu_torch.parallel.mesh import INTRA_AXIS, make_mesh, make_mesh_2d

    if device is None and old_mesh is not None:
        device = getattr(old_mesh, "device", None)
    names = tuple(old_mesh.axis_names) if old_mesh is not None else ()
    if len(names) != 2:
        return make_mesh(n, device=device)
    intra, inter = factorize_mesh(n, int(old_mesh.shape[INTRA_AXIS]))
    if inter == 1:
        return make_mesh(n, device=device)
    return make_mesh_2d(intra, inter, device=device)


def _rank_world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def reshard(src_trainer, src_state, dst_trainer, scratch_dir: Optional[str] = None):
    """`src_state` moved onto `dst_trainer`'s tables (another capacity, a
    sharded or plain trainer, any config whose model and features match)
    through the checkpoint container: the tested export/import path, keys
    re-probed into their new slots and owners. In a multi-process group
    pass a SHARED scratch_dir (a sharded source writes part files there)."""
    from deeprec_tpu_torch.training.checkpoint import CheckpointManager

    if _rank_world()[1] > 1 and scratch_dir is None:
        raise ValueError(
            "multi-process reshard needs a shared scratch_dir (process 0 "
            "writes the checkpoint; every process reads it)")
    d = scratch_dir or tempfile.mkdtemp(prefix="reshard_")
    CheckpointManager(d, src_trainer, keep=1).save(src_state)
    return CheckpointManager(d, dst_trainer, keep=1).restore()


class ElasticCoordinator:
    """File-based scaling control plane (ElasticTrainingService analog).

    Plan file (`plan.json`): `{"epoch": E, "target": N}` — the epoch grows
    per scaling event so a plan that already ran is not run again. Worker
    acks (`ack-E-P`): the ReadyToUpdate barrier — the supervisor respawns
    only after every worker of the outgoing generation acked."""

    def __init__(self, directory: str):
        self.dir = directory
        self._decided: Optional[Tuple[int, int]] = None  # (epoch, target)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------- autoscaler

    def request_scale(self, target: int) -> int:
        """Post a scaling plan. Returns the new plan epoch."""
        epoch = self.plan()[0] + 1
        tmp = os.path.join(self.dir, f".plan.{epoch}.tmp")
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "target": int(target)}, f)
        os.replace(tmp, os.path.join(self.dir, "plan.json"))
        return epoch

    def plan(self) -> Tuple[int, Optional[int]]:
        """(epoch, target) of the current plan; (0, None) when none."""
        try:
            with open(os.path.join(self.dir, "plan.json")) as f:
                p = json.load(f)
            return int(p["epoch"]), int(p["target"])
        except (OSError, ValueError, KeyError):
            return 0, None

    # ---------------------------------------------------------- workers

    def should_scale(self) -> Optional[int]:
        """Poll at a step boundary. Returns the target process count when a
        plan newer than `DEEPREC_ELASTIC_EPOCH` (the epoch this generation
        was started for) is posted, else None. In a process group rank 0's
        view is broadcast, so every process decides at the same step."""
        done_epoch = int(os.environ.get("DEEPREC_ELASTIC_EPOCH", "0"))
        rank, world = _rank_world()
        epoch, target = self.plan() if rank == 0 else (0, None)
        if world > 1:
            import torch.distributed as dist

            view = [epoch, target]
            dist.broadcast_object_list(view, src=0)
            epoch, target = view
        if target is not None and epoch > done_epoch:
            # every process remembers the SAME decision: acks reference it,
            # not a re-read of plan.json a racing autoscaler may replace
            self._decided = (epoch, target)
            return target
        return None

    def ack_rescale(self) -> None:
        """ReadyToUpdate: mark this process ready for the topology swap,
        after the rescale checkpoint is on disk and right before exiting
        with EXIT_RESCALE. The ack file holds the agreed target."""
        if self._decided is None:
            raise RuntimeError("ack_rescale without a should_scale decision")
        epoch, target = self._decided
        with open(os.path.join(self.dir, f"ack-{epoch}-{_rank_world()[0]:05d}"),
                  "w") as f:
            f.write(str(target))

    def acked(self, epoch: int, n: int) -> bool:
        """Supervisor side: has every worker of the outgoing generation
        acked plan `epoch`?"""
        return all(os.path.exists(os.path.join(self.dir, f"ack-{epoch}-{p:05d}"))
                   for p in range(n))

    def wait_acked_after(self, after_epoch: int, n: int,
                         timeout: float = 300.0) -> Tuple[int, int]:
        """Supervisor side: wait until SOME epoch > after_epoch has all `n`
        worker acks; return (epoch, target). Scans the acks rather than
        trusting plan.json (the workers may have agreed on an older plan
        than the latest posted one)."""
        deadline = time.time() + timeout
        pat = re.compile(r"ack-(\d+)-\d{5}$")
        while True:
            epochs = sorted({
                int(m.group(1))
                for p in glob.glob(os.path.join(self.dir, "ack-*"))
                if (m := pat.search(p)) and int(m.group(1)) > after_epoch
            })
            for e in epochs:
                if self.acked(e, n):
                    with open(os.path.join(self.dir, f"ack-{e}-00000")) as f:
                        return e, int(f.read().strip())
            if time.time() > deadline:
                raise TimeoutError(
                    f"elastic: {n} workers did not ack any plan after "
                    f"epoch {after_epoch} within {timeout}s")
            time.sleep(0.05)

    def wait_acked(self, epoch: int, n: int, timeout: float = 300.0) -> None:
        deadline = time.time() + timeout
        while not self.acked(epoch, n):
            if time.time() > deadline:
                raise TimeoutError(
                    f"elastic: {n} workers did not ack plan {epoch} within "
                    f"{timeout}s")
            time.sleep(0.05)
