"""Multi-process training: the mesh over `torch.distributed` and its
collectives (`mesh.py`), hash-sharded tables with the allgather, a2a and
hier exchanges (`sharded.py`), the sharded trainer (`trainer.py`) with its
skew-aware placement plans, drift-driven replanner and row migration
(`placement.py`) and learned cost model (`costmodel.py`), the stale-by-one
async embedding stage (`async_stage.py`), sequence-parallel ring attention
(`ring_attention.py`) and elastic re-scaling (`elastic.py`:
`EXIT_RESCALE`, `ElasticCoordinator`, `reshard`, `factorize_mesh`,
`plan_mesh_after_rescale`)."""
from deeprec_tpu_torch.parallel.elastic import (
    EXIT_RESCALE, ElasticCoordinator, factorize_mesh, plan_mesh_after_rescale, reshard)
from deeprec_tpu_torch.parallel.mesh import (
    DATA_AXIS, INTER_AXIS, INTRA_AXIS, Mesh, axis_size, make_mesh, make_mesh_2d,
    mesh_batch_axes, ppermute, put_global, put_tiled_global, shard_batch)
from deeprec_tpu_torch.parallel.placement import plan_owner
from deeprec_tpu_torch.parallel.sharded import ShardedLookup, ShardedRoute, ShardedTable
from deeprec_tpu_torch.parallel.trainer import ShardedTrainer
from deeprec_tpu_torch.parallel.async_stage import AsyncShardedTrainer, AsyncState
from deeprec_tpu_torch.parallel.ring_attention import ring_attention, ring_attention_sharded

__all__ = ["EXIT_RESCALE", "ElasticCoordinator", "factorize_mesh", "plan_mesh_after_rescale",
           "reshard", "DATA_AXIS", "INTER_AXIS", "INTRA_AXIS", "Mesh", "axis_size",
           "make_mesh", "make_mesh_2d", "mesh_batch_axes", "ppermute", "put_global",
           "put_tiled_global", "shard_batch", "plan_owner", "ShardedLookup", "ShardedRoute",
           "ShardedTable", "ShardedTrainer", "AsyncShardedTrainer", "AsyncState",
           "ring_attention", "ring_attention_sharded"]
