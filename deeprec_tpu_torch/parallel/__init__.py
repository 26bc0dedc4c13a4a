"""Multi-process training support: elastic re-scaling (`elastic.py`:
`EXIT_RESCALE`, `ElasticCoordinator`, `reshard` on one device,
`factorize_mesh`). The device mesh and the sharded trainer are ROADMAP
queue A item 6."""
from deeprec_tpu_torch.parallel.elastic import (
    EXIT_RESCALE, ElasticCoordinator, factorize_mesh, reshard)

__all__ = ["EXIT_RESCALE", "ElasticCoordinator", "factorize_mesh", "reshard"]
