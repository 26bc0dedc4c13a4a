from deeprec_tpu_torch.data.prefetch import Prefetcher, staged
from deeprec_tpu_torch.data.synthetic import (
    CriteoStats, SyntheticBehaviorSequence, SyntheticCriteo, SyntheticMultiTask, SyntheticTwoTower,
    zipf_ids)

__all__ = ["CriteoStats", "Prefetcher", "SyntheticBehaviorSequence", "SyntheticCriteo", "SyntheticMultiTask",
           "SyntheticTwoTower", "staged", "zipf_ids"]
