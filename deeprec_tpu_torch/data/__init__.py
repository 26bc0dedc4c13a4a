from deeprec_tpu_torch.data.synthetic import (
    SyntheticBehaviorSequence, SyntheticCriteo, SyntheticMultiTask, SyntheticTwoTower,
    zipf_ids)

__all__ = ["SyntheticBehaviorSequence", "SyntheticCriteo", "SyntheticMultiTask",
           "SyntheticTwoTower", "zipf_ids"]
