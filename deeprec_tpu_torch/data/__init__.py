from deeprec_tpu_torch.data.synthetic import (
    SyntheticBehaviorSequence, SyntheticCriteo, zipf_ids)

__all__ = ["SyntheticBehaviorSequence", "SyntheticCriteo", "zipf_ids"]
