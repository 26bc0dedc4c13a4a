from deeprec_tpu_torch.data.synthetic import SyntheticCriteo, zipf_ids

__all__ = ["SyntheticCriteo", "zipf_ids"]
