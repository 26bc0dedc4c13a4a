"""Criteo models."""
from deeprec_tpu_torch.models.dlrm import DLRM, DLRMDCN

__all__ = ["DLRM", "DLRMDCN"]
