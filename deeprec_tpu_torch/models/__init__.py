"""Criteo and behavior-sequence models."""
from deeprec_tpu_torch.models.bst import BST
from deeprec_tpu_torch.models.dlrm import DLRM, DLRMDCN

__all__ = ["BST", "DLRM", "DLRMDCN"]
