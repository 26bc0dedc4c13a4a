"""Criteo and behavior-sequence models."""
from deeprec_tpu_torch.models.bst import BST
from deeprec_tpu_torch.models.dcn import DCN, DCNv2
from deeprec_tpu_torch.models.deepfm import DeepFM
from deeprec_tpu_torch.models.din import DIN
from deeprec_tpu_torch.models.dlrm import DLRM, DLRMDCN
from deeprec_tpu_torch.models.masknet import MaskNet
from deeprec_tpu_torch.models.wdl import WDL

__all__ = ["BST", "DCN", "DCNv2", "DIN", "DLRM", "DLRMDCN", "DeepFM", "MaskNet",
           "WDL"]
