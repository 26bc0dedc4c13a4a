"""The modelzoo: Criteo, behavior-sequence, two-tower and multi-task
models, and the name registry."""
from deeprec_tpu_torch.models.bst import BST
from deeprec_tpu_torch.models.dcn import DCN, DCNv2
from deeprec_tpu_torch.models.deepfm import DeepFM
from deeprec_tpu_torch.models.dien import DIEN
from deeprec_tpu_torch.models.din import DIN
from deeprec_tpu_torch.models.dlrm import DLRM, DLRMDCN
from deeprec_tpu_torch.models.dssm import DSSM
from deeprec_tpu_torch.models.masknet import MaskNet
from deeprec_tpu_torch.models.multitask import DBMTL, ESMM, MMoE, PLE, SimpleMultiTask
from deeprec_tpu_torch.models.registry import REGISTRY, build_model
from deeprec_tpu_torch.models.wdl import WDL

__all__ = ["BST", "DBMTL", "DCN", "DCNv2", "DIEN", "DIN", "DLRM", "DLRMDCN", "DSSM",
           "DeepFM", "ESMM", "MMoE", "MaskNet", "PLE", "REGISTRY", "SimpleMultiTask",
           "WDL", "build_model"]
