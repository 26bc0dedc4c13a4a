"""Name -> model class — the port of `deeprec_tpu/models/registry.py`: the
same 18 names, each mapped to the port's class of the same name.
Constructor keywords are the JAX dataclass fields plus `seed`."""
from __future__ import annotations

from deeprec_tpu_torch.models.bst import BST
from deeprec_tpu_torch.models.dcn import DCN, DCNv2
from deeprec_tpu_torch.models.deepfm import DeepFM
from deeprec_tpu_torch.models.dien import DIEN
from deeprec_tpu_torch.models.din import DIN
from deeprec_tpu_torch.models.dlrm import DLRM, DLRMDCN
from deeprec_tpu_torch.models.dssm import DSSM
from deeprec_tpu_torch.models.masknet import MaskNet
from deeprec_tpu_torch.models.multitask import DBMTL, ESMM, MMoE, PLE, SimpleMultiTask
from deeprec_tpu_torch.models.wdl import WDL

REGISTRY = {
    "wdl": WDL,
    "wide_and_deep": WDL,
    "dlrm": DLRM,
    "dlrm_dcn": DLRMDCN,
    "mlperf": DLRMDCN,
    "deepfm": DeepFM,
    "dcn": DCN,
    "dcnv2": DCNv2,
    "din": DIN,
    "dien": DIEN,
    "bst": BST,
    "dssm": DSSM,
    "masknet": MaskNet,
    "mmoe": MMoE,
    "ple": PLE,
    "esmm": ESMM,
    "dbmtl": DBMTL,
    "simple_multitask": SimpleMultiTask,
}


def build_model(name: str, **kwargs):
    try:
        cls = REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; choose from {sorted(REGISTRY)}") from None
    return cls(**kwargs)
