"""The port's modelzoo driver (`common.py`): `python -m
deeprec_tpu_torch.modelzoo --model <name> [flags]`, the flags of
`modelzoo/common.py` plus `--model` and `--device`."""
from deeprec_tpu_torch.modelzoo.common import (
    MODELS, build_argparser, ev_option, main, make_data, make_optimizers, model_fn, run)

__all__ = ["MODELS", "build_argparser", "ev_option", "main", "make_data", "make_optimizers",
           "model_fn", "run"]
