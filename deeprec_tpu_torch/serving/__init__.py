"""Serving."""
from deeprec_tpu_torch.serving.predictor import Predictor

__all__ = ["Predictor"]
