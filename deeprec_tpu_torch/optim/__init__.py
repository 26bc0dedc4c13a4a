from deeprec_tpu_torch.optim.apply import apply_gradients, ensure_slots
from deeprec_tpu_torch.optim.dense import adam
from deeprec_tpu_torch.optim.sparse import (
    REGISTRY, Adagrad, AdagradDecay, Adam, AdamAsync, AdamW, Ftrl,
    GradientDescent, SparseOptimizer, make,
)

__all__ = [
    "REGISTRY", "Adagrad", "AdagradDecay", "Adam", "AdamAsync", "AdamW",
    "Ftrl", "GradientDescent", "SparseOptimizer", "adam", "apply_gradients",
    "ensure_slots", "make",
]
