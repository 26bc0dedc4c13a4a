"""Model-quality firewall — the port holds only its serving half for now:
the pre-swap canary (`canary.QualityGate`), which `Predictor` evaluates on
the shadow state of every update before the snapshot swap. The sentinel,
the quarantine policy and the row hygiene of the JAX package's `guard/`
belong to the online loop (ROADMAP queue A item 8)."""
from deeprec_tpu_torch.guard.canary import QualityGate, QualityGateRejected, np_auc

__all__ = ["QualityGate", "QualityGateRejected", "np_auc"]
