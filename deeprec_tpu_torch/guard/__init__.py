"""Model-quality firewall — the port of `deeprec_tpu/guard/`: defense
against semantic faults, where every process is healthy but the MODEL goes
bad (a poisoned batch or an exploding gradient writes NaN or garbage rows,
and the delta chain would ship them to serving).

  * `sentinel`   — per-step checks on the device (non-finite loss or grad,
    a loss spike against an EMA, the global grad norm, the updated rows'
    norm) packed into ONE int32 flags scalar per step, read by the online
    loop one dispatch later.
  * `quarantine` — the TrainLoop's rollback policy: a tripped dispatch
    restores the last verified checkpoint, replays the window minus the
    poisoned batch, dead-letters it, and permanently quarantines a batch
    that trips `max_batch_trips` times.
  * `rows`       — the sentinel's touched-row norms and optional clamp, and
    `Trainer.maintain`'s anomaly eviction.
  * `canary`     — the pre-swap quality gate that `Predictor` evaluates on
    the shadow state of every update.
"""
from deeprec_tpu_torch.guard.canary import QualityGate, QualityGateRejected, np_auc
from deeprec_tpu_torch.guard.quarantine import DeadLetter, GuardPolicy, batch_fingerprint
from deeprec_tpu_torch.guard.sentinel import (
    FLAG_GRAD_NORM,
    FLAG_LOSS_SPIKE,
    FLAG_NONFINITE_GRAD,
    FLAG_NONFINITE_LOSS,
    FLAG_ROW_NORM,
    SentinelConfig,
    flag_kinds,
    guard_init,
)

__all__ = [
    "SentinelConfig", "guard_init", "flag_kinds",
    "FLAG_NONFINITE_LOSS", "FLAG_NONFINITE_GRAD", "FLAG_GRAD_NORM",
    "FLAG_LOSS_SPIKE", "FLAG_ROW_NORM",
    "GuardPolicy", "DeadLetter", "batch_fingerprint",
    "QualityGate", "QualityGateRejected", "np_auc",
]
