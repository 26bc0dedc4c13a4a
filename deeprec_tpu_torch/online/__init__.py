"""Continuous-training subsystem — the port of `deeprec_tpu/online/`:
trainer -> delta chain -> serving as one supervised pipeline.

  * `online.loop.TrainLoop`   — consume a stream or a WorkQueue, emit
    `save_incremental_async` on a cadence, stamp heartbeats, honour the
    elastic EXIT_RESCALE contract, and (with a `GuardPolicy`) roll back
    on a step-sentinel trip.
  * `online.loop.ServeLoop`   — Predictor + ModelServer (+ optional HTTP
    front) polling the delta chain under live load, with a poll thread
    that survives any failure and heartbeats its health.
  * `online.supervisor`       — heartbeat leases, and a Supervisor that
    restarts dead or wedged workers under a backoff budget.
  * `online.faults`           — deterministic fault injectors (kill at
    step, torn checkpoint write, corrupt-delta bit flip, broker outage,
    data poison).
"""
_EXPORTS = {
    "TrainLoop": "deeprec_tpu_torch.online.loop",
    "ServeLoop": "deeprec_tpu_torch.online.loop",
    "wait_for_full_checkpoint": "deeprec_tpu_torch.online.loop",
    "Heartbeat": "deeprec_tpu_torch.online.supervisor",
    "ProcessSpec": "deeprec_tpu_torch.online.supervisor",
    "Supervisor": "deeprec_tpu_torch.online.supervisor",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    # Lazy re-exports: `python -m deeprec_tpu_torch.online.loop` must not
    # find the module pre-imported by its own package __init__ (runpy
    # warns, and the double import would run module code twice).
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
