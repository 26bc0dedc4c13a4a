"""The telemetry plane — for now only its metrics half, the port's copy of
`deeprec_tpu/obs/metrics.py`: the input readers' error counters, the input
stall gauge and the pipeline's emitted-batch counters write to it.
`DEEPREC_OBS=off` turns it into no-op singletons."""
from deeprec_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    default_registry,
    metrics_enabled,
    parse_prometheus,
)

__all__ = ["MetricsRegistry", "default_registry", "metrics_enabled", "parse_prometheus"]
