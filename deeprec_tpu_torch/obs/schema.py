"""The one health/stats schema every serving surface emits.

Before this module the stack had three near-duplicate health shapes —
``Predictor.health()`` (the `/healthz` body), the socket frontend's
``_health_sweep()`` merge (which invented its own synthetic down-member
entries), and the online ``ServeLoop`` heartbeat stamp (a hand-picked
subset) — plus ad-hoc keys sprinkled per surface. Watchdogs had to know
which shape they were reading.

``health_payload()`` is now the single constructor: every canonical key
is always present (defaulted when unknown), extra surface-specific keys
ride along unchanged, and the payload self-identifies via ``schema``.
The canonical names ARE the historical predictor keys, so every existing
consumer (tests, `/healthz` scrapers, the supervisor's wedge detection)
keeps working unchanged — old keys are the aliases, kept forever.

The same fields are what the metrics plane exposes as gauges
(deeprec_serving_staleness_seconds, ...) — see docs/observability.md for
the catalog.

The port's copy of `deeprec_tpu/obs/schema.py` (it imports no jax; the port keeps its
own copy, as it does of every module it needs).
"""
from __future__ import annotations

from typing import Dict, Optional

HEALTH_SCHEMA = "deeprec.health/1"

# Canonical keys, in emission order. Everything here predates the obs
# plane — consolidation means one constructor, not new spellings.
CANONICAL_HEALTH_KEYS = (
    "status",                     # "ok" | "degraded" | "down" | "error"
    "model_version",
    "step",
    "staleness_seconds",          # age of the last SUCCESSFUL poll round
    "last_update_age_seconds",    # age of the last model change
    "consecutive_poll_failures",
    "last_good_version",
    "quarantined",
)


def health_payload(status: str, *,
                   model_version: Optional[int] = None,
                   step: Optional[int] = None,
                   staleness_seconds: Optional[float] = None,
                   last_update_age_seconds: Optional[float] = None,
                   consecutive_poll_failures: int = 0,
                   last_good_version: Optional[int] = None,
                   quarantined: int = 0,
                   **extra) -> Dict:
    """Build the canonical health dict. `extra` keys (members, reachable,
    member, error, replicas, ...) append after the canonical block so
    every surface stays free to add context without forking the shape."""
    out: Dict = {
        "schema": HEALTH_SCHEMA,
        "status": status,
        "model_version": model_version,
        "step": step,
        "staleness_seconds": staleness_seconds,
        "last_update_age_seconds": last_update_age_seconds,
        "consecutive_poll_failures": consecutive_poll_failures,
        "last_good_version": last_good_version,
        "quarantined": quarantined,
    }
    out.update(extra)
    return out


def is_health_payload(d: Dict) -> bool:
    return isinstance(d, dict) and all(k in d for k in CANONICAL_HEALTH_KEYS)
