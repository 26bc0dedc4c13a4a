"""Training metrics logging — the port of `deeprec_tpu/training/logging.py`:
a JSONL metrics stream any dashboard can tail (modelzoo's
`--metrics_file`), and the table gauges (live keys per table)."""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricsLogger:
    """Append-only JSONL metrics: one record per call, wall-clock stamped.
    Scalars (0-d tensors included) are written as floats; anything else as
    it is."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **scalars: Any) -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def table_gauges(trainer, state) -> Dict[str, int]:
    """{"table_size/<table>": live keys} for every table of the trainer."""
    return {f"table_size/{name}": int(t.size(trainer.table_state(state, name)).sum())
            for name, t in trainer.tables.items()}
