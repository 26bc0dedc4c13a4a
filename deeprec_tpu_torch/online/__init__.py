"""Process supervision (`online/supervisor.py`): heartbeat leases and a
Supervisor that restarts dead or wedged workers under a backoff budget —
the part of `deeprec_tpu/online/` the serving fleet needs. The training
and serving loops (`loop.py`) and the fault injectors (`faults.py`) are
ROADMAP queue A item 8."""
from deeprec_tpu_torch.online.supervisor import Heartbeat, ProcessSpec, Supervisor

__all__ = ["Heartbeat", "ProcessSpec", "Supervisor"]
