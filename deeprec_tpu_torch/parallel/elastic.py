"""The elastic-rescale exit code of `deeprec_tpu/parallel/elastic.py`.

A worker that leaves on purpose (a serving member draining for a rolling
restart, a trainer asked to rescale) exits with `EXIT_RESCALE`; a
`online.Supervisor` respawns such a worker at once, without charging its
restart budget. Only this constant is ported so far: the rest of the
module (the rescale choreography of a sharded trainer) is ROADMAP queue A
item 8.
"""
from __future__ import annotations

EXIT_RESCALE = 42
