"""One capped-exponential-with-jitter backoff policy for every retry
loop — the port's copy of `deeprec_tpu/utils/backoff.py`.

Before this module the same policy was hand-rolled three times —
`TCPStreamReader.backoff_delay` (broker reconnects), the frontend's
`_Member.mark_down` (dead-backend routing backoff), and the serving
`_run_poll_loop` (delta-poll failures) — plus a fourth in the online
`Supervisor._restart`. Each re-derived the identical
``min(cap, base * 2^(k-1))`` shape with a ``[0.5, 1.5)`` jitter band and
each clamped the exponent differently, which is exactly the kind of
near-duplicate drift DRT lint rules can't see. The helpers here are
PURE (no sleeping, no clocks) so tests pin the whole policy without
waiting on it; callers own their RNG so jitter stays per-instance
deterministic where the call sites seeded it that way.
"""
from __future__ import annotations

import random
from typing import Optional

#: exponent clamp: 2**20 of any sane base is far past any cap, and an
#: unbounded attempt counter must never overflow the float exponent.
MAX_EXPONENT = 20


def backoff_delay(attempt: int, base: float, cap: float,
                  max_exponent: int = MAX_EXPONENT) -> float:
    """Capped exponential delay BEFORE jitter: the k-th consecutive
    failure (attempt=k, 1-based) waits ``base * 2**(k-1)``, never above
    ``cap``. ``attempt <= 1`` waits the base. Pure — pinned by unit
    tests without sleeping."""
    return min(cap, base * (2 ** max(0, min(attempt - 1, max_exponent))))


def jittered(delay: float, rng: random.Random,
             lo: float = 0.5, hi: float = 1.5) -> float:
    """Spread ``delay`` across ``[lo, hi) * delay`` so N clients hitting
    one dead peer don't re-probe in lockstep (the thundering-herd half
    of the policy; every call site uses the same band)."""
    return delay * (lo + (hi - lo) * rng.random())


def jittered_backoff(attempt: int, base: float, cap: float,
                     rng: random.Random,
                     max_exponent: int = MAX_EXPONENT,
                     lo: float = 0.5, hi: float = 1.5) -> float:
    """``jittered(backoff_delay(...))`` — the composition every retry
    loop actually sleeps on."""
    return jittered(backoff_delay(attempt, base, cap, max_exponent),
                    rng, lo, hi)


def seeded_rng(*identity, pid: Optional[int] = None) -> random.Random:
    """Per-instance jitter RNG seeded from an identity tuple
    (host, port, ...) so two members of one fleet never share a jitter
    stream. Stable within a process only — str hashing is salted per
    process, which is FINE for jitter (unlike routing: see the frontend's
    `_group_key`, which must use crc32 for exactly that reason). Pass
    ``pid`` to additionally decorrelate processes sharing an identity."""
    seed = hash(identity) & 0xFFFFFFFF
    if pid is not None:
        seed ^= pid & 0xFFFFFFFF
    return random.Random(seed)
