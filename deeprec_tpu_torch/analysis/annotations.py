"""Thread-safety annotation vocabulary — the port's copy of
`deeprec_tpu/analysis/annotations.py`.

Decorators that stamp a metadata attribute and return the object unchanged
(no import weight, no call overhead). They document the locking protocol
of a class for its reader and for the JAX package's static analyzer, which
reads them syntactically:

``@not_thread_safe``
    The object has no internal synchronization; a background thread may
    touch it only under an external protocol (a drain barrier, a single
    writer).

``@guarded_by("lockattr")``
    The object's fields are protected by ``self.<lockattr>``; its methods
    take the lock and form the thread-safe API.
"""
from __future__ import annotations

NOT_THREAD_SAFE_ATTR = "__deeprec_not_thread_safe__"
GUARDED_BY_ATTR = "__deeprec_guarded_by__"


def not_thread_safe(obj):
    """Mark a class or function as having no internal synchronization."""
    setattr(obj, NOT_THREAD_SAFE_ATTR, True)
    return obj


def guarded_by(lock_attr: str):
    """Mark a class whose fields are guarded by ``self.<lock_attr>``."""

    def mark(obj):
        setattr(obj, GUARDED_BY_ATTR, lock_attr)
        return obj

    return mark


def is_not_thread_safe(obj) -> bool:
    return bool(getattr(obj, NOT_THREAD_SAFE_ATTR, False))


def guard_lock_of(obj):
    """The guarding lock attribute name, or None."""
    return getattr(obj, GUARDED_BY_ATTR, None)
