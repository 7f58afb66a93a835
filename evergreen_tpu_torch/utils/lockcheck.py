"""Lock constructors with a role name.

The part of ``evergreen_tpu/utils/lockcheck.py`` the store and the
capacity plane create their locks through. The role names are kept so a
lock is created at the same site under the same name in both packages;
the JAX package's runtime lock-order witness (``EVERGREEN_TPU_LOCKCHECK``)
is not ported, so each factory returns the raw ``threading`` primitive,
as the JAX package does with the witness off.
"""
from __future__ import annotations

import threading


def make_lock(role: str):
    """A ``threading.Lock`` for the lock role ``role``."""
    return threading.Lock()


def make_rlock(role: str):
    """A ``threading.RLock`` for the lock role ``role``."""
    return threading.RLock()


def make_condition(role: str):
    """A ``threading.Condition`` over a new lock of role ``role``."""
    return threading.Condition(make_lock(role))
