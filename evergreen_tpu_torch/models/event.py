"""Typed event log — appended on every state change, read later by the
trigger and notification pipeline (reference model/event/ package).

A copy of ``evergreen_tpu/models/event.py``'s ``Event``, ``coll`` and
``log``, which the tick calls for the intent hosts it creates, the
overload ladder for its transitions and sheds, the recovery pass, the
task lifecycle (``models/lifecycle.py``) and the job plane (the queue,
provisioning and the monitors) for what they change, with the resource
types they log under. Event ids come from one process-wide sequence,
``evt-<n>``, as in the JAX package. The readers (``Event.from_doc``,
``find_unprocessed``, ``mark_processed``, ``find_by_resource``) and the
other resource types are not ported: nothing in the port reads events.
"""
from __future__ import annotations

import dataclasses
import itertools
import time as _time
from typing import Optional

from ..storage.store import Collection, Store
from ..utils import lockcheck as _lockcheck

COLLECTION = "events"

_SEQ = itertools.count()
_SEQ_LOCK = _lockcheck.make_lock("events.model_seq")
#: highest seq issued in this process — reseeding (after recovering a
#: store with surviving ids) must never move the shared counter BELOW
#: ids already handed out for another store
_SEQ_HWM = -1


# Resource types (reference model/event/event.go)
RESOURCE_TASK = "TASK"
RESOURCE_HOST = "HOST"
RESOURCE_BUILD = "BUILD"
RESOURCE_VERSION = "VERSION"
RESOURCE_DISTRO = "DISTRO"
RESOURCE_ADMIN = "ADMIN"


@dataclasses.dataclass
class Event:
    id: str
    resource_type: str
    event_type: str
    resource_id: str
    timestamp: float
    processed_at: float = 0.0
    data: dict = dataclasses.field(default_factory=dict)

    def to_doc(self) -> dict:
        # a flat doc with a shallow copy of the payload keeps the doc
        # detached from the caller's mapping
        return {
            "_id": self.id,
            "resource_type": self.resource_type,
            "event_type": self.event_type,
            "resource_id": self.resource_id,
            "timestamp": self.timestamp,
            "processed_at": self.processed_at,
            "data": dict(self.data),
        }


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def _reseed_past(c: Collection) -> None:
    """Resume the id sequence past the highest event id in ``c`` (a store
    that already holds ids ahead of this process's counter), never below
    the process-wide high-water mark."""
    global _SEQ
    floor = _SEQ_HWM
    for k in c.key_order():
        try:
            floor = max(floor, int(k.rsplit("-", 1)[1]))
        except (IndexError, ValueError):
            continue
    _SEQ = itertools.count(floor + 1)


def log(
    store: Store,
    resource_type: str,
    event_type: str,
    resource_id: str,
    data: Optional[dict] = None,
    timestamp: Optional[float] = None,
) -> Event:
    global _SEQ_HWM
    c = coll(store)
    for attempt in range(3):
        with _SEQ_LOCK:
            seq = next(_SEQ)
            _SEQ_HWM = max(_SEQ_HWM, seq)
        ev = Event(
            id=f"evt-{seq}",
            resource_type=resource_type,
            event_type=event_type,
            resource_id=resource_id,
            timestamp=_time.time() if timestamp is None else timestamp,
            data=data or {},
        )
        try:
            c.insert(ev.to_doc())
            return ev
        except KeyError:
            # the store carries ids ahead of this process's counter: jump
            # past them and retry (bounded — concurrent reseeders can only
            # move the counter forward)
            with _SEQ_LOCK:
                _reseed_past(c)
    raise KeyError("could not allocate a fresh event id after reseeding")
