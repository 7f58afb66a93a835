"""Build document — one buildvariant instantiation within a version
(reference model/build/build.go).

A copy of ``evergreen_tpu/models/build.py``: ``mark_end`` rolls a task's
status up to its build (``models/lifecycle.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..globals import BuildStatus
from ..storage.store import Collection, Store

COLLECTION = "builds"


@dataclasses.dataclass
class Build:
    id: str
    version: str = ""
    project: str = ""
    build_variant: str = ""
    display_name: str = ""
    revision: str = ""
    revision_order_number: int = 0
    requester: str = ""
    status: str = BuildStatus.CREATED.value
    activated: bool = False
    activated_time: float = 0.0
    create_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    tasks: List[str] = dataclasses.field(default_factory=list)

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["_id"] = doc.pop("id")
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "Build":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        return cls(**{k: v for k, v in doc.items() if k in _BUILD_FIELDS})


_BUILD_FIELDS = frozenset(f.name for f in dataclasses.fields(Build))


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def get(store: Store, build_id: str) -> Optional[Build]:
    doc = coll(store).get(build_id)
    return Build.from_doc(doc) if doc else None


def find_by_version(store: Store, version_id: str) -> List[Build]:
    return [Build.from_doc(d)
            for d in coll(store).find(lambda d: d["version"] == version_id)]
