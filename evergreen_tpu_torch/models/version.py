"""Version document — one revision (or patch) of a project
(reference model/version.go).

A copy of ``evergreen_tpu/models/version.py``'s document and the lookups
``mark_end``'s status rollup reads (``models/lifecycle.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..globals import VersionStatus
from ..storage.store import Collection, Store

COLLECTION = "versions"


@dataclasses.dataclass
class Version:
    id: str
    project: str = ""
    branch: str = ""
    revision: str = ""
    revision_order_number: int = 0
    requester: str = ""
    author: str = ""
    message: str = ""
    status: str = VersionStatus.CREATED.value
    activated: bool = False
    create_time: float = 0.0
    start_time: float = 0.0
    finish_time: float = 0.0
    build_ids: List[str] = dataclasses.field(default_factory=list)
    build_variants_status: List[dict] = dataclasses.field(default_factory=list)
    config_yaml: str = ""
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)
    ignored: bool = False

    def to_doc(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["_id"] = doc.pop("id")
        return doc

    @classmethod
    def from_doc(cls, doc: dict) -> "Version":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        return cls(**{k: v for k, v in doc.items() if k in _VERSION_FIELDS})


_VERSION_FIELDS = frozenset(f.name for f in dataclasses.fields(Version))


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def get(store: Store, version_id: str) -> Optional[Version]:
    doc = coll(store).get(version_id)
    return Version.from_doc(doc) if doc else None
