"""Per-project variables with private redaction and copy semantics.

A copy of ``evergreen_tpu/models/project_vars.py`` (reference
model/project_vars.go: ProjectVars{Vars map[string]string, PrivateVars
map[string]bool} stored per project ref), whole: ``ProjectVars`` with
``to_doc``, ``from_doc`` and ``redacted``; ``get``, ``upsert`` and
``copy_vars``, whose semantics mirror rest/route/project_copy.go
copyVariablesHandler.Run: dry_run returns the redacted preview of what
would be copied without writing; a real run merges into the destination
(or replaces it when overwrite is set); private vars are dropped unless
include_private. The REST surface's project copy routes call it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from ..storage.store import Store

COLLECTION = "project_vars"


@dataclasses.dataclass
class ProjectVars:
    project_id: str
    vars: Dict[str, str] = dataclasses.field(default_factory=dict)
    private_vars: Dict[str, bool] = dataclasses.field(default_factory=dict)

    def to_doc(self) -> dict:
        return {
            "_id": self.project_id,
            "vars": dict(self.vars),
            "private_vars": dict(self.private_vars),
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "ProjectVars":
        return cls(
            project_id=doc["_id"],
            vars=dict(doc.get("vars", {})),
            private_vars=dict(doc.get("private_vars", {})),
        )

    def redacted(self) -> Dict[str, str]:
        """Private values blanked (reference RedactPrivateVars)."""
        return {
            k: "" if self.private_vars.get(k) else v
            for k, v in self.vars.items()
        }


def get(store: Store, project_id: str) -> ProjectVars:
    doc = store.collection(COLLECTION).get(project_id)
    return ProjectVars.from_doc(doc) if doc else ProjectVars(project_id)


def upsert(store: Store, pv: ProjectVars) -> None:
    store.collection(COLLECTION).upsert(pv.to_doc())


def copy_vars(
    store: Store,
    copy_from: str,
    copy_to: str,
    dry_run: bool = False,
    include_private: bool = False,
    overwrite: bool = False,
) -> Dict[str, str]:
    """reference rest/route/project_copy.go copyVariablesHandler.Run.
    Returns the (redacted) vars that were — or on dry_run, would be —
    written to the destination."""
    src = get(store, copy_from)
    vars_to_copy = dict(src.vars)
    private = dict(src.private_vars)
    if not include_private:
        for k in list(vars_to_copy):
            if private.get(k):
                del vars_to_copy[k]
                del private[k]
    redacted = {k: "" if private.get(k) else v for k, v in vars_to_copy.items()}
    if dry_run:
        return redacted
    dst = get(store, copy_to)
    if overwrite:
        dst.vars = {}
        dst.private_vars = {}
    dst.vars.update(vars_to_copy)
    dst.private_vars.update({k: True for k in private if private[k]})
    dst.project_id = copy_to
    upsert(store, dst)
    return redacted
