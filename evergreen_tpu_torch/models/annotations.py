"""Task annotations + build baron.

A copy of ``evergreen_tpu/models/annotations.py``, whole (reference
model/annotations/: failure annotations with suspected and linked issues;
model/build_baron.go: ticket search hooks for known failures). A task
execution's annotation is one ``task_annotations`` document keyed
``<task>:<execution>``; the ticket system is a pluggable per-project
callback (``register_ticket_searcher``, the thirdparty/jira.go seam).
The REST surface's annotation routes read and write it.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, Dict, List, Optional

from ..storage.store import Store

COLLECTION = "task_annotations"


@dataclasses.dataclass
class IssueLink:
    url: str
    issue_key: str = ""
    source: str = ""  # api | build-baron | user
    added_by: str = ""


@dataclasses.dataclass
class Annotation:
    task_id: str
    execution: int = 0
    note: str = ""
    issues: List[IssueLink] = dataclasses.field(default_factory=list)
    suspected_issues: List[IssueLink] = dataclasses.field(default_factory=list)
    webhook_configured: bool = False
    updated_at: float = 0.0


def _doc_id(task_id: str, execution: int) -> str:
    return f"{task_id}:{execution}"


def get_annotation(
    store: Store, task_id: str, execution: int = 0
) -> Optional[Annotation]:
    doc = store.collection(COLLECTION).get(_doc_id(task_id, execution))
    if doc is None:
        return None
    doc = {k: v for k, v in doc.items() if k != "_id"}
    doc["issues"] = [IssueLink(**i) for i in doc.get("issues", [])]
    doc["suspected_issues"] = [
        IssueLink(**i) for i in doc.get("suspected_issues", [])
    ]
    return Annotation(**doc)


def upsert_annotation(store: Store, ann: Annotation) -> None:
    ann.updated_at = _time.time()
    doc = dataclasses.asdict(ann)
    doc["_id"] = _doc_id(ann.task_id, ann.execution)
    store.collection(COLLECTION).upsert(doc)


def add_issue(
    store: Store, task_id: str, execution: int, issue: IssueLink,
    suspected: bool = False,
) -> None:
    ann = get_annotation(store, task_id, execution) or Annotation(
        task_id=task_id, execution=execution
    )
    (ann.suspected_issues if suspected else ann.issues).append(issue)
    upsert_annotation(store, ann)


def remove_issue(
    store: Store, task_id: str, execution: int, issue_key: str,
    suspected: bool = False,
) -> bool:
    """Drop an issue link by key (reference annotations RemoveIssueFromAnnotation)."""
    ann = get_annotation(store, task_id, execution)
    if ann is None:
        return False
    links = ann.suspected_issues if suspected else ann.issues
    kept = [l for l in links if l.issue_key != issue_key]
    if len(kept) == len(links):
        return False
    if suspected:
        ann.suspected_issues = kept
    else:
        ann.issues = kept
    upsert_annotation(store, ann)
    return True


def move_issue_to_suspected(
    store: Store, task_id: str, execution: int, issue_key: str,
    to_suspected: bool = True,
) -> bool:
    """Move a link between issues↔suspected (reference MoveIssueToAnnotation)."""
    ann = get_annotation(store, task_id, execution)
    if ann is None:
        return False
    src = ann.issues if to_suspected else ann.suspected_issues
    dst = ann.suspected_issues if to_suspected else ann.issues
    for link in list(src):
        if link.issue_key == issue_key:
            src.remove(link)
            dst.append(link)
            upsert_annotation(store, ann)
            return True
    return False


def set_note(store: Store, task_id: str, execution: int, note: str) -> None:
    """Replace the annotation note (reference UpdateAnnotationNote)."""
    ann = get_annotation(store, task_id, execution) or Annotation(
        task_id=task_id, execution=execution
    )
    ann.note = note
    upsert_annotation(store, ann)


#: build-baron ticket search: project id + task doc → suspected issues
TicketSearcher = Callable[[str, dict], List[IssueLink]]
_TICKET_SEARCHERS: Dict[str, TicketSearcher] = {}


def register_ticket_searcher(project: str, searcher: TicketSearcher) -> None:
    _TICKET_SEARCHERS[project] = searcher


def build_baron_suggest(store: Store, task_id: str) -> List[IssueLink]:
    """Suggest tickets for a failed task (reference model/build_baron.go)."""
    doc = store.collection("tasks").get(task_id)
    if doc is None:
        return []
    searcher = _TICKET_SEARCHERS.get(doc["project"])
    if searcher is None:
        return []
    suggestions = searcher(doc["project"], doc)
    for link in suggestions:
        add_issue(store, task_id, doc.get("execution", 0), link, suspected=True)
    return suggestions
