"""Cmp-based task prioritizer — the reference's alternative comparator-chain
planner, selectable per distro via ``PlannerSettings.version = "cmpbased"``.

Reference: scheduler/task_prioritizer.go:81 (``PrioritizeTasks``: requester
split → per-bucket stable sort → 1:1 interleave merge), comparator chain
order task_prioritizer.go:60-68, the seven comparators
scheduler/task_priority_cmp.go:22-199, and the sort setup functions
scheduler/setup_funcs.go:35 (duration prefetch) and :72 (task-group
pre-grouping). The reference keeps this planner in-tree as the alternative
to the tunable planner (scheduler/scheduler.go:28-33 currently hardwires
tunable); here either is selectable and cmp-based distros are planned
host-side next to the batched solve. A copy of
``evergreen_tpu/scheduler/cmp_prioritizer.py``.

The chain is deliberately kept as a cmp function rather than a sort key:
``byAge`` compares revision order for same-project commit pairs but ingest
time otherwise, which no lexicographic key encodes. Python's stable sort
with ``cmp_to_key`` yields a deterministic order consistent with the chain
— the same contract as the reference's ``sort.Stable`` (whose ``Less`` is
likewise not a total order, so exact tie layout is algorithm-defined in
both implementations).
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, List, Optional, Tuple

from ..globals import (
    GITHUB_MERGE_REQUESTER,
    MAX_TASK_PRIORITY,
    is_mainline_requester,
    is_patch_requester,
)
from ..models.task import Task

_log = logging.getLogger(__name__)

#: comparator outcome: 1 → t1 more important, -1 → t2, 0 → next
#: comparator, None → terminal tie (stop the chain, keep stable order)
CmpResult = Tuple[Optional[int], str]


def _by_task_group_order(t1: Task, t2: Task, _v) -> CmpResult:
    """task_priority_cmp.go:126 byTaskGroupOrder: grouped tasks sort ahead
    of ungrouped; same group+build by GroupIndex; different groups keep the
    pre-sort's lexical (build, group) order so later comparators can't
    interleave groups.

    Continues the chain ONLY for ungrouped pairs. Any pair involving a
    grouped task is decided here; equal-order same-group pairs are a
    TERMINAL tie (the reference falls through to the lexical compare with
    equal keys, making Less false in both directions, so sort.Stable keeps
    the pre-sort order and no later comparator ever runs) — letting
    byPriority et al. reorder group members would break the 'dispatched in
    definition order' guarantee this comparator exists to enforce."""
    if not t1.task_group and not t2.task_group:
        return 0, ""
    if t1.task_group and not t2.task_group:
        return 1, "the task in a task group is first"
    if t2.task_group and not t1.task_group:
        return -1, "the task in a task group is first"
    if t1.task_group == t2.task_group and t1.build_id == t2.build_id:
        if t1.task_group_order < t2.task_group_order:
            return 1, "earlier in the same task group"
        if t2.task_group_order < t1.task_group_order:
            return -1, "earlier in the same task group"
        return None, "same group and order: stable order kept"
    k1 = f"{t1.build_id}-{t1.task_group}"
    k2 = f"{t2.build_id}-{t2.task_group}"
    if k1 < k2:
        return 1, "different groups, sorting lexically"
    if k2 < k1:
        return -1, "different groups, sorting lexically"
    return None, "colliding group keys: stable order kept"


def _by_commit_queue(t1: Task, t2: Task, version_requesters: Dict[str, str]) -> CmpResult:
    """task_priority_cmp.go:182 byCommitQueue: tasks of merge-queue
    versions outrank everything below the group comparator."""
    m1 = version_requesters.get(t1.version, t1.requester) == GITHUB_MERGE_REQUESTER
    m2 = version_requesters.get(t2.version, t2.requester) == GITHUB_MERGE_REQUESTER
    if m1 and not m2:
        return 1, "merge queue task is first"
    if m2 and not m1:
        return -1, "merge queue task is first"
    return 0, ""


def _by_priority(t1: Task, t2: Task, _v) -> CmpResult:
    if t1.priority > t2.priority:
        return 1, "higher priority is first"
    if t1.priority < t2.priority:
        return -1, "higher priority is first"
    return 0, ""


def _by_num_deps(t1: Task, t2: Task, _v) -> CmpResult:
    if t1.num_dependents > t2.num_dependents:
        return 1, "more dependents is first"
    if t1.num_dependents < t2.num_dependents:
        return -1, "more dependents is first"
    return 0, ""


def _by_generate_tasks(t1: Task, t2: Task, _v) -> CmpResult:
    if t1.generate_task == t2.generate_task:
        return 0, ""
    return (1 if t1.generate_task else -1), "generator task is first"


def _by_age(t1: Task, t2: Task, _v) -> CmpResult:
    """task_priority_cmp.go:69 byAge multi-tenant policy: same-project
    commit pairs prefer the NEWER revision (stale mainline work is
    superseded); everything else prefers the OLDER ingest time (fairness
    across tenants and patches)."""
    if (
        is_mainline_requester(t1.requester)
        and is_mainline_requester(t2.requester)
        and t1.project == t2.project
    ):
        if t1.revision_order_number > t2.revision_order_number:
            return 1, "newer commit from the same project is first"
        if t1.revision_order_number < t2.revision_order_number:
            return -1, "newer commit from the same project is first"
        return 0, ""
    if t1.ingest_time < t2.ingest_time:
        return 1, "older is first"
    if t2.ingest_time < t1.ingest_time:
        return -1, "older is first"
    return 0, ""


def _by_runtime(t1: Task, t2: Task, _v) -> CmpResult:
    """task_priority_cmp.go:99 byRuntime: longer expected tasks start
    first to shorten makespan; unknown (zero) durations never decide."""
    e1 = t1.expected_duration_s
    e2 = t2.expected_duration_s
    if e1 == 0 or e2 == 0 or e1 == e2:
        return 0, ""
    return (1 if e1 > e2 else -1), "longer expected runtime is first"


#: chain order is load-bearing (task_prioritizer.go:60-68)
COMPARATORS = (
    ("order within task group", _by_task_group_order),
    ("merge queue", _by_commit_queue),
    ("task priority", _by_priority),
    ("number of dependents", _by_num_deps),
    ("task generator", _by_generate_tasks),
    ("task age", _by_age),
    ("expected runtime", _by_runtime),
)


def explain_order(
    t1: Task, t2: Task, version_requesters: Optional[Dict[str, str]] = None
) -> str:
    """Which comparator decides the pair, and why — the usable form of the
    reference's O(n²) orderingLogic debug map (task_prioritizer.go:199-206)."""
    vr = version_requesters or {}
    for name, cmp in COMPARATORS:
        ret, reason = cmp(t1, t2, vr)
        if ret is None:
            return f"{name}: {reason} ({t1.id} / {t2.id})"
        if ret:
            first, second = (t1, t2) if ret > 0 else (t2, t1)
            return f"{name}: {reason} ({first.id} before {second.id})"
    return "tie: insertion order preserved"


def split_by_requester(
    tasks: List[Task],
) -> Tuple[List[Task], List[Task], List[Task], List[Task]]:
    """task_prioritizer.go:215-250 splitTasksByRequester → (high-priority,
    patch, mainline, dropped). Over-MaxTaskPriority tasks always lead the
    queue; system requesters (incl. periodic/ad-hoc builds) are mainline;
    patch requesters (CLI, PR, merge queue) are patch; anything else is
    dropped from the plan — the reference's unrecognized-requester error
    path — and returned so callers can surface the starvation."""
    high: List[Task] = []
    patch: List[Task] = []
    mainline: List[Task] = []
    dropped: List[Task] = []
    for t in tasks:
        if t.priority > MAX_TASK_PRIORITY:
            high.append(t)
        elif is_mainline_requester(t.requester):
            mainline.append(t)
        elif is_patch_requester(t.requester):
            patch.append(t)
        else:
            dropped.append(t)
    return high, patch, mainline, dropped


def _group_task_groups(tasks: List[Task]) -> List[Task]:
    """setup_funcs.go:72 groupTaskGroups: reverse-lexical pre-sort on
    (build, group, id) so members of one task group are adjacent before
    the stable comparator sort pins their relative order."""
    return sorted(
        tasks,
        key=lambda t: f"{t.build_id}-{t.task_group}-{t.id}",
        reverse=True,
    )


def _sort_bucket(
    tasks: List[Task], version_requesters: Dict[str, str]
) -> List[Task]:
    def cmp(t1: Task, t2: Task) -> int:
        for _, c in COMPARATORS:
            ret, _ = c(t1, t2, version_requesters)
            if ret is None:
                return 0  # terminal tie: stable sort keeps pre-sort order
            if ret:
                return -ret  # more important sorts earlier
        return 0

    return sorted(_group_task_groups(tasks), key=functools.cmp_to_key(cmp))


def _interleave(patch: List[Task], mainline: List[Task]) -> List[Task]:
    """task_prioritizer.go:253 mergeTasks: strict 1:1 interleave starting
    with a patch task; whichever list runs out first cedes the rest."""
    out: List[Task] = []
    p = m = 0
    for idx in range(len(patch) + len(mainline)):
        if p >= len(patch):
            out.append(mainline[m])
            m += 1
        elif m >= len(mainline):
            out.append(patch[p])
            p += 1
        elif idx % 2 == 1:
            out.append(mainline[m])
            m += 1
        else:
            out.append(patch[p])
            p += 1
    return out


def prioritize_tasks(
    tasks: List[Task],
    version_requesters: Optional[Dict[str, str]] = None,
) -> List[Task]:
    """Full cmp-based plan: split → per-bucket comparator sort → merge
    (task_prioritizer.go:81 PrioritizeTasks). ``version_requesters`` maps
    version id → requester for the merge-queue comparator; task requester
    is the fallback when the version doc is unknown."""
    vr = version_requesters or {}
    high, patch, mainline, dropped = split_by_requester(tasks)
    if dropped:
        _log.error(
            "dropping %d task(s) with unrecognized requester from the plan "
            "(they will not be queued): %s",
            len(dropped),
            [(t.id, t.requester) for t in dropped[:10]],
        )
    return _sort_bucket(high, vr) + _interleave(
        _sort_bucket(patch, vr), _sort_bucket(mainline, vr)
    )
