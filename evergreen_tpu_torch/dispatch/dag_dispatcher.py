"""Server-side DAG dispatcher: hands queued tasks to agents.

A copy of ``evergreen_tpu/dispatch/dag_dispatcher.py``. It re-implements
the semantics of the reference's revised-with-dependencies dispatcher
(model/task_queue_service_dependency.go:56-650): an in-memory per-distro
structure rebuilt from the persisted queue document (either layout the
persister writes: ``rows`` or ``cols``) on a TTL or when the queue's
long-poll generation or dirty stamp moves, holding

  * a dependency graph over queue items, topologically ordered with ties
    broken by the planner's queue rank (topo.SortStabilized, :216);
  * task-group units whose tasks dispatch in group-order with max-hosts
    enforcement and single-host-group failure blocking (:560-650);
  * dispatch marking so one item is handed to at most one host per rebuild
    (the durable guarantee is the host document's atomic compare-and-set,
    rest/route/host_agent.go:311-420).

The topological sort is a stabilized Kahn's algorithm over the queue's
local edges (heap keyed by queue index). Tasks in dependency cycles are
excluded from dispatch, mirroring topo.Unorderable handling.
"""
from __future__ import annotations

import dataclasses
import heapq
import time as _time
from typing import Dict, List, Optional

from ..globals import TaskStatus
from ..models import host as host_mod
from ..models import task as task_mod
from ..models import task_queue as tq_mod
from ..models.task_queue import TaskQueueItem
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck

DEFAULT_TTL_S = 60.0


@dataclasses.dataclass
class TaskSpec:
    """The host's last-run task context, used for task-group stickiness
    (reference model/task_queue.go TaskSpec)."""

    group: str = ""
    build_variant: str = ""
    project: str = ""
    version: str = ""
    group_max_hosts: int = 0


def composite_group_id(group: str, variant: str, project: str, version: str) -> str:
    return f"{group}_{variant}_{project}_{version}"


@dataclasses.dataclass
class _GroupUnit:
    id: str
    group: str
    variant: str
    project: str
    version: str
    max_hosts: int
    tasks: List[TaskQueueItem] = dataclasses.field(default_factory=list)


class DAGDispatcher:
    def __init__(
        self, store: Store, distro_id: str, ttl_s: float = DEFAULT_TTL_S,
        secondary: bool = False,
    ) -> None:
        self.store = store
        self.distro_id = distro_id
        self.ttl_s = ttl_s
        self.secondary = secondary
        self._lock = _lockcheck.make_rlock("dispatch.dag")
        self._last_updated = 0.0
        self._loaded_stamp = 0.0
        self._sorted: List[TaskQueueItem] = []
        self._items: Dict[str, TaskQueueItem] = {}
        self._groups: Dict[str, _GroupUnit] = {}
        self._dispatched: set = set()
        self._pos: Dict[str, int] = {}
        self._next_live: List[int] = [0]
        #: queue-change generation source (dispatch/longpoll.py hub):
        #: lets the per-pull refresh fast path be one int compare
        #: instead of a queue-doc read under two locks — with many pulling
        #: agents that read was the first global serialization point
        from .longpoll import hub_for

        self._hub = hub_for(store)
        self._seen_gen = -1
        #: TTL'd running-host count per task-group unit: the max-hosts
        #: admission check was a full host-collection scan per group
        #: handout UNDER the dispatcher lock — O(fleet) serialized work.
        #: The cache recounts at most every GROUP_COUNT_TTL_S and is
        #: incremented locally on handout, so within one window the
        #: check can only be CONSERVATIVE (over-count), never over-admit
        #: beyond the CAS race the reference also carries.
        self._grp_running: Dict[str, list] = {}

    GROUP_COUNT_TTL_S = 0.25

    # -- rebuild ------------------------------------------------------------ #

    def refresh(self, now: Optional[float] = None, force: bool = False) -> None:
        now = _time.time() if now is None else now
        # generation fast path (no locks, no store reads): the long-poll
        # hub's listener bumps a per-distro int on ANY journaled write
        # to the queue docs, so an unchanged generation inside the TTL
        # means the doc-stamp compare below could only answer "still
        # fresh". Racy by design — a concurrent bump at worst sends us
        # into the locked slow path.
        if not force:
            gen = self._hub.generation(self.distro_id)
            if gen == self._seen_gen and now - self._last_updated < self.ttl_s:
                return
        with self._lock:
            gen = self._hub.generation(self.distro_id)
            if not force and now - self._last_updated < self.ttl_s:
                # dependency-wake fast path: a MarkEnd flipped queue flags
                # and stamped the doc dirty (dispatch/wake.py) — rebuild
                # immediately instead of waiting out the TTL
                doc = tq_mod.coll(self.store, self.secondary).get(self.distro_id)
                stamp = 0.0
                if doc is not None:
                    stamp = max(doc.get("generated_at", 0.0),
                                doc.get("dirty_at", 0.0))
                if stamp <= self._loaded_stamp:
                    self._seen_gen = gen
                    return
            queue = tq_mod.load(self.store, self.distro_id,
                                secondary=self.secondary)
            doc = tq_mod.coll(self.store, self.secondary).get(self.distro_id)
            self._loaded_stamp = (
                max(doc.get("generated_at", 0.0), doc.get("dirty_at", 0.0))
                if doc else 0.0
            )
            self._seen_gen = gen
            self.rebuild(queue.queue if queue else [], now)

    def rebuild(self, items: List[TaskQueueItem], now: float) -> None:
        with self._lock:
            self._items = {it.id: it for it in items}
            self._dispatched = set()
            self._groups = {}
            self._pos = {}
            self._next_live = []
            for it in items:
                if it.task_group:
                    gid = composite_group_id(
                        it.task_group, it.build_variant, it.project, it.version
                    )
                    unit = self._groups.get(gid)
                    if unit is None:
                        unit = _GroupUnit(
                            id=gid,
                            group=it.task_group,
                            variant=it.build_variant,
                            project=it.project,
                            version=it.version,
                            max_hosts=it.task_group_max_hosts,
                        )
                        self._groups[gid] = unit
                    unit.tasks.append(it)
            for unit in self._groups.values():
                unit.tasks.sort(key=lambda it: it.task_group_order)

            self._sorted = self._topo_sort(items)
            # Skip-pointer over the scan order: consumed items (dispatched,
            # already-started, dead groups) are unlinked with union-find
            # path compression, so draining a 50k queue costs O(n α(n))
            # total instead of O(n²) — the reference's linear FindNextTask
            # rescan is its slow-path-budget risk at this depth.
            self._pos = {it.id: i for i, it in enumerate(self._sorted)}
            self._next_live = list(range(len(self._sorted) + 1))
            self._grp_running = {}
            self._last_updated = now

    def _first_live(self, i: int) -> int:
        """Smallest live index ≥ i, with path compression."""
        nxt = self._next_live
        root = i
        while nxt[root] != root:
            root = nxt[root]
        while nxt[i] != root:
            nxt[i], i = root, nxt[i]
        return root

    def _consume(self, item_id: str) -> None:
        """Permanently remove an item from the scan order (valid only for
        within-epoch-permanent states: dispatched or already started)."""
        i = self._pos.get(item_id)
        if i is not None and self._next_live[i] == i:
            self._next_live[i] = i + 1

    def _topo_sort(self, items: List[TaskQueueItem]) -> List[TaskQueueItem]:
        """Stabilized Kahn: dependency order first, planner queue rank as the
        tie-break (reference rebuild :205-249)."""
        index = {it.id: i for i, it in enumerate(items)}
        indegree = {it.id: 0 for it in items}
        children: Dict[str, List[str]] = {it.id: [] for it in items}
        for it in items:
            for dep in it.dependencies:
                if dep in index:  # only edges internal to the queue
                    children[dep].append(it.id)
                    indegree[it.id] += 1
        ready = [index[i] for i, deg in indegree.items() if deg == 0]
        heapq.heapify(ready)
        out: List[TaskQueueItem] = []
        while ready:
            qi = heapq.heappop(ready)
            it = items[qi]
            out.append(it)
            for child in children[it.id]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    heapq.heappush(ready, index[child])
        # nodes still with indegree > 0 form cycles: excluded from dispatch
        return out

    # -- dispatch ------------------------------------------------------------ #

    def find_next_task(
        self, spec: TaskSpec, now: Optional[float] = None
    ) -> Optional[TaskQueueItem]:
        """The agent-facing handout (reference FindNextTask :258-492).

        Concurrency shape: plain queue items are RESERVED
        under the dispatcher lock (dispatched-set + skip-pointer consume
        — a few dict ops) and re-validated against the live task doc
        OUTSIDE it, so the one lock every agent serializes on is held
        for microseconds, not for store reads and Task materialization.
        A reservation that fails validation loops for the next
        candidate, exactly like the old in-lock continue."""
        now = _time.time() if now is None else now
        if spec.group:
            with self._lock:
                # Task-group stickiness: a host that just ran a group
                # task gets the group's next task if any remain
                # (:269-282).
                gid = composite_group_id(
                    spec.group, spec.build_variant, spec.project, spec.version
                )
                unit = self._groups.get(gid)
                if unit is not None and self._group_has_dispatchable(unit):
                    nxt = self._next_task_group_task(unit)
                    if nxt is not None:
                        return nxt
        while True:
            with self._lock:
                res = self._scan_next()
            if res is None:
                return None
            kind, it = res
            if kind == "group":
                return it
            # solo item, already reserved: re-validate against the live
            # document outside the dispatcher lock. Raw-doc checks first
            # — the common dependency-free task never pays a Task
            # materialization here (the assign layer builds its own for
            # the dispatchability gate).
            doc = task_mod.coll(self.store).get(it.id)
            if doc is None:
                return None
            if doc.get("start_time", 0.0) > 0.0:
                continue
            deps = doc.get("depends_on")
            if deps and not doc.get("override_dependencies", False):
                if not self._deps_met_fresh(task_mod.Task.from_doc(doc)):
                    continue
            return it

    def _scan_next(self):
        """One pass over the live scan order (under the lock): reserve
        and return the next plain candidate as ``("solo", item)`` — its
        live-doc validation happens outside — or hand out a group task
        as ``("group", item)`` (group semantics need the unit state, so
        they stay under the lock; the max-hosts fleet scan is TTL-cached
        in ``_grp_running``)."""
        n = len(self._sorted)
        i = self._first_live(0)
        while i < n:
            it = self._sorted[i]
            i = self._first_live(i + 1)
            if it.task_group_max_hosts == 0:
                if it.id in self._dispatched:
                    self._consume(it.id)
                    continue
                if not it.dependencies_met:
                    continue  # transient: stays in the scan order
                self._dispatched.add(it.id)
                self._consume(it.id)
                return "solo", it
            gid = composite_group_id(
                it.task_group, it.build_variant, it.project, it.version
            )
            unit = self._groups.get(gid)
            if unit is None:
                # group removed (single-host blocking): dead slot
                self._consume(it.id)
                continue
            if not self._group_has_dispatchable(unit):
                if all(g.id in self._dispatched for g in unit.tasks):
                    # fully handed out — permanently done this epoch
                    self._consume(it.id)
                continue
            if self._group_running(unit) >= unit.max_hosts > 0:
                continue
            nxt = self._next_task_group_task(unit)
            if nxt is not None:
                entry = self._grp_running.get(unit.id)
                if entry is not None:
                    entry[1] += 1  # conservative until the TTL recount
                return "group", nxt
        return None

    def _group_running(self, unit: _GroupUnit) -> int:
        """Hosts currently running this group, recounted at most every
        GROUP_COUNT_TTL_S (the scan is O(fleet) and used to run per
        group handout under the dispatcher lock)."""
        entry = self._grp_running.get(unit.id)
        now_mono = _time.monotonic()
        if entry is not None and now_mono - entry[0] < self.GROUP_COUNT_TTL_S:
            return entry[1]
        running = host_mod.coll(self.store).count(
            lambda doc: doc["running_task_group"] == unit.group
            and doc["running_task_build_variant"] == unit.variant
            and doc["running_task_project"] == unit.project
            and doc["running_task_version"] == unit.version
        )
        self._grp_running[unit.id] = [now_mono, running]
        return running

    def _group_has_dispatchable(self, unit: _GroupUnit) -> bool:
        return any(
            it.dependencies_met and it.id not in self._dispatched
            for it in unit.tasks
        )

    def _next_task_group_task(self, unit: _GroupUnit) -> Optional[TaskQueueItem]:
        """Group tasks dispatch in group order; a failed earlier task blocks
        the rest of a single-host group (reference nextTaskGroupTask
        :608-680 + isBlockedSingleHostTaskGroup)."""
        for it in unit.tasks:
            if it.id in self._dispatched:
                continue
            t = task_mod.get(self.store, it.id)
            if t is None:
                return None
            if self._blocked_single_host_group(unit, t):
                self._groups.pop(unit.id, None)
                for g in unit.tasks:
                    self._consume(g.id)
                return None
            if t.start_time > 0.0:
                self._dispatched.add(it.id)
                self._consume(it.id)
                continue
            if not self._deps_met_fresh(t):
                continue
            self._dispatched.add(it.id)
            self._consume(it.id)
            return it
        return None

    def _blocked_single_host_group(self, unit: _GroupUnit, t) -> bool:
        """A single-host group is done dispatching when the candidate task
        already ran and did not succeed (reference
        isBlockedSingleHostTaskGroup :689-693 — blocking of LATER members
        happens at task end, models/lifecycle.py block_single_host_group)."""
        return (
            unit.max_hosts == 1
            and t.finish_time > 0.0
            and t.status != TaskStatus.SUCCEEDED.value
        )

    def _deps_met_fresh(self, t) -> bool:
        """Re-check dependencies against current task states (reference
        FindNextTask re-validates via task.DependenciesMet :399-414)."""
        if not t.depends_on:
            return True
        cache = {
            p.id: p
            for p in task_mod.by_ids(self.store, [d.task_id for d in t.depends_on])
        }
        return t.dependencies_met(cache)


class DispatcherService:
    """TTL-cached per-distro dispatchers (reference
    model/task_queue_service.go:54-100)."""

    def __init__(self, store: Store, ttl_s: float = DEFAULT_TTL_S) -> None:
        self.store = store
        self.ttl_s = ttl_s
        self._lock = _lockcheck.make_lock("dispatch.dag.claims")
        self._dispatchers: Dict[str, DAGDispatcher] = {}

    def get(self, distro_id: str, secondary: bool = False) -> DAGDispatcher:
        key = f"{distro_id}//secondary" if secondary else distro_id
        with self._lock:
            disp = self._dispatchers.get(key)
            if disp is None:
                disp = DAGDispatcher(
                    self.store, distro_id, self.ttl_s, secondary=secondary
                )
                self._dispatchers[key] = disp
            return disp

    def refresh_find_next_task(
        self, distro_id: str, spec: TaskSpec, now: Optional[float] = None
    ) -> Optional[TaskQueueItem]:
        disp = self.get(distro_id)
        disp.refresh(now)
        return disp.find_next_task(spec, now)
