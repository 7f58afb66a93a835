"""Incremental tick cache: dirty-tracked runnable-task maintenance.

A copy of ``evergreen_tpu/scheduler/cache.py``. The reference's finder
re-queries Mongo for the full runnable set every tick for every distro
(scheduler/task_finder.go). Under churn most of the set is unchanged tick
to tick, so this cache subscribes to the tasks, hosts, distros and config
collections and re-materializes ONLY dirty documents; ``gather`` then
feeds the warm per-distro views into the shared ``gather_tick_inputs``
assembly.

Invariants:
  * the change listener fires inside the collection lock on every write
    path (``storage/store.py``), so a task can never change without
    landing in the dirty set; the dirty set has its own leaf lock (never
    held while touching the store) so listener and drain cannot deadlock
    or lose ids;
  * the emitted task order is the store's key order
    (``Collection.key_order``), so a cached tick is bit-identical to a
    cold rerun from the same store.

It also keeps the delta stream the resident state plane consumes
(``drain_resident_deltas``) and the persister's per-distro stamp hints
(``stamp_candidates``). The JAX cache's global store-order view
(``runnable_in_store_order``, ``runnable_count``) has no caller in the
port and is left out.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Set, Tuple

from ..globals import TaskStatus
from ..models import distro as distro_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models.host import Host, is_active_host_doc
from ..models.task import Task
from ..storage.store import Store
from ..utils import lockcheck as _lockcheck
from .snapshot import deps_met_for


class TickCache:
    def __init__(self, store: Store) -> None:
        # weak: the store holds the cache through its listeners, and the
        # per-store registry must not keep the store alive
        self._store_ref = weakref.ref(store)
        self._lock = _lockcheck.make_lock("sched.cache")  # guards _runnable/_primed
        self._dirty_lock = _lockcheck.make_lock("sched.cache.dirty")  # leaf lock: guards _dirty only
        self._dirty: Set[str] = set()
        self._primed = False
        #: runnable task id → materialized Task
        self._runnable: Dict[str, Task] = {}
        #: per-distro (rank, Task) entries + the exported plain lists.
        #: Exported list OBJECTS are regenerated only for distros whose
        #: membership changed — an unchanged distro hands the snapshot
        #: memo and the resident plane the IDENTICAL list across ticks
        self._distro_entries: Dict[str, List[Tuple[int, Task]]] = {}
        self._alias_entries: Dict[str, List[Tuple[int, Task]]] = {}
        self._distro_lists: Dict[str, List[Task]] = {}
        self._alias_lists: Dict[str, List[Task]] = {}
        #: incrementally-maintained dependency-met flags + the reverse
        #: dependency index that drives their invalidation: a task's flag
        #: changes only when the task itself or one of its parents churns
        self._deps_met: Dict[str, bool] = {}
        self._dep_edges: Dict[str, List[str]] = {}   # task → parent ids
        self._dependents: Dict[str, Set[str]] = {}   # parent → task ids
        task_mod.coll(store).add_listener(self._on_task_change)
        #: active host id → materialized Host (same dirty-tracking scheme
        #: over the hosts collection)
        self._hosts_dirty: Set[str] = set()
        self._hosts_primed = False
        self._active_hosts: Dict[str, Host] = {}
        host_mod.coll(store).add_listener(self._on_host_change)
        #: cached Distro views (find_needs_hosts_planning order +
        #: needs_planning id set): distro docs churn rarely, and STABLE
        #: Distro object identity across ticks is what the resident state
        #: plane keys its settings-change detection on
        self._distros_dirty = True
        self._distro_view_cache = None
        distro_mod.coll(store).add_listener(self._on_distro_change)
        store.collection("config").add_listener(self._on_distro_change)
        #: ---- resident-state-plane delta stream --------------------------- #
        #: generation stamp bumped on every cold (re)prime — a consumer
        #: holding state from an older generation has a delta-stream gap
        #: and must full-rebuild
        self._prime_gen = 0
        #: task ids whose deps-met flag was recomputed since last drain
        self._dm_dirty: Set[str] = set()
        #: host ids whose doc (or whose running task's doc) churned
        self._res_hosts_dirty: Set[str] = set()
        #: running-task ↔ host index so a task-doc change invalidates the
        #: host row that derives its running estimate from it
        self._host_of_task: Dict[str, str] = {}
        self._task_of_host: Dict[str, str] = {}
        #: per-distro ids that may still need a scheduled_time /
        #: dependencies_met_time stamp (the persister's candidate scan
        #: collapses to these instead of walking the whole plan)
        self._unstamped: Dict[str, Set[str]] = {}

    @property
    def store(self) -> Store:
        return self._store_ref()

    # Runs under the collection lock; touch only the leaf dirty lock.
    def _on_task_change(self, task_id: str) -> None:
        with self._dirty_lock:
            self._dirty.add(task_id)

    # Runs under the collection lock; touch only the leaf dirty lock.
    def _on_host_change(self, host_id: str) -> None:
        with self._dirty_lock:
            self._hosts_dirty.add(host_id)

    # Runs under the collection lock; a bare flag needs no lock at all.
    def _on_distro_change(self, _id: str) -> None:
        self._distros_dirty = True

    def _qualifies(self, doc: Optional[dict]) -> bool:
        if doc is None:
            return False
        if doc["status"] != TaskStatus.UNDISPATCHED.value or not doc["activated"]:
            return False
        if doc["priority"] < 0:
            return False
        if doc.get("execution_platform", "host") != "host":
            return False
        if any(d.get("unattainable") for d in doc.get("depends_on", [])) and not doc.get(
            "override_dependencies", False
        ):
            return False
        return True

    def _reindex_deps(self, t: Task) -> None:
        for p in self._dep_edges.pop(t.id, ()):
            deps = self._dependents.get(p)
            if deps is not None:
                deps.discard(t.id)
                if not deps:
                    del self._dependents[p]
        parents = [d.task_id for d in t.depends_on]
        if parents:
            self._dep_edges[t.id] = parents
            for p in parents:
                self._dependents.setdefault(p, set()).add(t.id)

    def _drop_dep_index(self, tid: str) -> None:
        for p in self._dep_edges.pop(tid, ()):
            deps = self._dependents.get(p)
            if deps is not None:
                deps.discard(tid)
                if not deps:  # don't leak one empty set per historic parent
                    del self._dependents[p]
        self._deps_met.pop(tid, None)

    def _recompute_deps_met(self, ids) -> None:
        """Recompute flags for a subset, with membership semantics over
        the FULL runnable set."""
        tasks = [self._runnable[i] for i in ids]
        if not tasks:
            return
        self._deps_met.update(
            deps_met_for(tasks, task_mod.coll(self.store),
                         in_snapshot=self._runnable.keys())
        )

    def _note_stamp_state(self, t: Task) -> None:
        """Track whether ``t`` may still need a scheduled/deps-met stamp."""
        s = self._unstamped.get(t.distro_id)
        if t.scheduled_time <= 0.0 or t.dependencies_met_time <= 0.0:
            if s is None:
                s = self._unstamped[t.distro_id] = set()
            s.add(t.id)
        elif s is not None:
            s.discard(t.id)

    def _drop_stamp_state(self, t: Task) -> None:
        s = self._unstamped.get(t.distro_id)
        if s is not None:
            s.discard(t.id)

    def apply_dirty(self) -> int:
        """Fold pending changes into the runnable map; returns changes."""
        with self._lock:
            if not self._primed:
                with self._dirty_lock:
                    self._dirty.clear()
                self._runnable = {
                    t.id: t for t in task_mod.find_host_runnable(self.store)
                }
                order = task_mod.coll(self.store).key_order()
                ranked = sorted(
                    (order.get(t.id, 1 << 60), t)
                    for t in self._runnable.values()
                )
                self._deps_met.clear()
                self._dep_edges.clear()
                self._dependents.clear()
                self._unstamped = {}
                for t in self._runnable.values():
                    self._reindex_deps(t)
                    self._note_stamp_state(t)
                self._recompute_deps_met(list(self._runnable))
                self._rebuild_distro_lists(ranked)
                self._primed = True
                # a cold (re)prime breaks any consumer's delta stream
                self._prime_gen += 1
                self._dm_dirty.clear()
                return len(self._runnable)
            with self._dirty_lock:
                dirty, self._dirty = self._dirty, set()
            coll = task_mod.coll(self.store)
            # a churned task invalidates its own flag and its dependents'
            # (their membership/finished check reads the parent's state)
            affected: Set[str] = set()
            for tid in dirty:
                affected |= self._dependents.get(tid, set())
            n = 0
            gone: Set[str] = set()
            #: distro ids whose primary/alias membership changed — only
            #: these have their per-distro lists rebuilt below
            dirty_primary: Set[str] = set()
            dirty_alias: Set[str] = set()
            fresh_primary: Dict[str, List[Tuple[int, Task]]] = {}
            fresh_alias: Dict[str, List[Tuple[int, Task]]] = {}
            order = coll.key_order()
            for tid in dirty:
                doc = coll.get(tid)
                old = self._runnable.get(tid)
                # a churned task that is RUNNING on a host invalidates the
                # host row deriving its duration estimate from the doc
                hid = self._host_of_task.get(tid)
                if hid is not None:
                    self._res_hosts_dirty.add(hid)
                if self._qualifies(doc):
                    t = Task.from_doc(doc)
                    rank = order.get(tid, 1 << 60)
                    if old is not None:
                        gone.add(tid)  # the replaced instance leaves its views
                        dirty_primary.add(old.distro_id)
                        dirty_alias.update(old.secondary_distros)
                        if old.distro_id != t.distro_id:
                            self._drop_stamp_state(old)
                    self._runnable[tid] = t
                    dirty_primary.add(t.distro_id)
                    fresh_primary.setdefault(t.distro_id, []).append(
                        (rank, t)
                    )
                    for sd in t.secondary_distros:
                        if sd != t.distro_id:
                            dirty_alias.add(sd)
                            fresh_alias.setdefault(sd, []).append((rank, t))
                    self._reindex_deps(t)
                    self._note_stamp_state(t)
                    affected.add(tid)
                    n += 1
                elif old is not None:
                    del self._runnable[tid]
                    gone.add(tid)
                    dirty_primary.add(old.distro_id)
                    dirty_alias.update(old.secondary_distros)
                    self._drop_dep_index(tid)
                    self._drop_stamp_state(old)
                    n += 1
            self._patch_distro_lists(
                dirty_primary, fresh_primary, gone,
                self._distro_entries, self._distro_lists,
            )
            self._patch_distro_lists(
                dirty_alias, fresh_alias, gone,
                self._alias_entries, self._alias_lists,
            )
            live_affected = affected & self._runnable.keys()
            self._recompute_deps_met(live_affected)
            self._dm_dirty |= live_affected
            # tripwire: the deps-met map must track the runnable set
            # KEY-FOR-KEY (the gather passes it through, and the snapshot
            # fill defaults a missing id to met) — compare key sets, not
            # sizes. A gap repairs itself fail-closed here.
            if self._deps_met.keys() != self._runnable.keys():
                self._deps_met = {
                    k: v for k, v in self._deps_met.items()
                    if k in self._runnable
                }
                missing = [
                    k for k in self._runnable if k not in self._deps_met
                ]
                self._recompute_deps_met(missing)
                self._dm_dirty.update(missing)
            return n

    def _rebuild_distro_lists(self, ranked: List[Tuple[int, Task]]) -> None:
        """Cold prime of the per-distro views from the (store rank, Task)
        pairs in store order."""
        self._distro_entries = {}
        self._alias_entries = {}
        for rank, t in ranked:
            self._distro_entries.setdefault(t.distro_id, []).append(
                (rank, t)
            )
            for sd in t.secondary_distros:
                if sd != t.distro_id:
                    self._alias_entries.setdefault(sd, []).append((rank, t))
        self._distro_lists = {
            did: [t for _, t in ent]
            for did, ent in self._distro_entries.items()
        }
        self._alias_lists = {
            did: [t for _, t in ent]
            for did, ent in self._alias_entries.items()
        }

    @staticmethod
    def _patch_distro_lists(
        dirty_distros: Set[str],
        fresh_by_distro: Dict[str, List[Tuple[int, Task]]],
        gone: Set[str],
        entries: Dict[str, List[Tuple[int, Task]]],
        lists: Dict[str, List[Task]],
    ) -> None:
        """Rebuild ONLY the touched distros' ordered views; untouched
        distros keep their existing list objects (identity is what the
        snapshot membership memo keys on)."""
        for did in dirty_distros:
            ent = entries.get(did, [])
            if gone:
                ent = [e for e in ent if e[1].id not in gone]
            add = fresh_by_distro.get(did)
            if add:
                ent.extend(sorted(add))
                ent.sort()
            if ent:
                entries[did] = ent
                lists[did] = [t for _, t in ent]
            else:
                entries.pop(did, None)
                lists.pop(did, None)

    def _host_qualifies(self, doc: Optional[dict]) -> bool:
        return doc is not None and is_active_host_doc(doc)

    def _index_running_task(self, hid: str, running: str) -> None:
        old = self._task_of_host.get(hid)
        if old is not None and old != running:
            self._host_of_task.pop(old, None)
        if running:
            self._task_of_host[hid] = running
            self._host_of_task[running] = hid
        else:
            self._task_of_host.pop(hid, None)

    def apply_hosts_dirty(self) -> int:
        """Fold pending host changes into the active-host map."""
        with self._lock:
            if not self._hosts_primed:
                with self._dirty_lock:
                    self._hosts_dirty.clear()
                self._active_hosts = {
                    h.id: h for h in host_mod.all_active_hosts(self.store)
                }
                self._host_of_task.clear()
                self._task_of_host.clear()
                for h in self._active_hosts.values():
                    if h.running_task:
                        self._index_running_task(h.id, h.running_task)
                self._hosts_primed = True
                self._prime_gen += 1
                self._res_hosts_dirty.clear()
                return len(self._active_hosts)
            with self._dirty_lock:
                dirty = self._hosts_dirty
                self._hosts_dirty = set()
            coll = host_mod.coll(self.store)
            n = 0
            for hid in dirty:
                self._res_hosts_dirty.add(hid)
                doc = coll.get(hid)
                if self._host_qualifies(doc):
                    h = Host.from_doc(doc)
                    self._active_hosts[hid] = h
                    self._index_running_task(hid, h.running_task)
                    n += 1
                elif hid in self._active_hosts:
                    del self._active_hosts[hid]
                    self._index_running_task(hid, "")
                    n += 1
            return n

    def active_hosts_in_store_order(self) -> List[Host]:
        """The warm capacity view, in cold-scan (store key) order."""
        self.apply_hosts_dirty()
        order = host_mod.coll(self.store).key_order()
        with self._lock:
            hosts = list(self._active_hosts.values())
        hosts.sort(key=lambda h: order.get(h.id, 1 << 60))
        return hosts

    def distro_view(self) -> Tuple[List, Set[str]]:
        """Cached (find_needs_hosts_planning list, needs_planning id set).
        Between distro or config changes both the LIST object and the
        Distro instances keep their identity — which is what the resident
        state plane's settings-change detection keys on."""
        with self._lock:
            if self._distros_dirty or self._distro_view_cache is None:
                # clear the flag BEFORE the read: a concurrent write that
                # lands mid-find re-dirties and we recompute next tick
                self._distros_dirty = False
                self._distro_view_cache = (
                    distro_mod.find_needs_hosts_planning(self.store),
                    {d.id for d in distro_mod.find_needs_planning(self.store)},
                )
            return self._distro_view_cache

    def drain_resident_deltas(self) -> Tuple[int, Set[str], Set[str]]:
        """Hand the resident state plane everything that changed since the
        last drain: ``(prime_generation, deps-met-dirty ids, host-dirty
        ids)``. Sets accumulate across ticks that skip the resident path
        (serial fallback, breaker-open), so a drain is always complete; a
        prime-generation bump is the one true delta-stream gap."""
        with self._lock:
            dm, self._dm_dirty = self._dm_dirty, set()
            hs, self._res_hosts_dirty = self._res_hosts_dirty, set()
            return self._prime_gen, dm, hs

    def stamp_candidates(self, distro_id: str):
        """Ids in this distro's runnable set that may still need a
        scheduled/deps-met stamp (None before priming: caller must scan)."""
        if not self._primed:
            return None
        with self._lock:
            s = self._unstamped.get(distro_id)
            return frozenset(s) if s else frozenset()

    def gather(self, now: float) -> Tuple:
        """Same contract as ``scheduler.wrapper.gather_tick_inputs``,
        served from the warm per-distro views: no flatten/split loop over
        every task, no deps-met dict rebuild — per-tick assembly cost is
        O(distros), not O(tasks)."""
        from .wrapper import gather_tick_inputs

        self.apply_dirty()
        distros, planning_ids = self.distro_view()
        return gather_tick_inputs(
            self.store,
            now,
            active_hosts=self.active_hosts_in_store_order(),
            deps_met=self._deps_met,
            by_distro=self._distro_lists,
            alias_by_distro=self._alias_lists,
            distro_view=(distros, planning_ids),
        )

    def runnable_task(self, task_id: str):
        """The materialized runnable Task for an id, or None (resident
        state plane: resolve a deps-met-dirty id to its distro rows)."""
        with self._lock:
            return self._runnable.get(task_id)
