"""Scheduler tick driver — the PlanDistro equivalent, batched.

A copy of ``evergreen_tpu/scheduler/wrapper.py``'s tick on the in-memory
store. Reference flow (scheduler/wrapper.go:30 PlanDistro, per distro):
underwater unschedule → find runnable → prioritize → queue info →
persist, with host allocation as a separate per-distro job
(units/host_allocator.go). Here ONE tick does all distros: gather the
store into solver inputs, build the packed snapshot, run the batched
solve on the card (``ops/solve.py::run_solve_packed``), unpack it into
per-distro plans and queue info, plan cmp-based distros host-side, let
the capacity plane replace opted-in spawn counts, persist one queue
document per distro (``scheduler/persister.py``), create the intent
hosts and log their events. A solve that raises, overruns its deadline
or has its breaker open degrades the tick to the serial oracle
(``scheduler/serial.py``). A kernel that fails to build or launch
(``KernelError``) is not degraded: it raises out of the tick.

``run_tick`` runs the solve and the capacity program on the card and
raises without one unless the caller passes ``device="cpu"``. On a
durable store (``storage/durable.py``) the tick is the JAX package's
guarded tick: a holder whose lease epoch was superseded plans and writes
nothing (``degraded="fenced"``) and drops its resident plane and the
mirror's buffers; the persist barrier (``sync_persist``) waits out the
previous tick's asynchronous commit first, and a deferred write error
resets the persister and heals with a checkpoint
(``"persist-failed"``); every write of the tick rides one WAL group
frame, committed at the end (``wal_commit`` phase) synchronously or,
with ``TickOptions.async_persist``, on the store's flusher thread, so
the write overlaps the next tick. An exception that escapes the tick
(``KernelError``, ``MirrorError``) still commits the open group first.
On the in-memory store these hooks do nothing. With
``TickOptions.use_cache`` it gathers from the per-store TickCache
(``scheduler/cache.py``) and, unless ``use_resident`` is off, packs
through the resident state plane (``scheduler/resident.py``), whose
snapshot on the card is the device mirror's resident buffers; a mirror
upload that fails raises out of the tick like ``KernelError``. The
sharded plane (``scheduler/sharded_plane.py``) sets the options that
split one fleet over shards: ``intent_budget``,
``capacity_quota_scale``, ``use_resident``, ``solve_fn`` (its round
barrier, whose ``KernelError``/``MirrorError`` also raise out of the
tick) and ``force_dims``. A shard worker in harness mode
(``runtime/worker.py``) turns ``underwater_unschedule`` off. The tick
always plans solver distros with the batched solve and caps in-flight
intents at ``MAX_INTENT_HOSTS_IN_FLIGHT``: the JAX options
``planner_version`` and ``max_intent_hosts`` are left out (the root
span's ``planner`` attribute is ``"tpu"``). The tick is one trace
(``utils/tracing.py``): the root ``tick`` span, its phase children
(``delta_drain``, ``pack``, ``solve``, ``unpack``, ``persist``,
``tick_stats``, ``wal_commit``; the resident plane's ``resident_apply``,
``pack`` and ``arena_lease``), ``TickResult.trace_id``, and
``store._last_tick_trace`` for the dispatch assigns that follow.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
import time as _time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..ops._build import KernelError
from ..globals import (
    ALIAS_SUFFIX,
    DEFAULT_TASK_DURATION_S,
    MAX_INTENT_HOSTS_IN_FLIGHT,
    UNDERWATER_UNSCHEDULE_THRESHOLD_S,
    PlannerVersion,
)
from ..models import distro as distro_mod
from ..models import event as event_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models.distro import Distro
from ..models.host import Host, new_intent
from ..models.task import Task
from ..models.task_queue import DistroQueueInfo, QueueInfoView
from ..ops.packing import ArenaPool
from ..ops.resident_ops import MirrorError
from ..ops.solve import run_solve_packed
from ..settings import ReleaseModeConfig, ServiceFlags
from ..storage.lease import EpochFencedError
from ..storage.store import Store
from ..utils import faults
from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils import overload as overload_mod
from ..utils import tracing as _tracing
from ..utils.circuit import CircuitBreaker
from ..utils.log import get_logger
from . import cmp_prioritizer, serial
from .cache import TickCache
from .capacity_plane import capacity_plane_for, extract_fused_view
from .persister import persist_task_queue, persister_state_for
from .provenance import TickProvenance, build_provenance
from .resident import peek_resident_plane, resident_plane_for
from .serial import RunningTaskEstimate
from .snapshot import Snapshot, build_snapshot, deps_met_for, pack_capacity_page

TICK_DEGRADED = _metrics.counter(
    "scheduler_tick_degraded_total",
    "Tick degradations by cause (fenced / persist_failed / breaker_open "
    "/ solve_failed / shed); one tick can count several causes.",
    labels=("cause",),
    legacy=lambda labels: [f"scheduler.tick.{labels['cause']}"],
)
TICKS_TOTAL = _metrics.counter(
    "scheduler_ticks_total",
    "Completed scheduler ticks by outcome ('ok' or the degradation "
    "reason carried on TickResult.degraded).",
    labels=("outcome",),
)
TICK_MS = _metrics.histogram(
    "scheduler_tick_duration_ms",
    "Wall time of one full scheduling tick (gather through persist).",
)
TICK_PHASE_MS = _metrics.histogram(
    "scheduler_tick_phase_duration_ms",
    "Wall time of each tick pipeline phase (delta_drain / pack / solve "
    "/ unpack / cmp / capacity / persist / wal_commit).",
    labels=("phase",),
)
INTENT_BUDGET_CLAMPED = _metrics.counter(
    "scheduler_intent_budget_clamped_total",
    "Requested intent hosts NOT created because the in-flight intent "
    "budget was exhausted — each unit is one host the allocator wanted "
    "but the cap rejected.",
)

#: the warm gather's task list for a distro with no runnable work: one
#: stable object, so the snapshot membership memo and the resident plane
#: see identity across ticks (nothing in the tick path mutates task lists)
_EMPTY_TASKS: List[Task] = []

_tick_caches_lock = _lockcheck.make_lock("sched.tick_caches")

#: per-store TickCache singletons. Every per-store registry of the tick
#: is keyed weakly and its values refer to the store only weakly, so a
#: store's caches, arenas and card buffers go when the store goes.
_tick_caches: "weakref.WeakKeyDictionary[Store, TickCache]" = (
    weakref.WeakKeyDictionary())


def tick_cache_for(store: Store) -> TickCache:
    """Per-store TickCache singleton (the long-lived service uses one so
    each tick only re-materializes changed tasks)."""
    with _tick_caches_lock:
        cache = _tick_caches.get(store)
        if cache is None:
            cache = _tick_caches[store] = TickCache(store)
        return cache


#: per-store snapshot memos (shape hysteresis, membership cache, arena
#: pool) — the scheduler's own cross-tick state
_sched_memos: "weakref.WeakKeyDictionary[Store, tuple]" = weakref.WeakKeyDictionary()


def _snapshot_memos_for(store: Store) -> Tuple[dict, dict, ArenaPool]:
    with _tick_caches_lock:
        memos = _sched_memos.get(store)
        if memos is None:
            memos = _sched_memos[store] = ({}, {}, ArenaPool())
        return memos


#: consecutive solve failures before the breaker opens, and how long it
#: stays open before half-open probes (the reference's planner=tpu →
#: tunable downgrade, generalized)
SOLVE_BREAKER_THRESHOLD = 3
SOLVE_BREAKER_COOLDOWN_S = 60.0

#: per-store circuit breakers around the packed device solve
_solve_breakers: "weakref.WeakKeyDictionary[Store, CircuitBreaker]" = (
    weakref.WeakKeyDictionary())


def solve_breaker_for(store: Store):
    """Per-store breaker guarding the device-solve path of run_tick."""
    with _tick_caches_lock:
        breaker = _solve_breakers.get(store)
        if breaker is None:
            breaker = _solve_breakers[store] = CircuitBreaker(
                "scheduler.solve",
                failure_threshold=SOLVE_BREAKER_THRESHOLD,
                cooldown_s=SOLVE_BREAKER_COOLDOWN_S,
            )
        return breaker


@dataclasses.dataclass
class TickOptions:
    max_scheduled_per_distro: int = 0
    #: unschedule tasks that sat undispatched past
    #: ``UNDERWATER_UNSCHEDULE_THRESHOLD_S`` before gathering
    underwater_unschedule: bool = True
    create_intent_hosts: bool = True
    #: ABSOLUTE intent budget for THIS tick, already netted against
    #: fleet-wide in-flight intents by the caller (the sharded plane
    #: splits one fleet budget across shards this way). None = the
    #: classic computation against this store's in-flight count.
    intent_budget: Optional[int] = None
    #: the fraction of the configured pool quotas and fleet capacity
    #: budget THIS scheduler may use (the sharded plane passes
    #: 1/n_shards so the fleet-wide caps hold across per-shard solves)
    capacity_quota_scale: float = 1.0
    #: wall budget for the packed device solve; an overrun counts as a
    #: breaker failure and the tick falls back to the serial oracle
    #: (0 = no deadline)
    solve_deadline_s: float = 0.0
    #: whole-tick budget: when exceeded, optional work is shed — stats
    #: first, then event emission — but never planning (0 = unlimited)
    tick_budget_s: float = 0.0
    #: commit the tick's WAL group on the store's flusher thread, so the
    #: file write of tick t overlaps tick t+1 (the long-lived service
    #: sets this); a deferred write error surfaces at the next tick's
    #: barrier as degraded="persist-failed". False: the commit (and any
    #: error) lands before run_tick returns
    async_persist: bool = False
    #: incremental runnable-set maintenance between ticks
    #: (scheduler/cache.py), packed through the resident state plane
    #: (scheduler/resident.py): the snapshot columns stay persistent
    #: buffers across ticks and take the cache's deltas in place; a
    #: host-side delta failure falls back to the full rebuild path
    use_cache: bool = False
    #: pack through the resident state plane when ``use_cache`` is on;
    #: False builds the snapshot fresh from the warm gather (the sharded
    #: plane's stacked round, whose blocks share common dims)
    use_resident: bool = True
    #: run THIS callable on the packed snapshot instead of
    #: ``run_solve_packed`` on the tick's device (the sharded plane's
    #: stacked-round barrier); any failure degrades like a failing solve,
    #: but ``KernelError`` and ``MirrorError`` raise out of the tick
    solve_fn: Optional[Callable] = None
    #: minimum padded dims for the snapshot build (a floor, maxed with
    #: the natural buckets): the sharded plane forces every shard to the
    #: round's common dims so the blocks stack. None = natural bucketing
    #: with hysteresis.
    force_dims: Optional[Dict[str, int]] = None


@dataclasses.dataclass
class TickResult:
    #: distro id -> number of queue items persisted this tick
    queues: Dict[str, int]
    new_hosts: Dict[str, int]
    intent_hosts: List[Host]
    n_tasks: int
    n_distros: int
    snapshot_ms: float = 0.0
    solve_ms: float = 0.0
    total_ms: float = 0.0
    #: which planner actually produced the solver-distro queues:
    #: "tpu" | "serial" | "" (no solver distros)
    planner_used: str = ""
    #: non-empty when the tick degraded: "solve-failed" | "solve-deadline"
    #: | "breaker-open" | "persist-failed" | "fenced" (the writer's lease
    #: epoch was superseded: the tick's WAL group was shed and the holder
    #: stood down)
    degraded: str = ""
    #: optional work shed under the tick budget or the overload ladder
    #: ("events", "stats")
    shed: List[str] = dataclasses.field(default_factory=list)
    #: the overload-ladder level this tick planned under
    #: ("green" | "yellow" | "red" | "black")
    overload: str = "green"
    #: id of the tick's trace (utils/tracing.py): the whole pipeline —
    #: delta drain → pack → solve → unpack → persist → WAL commit (and
    #: the async flusher's write, and the dispatch assigns that follow)
    #: — is one span tree under this id; "" when tracing is disabled
    trace_id: str = ""
    #: per-distro solve score terms (scheduler/provenance.py) so "why is
    #: task X at rank Y" is answerable after the tick; None on serial /
    #: degraded ticks
    provenance: Optional[TickProvenance] = None


def gather_tick_inputs(
    store: Store,
    now: float,
    runnable_tasks: Optional[List[Task]] = None,
    active_hosts: Optional[List[Host]] = None,
    deps_met: Optional[Dict[str, bool]] = None,
    by_distro: Optional[Dict[str, List[Task]]] = None,
    alias_by_distro: Optional[Dict[str, List[Task]]] = None,
    distro_view: Optional[Tuple[List[Distro], set]] = None,
) -> Tuple[
    List[Distro],
    Dict[str, List[Task]],
    Dict[str, List[Host]],
    Dict[str, RunningTaskEstimate],
    Dict[str, bool],
]:
    """Read the store into solver inputs: runnable tasks per distro, active
    hosts per distro, running-task duration estimates, dep-met mask.

    ``runnable_tasks`` / ``active_hosts`` / ``deps_met`` let a caller
    supply warm sets (already in store order); when absent, the finders
    scan the collections (scheduler/task_finder.go:34-36 analog) — never
    the full task history.

    ``by_distro``/``alias_by_distro`` are the TickCache's maintained
    per-distro views (store order, unchanged distros keep identical list
    objects): assembly then costs O(distros) and ``deps_met`` is passed
    through as-is — the cache maintains it key-for-key with the runnable
    set. ``distro_view`` is the cache's (distro list, planning id set).
    """
    # The snapshot covers the allocator's distro set (a superset that
    # includes disabled distros, which still maintain minimum hosts); task
    # queues are only gathered for the plannable subset (reference
    # model/distro/db.go:198-224). The cached view is copied because alias
    # rows are appended below.
    if distro_view is not None:
        distros = list(distro_view[0])
        distro_ids = distro_view[1]
    else:
        distros = distro_mod.find_needs_hosts_planning(store)
        distro_ids = {d.id for d in distro_mod.find_needs_planning(store)}
    all_ids = {d.id for d in distros}

    if by_distro is not None:
        tasks_by_distro = {
            d.id: by_distro.get(d.id, _EMPTY_TASKS)
            if d.id in distro_ids else _EMPTY_TASKS
            for d in distros
        }
        alias_tasks = {
            did: tasks
            for did, tasks in (alias_by_distro or {}).items()
            if did in distro_ids and tasks
        }
    else:
        if runnable_tasks is None:
            runnable_tasks = task_mod.find_host_runnable(store)

        tasks_by_distro = {d.id: [] for d in distros}
        alias_tasks = {}
        runnable: List[Task] = []
        for t in runnable_tasks:
            if t.distro_id in distro_ids:
                tasks_by_distro[t.distro_id].append(t)
                runnable.append(t)
            for sd in t.secondary_distros:
                if sd in distro_ids and sd != t.distro_id:
                    alias_tasks.setdefault(sd, []).append(t)
                    if t.distro_id not in distro_ids:
                        runnable.append(t)

    # Secondary (alias) queues plan as extra rows of the SAME batched solve
    # (the reference runs a separate alias-scheduler job per distro,
    # units/scheduler_alias.go; here it's just more rows in the tensor).
    for did, tasks in sorted(alias_tasks.items()):
        base = next(d for d in distros if d.id == did)
        alias = dataclasses.replace(base, id=f"{did}{ALIAS_SUFFIX}")
        distros.append(alias)
        tasks_by_distro[alias.id] = tasks

    # Resolve dependency parents + running-task estimates from raw docs
    # (materializing Task objects here is hot-loop cost). A supplied
    # deps-met map is restricted to this gather's runnable set, except the
    # TickCache's, which is passed through.
    coll = task_mod.coll(store)
    if by_distro is not None:
        if deps_met is None:
            raise ValueError("by_distro gather requires the cache deps map")
    elif deps_met is None:
        deps_met = deps_met_for(runnable, coll)
    else:
        # fail CLOSED on a missing flag: a maintenance gap must show up
        # as a held-back task, never as a task dispatched ahead of
        # unfinished parents
        deps_met = {t.id: deps_met.get(t.id, False) for t in runnable}

    hosts_by_distro: Dict[str, List[Host]] = {d.id: [] for d in distros}
    if active_hosts is None:
        active_hosts = host_mod.all_active_hosts(store)
    active_hosts = [h for h in active_hosts if h.distro_id in all_ids]
    running_ids = [h.running_task for h in active_hosts if h.running_task]
    running_docs = {d["_id"]: d for d in coll.find_ids(running_ids)}
    running_estimates: Dict[str, RunningTaskEstimate] = {}
    for h in active_hosts:
        hosts_by_distro[h.distro_id].append(h)
        if h.running_task:
            rd = running_docs.get(h.running_task)
            if rd is not None:
                dur = rd.get("expected_duration_s", 0.0)
                # a missing or zero start_time means "unknown": elapsed
                # pins to 0, as does start_s
                st = rd.get("start_time", 0.0)
                running_estimates[h.id] = RunningTaskEstimate(
                    elapsed_s=max(0.0, now - st) if st > 0.0 else 0.0,
                    expected_s=dur if dur > 0 else float(DEFAULT_TASK_DURATION_S),
                    std_dev_s=rd.get("duration_std_dev_s", 0.0)
                    if dur > 0 else 0.0,
                    start_s=st if st > 0.0 else 0.0,
                )
    return distros, tasks_by_distro, hosts_by_distro, running_estimates, deps_met


def _unpack_solve(
    snapshot: Snapshot,
    out: Dict[str, np.ndarray],
) -> Tuple[Dict[str, List[Task]], Dict[str, Dict[str, float]], Dict[str, QueueInfoView], Dict[str, int], Dict[str, List[bool]], dict, TickProvenance]:
    """Device outputs → per-distro ordered plans, sort values, positional
    deps-met columns, lazy queue-info views, spawn counts, the shared
    raw info columns (for the persister's whole-tick epoch compare), and
    the tick's decision provenance (scheduler/provenance.py)."""
    flat = snapshot.flat_tasks
    n = snapshot.n_tasks
    # The solve's first sort key is the distro index (invalid/hole slots
    # key as D and sort LAST), so the returned order is already segmented
    # distro by distro with the n real tasks as its prefix: cut the
    # prefix, then slice per distro.
    order = np.asarray(out["order"])
    real = order[:n]
    t_distro = np.asarray(snapshot.arrays["t_distro"])
    dpd = t_distro[real]
    vals = np.asarray(out["t_value"])[real].astype(float)
    bounds = np.searchsorted(dpd, np.arange(len(snapshot.distro_ids) + 1))
    ordered_tasks = [flat[i] for i in real.tolist()]
    # deps-met flags and sort values ride along as numpy slices aligned
    # with plans[did]
    met_flat = np.asarray(snapshot.arrays["t_deps_met"])[real]
    plans: Dict[str, List[Task]] = {}
    sort_values: Dict[str, np.ndarray] = {}
    met_cols: Dict[str, np.ndarray] = {}
    for di, did in enumerate(snapshot.distro_ids):
        lo, hi = int(bounds[di]), int(bounds[di + 1])
        plans[did] = ordered_tasks[lo:hi]
        sort_values[did] = vals[lo:hi]
        met_cols[did] = met_flat[lo:hi]

    # Per-segment / per-distro scalars: pull each column to a plain list
    # once, so the lazy QueueInfoView objects index lists rather than
    # numpy per scalar; a view builds its TaskGroupInfo rows only when
    # read.
    def host_list(name: str):
        return np.asarray(out[name]).tolist()

    cols = {
        name: host_list(name)
        for name in (
            "g_count", "g_expected_dur_s", "g_count_free",
            "g_count_required", "g_over_count", "g_wait_over", "g_merge",
            "g_over_dur_s", "d_length", "d_deps_met", "d_merge",
            "d_expected_dur_s", "d_over_count", "d_over_dur_s",
            "d_wait_over",
        )
    }
    cols["g_max_hosts"] = np.asarray(snapshot.arrays["g_max_hosts"]).tolist()
    cols["d_thresh_s"] = np.asarray(snapshot.arrays["d_thresh_s"]).tolist()
    cols["seg_names"] = snapshot.seg_names
    seg_ids_by_di: Dict[int, List[int]] = {}
    for gi, (di, _name) in enumerate(snapshot.seg_names):
        seg_ids_by_di.setdefault(di, []).append(gi)

    d_new = host_list("d_new_hosts")
    infos: Dict[str, QueueInfoView] = {}
    new_hosts: Dict[str, int] = {}
    for di, did in enumerate(snapshot.distro_ids):
        infos[did] = QueueInfoView(di, seg_ids_by_di.get(di, ()), cols)
        new_hosts[did] = int(d_new[di])
    provenance = build_provenance(
        snapshot, out, real, ordered_tasks, vals, bounds
    )
    return plans, sort_values, infos, new_hosts, met_cols, (
        cols, snapshot.distro_ids, seg_ids_by_di,
    ), provenance


def _apply_release_mode(store: Store, distros):
    """Release-window overrides applied at settings-resolution time
    (reference model/distro/distro.go:680-748): scale auto-tunable
    distros' max hosts and override the planner target time. Returns
    REPLACED copies — cached distro objects are never mutated — and the
    identical list when the section is inactive."""
    if ServiceFlags.get(store).release_mode_disabled:
        return distros
    cfg = ReleaseModeConfig.get(store)
    if not (cfg.distro_max_hosts_factor > 0
            or cfg.target_time_seconds_override > 0):
        return distros
    out = []
    for d in distros:
        has, ps = d.host_allocator_settings, d.planner_settings
        changed = False
        if cfg.distro_max_hosts_factor > 0 and has.auto_tune_maximum_hosts:
            has = dataclasses.replace(
                has,
                maximum_hosts=int(
                    math.ceil(
                        has.maximum_hosts * cfg.distro_max_hosts_factor
                    )
                ),
            )
            changed = True
        if cfg.target_time_seconds_override > 0:
            ps = dataclasses.replace(
                ps, target_time_s=float(cfg.target_time_seconds_override)
            )
            changed = True
        out.append(
            dataclasses.replace(d, host_allocator_settings=has,
                                planner_settings=ps)
            if changed else d
        )
    return out


def _solve_bounded(
    store: Store, snapshot, deadline_s: float, solve_fn=None
):
    """The packed solve under a wall deadline. With a deadline the solve
    runs on a daemon worker and a hang past the budget raises
    TimeoutError — the wedged call is abandoned (a dead tunnel/sidecar
    would otherwise block run_tick forever, well past the 15s cadence).
    Without one it runs inline. The solve seam fires inside the bounded
    region so injected hangs are caught like real ones. ``solve_fn``
    (the sharded plane's stacked-round barrier, or a solve on another
    device) replaces ``run_solve_packed`` on the card when given. The
    solve runs under the device profiler when the tracer config names a
    directory (``utils/tracing.py::maybe_device_profile``, once per
    directory per process); a solve abandoned at its deadline before it
    began does not open it."""
    abandoned = threading.Event()

    def work():
        faults.fire("scheduler.solve")
        if abandoned.is_set():
            return (solve_fn or run_solve_packed)(snapshot)
        with _tracing.maybe_device_profile(store):
            return (solve_fn or run_solve_packed)(snapshot)

    if deadline_s <= 0:
        return work()
    result: list = []
    # the worker thread parents any spans it emits into the caller's
    # tick trace instead of rooting fresh
    ctx = _tracing.capture_context()

    def runner():
        try:
            with _tracing.attached(ctx):
                result.append(("ok", work()))
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            result.append(("err", exc))

    th = threading.Thread(target=runner, daemon=True, name="tick-solve")
    th.start()
    th.join(deadline_s)
    if th.is_alive() or not result:
        abandoned.set()
        raise TimeoutError(
            f"solve exceeded its {deadline_s}s deadline"
        )
    kind, val = result[0]
    if kind == "err":
        raise val
    return val


def run_tick(
    store: Store,
    opts: Optional[TickOptions] = None,
    now: Optional[float] = None,
    device=None,
) -> TickResult:
    """One full scheduling tick over every distro. The packed solve and
    the two-call capacity program run on ``device``: the CUDA card when
    None (raising without one), the CPU only when the caller passes
    ``device="cpu"``. The whole tick is ONE trace: a root ``tick`` span
    here, phase spans in the body, and the async WAL flusher and later
    dispatch assigns parenting in through the captured context
    (``TickResult.trace_id``)."""
    dev = resolve_device(device)
    opts = opts or TickOptions()
    now = _time.time() if now is None else now
    # shard identity rides on every tick span, so a per-shard trace is
    # attributable to the shard that produced it
    _span_attrs = {"planner": PlannerVersion.TPU.value}
    _shard = getattr(store, "shard_id", None)
    if _shard is not None:
        _span_attrs["shard"] = _shard
    with _tracing.Tracer(store, "scheduler").span(
        "tick", **_span_attrs
    ) as _tick_span:
        result = _run_tick_guarded(store, opts, now, dev)
        result.trace_id = _tick_span.get("trace_root", "")
        _tick_span["attributes"].update(
            n_tasks=result.n_tasks,
            n_distros=result.n_distros,
            planner_used=result.planner_used,
            degraded=result.degraded,
            overload=result.overload,
            shed=list(result.shed),
        )
    TICK_MS.observe(result.total_ms)
    TICKS_TOTAL.inc(outcome=result.degraded or "ok")
    return result


def _run_tick_guarded(
    store: Store, opts: TickOptions, now: float, dev
) -> TickResult:
    t0 = _time.perf_counter()
    pstate = persister_state_for(store)
    _rlog = get_logger("resilience")

    # dispatch assigns that follow this tick parent into its trace (the
    # "…→ dispatch" leg of the tick span tree); harmless when tracing is
    # off — the context is None and assigns root themselves
    store._last_tick_trace = _tracing.capture_context()

    def _fenced_result() -> TickResult:
        # the holder's lease epoch was superseded: plan nothing, write
        # nothing (the lease's on_lost path already stood it down)
        TICK_DEGRADED.inc(cause="fenced")
        _invalidate_resident(store, "fenced")
        _rlog.error("degraded-tick", reason="fenced", fallback="none")
        return TickResult(
            queues={}, new_hosts={}, intent_hosts=[], n_tasks=0,
            n_distros=0, total_ms=(_time.perf_counter() - t0) * 1e3,
            degraded="fenced",
        )

    # a holder deposed between ticks must not even begin: the check
    # re-reads the lease file, so a steal the renewer has not yet
    # noticed is caught here rather than after a full solve
    try:
        store.assert_not_fenced(read_lease_file=True)
    except EpochFencedError:
        return _fenced_result()

    # stamp the tick start on the overload ladder before any work, so a
    # tick that blows its cadence is visible as lag on the NEXT
    # evaluation even if everything below degrades
    monitor = overload_mod.monitor_for(store)
    monitor.note_tick_start(now)

    # persist barrier first, before this tick writes anything: wait out
    # the previous tick's async group commit and surface its deferred
    # error. A lost group means the WAL may lack the delta bases the
    # fingerprints assume: reset them (full rewrites this tick) and heal
    # durability with a checkpoint of the in-memory truth.
    prior_persist_failed = False
    try:
        store.sync_persist()
    except EpochFencedError:
        return _fenced_result()  # the previous tick's commit was fenced
    except Exception as exc:  # noqa: BLE001 — the previous tick's commit
        prior_persist_failed = True
        pstate.reset()
        store.heal_durability()
        TICK_DEGRADED.inc(cause="persist_failed")
        _rlog.error(
            "wal-group-commit-failed", deferred=True, error=repr(exc)[-300:]
        )

    # the tick's WAL group: every journaled write until the commit at the
    # end of the tick rides in one framed append
    store.begin_tick()
    committed = [False]
    try:
        return _run_tick_body(
            store, opts, now, t0, pstate, dev, monitor,
            prior_persist_failed, committed,
        )
    finally:
        if not committed[0]:
            # an exception escaped mid-tick (a card fault among them):
            # commit what was buffered (memory already holds it) so the
            # group is never left open
            try:
                store.end_tick()
            except EpochFencedError:
                # fenced mid-tick: the store shed the group; a fenced
                # holder must not heal (it owns no snapshot any more)
                pstate.reset()
            except Exception:  # noqa: BLE001 — best-effort cleanup, but a
                # lost group still invalidates the delta bases
                pstate.reset()
                store.heal_durability()


def _invalidate_resident(store: Store, reason: str) -> None:
    """Drop the store's resident plane (and its mirror's buffers on the
    card), if it has one."""
    plane = peek_resident_plane(store)
    if plane is not None:
        plane.invalidate(reason)


def _commit_tick_group(store: Store, opts: TickOptions) -> str:
    """Commit the tick's WAL group; returns "" or a degradation reason."""
    try:
        if opts.async_persist:
            store.end_tick_async()
        else:
            store.end_tick()
        return ""
    except EpochFencedError:
        # the epoch was superseded between begin_tick and the commit: the
        # store shed the group and stood the holder down; no heal (a
        # fenced holder must not touch the snapshot a newer epoch owns)
        persister_state_for(store).reset()
        _invalidate_resident(store, "fenced")
        TICK_DEGRADED.inc(cause="fenced")
        get_logger("resilience").error(
            "tick-fenced", epoch=getattr(store, "epoch", 0)
        )
        return "fenced"
    except Exception as exc:  # noqa: BLE001 — a WAL error degrades the
        # tick, never kills it
        persister_state_for(store).reset()
        store.heal_durability()
        TICK_DEGRADED.inc(cause="persist_failed")
        get_logger("resilience").error(
            "wal-group-commit-failed", deferred=False, error=repr(exc)[-300:]
        )
        return "persist-failed"


def _run_tick_body(
    store: Store,
    opts: TickOptions,
    now: float,
    t0: float,
    pstate,
    dev,
    monitor,
    prior_persist_failed: bool,
    committed: list,
) -> TickResult:
    if opts.underwater_unschedule:
        task_mod.unschedule_stale_underwater(
            store, "", now, UNDERWATER_UNSCHEDULE_THRESHOLD_S
        )

    # delta drain: the TickCache's maintained views (or the cold
    # finders) become this tick's solver inputs
    tick_cache = tick_cache_for(store) if opts.use_cache else None
    _tracer = _tracing.Tracer(store, "scheduler")
    t_gather = _time.perf_counter()
    with _tracer.span("delta_drain", cached=opts.use_cache):
        (
            distros,
            tasks_by_distro,
            hosts_by_distro,
            running_estimates,
            deps_met,
        ) = (tick_cache.gather(now) if tick_cache is not None
             else gather_tick_inputs(store, now))
    TICK_PHASE_MS.observe(
        (_time.perf_counter() - t_gather) * 1e3, phase="delta_drain"
    )

    distros = _apply_release_mode(store, distros)

    queues: Dict[str, int] = {}
    new_hosts: Dict[str, int] = {}
    intent_hosts: List[Host] = []
    snapshot_ms = solve_ms = 0.0
    n_tasks = sum(len(v) for v in tasks_by_distro.values())

    # Per-distro planner selection (reference scheduler/scheduler.go:28
    # PrioritizeTasks): cmp-based distros are planned host-side with the
    # comparator chain; everything else goes through the batched solve.
    cmp_distros = [
        d for d in distros
        if d.planner_settings.version == PlannerVersion.CMP_BASED.value
    ]
    solver_distros = [
        d for d in distros
        if d.planner_settings.version != PlannerVersion.CMP_BASED.value
    ]

    plans: Dict[str, List[Task]] = {}
    sort_values: Dict[str, Dict[str, float]] = {}
    infos: Dict[str, DistroQueueInfo] = {}
    #: positional deps-met columns from the solve's unpack; distros
    #: planned host-side (cmp/serial) fall back to the dict
    met_cols: Dict[str, List[bool]] = {}
    planner_used = ""
    degraded = "persist-failed" if prior_persist_failed else ""
    shed: List[str] = []
    provenance = None
    #: distro id → (pool index, capacity opt-in) read off the packed
    #: d_pool / d_cap_on buffer columns on solve ticks; None on
    #: serial/cmp ticks — the plane re-derives from the distros
    capacity_cols = None
    #: True when a tick that WANTED the device solve fell back to the
    #: serial oracle (raise/deadline/breaker): the capacity plane must
    #: not solve on top of oracle-fallback numbers, but a deliberately
    #: serial-planned tick is fine
    solve_degraded = False
    _rlog = get_logger("resilience")

    # The tick's intent budget, computed BEFORE the solve so the fused
    # capacity page can ship it to the device and the joint solve
    # optimizes within exactly the allowance the creation loop below
    # enforces. Nothing between here and the creation loop mints
    # intents, so the count stays honest.
    if opts.create_intent_hosts and opts.intent_budget is not None:
        # fleet-accounted budget from the sharded plane: counting this
        # store's own intents again would double-charge the shard
        budget = max(0, int(opts.intent_budget))
    elif opts.create_intent_hosts:
        budget = max(
            0,
            # the global cap on in-flight intent hosts
            # (units/host_allocator.go:35)
            MAX_INTENT_HOSTS_IN_FLIGHT
            - host_mod.count_intents_in_flight(store),
        )
    else:
        budget = 0  # the 4k-host scan is pure cost when intents are off

    #: extract_fused_view's capture of the packed solve's capacity
    #: outputs — the fused rung of the capacity plane's fallback ladder;
    #: None on serial/cmp ticks, failed solves, or without a page
    fused_view = None

    # Circuit-broken device path (the reference's planner=tpu → tunable
    # downgrade): a raising or deadline-blowing solve degrades THIS tick
    # to the serial oracle; repeated failures open the breaker so
    # subsequent ticks skip the device path until half-open probes pass.
    want_tpu = bool(solver_distros)
    breaker = solve_breaker_for(store) if want_tpu else None
    if want_tpu and not breaker.allow(now=now):
        want_tpu = False
        solve_degraded = True
        degraded = "breaker-open"
        TICK_DEGRADED.inc(cause="breaker_open")
        _rlog.warning(
            "degraded-tick", reason=degraded, fallback="serial"
        )
    if want_tpu:
        snapshot = None
        try:
            t1 = _time.perf_counter()
            dims_memo, memb_memo, arena_pool = _snapshot_memos_for(store)
            # the fused capacity page: pool economics + budget/knobs as
            # packed columns, so the capacity program runs INSIDE this
            # tick's one solve (None keeps the device block a no-op)
            capacity_page = None
            if opts.create_intent_hosts:
                capacity_page = capacity_plane_for(store).build_capacity_page(
                    quota_scale=opts.capacity_quota_scale,
                    intent_budget=budget,
                )
            if tick_cache is not None and opts.use_resident:
                # resident state plane: persistent columns mutated by the
                # cache's deltas; a host-side delta failure returns None
                # and the full rebuild below serves the tick
                snapshot = resident_plane_for(store, dev).sync(
                    tick_cache, solver_distros, tasks_by_distro,
                    hosts_by_distro, running_estimates, deps_met, now,
                    arena_pool=arena_pool, capacity_page=capacity_page,
                )
            if snapshot is None:
                # full-rebuild pack (the resident plane packs inside its
                # own "pack" span)
                with _tracer.span("pack", mode="rebuild"):
                    snapshot = build_snapshot(
                        solver_distros, tasks_by_distro, hosts_by_distro,
                        running_estimates, deps_met, now,
                        force_dims=opts.force_dims,
                        dims_memo=(dims_memo if opts.force_dims is None
                                   else None),
                        memb_memo=memb_memo, arena_pool=arena_pool,
                    )
                    # page columns are packed post-build (and re-zeroed
                    # when absent: pool-leased arenas can carry an
                    # earlier page)
                    pack_capacity_page(snapshot.arrays, capacity_page)
            t2 = _time.perf_counter()
            # the bounded solve (under the device profiler when the
            # tracer config names a directory). run_solve_packed
            # synchronises the card before its fetch, so the device time
            # lands in THIS span instead of the first consumer's
            with _tracer.span("solve", deadline_s=opts.solve_deadline_s):
                out = _solve_bounded(
                    store, snapshot, opts.solve_deadline_s,
                    solve_fn=(opts.solve_fn or functools.partial(
                        run_solve_packed, device=dev)),
                )
            t3 = _time.perf_counter()
            snapshot_ms = (t2 - t1) * 1e3
            solve_ms = (t3 - t2) * 1e3
            TICK_PHASE_MS.observe(snapshot_ms, phase="pack")
            TICK_PHASE_MS.observe(solve_ms, phase="solve")
            with _tracer.span("unpack"):
                (plans, sort_values, infos, new_hosts, met_cols,
                 info_epoch, provenance) = _unpack_solve(snapshot, out)
            TICK_PHASE_MS.observe(
                (_time.perf_counter() - t3) * 1e3, phase="unpack"
            )
            pstate.note_solve_infos(*info_epoch)
            # copy the two capacity settings columns out while the arena
            # views are still this tick's (the lease returns in the
            # finally below; the next tick may re-zero the buffers)
            _dpool = np.asarray(snapshot.arrays["d_pool"])
            _dcap = np.asarray(snapshot.arrays["d_cap_on"])
            capacity_cols = {
                did: (int(_dpool[i]), bool(_dcap[i]))
                for i, did in enumerate(snapshot.distro_ids)
            }
            if capacity_page is not None:
                fused_view = extract_fused_view(snapshot, out)
            planner_used = "tpu"
            breaker.record_success(now=now)
        except (KernelError, MirrorError):
            # the card cannot run its kernels or take its uploads: a
            # fault to fix, not work to move to the host
            raise
        except Exception as exc:  # noqa: BLE001 — ANY other solve-path
            # failure degrades the tick; it must never kill it
            want_tpu = False
            solve_degraded = True
            degraded = (
                "solve-deadline" if isinstance(exc, TimeoutError)
                else "solve-failed"
            )
            breaker.record_failure(now=now, error=repr(exc))
            TICK_DEGRADED.inc(cause="solve_failed")
            _rlog.error(
                "degraded-tick",
                reason=degraded,
                fallback="serial",
                error=repr(exc)[-300:],
            )
            plans, sort_values, infos, met_cols = {}, {}, {}, {}
            new_hosts = {}
            provenance = None
            capacity_cols = None
            fused_view = None
        finally:
            # return the pool-leased arena even when the solve raised (a
            # failed solve must not strand the slot)
            if snapshot is not None and snapshot.arena is not None:
                snapshot.arena.close()
    if not want_tpu and solver_distros:
        results = serial.serial_tick(
            solver_distros, tasks_by_distro, hosts_by_distro,
            running_estimates, deps_met, now,
        )
        plans = {d: r[0] for d, r in results.items()}
        infos = {d: r[1] for d, r in results.items()}
        new_hosts = {d: r[2] for d, r in results.items()}
        sort_values = {d: r[3] for d, r in results.items()}
        planner_used = "serial"
        # a serial tick writes dataclass info docs; the next solve tick
        # must not trust a stale info epoch
        pstate.note_solve_infos(None)

    if cmp_distros:
        t_cmp = _time.perf_counter()
        # only the version docs the cmp tasks actually reference (the
        # merge-queue comparator reads the version's requester)
        version_ids = {
            t.version
            for d in cmp_distros
            for t in tasks_by_distro.get(d.id, [])
            if t.version
        }
        version_requesters = {
            doc["_id"]: doc.get("requester", "")
            for doc in store.collection("versions").find_ids(version_ids)
        }
        for d in cmp_distros:
            plan = cmp_prioritizer.prioritize_tasks(
                tasks_by_distro.get(d.id, []), version_requesters
            )
            info, n_new = serial.queue_info_and_new_hosts(
                d, plan, deps_met, hosts_by_distro.get(d.id, []),
                running_estimates, now,
            )
            plans[d.id] = plan
            infos[d.id] = info
            new_hosts[d.id] = n_new
            sort_values[d.id] = {}
        TICK_PHASE_MS.observe(
            (_time.perf_counter() - t_cmp) * 1e3, phase="cmp"
        )

    # Alias rows plan queues but never allocate hosts (the reference's
    # alias scheduler has no allocator job, units/scheduler_alias.go) —
    # drop their solve outputs from the reported spawn counts.
    for k in [k for k in new_hosts if k.endswith(ALIAS_SUFFIX)]:
        del new_hosts[k]

    # Single-task distros allocate 1:1 with dependency-met tasks (reference
    # units/host_allocator.go:174-181), bypassing the utilization heuristic.
    for d in distros:
        if d.single_task_distro and d.id in new_hosts:
            info = infos.get(d.id)
            demand = info.length_with_dependencies_met if info else 0
            existing = len(hosts_by_distro.get(d.id, []))
            cap = d.host_allocator_settings.maximum_hosts or demand
            new_hosts[d.id] = max(0, min(demand, cap - existing))

    # Capacity plane: distros opted into the joint (distros × pools)
    # program get their heuristic spawn counts replaced by the batched
    # solve's — served straight from the fused view when this tick's
    # solve carried a capacity page; any failure leaves the heuristic
    # counts untouched (scheduler/capacity_plane.py owns the breakers +
    # fallback ladder).
    if opts.create_intent_hosts and new_hosts:
        t_cap = _time.perf_counter()
        new_hosts = capacity_plane_for(store).apply(
            distros, infos, new_hosts, hosts_by_distro, now,
            degraded=solve_degraded,
            quota_scale=opts.capacity_quota_scale,
            intent_budget=budget,
            packed_cols=capacity_cols,
            # a cmp distro draws from the same budget but is invisible
            # to the packed solve: the device's reserved-wants mirror
            # would be wrong, so mixed ticks pin the two-call rung
            fused=fused_view if not cmp_distros else None,
            device=dev,
        )
        TICK_PHASE_MS.observe(
            (_time.perf_counter() - t_cap) * 1e3, phase="capacity"
        )

    # Brownout: at RED or worse the ladder sheds the tick's optional
    # work (stats, event emission) up front — the same work the tick
    # budget sheds reactively, but driven by SERVICE-wide load instead
    # of this tick's own overrun
    olevel = monitor.evaluate()

    def _shed_optional() -> str:
        """"" when optional work may run, else the shed reason."""
        if olevel >= overload_mod.RED:
            return "overload"
        if (
            opts.tick_budget_s > 0
            and _time.perf_counter() - t0 > opts.tick_budget_s
        ):
            return "budget-exceeded"
        return ""

    # persist phase span: per-distro failures are caught inside the
    # loop; the finally closes it with the write shapes the delta
    # persister chose this tick (skip / column-patch / splice / rewrite)
    t_persist = _time.perf_counter()
    with _tracer.span("persist", n_distros=len(distros)) as _persist_rec:
        _shapes_before = (
            pstate.skipped, pstate.patched, pstate.spliced, pstate.rewritten,
        )
        try:
            for d in distros:
                plan = plans.get(d.id, [])
                is_alias = d.id.endswith(ALIAS_SUFFIX)
                base_id = d.id[: -len(ALIAS_SUFFIX)] if is_alias else d.id
                info = infos.get(d.id, DistroQueueInfo())
                info.secondary_queue = is_alias
                try:
                    queues[d.id] = persist_task_queue(
                        store,
                        base_id,
                        plan,
                        sort_values.get(d.id, {}),
                        met_cols.get(d.id, deps_met),
                        info,
                        opts.max_scheduled_per_distro,
                        secondary=is_alias,
                        now=now,
                        state=pstate,
                        # the cache's per-distro unstamped set collapses the
                        # candidate scan to the handful of fresh tasks (alias
                        # plans hold other distros' tasks — those scan)
                        stamp_hint=(
                            tick_cache.stamp_candidates(d.id)
                            if tick_cache is not None and not is_alias else None
                        ),
                    )
                except Exception as exc:  # noqa: BLE001 — isolate per distro
                    queues[d.id] = 0
                    # the doc may be half-written: drop its fingerprint so the
                    # next tick full-rewrites instead of patching a broken base
                    pstate._fps.pop((base_id, is_alias), None)
                    degraded = degraded or "persist-failed"
                    TICK_DEGRADED.inc(cause="persist_failed")
                    _rlog.error(
                        "queue-persist-failed",
                        distro=base_id,
                        error=repr(exc)[-300:],
                    )
                    continue
                if is_alias:
                    continue  # alias rows never spawn hosts (units/scheduler_alias.go)
                if opts.create_intent_hosts:
                    want = new_hosts.get(d.id, 0)
                    n = min(want, budget)
                    if want > n:
                        # the allocator asked for more than the in-flight budget
                        # allows: count every rejected host so a starved fleet
                        # budget is visible, never silent
                        INTENT_BUDGET_CLAMPED.inc(want - n)
                    budget -= n
                    created = []
                    try:
                        for _ in range(n):
                            intent = new_intent(d.id, d.provider)
                            host_mod.insert(store, intent)
                            created.append(intent)
                    except Exception as exc:  # noqa: BLE001 — isolate per distro
                        degraded = degraded or "persist-failed"
                        TICK_DEGRADED.inc(cause="persist_failed")
                        _rlog.error(
                            "intent-create-failed",
                            distro=base_id,
                            error=repr(exc)[-300:],
                        )
                    intent_hosts.extend(created)
                    if created:
                        # event emission is optional work: over the tick budget
                        # (or under brownout) it is shed before anything that
                        # affects planning
                        shed_reason = _shed_optional()
                        if shed_reason:
                            if "events" not in shed:
                                shed.append("events")
                                overload_mod.record_shed(
                                    store, "tick", "events", detail=shed_reason
                                )
                            continue
                        try:
                            event_mod.log(
                                store,
                                event_mod.RESOURCE_HOST,
                                "HOSTS_CREATED",
                                d.id,
                                {"count": len(created)},
                                timestamp=now,
                            )
                        except Exception as exc:  # noqa: BLE001 — events are
                            # optional work; a storage fault here never kills
                            # the tick
                            degraded = degraded or "persist-failed"
                            TICK_DEGRADED.inc(cause="persist_failed")
                            _rlog.error(
                                "event-emit-failed",
                                distro=base_id,
                                error=repr(exc)[-300:],
                            )
        finally:
            _persist_rec["attributes"].update(
                skip=pstate.skipped - _shapes_before[0],
                patch=pstate.patched - _shapes_before[1],
                splice=pstate.spliced - _shapes_before[2],
                rewrite=pstate.rewritten - _shapes_before[3],
            )
    TICK_PHASE_MS.observe(
        (_time.perf_counter() - t_persist) * 1e3, phase="persist"
    )

    # Stats are the FIRST work shed under the tick budget (before events,
    # long before planning): the time-to-empty estimate and its span are
    # telemetry, not decisions.
    worst = ("", 0.0)
    stats_shed_reason = _shed_optional()
    if stats_shed_reason:
        if "stats" not in shed:
            shed.append("stats")
            overload_mod.record_shed(
                store, "tick", "stats", detail=stats_shed_reason
            )
    else:
        # time-to-empty estimate per tick (the reference's allocator
        # telemetry, units/host_allocator.go:295-334): queued work over
        # usable capacity
        tte = {}
        for d in distros:
            info = infos.get(d.id)
            if info is None or d.id.endswith(ALIAS_SUFFIX):
                continue
            capacity = max(
                len(hosts_by_distro.get(d.id, [])) + new_hosts.get(d.id, 0), 1
            )
            tte[d.id] = round(info.expected_duration_s / capacity, 1)
        worst = max(tte.items(), key=lambda kv: kv[1]) if tte else ("", 0.0)
        # the per-solve timing span (the reference's scheduler span
        # attributes; sink: the store's spans collection)
        with _tracer.span(
            "tick_stats",
            n_tasks=n_tasks,
            n_distros=len(distros),
            snapshot_ms=round(snapshot_ms, 2),
            solve_ms=round(solve_ms, 2),
            total_ms=round((_time.perf_counter() - t0) * 1e3, 2),
            planner=PlannerVersion.TPU.value,
            worst_time_to_empty_s=worst[1],
            worst_time_to_empty_distro=worst[0],
        ):
            pass
    if shed:
        TICK_DEGRADED.inc(cause="shed")
        _rlog.warning(
            "degraded-tick",
            reason=stats_shed_reason or "budget-exceeded",
            shed=list(shed),
            budget_s=opts.tick_budget_s,
            overload=overload_mod.level_name(olevel),
        )
    # commit the tick's WAL group: sync mode surfaces a write error as
    # THIS tick's degradation; async mode hands the frame to the flusher
    # (the write overlaps the next tick) and a deferred error degrades
    # the NEXT tick at its barrier. The commit time feeds the ladder's
    # store-latency EWMA
    committed[0] = True
    t_commit = _time.perf_counter()
    with _tracer.span(
        "wal_commit", mode="async" if opts.async_persist else "sync"
    ):
        commit_reason = _commit_tick_group(store, opts)
    commit_ms = (_time.perf_counter() - t_commit) * 1e3
    TICK_PHASE_MS.observe(commit_ms, phase="wal_commit")
    monitor.observe("store_latency_ms", commit_ms, ewma=0.4)
    if commit_reason == "fenced":
        degraded = "fenced"  # supersedes any earlier per-distro reason
    else:
        degraded = degraded or commit_reason
    total_ms = (_time.perf_counter() - t0) * 1e3
    if provenance is not None:
        # "why is task X at rank Y" stays answerable after the tick
        # (scheduler/provenance.py provenance_for)
        store._last_provenance = provenance
    # the structured runtime-stats line operators grep for (reference
    # grip message.Fields, scheduler/wrapper.go:93-128); it survives
    # shedding — it IS the breadcrumb trail
    get_logger("scheduler").info(
        "runtime-stats",
        operation="tick",
        n_tasks=n_tasks,
        n_distros=len(distros),
        snapshot_ms=round(snapshot_ms, 2),
        solve_ms=round(solve_ms, 2),
        total_ms=round(total_ms, 2),
        new_hosts=sum(new_hosts.values()),
        worst_time_to_empty_s=worst[1],
        worst_time_to_empty_distro=worst[0],
        planner_used=planner_used,
        degraded=degraded,
        shed=list(shed),
        overload=overload_mod.level_name(olevel),
    )
    return TickResult(
        queues=queues,
        new_hosts=new_hosts,
        intent_hosts=intent_hosts,
        n_tasks=n_tasks,
        n_distros=len(distros),
        snapshot_ms=snapshot_ms,
        solve_ms=solve_ms,
        total_ms=total_ms,
        planner_used=planner_used,
        degraded=degraded,
        shed=shed,
        overload=overload_mod.level_name(olevel),
        provenance=provenance,
    )
