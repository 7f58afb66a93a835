"""Scheduler tick, planning half: store → gather → snapshot → bounded
solve → unpack.

A copy of the planning half of ``evergreen_tpu/scheduler/wrapper.py``:
the solve breaker, ``gather_tick_inputs`` (without the TickCache's
views), ``_unpack_solve``,
``_apply_release_mode`` and ``_solve_bounded``, whose solve is the port's
``run_solve_packed`` on the card. A tick composes them as the JAX
``run_tick`` body does — intent budget, ``capacity_plane_for(store)
.build_capacity_page``, ``build_snapshot`` + ``pack_capacity_page``,
``_solve_bounded``, ``_unpack_solve``, the ``d_pool``/``d_cap_on``
columns and ``extract_fused_view``, the alias and single-task rules,
``capacity_plane_for(store).apply``. ``run_tick`` itself, its options
and result, the persister, the serial oracle, the TickCache, the
resident plane and the tracing spans are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..globals import ALIAS_SUFFIX, DEFAULT_TASK_DURATION_S
from ..models import distro as distro_mod
from ..models import host as host_mod
from ..models import task as task_mod
from ..models.distro import Distro
from ..models.host import Host
from ..models.task import Task
from ..models.task_queue import QueueInfoView
from ..ops.solve import run_solve_packed
from ..settings import ReleaseModeConfig, ServiceFlags
from ..storage.store import Store
from ..utils import faults
from ..utils import lockcheck as _lockcheck
from ..utils.circuit import CircuitBreaker
from .provenance import TickProvenance, build_provenance
from .serial import RunningTaskEstimate
from .snapshot import Snapshot, deps_met_for

_breakers_lock = _lockcheck.make_lock("sched.tick_caches")


#: consecutive solve failures before the breaker opens, and how long it
#: stays open before half-open probes (the reference's planner=tpu →
#: tunable downgrade, generalized)
SOLVE_BREAKER_THRESHOLD = 3
SOLVE_BREAKER_COOLDOWN_S = 60.0

#: per-store circuit breakers around the packed device solve
_solve_breakers: Dict[int, tuple] = {}


def solve_breaker_for(store: Store):
    """Per-store breaker guarding the device-solve path of run_tick."""
    key = id(store)
    with _breakers_lock:
        entry = _solve_breakers.get(key)
        if entry is None or entry[0] is not store:
            entry = (
                store,
                CircuitBreaker(
                    "scheduler.solve",
                    failure_threshold=SOLVE_BREAKER_THRESHOLD,
                    cooldown_s=SOLVE_BREAKER_COOLDOWN_S,
                ),
            )
            _solve_breakers[key] = entry
        return entry[1]


def gather_tick_inputs(
    store: Store,
    now: float,
    runnable_tasks: Optional[List[Task]] = None,
    active_hosts: Optional[List[Host]] = None,
    deps_met: Optional[Dict[str, bool]] = None,
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
    the full task history. The JAX function's TickCache views
    (``by_distro``, ``alias_by_distro``, ``distro_view``) come with the
    TickCache.
    """
    # The snapshot covers the allocator's distro set (a superset that
    # includes disabled distros, which still maintain minimum hosts); task
    # queues are only gathered for the plannable subset (reference
    # model/distro/db.go:198-224).
    distros = distro_mod.find_needs_hosts_planning(store)
    distro_ids = {d.id for d in distro_mod.find_needs_planning(store)}
    all_ids = {d.id for d in distros}

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
    # deps-met map is restricted to this gather's runnable set.
    coll = task_mod.coll(store)
    if deps_met is None:
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
    device) replaces ``run_solve_packed`` on the card when given."""

    def work():
        faults.fire("scheduler.solve")
        return (solve_fn or run_solve_packed)(snapshot)

    if deadline_s <= 0:
        return work()
    result: list = []

    def runner():
        try:
            result.append(("ok", work()))
        except BaseException as exc:  # noqa: BLE001 — relayed to caller
            result.append(("err", exc))

    th = threading.Thread(target=runner, daemon=True, name="tick-solve")
    th.start()
    th.join(deadline_s)
    if th.is_alive() or not result:
        raise TimeoutError(
            f"solve exceeded its {deadline_s}s deadline"
        )
    kind, val = result[0]
    if kind == "err":
        raise val
    return val
