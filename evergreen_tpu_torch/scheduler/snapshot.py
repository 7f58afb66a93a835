"""Snapshot builder: domain documents → the packed solve's arena buffers.

Counterpart of ``evergreen_tpu/scheduler/snapshot.py`` without its
native packer: one host-side pass that fills

  * task feature arrays [N]   (priority, requester flags, durations, …)
  * unit-membership edges [M] (task → planner unit)
  * allocator segments [G]    (distro × task-group aggregation targets)
  * host arrays [H]           (free/running state + running-task estimates)
  * the distro settings matrix [D] and the capacity page [P], [C]

as views into three typed arenas (``ops/packing.py``). For the same
problem the buffers are byte-identical to the JAX package's, so both
packages solve the very same input (``tests/test_torch_layout.py``).
A long-lived caller passes the membership memo and the arena pool that
``scheduler/wrapper.py::_snapshot_memos_for`` keeps per store; the
resident state plane (``scheduler/resident.py``) reuses this module's
pieces for its slabs.
"""
from __future__ import annotations

import dataclasses
import operator as _operator
from typing import Dict, List, Tuple

import numpy as np

from ..globals import (
    ALIAS_SUFFIX,
    DEFAULT_TASK_DURATION_S,
    MAX_TASK_TIME_IN_QUEUE_S,
    TASK_COMPLETED_STATUSES,
    FeedbackRule,
    Provider,
    RoundingRule,
    is_github_merge_queue_requester,
    is_patch_requester,
)
from ..models.distro import Distro
from ..models.host import Host
from ..models.task import Task
from ..ops.capacity import C_BUCKET, P_BUCKET, pool_index_of
from ..ops.packing import Arena
from .serial import RunningTaskEstimate


def build_memberships(
    distro: Distro,
    tasks: List[Task],
    base: int,
    unit_base: int = 0,
    di: int = 0,
    named_base: int = 0,
    t_seg_out=None,
    deps_met: Dict[str, bool] = None,
    t_dm_out=None,
) -> Tuple[int, np.ndarray, np.ndarray, List[str], List[int]]:
    """Planner units and allocator segments of one distro's tasks.

    Returns (n_units, membership task indices, membership unit indices,
    distinct segment names in first-seen order, per-segment max hosts).
    Unit creation ORDER is the planner's deterministic tie-break. When
    ``t_seg_out`` is given, each task's global segment id lands there:
    ``di`` (the distro's "" segment) for ungrouped tasks, ``named_base`` +
    local ordinal for grouped ones; ``t_dm_out`` receives each task's
    ``deps_met.get(id, True)``."""
    group_versions = distro.planner_settings.group_versions
    key_to_unit: Dict[str, int] = {}   # group-string / version keys
    task_unit: Dict[str, int] = {}     # task id -> registered unit
    mem_by_task: List[List[int]] = []
    n_units = 0
    seg_ord: Dict[str, int] = {}
    seg_names: List[str] = []
    seg_max: List[int] = []

    for i, t in enumerate(tasks):
        if t_dm_out is not None:
            t_dm_out[i] = (
                deps_met.get(t.id, True) if deps_met is not None else True
            )
        units_of_t: List[int] = []
        if t.task_group:
            k = t.task_group_string()
            u = key_to_unit.get(k)
            if u is None:
                u = key_to_unit[k] = n_units
                n_units += 1
            units_of_t.append(u)
            task_unit.setdefault(t.id, u)
            if group_versions:
                v = key_to_unit.get(t.version)
                if v is None:
                    v = key_to_unit[t.version] = n_units
                    n_units += 1
                if v not in units_of_t:
                    units_of_t.append(v)
            so = seg_ord.get(k)
            if so is None:
                so = seg_ord[k] = len(seg_names)
                seg_names.append(k)
                seg_max.append(0)
            if seg_max[so] == 0 and t.task_group_max_hosts > 0:
                seg_max[so] = t.task_group_max_hosts
            if t_seg_out is not None:
                t_seg_out[i] = named_base + so
        else:
            if group_versions:
                v = key_to_unit.get(t.version)
                if v is None:
                    v = key_to_unit[t.version] = n_units
                    n_units += 1
                units_of_t.append(v)
                task_unit.setdefault(t.id, v)
            else:
                u = n_units
                n_units += 1
                units_of_t.append(u)
                task_unit[t.id] = u
            if t_seg_out is not None:
                t_seg_out[i] = di
        mem_by_task.append(units_of_t)

    # dependency-closure pass: a task joins the unit registered under each
    # of its dependencies' ids
    for j, t in enumerate(tasks):
        if t.depends_on:
            lst = mem_by_task[j]
            for dep in t.depends_on:
                u = task_unit.get(dep.task_id)
                if u is not None and u not in lst:
                    lst.append(u)

    m_task: List[int] = []
    m_unit: List[int] = []
    for j, lst in enumerate(mem_by_task):
        for u in lst:
            m_task.append(base + j)
            m_unit.append(unit_base + u)
    return (
        n_units,
        np.asarray(m_task, np.int32),
        np.asarray(m_unit, np.int32),
        seg_names,
        seg_max,
    )


def _bucket(n: int, minimum: int = 32) -> int:
    """Round up to the next bucket size: powers of two interleaved with
    1.25×/1.5×/1.75× quarter-points, so padding waste stays ≤ 25% while
    distinct shapes grow only logarithmically with queue size."""
    if n <= minimum:
        return minimum
    lo = 1 << (int(n).bit_length() - 1)
    if n <= lo:
        return lo
    if lo >= 64:
        for num in (5, 6, 7):  # lo·1.25, lo·1.5, lo·1.75
            q = lo * num // 4
            if n <= q:
                return q
    else:
        mid = lo + lo // 2
        if n <= mid:
            return mid
    return lo * 2


@dataclasses.dataclass
class Snapshot:
    """Point-in-time tensor view of the whole scheduling problem."""

    now: float
    distro_ids: List[str]
    task_ids: List[str]
    host_ids: List[str]
    #: segment index → (distro index, group name)
    seg_names: List[Tuple[int, str]]
    #: real (unpadded) sizes
    n_tasks: int
    n_units: int
    n_hosts: int
    n_segs: int
    n_distros: int
    #: named views into the arenas (bool fields exposed as bool)
    arrays: Dict[str, np.ndarray]
    arena: Arena = None
    #: the task objects in flat (task_ids) order, so unpacking a result
    #: indexes tasks positionally
    flat_tasks: List[Task] = None

    def shape_key(self) -> Tuple[int, ...]:
        """(N, M, U, G, H, D, P, C): the padded dims, which alone fix the
        arena layout (``arena_for_dims``)."""
        a = self.arrays
        return (
            len(a["t_valid"]),
            len(a["m_task"]),
            len(a["u_distro"]),
            len(a["g_distro"]),
            len(a["h_valid"]),
            len(a["d_valid"]),
            len(a["p_price"]),
            len(a["c_cfg"]),
        )


def deps_met_for(tasks, coll, in_snapshot=None) -> Dict[str, bool]:
    """Fetch the finished parents' statuses from the tasks collection
    ``coll`` and compute the deps-met mask over ``tasks`` — the one block
    shared by the cold gather and the TickCache's incremental
    maintenance, so warm/cold parity cannot drift."""
    parent_ids = {d.task_id for t in tasks for d in t.depends_on}
    finished = {
        doc["_id"]: doc["status"]
        for doc in coll.find_ids(list(parent_ids))
        if doc["status"] in TASK_COMPLETED_STATUSES
    }
    return compute_deps_met(tasks, finished, in_snapshot=in_snapshot)


def compute_deps_met(
    tasks: List[Task],
    finished_status: Dict[str, str],
    in_snapshot=None,
) -> Dict[str, bool]:
    """Dependency-met mask over the snapshot's tasks: a dependency is met
    iff its parent is finished with the required status. Parents inside
    the snapshot are unfinished by construction, so only out-of-snapshot
    parents (``finished_status``: task id → final status) can satisfy
    an edge. ``in_snapshot`` overrides the membership set when the caller
    computes flags for a SUBSET of tasks whose parents may live elsewhere
    in the full snapshot (the TickCache's incremental maintenance)."""
    if in_snapshot is None:
        in_snapshot = {t.id for t in tasks}
    met: Dict[str, bool] = {}
    for t in tasks:
        if t.override_dependencies or not t.depends_on:
            met[t.id] = True
            continue
        ok = True
        for dep in t.depends_on:
            if dep.task_id in in_snapshot:
                ok = False
                break
            status = finished_status.get(dep.task_id)
            if status is None:
                ok = False
                break
            if dep.status != "*" and status != dep.status:
                ok = False
                break
        met[t.id] = ok
    return met


#: field name → arena kind; the single source of truth for the layout
#: (the sidecar wire format rebuilds it from the shape key alone)
FIELD_KINDS: Dict[str, str] = {
    # tasks [N]
    "t_valid": "u8", "t_distro": "i32", "t_priority": "i32",
    "t_is_merge": "u8", "t_is_patch": "u8", "t_stepback": "u8",
    "t_generate": "u8", "t_in_group": "u8", "t_group_order": "i32",
    "t_time_in_queue_s": "f32", "t_expected_s": "f32",
    "t_wait_dep_met_s": "f32", "t_num_dependents": "i32",
    "t_deps_met": "u8", "t_seg": "i32",
    # memberships [M]
    "m_task": "i32", "m_unit": "i32", "m_valid": "u8",
    # units [U]: the three rank terms are computed host-side in f64
    "u_distro": "i32", "u_tiq_term": "f32", "u_mainline_hours": "f32",
    "u_runtime_term": "f32",
    # segments [G]
    "g_distro": "i32", "g_unnamed": "u8", "g_max_hosts": "i32",
    "g_valid": "u8",
    # hosts [H]
    "h_valid": "u8", "h_distro": "i32", "h_seg": "i32", "h_free": "u8",
    "h_running": "u8", "h_elapsed_s": "f32", "h_expected_s": "f32",
    "h_std_s": "f32",
    # distros [D]
    "d_task_count": "i32", "d_valid": "u8", "d_min_hosts": "i32",
    "d_max_hosts": "i32",
    "d_future_fraction": "f32", "d_round_up": "u8", "d_feedback": "u8",
    "d_disabled": "u8", "d_ephemeral": "u8", "d_is_docker": "u8",
    "d_thresh_s": "f32", "d_patch_factor": "f32", "d_patch_tiq_factor": "f32",
    "d_cq_factor": "f32", "d_mainline_tiq_factor": "f32",
    "d_runtime_factor": "f32", "d_generate_factor": "f32",
    "d_numdep_factor": "f32", "d_stepback_factor": "f32",
    # capacity eligibility columns
    "d_pool": "i32", "d_cap_on": "u8",
    "d_alias": "u8", "d_single_task": "u8",
    # capacity page: pool vectors [P] and the scalar page [C]
    "p_price": "f32", "p_quota": "f32",
    "c_cfg": "f32",
}

_DIM_OF_FIELD = {
    "t_": "N", "m_": "M", "u_": "U", "g_": "G", "h_": "H", "d_": "D",
    "p_": "P", "c_": "C",
}

#: P and C never bucket: they are constants of the capacity program
_FIXED_DIMS = {"P": P_BUCKET, "C": C_BUCKET}


def layout_for_dims(dims: Dict[str, int]) -> Arena:
    """The canonical (unallocated) snapshot layout for bucket sizes
    ``{"N":…, "M":…, "U":…, "G":…, "H":…, "D":…}``. The field order of
    FIELD_KINDS fully determines the transfer layout."""
    dims = {**_FIXED_DIMS, **dims}
    arena = Arena()
    for name, kind in FIELD_KINDS.items():
        arena.alloc(name, dims[_DIM_OF_FIELD[name[:2]]], kind)
    return arena


def arena_for_dims(dims: Dict[str, int], pool=None) -> Arena:
    """A zeroed snapshot arena for bucket sizes ``dims``; ``pool`` (an
    ``ops.packing.ArenaPool``) leases one of its rotating buffer sets
    instead of allocating."""
    arena = layout_for_dims(dims)
    arena.finalize(pool)
    return arena


def _factor(v: float) -> float:
    """Factors ≤ 0 resolve to 1."""
    return float(v) if v > 0 else 1.0


def pack_distro_settings(a: Dict[str, np.ndarray], distros) -> None:
    """Fill the per-distro settings columns (everything derived from the
    Distro document) into the first ``len(distros)`` rows of ``d_*``."""
    n_d = len(distros)
    if not n_d:
        return
    ps_l = [d.planner_settings for d in distros]
    hs_l = [d.host_allocator_settings for d in distros]

    def fill(name, values):
        a[name][:n_d] = values

    fill("d_min_hosts", [h.minimum_hosts for h in hs_l])
    fill("d_max_hosts", [h.maximum_hosts for h in hs_l])
    fill("d_future_fraction", [h.future_host_fraction for h in hs_l])
    fill("d_round_up", [h.rounding_rule == RoundingRule.UP.value for h in hs_l])
    fill(
        "d_feedback",
        [h.feedback_rule == FeedbackRule.WAITS_OVER_THRESH.value for h in hs_l],
    )
    fill("d_disabled", [d.disabled for d in distros])
    fill("d_ephemeral", [d.is_ephemeral() for d in distros])
    fill("d_is_docker", [d.provider == Provider.DOCKER.value for d in distros])
    fill("d_thresh_s", [p.max_duration_per_host_s() for p in ps_l])
    fill("d_patch_factor", [_factor(p.patch_factor) for p in ps_l])
    fill("d_patch_tiq_factor", [_factor(p.patch_time_in_queue_factor) for p in ps_l])
    fill("d_cq_factor", [_factor(p.commit_queue_factor) for p in ps_l])
    fill(
        "d_mainline_tiq_factor",
        [_factor(p.mainline_time_in_queue_factor) for p in ps_l],
    )
    fill("d_runtime_factor", [_factor(p.expected_runtime_factor) for p in ps_l])
    fill("d_generate_factor", [_factor(p.generate_task_factor) for p in ps_l])
    fill("d_numdep_factor", [_factor(p.num_dependents_factor) for p in ps_l])
    fill("d_stepback_factor", [_factor(p.stepback_task_factor) for p in ps_l])
    fill("d_pool", [pool_index_of(d.provider) for d in distros])
    fill("d_cap_on", [p.capacity == "tpu" for p in ps_l])
    fill("d_alias", [d.id.endswith(ALIAS_SUFFIX) for d in distros])
    fill("d_single_task", [bool(d.single_task_distro) for d in distros])


def pack_capacity_page(a: Dict[str, np.ndarray], page) -> None:
    """Write (or clear, ``page=None``) the capacity page into the
    fixed-width p_/c_ columns. ``page`` holds "p_price", "p_quota" [P]
    and "c_cfg" [C]."""
    if page is None:
        a["p_price"][:] = 0.0
        a["p_quota"][:] = 0.0
        a["c_cfg"][:] = 0.0
        return
    a["p_price"][:P_BUCKET] = page["p_price"]
    a["p_quota"][:P_BUCKET] = page["p_quota"]
    a["c_cfg"][:C_BUCKET] = page["c_cfg"]


#: time-independent per-task columns copied from ``_pack_static`` into
#: the arena
_STATIC_ARENA_COLS = (
    "t_is_merge", "t_is_patch", "t_stepback", "t_generate", "t_in_group",
    "t_priority", "t_group_order", "t_num_dependents", "t_expected_s",
)


def _pack_static(tasks: List[Task]) -> Dict[str, np.ndarray]:
    """Static (time-independent) column block for one distro's tasks,
    plus the host-only scratch columns t_expected_floor_s / t_basis /
    t_start."""
    n = len(tasks)
    cols: Dict[str, np.ndarray] = {
        "t_is_merge": np.zeros(n, np.uint8),
        "t_is_patch": np.zeros(n, np.uint8),
        "t_stepback": np.zeros(n, np.uint8),
        "t_generate": np.zeros(n, np.uint8),
        "t_in_group": np.zeros(n, np.uint8),
        "t_priority": np.zeros(n, np.int32),
        "t_group_order": np.zeros(n, np.int32),
        "t_num_dependents": np.zeros(n, np.int32),
        "t_expected_s": np.zeros(n, np.float32),
        "t_expected_floor_s": np.zeros(n, np.float32),
        "t_basis": np.zeros(n, np.float64),
        "t_start": np.zeros(n, np.float64),
    }
    if not n:
        return cols
    merge_flags = [
        is_github_merge_queue_requester(t.requester) for t in tasks
    ]
    cols["t_is_merge"][:] = merge_flags
    cols["t_is_patch"][:] = [
        (not m) and is_patch_requester(t.requester)
        for m, t in zip(merge_flags, tasks)
    ]
    cols["t_stepback"][:] = [t.is_stepback_activated() for t in tasks]
    cols["t_generate"][:] = [bool(t.generate_task) for t in tasks]
    cols["t_in_group"][:] = [bool(t.task_group) for t in tasks]
    cols["t_priority"][:] = [t.priority for t in tasks]
    cols["t_group_order"][:] = [t.task_group_order for t in tasks]
    cols["t_num_dependents"][:] = [t.num_dependents for t in tasks]
    act = np.fromiter((t.activated_time for t in tasks), np.float64, n)
    ingest = np.fromiter((t.ingest_time for t in tasks), np.float64, n)
    cols["t_basis"][:] = np.where(act > 0.0, act, ingest)
    sched = np.fromiter((t.scheduled_time for t in tasks), np.float64, n)
    dmt = np.fromiter(
        (t.dependencies_met_time for t in tasks), np.float64, n
    )
    cols["t_start"][:] = np.maximum(sched, dmt)
    dur = np.fromiter((t.expected_duration_s for t in tasks), np.float64, n)
    exp64 = np.where(dur > 0.0, dur, float(DEFAULT_TASK_DURATION_S))
    cols["t_expected_s"][:] = exp64
    cols["t_expected_floor_s"][:] = np.floor(exp64)
    return cols


def _memb_equivalent(old_tasks: List[Task], tasks: List[Task]) -> bool:
    """Soft membership-memo hit: two task lists form identical planner
    units/segments iff every membership-relevant field matches pairwise —
    id, task group string inputs (group/variant/project/version), group
    max-hosts, and the dependency edges. A task re-materialized because
    only its time stamps changed then reuses the cached memberships; its
    static columns are still repacked (stamps feed t_start)."""
    if len(old_tasks) != len(tasks):
        return False
    for a, b in zip(old_tasks, tasks):
        if a is b:
            continue
        if (
            a.id != b.id
            or a.task_group != b.task_group
            or a.version != b.version
            or a.build_variant != b.build_variant
            or a.project != b.project
            or a.task_group_max_hosts != b.task_group_max_hosts
            or a.depends_on != b.depends_on
        ):
            return False
    return True


def build_snapshot(
    distros: List[Distro],
    tasks_by_distro: Dict[str, List[Task]],
    hosts_by_distro: Dict[str, List[Host]],
    running_estimates: Dict[str, RunningTaskEstimate],
    deps_met: Dict[str, bool],
    now: float,
    force_dims: Dict[str, int] = None,
    dims_memo: Dict[str, int] = None,
    memb_memo: Dict[str, tuple] = None,
    arena_pool=None,
) -> Snapshot:
    """Pack one scheduling problem into a fresh arena.

    ``force_dims`` is a floor on the bucket sizes, maxed with the natural
    buckets: the sharded build pads every shard to common dims so the
    blocks stack, and a shard that has grown past the floor pads up
    instead of overflowing.

    ``dims_memo`` (caller-owned, kept across ticks) adds hysteresis: a
    dimension keeps its previous bucket while the live count still fits
    and the bucket is at most 4x the natural one, so a count oscillating
    across a bucket edge does not change the layout every few ticks.

    ``memb_memo`` (caller-owned, kept across ticks) caches each distro's
    unit memberships, segments and static columns keyed on the identity
    of its task instances (or, on a soft hit, on their membership
    fields), stored base-relative and rebased with one vectorized add,
    so a warm build stays byte-identical to a cold one. ``arena_pool``
    leases the arena's buffers (``Snapshot.arena.close`` returns them)."""
    n_d = len(distros)

    # ---- flatten tasks + build planner unit memberships ------------------- #
    # Segment layout: the n_d "" segments first (global seg id == distro
    # index), then each distro's named task-group segments in first-seen
    # order.
    flat_tasks: List[Task] = []
    t_counts: List[int] = []
    u_counts: List[int] = []
    unit_base = 0
    n_t_total = sum(len(tasks_by_distro.get(d.id, [])) for d in distros)
    t_seg_np = np.zeros(max(n_t_total, 1), np.int32)
    t_dm_np = np.ones(max(n_t_total, 1), np.uint8)
    m_task_parts: List[np.ndarray] = []
    m_unit_parts: List[np.ndarray] = []
    static_jobs: List[Tuple[int, int, Dict[str, np.ndarray]]] = []
    seg_names: List[Tuple[int, str]] = [(di, "") for di in range(n_d)]
    seg_max_hosts_l: List[int] = [0] * n_d
    named_base = n_d
    _is = _operator.is_
    for di, d in enumerate(distros):
        tasks = tasks_by_distro.get(d.id, [])
        base = len(flat_tasks)
        gv = bool(d.planner_settings.group_versions)
        seg_slice = t_seg_np[base:base + len(tasks)]
        dm_slice = t_dm_np[base:base + len(tasks)]
        entry = memb_memo.get(d.id) if memb_memo is not None else None
        hard_hit = (
            entry is not None
            and entry[0] == gv
            and (
                entry[1] is tasks  # the TickCache reuses list objects
                or (
                    len(entry[1]) == len(tasks)
                    and all(map(_is, entry[1], tasks))
                )
            )
        )
        soft_hit = (
            not hard_hit
            and entry is not None
            and entry[0] == gv
            and _memb_equivalent(entry[1], tasks)
        )
        if hard_hit or soft_hit:
            (_, _, n_units_d, mt_local, mu_local, snames, smax, seg_local,
             scols) = entry
            if soft_hit:
                scols = _pack_static(tasks)
                memb_memo[d.id] = (gv, tasks, n_units_d, mt_local, mu_local,
                                   snames, smax, seg_local, scols)
            # rebase the cached local ids into this build's coordinates
            mt_arr = mt_local + np.int32(base)
            mu_arr = mu_local + np.int32(unit_base)
            if len(tasks):
                np.copyto(
                    seg_slice,
                    np.where(seg_local < 0, np.int32(di),
                             seg_local + np.int32(named_base)),
                )
                if deps_met is not None:
                    dm_slice[:] = np.fromiter(
                        (deps_met.get(t.id, True) for t in tasks),
                        np.uint8, len(tasks),
                    )
                else:
                    dm_slice[:] = 1
        else:
            n_units_d, mt_arr, mu_arr, snames, smax = build_memberships(
                d, tasks, base, unit_base, di, named_base, seg_slice,
                deps_met, dm_slice,
            )
            scols = _pack_static(tasks)
            if memb_memo is not None:
                # stored base-relative: grouped segments as local
                # ordinals, ungrouped (== di) as -1
                seg_local = np.where(
                    seg_slice >= n_d, seg_slice - np.int32(named_base),
                    np.int32(-1),
                ) if len(tasks) else seg_slice.copy()
                memb_memo[d.id] = (
                    gv, tasks, n_units_d, mt_arr - np.int32(base),
                    mu_arr - np.int32(unit_base), snames, smax, seg_local,
                    scols,
                )
        seg_names.extend((di, nm) for nm in snames)
        seg_max_hosts_l.extend(smax)
        named_base += len(snames)
        if len(tasks):
            static_jobs.append((base, len(tasks), scols))
        flat_tasks.extend(tasks)
        t_counts.append(len(tasks))
        u_counts.append(n_units_d)
        m_task_parts.append(mt_arr)
        m_unit_parts.append(mu_arr)
        unit_base += n_units_d

    if memb_memo is not None and len(memb_memo) > n_d:
        # evict distros that left the set: a deleted distro must not pin
        # its task list for the service's lifetime
        live = {d.id for d in distros}
        for k in [k for k in memb_memo if k not in live]:
            del memb_memo[k]

    m_task = (
        np.concatenate(m_task_parts) if m_task_parts
        else np.empty(0, np.int32)
    )
    m_unit = (
        np.concatenate(m_unit_parts) if m_unit_parts
        else np.empty(0, np.int32)
    )
    d_arange = np.arange(n_d, dtype=np.int32)
    t_distro = np.repeat(d_arange, t_counts)
    u_distro = np.repeat(d_arange, u_counts)
    n_t, n_m, n_u = len(flat_tasks), len(m_task), len(u_distro)

    # ---- hosts (may introduce segments no queued task names) -------------- #
    seg_index: Dict[Tuple[int, str], int] = {
        key: idx for idx, key in enumerate(seg_names)
    }

    def seg_for(di: int, name: str) -> int:
        key = (di, name)
        idx = seg_index.get(key)
        if idx is None:
            idx = len(seg_names)
            seg_index[key] = idx
            seg_names.append(key)
            seg_max_hosts_l.append(0)
        return idx

    flat_hosts: List[Host] = []
    h_counts: List[int] = []
    for d in distros:
        hs = hosts_by_distro.get(d.id, [])
        flat_hosts.extend(hs)
        h_counts.append(len(hs))
    n_h = len(flat_hosts)
    h_distro_np = np.repeat(d_arange, h_counts)
    ests = [
        running_estimates.get(h.id) if h.running_task else None
        for h in flat_hosts
    ]
    # default segment = the distro's "" segment; hosts running a
    # task-group task map to that group's segment (appended if new,
    # before dims are computed)
    h_seg_np = h_distro_np.copy()
    for i, h in enumerate(flat_hosts):
        if h.running_task and h.running_task_group:
            h_seg_np[i] = seg_for(int(h_distro_np[i]), h.task_group_string())
    n_g = len(seg_names)

    # ---- padded arena allocation ------------------------------------------ #
    counts = {
        "N": max(n_t, 1), "M": max(n_m, 1), "U": max(n_u, 1),
        "G": max(n_g, 1), "H": max(n_h, 1), "D": max(n_d, 1),
    }
    dims = {
        k: _bucket(c, minimum=8 if k == "D" else 32)
        for k, c in counts.items()
    }
    if force_dims is not None:
        dims = {k: max(int(force_dims.get(k, 0)), v) for k, v in dims.items()}
    elif dims_memo is not None:
        for k, c in counts.items():
            prev = dims_memo.get(k, 0)
            if prev >= c and prev <= 4 * dims[k]:
                dims[k] = prev
        dims_memo.update(dims)
    N, U, G, D = dims["N"], dims["U"], dims["G"], dims["D"]

    arena = arena_for_dims(dims, arena_pool)
    a: Dict[str, np.ndarray] = {}
    for name, kind in FIELD_KINDS.items():
        v = arena.view(name)
        a[name] = v.view(np.bool_) if kind == "u8" else v

    def fill(name: str, values, pad=0):
        arr = a[name]
        if pad:
            arr[:] = pad
        n = len(values)
        if n:
            arr[:n] = values
        return arr

    fill("t_distro", t_distro, pad=D - 1)
    # host-only scratch: whole-second expected durations feeding the exact
    # u_runtime_term sum below, floored in f64 before the f32 store
    t_exp_floor = np.zeros(max(n_t, 1), np.float32)
    basis = np.zeros(max(n_t, 1), np.float64)
    start = np.zeros(max(n_t, 1), np.float64)
    a["t_valid"][:n_t] = True
    for base, n, scols in static_jobs:
        for name in _STATIC_ARENA_COLS:
            a[name][base:base + n] = scols[name]
        t_exp_floor[base:base + n] = scols["t_expected_floor_s"]
        basis[base:base + n] = scols["t_basis"]
        start[base:base + n] = scols["t_start"]
    if n_t:
        # whole seconds, floored in f64 before the f32 store: integer-valued
        # sums are exact and order-independent in f64
        np.floor(
            np.where(
                basis[:n_t] > 0.0,
                np.minimum(
                    np.maximum(0.0, now - basis[:n_t]),
                    MAX_TASK_TIME_IN_QUEUE_S,
                ),
                0.0,
            ),
            out=basis[:n_t],
        )
        a["t_time_in_queue_s"][:n_t] = basis[:n_t]
        a["t_wait_dep_met_s"][:n_t] = np.where(
            start[:n_t] > 0.0, np.maximum(0.0, now - start[:n_t]), 0.0
        )
    fill("t_deps_met", t_dm_np[:n_t].view(np.bool_))
    fill("t_seg", t_seg_np[:n_t], pad=G - 1)

    # memberships (padding points at dummy task N-1 / unit U-1)
    fill("m_task", m_task, pad=N - 1)
    fill("m_unit", m_unit, pad=U - 1)
    a["m_valid"][:n_m] = True

    fill("u_distro", u_distro, pad=D - 1)

    # per-unit planner rank terms, exact in f64
    if n_m:
        tiq64 = a["t_time_in_queue_s"][:n_t].astype(np.float64)
        expf64 = t_exp_floor[:n_t].astype(np.float64)
        u_tiq_sum = np.bincount(m_unit, weights=tiq64[m_task], minlength=n_u)
        u_exp_sum = np.bincount(m_unit, weights=expf64[m_task], minlength=n_u)
        u_len64 = np.maximum(
            np.bincount(m_unit, minlength=n_u).astype(np.float64), 1.0
        )
        fill(
            "u_tiq_term",
            np.floor((u_tiq_sum / 60.0) / u_len64).astype(np.float32),
        )
        avg_life = u_tiq_sum / u_len64
        week_s = 7 * 24 * 3600.0
        fill(
            "u_mainline_hours",
            np.where(
                avg_life < week_s,
                np.trunc((week_s - avg_life) / 3600.0),
                0.0,
            ).astype(np.float32),
        )
        fill(
            "u_runtime_term",
            np.floor((u_exp_sum / 60.0) / u_len64).astype(np.float32),
        )

    # segments
    fill(
        "g_distro",
        np.fromiter((di for di, _ in seg_names), np.int32, n_g),
        pad=D - 1,
    )
    fill("g_unnamed", [name == "" for _, name in seg_names])
    fill("g_max_hosts", seg_max_hosts_l)
    a["g_valid"][:n_g] = True

    # hosts
    a["h_valid"][:n_h] = True
    fill("h_distro", h_distro_np, pad=D - 1)
    fill("h_seg", h_seg_np, pad=G - 1)
    if n_h:
        a["h_free"][:n_h] = [h.is_free() for h in flat_hosts]
        a["h_running"][:n_h] = [e is not None for e in ests]
        a["h_elapsed_s"][:n_h] = [e.elapsed_s if e else 0.0 for e in ests]
        a["h_expected_s"][:n_h] = [e.expected_s if e else 0.0 for e in ests]
        a["h_std_s"][:n_h] = [e.std_dev_s if e else 0.0 for e in ests]

    # distro settings matrix
    fill("d_valid", [True] * n_d)
    # live task counts per distro (on this contiguous layout also each
    # distro's range length: ops/solve.py::distro_task_offsets)
    fill("d_task_count", t_counts)
    pack_distro_settings(a, distros)

    return Snapshot(
        now=now,
        distro_ids=[d.id for d in distros],
        task_ids=[t.id for t in flat_tasks],
        host_ids=[h.id for h in flat_hosts],
        seg_names=seg_names,
        n_tasks=n_t,
        n_units=n_u,
        n_hosts=n_h,
        n_segs=n_g,
        n_distros=n_d,
        arrays=a,
        arena=arena,
        flat_tasks=flat_tasks,
    )
