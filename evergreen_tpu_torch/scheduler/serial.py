"""Serial reference-equivalent scheduler: the tick's fallback planner.

A copy of ``evergreen_tpu/scheduler/serial.py``: in plain Python, the
semantics of the reference's per-distro planning path — unit grouping
(scheduler/planner.go:431-459), unit scoring (planner.go:200-310), queue
export ordering (planner.go:462-481), queue aggregate info
(scheduler/scheduler.go:57-164), and the utilization-based host allocator
(scheduler/utilization_based_host_allocator.go).

``run_tick`` falls back to ``serial_tick`` when the packed solve on the
card raises, overruns its deadline or has its breaker open, and plans
cmp-based distros' queue info and spawn counts with
``queue_info_and_new_hosts``. It is deliberately loop-heavy and
per-distro, like the Go original; do not optimize it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from ..globals import (
    MAX_DURATION_PER_DISTRO_HOST_S,
    COMMIT_QUEUE_PRIORITY_BOOST,
    FeedbackRule,
    Provider,
    RoundingRule,
    is_github_merge_queue_requester,
    is_patch_requester,
)
from ..models.distro import Distro
from ..models.host import Host
from ..models.task import Task
from ..models.task_queue import DistroQueueInfo, TaskGroupInfo


def _get_factor(value: float) -> float:
    """Reference fallback: factors ≤ 0 resolve to 1
    (model/distro/distro.go:352-405)."""
    return value if value > 0 else 1


# --------------------------------------------------------------------------- #
# Unit grouping (reference scheduler/planner.go:431-459 PrepareTasksForPlanning)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Unit:
    """A schedulable group of tasks handled as one sortable object."""

    index: int
    task_ids: List[str] = dataclasses.field(default_factory=list)
    _seen: set = dataclasses.field(default_factory=set)

    def add(self, t: Task) -> None:
        if t.id not in self._seen:
            self._seen.add(t.id)
            self.task_ids.append(t.id)


def prepare_units(
    distro: Distro, tasks: List[Task]
) -> Tuple[List[Unit], Dict[str, List[int]]]:
    """Group tasks into units. Returns (units, task_id -> unit indices).

    Reference semantics (planner.go:431-459):
      * task-group members unite under the task-group string; the unit is
        also registered under each member's task id;
      * with group_versions, tasks also unite under their version id
        (group members are *added* to the version unit too);
      * otherwise each task forms a singleton unit registered under its id;
      * second pass: a task joins the unit registered under each of its
        dependencies' task ids, when that unit exists.
    """
    units: List[Unit] = []
    by_key: Dict[str, Unit] = {}
    membership: Dict[str, List[int]] = {}

    def unit_for(key: str) -> Unit:
        u = by_key.get(key)
        if u is None:
            u = Unit(index=len(units))
            units.append(u)
            by_key[key] = u
        return u

    def join(t: Task, u: Unit) -> None:
        u.add(t)
        lst = membership.setdefault(t.id, [])
        if u.index not in lst:
            lst.append(u.index)

    group_versions = distro.planner_settings.group_versions
    for t in tasks:
        if t.task_group:
            u = unit_for(t.task_group_string())
            join(t, u)
            by_key.setdefault(t.id, u)
            if group_versions:
                join(t, unit_for(t.version))
        elif group_versions:
            u = unit_for(t.version)
            join(t, u)
            by_key.setdefault(t.id, u)
        else:
            join(t, unit_for(t.id))

    for t in tasks:
        for dep in t.depends_on:
            u = by_key.get(dep.task_id)
            if u is not None:
                join(t, u)

    return units, membership


# --------------------------------------------------------------------------- #
# Unit scoring (reference scheduler/planner.go:200-310)
# --------------------------------------------------------------------------- #


def unit_value(
    distro: Distro, tasks: List[Task], now: float
) -> float:
    """value = computePriority * computeRankValue + unitLength
    (planner.go:209-217)."""
    s = distro.planner_settings
    unit_len = len(tasks)

    contains_merge = False
    contains_patch = False
    contains_non_group = False
    contains_generate = False
    contains_stepback = False
    time_in_queue_s = 0.0
    max_priority = 0
    expected_runtime_s = 0.0
    max_num_dependents = 0

    for t in tasks:
        if is_github_merge_queue_requester(t.requester):
            contains_merge = True
        elif is_patch_requester(t.requester):
            contains_patch = True
        contains_non_group = contains_non_group or not t.task_group
        contains_generate = contains_generate or t.generate_task
        contains_stepback = contains_stepback or t.is_stepback_activated()
        # whole seconds: the reference sums int64 nanoseconds
        # (planner.go:318-322); integer seconds keep the f64 sum exact
        # and order-independent, matching the snapshot builder's
        # precomputed u_tiq_term bit-for-bit
        time_in_queue_s += math.floor(t.time_in_queue(now))
        max_priority = max(max_priority, t.priority)
        # whole seconds, same rationale as time_in_queue_s above — keeps
        # the sum exact in f64 and bit-identical to the snapshot
        # builder's u_runtime_term
        expected_runtime_s += math.floor(t.fetch_expected_duration().average_s)
        max_num_dependents = max(max_num_dependents, t.num_dependents)

    # computePriority (planner.go:271-304)
    priority = 1 + max_priority
    if not contains_non_group:
        priority += unit_len
    if contains_generate:
        priority *= int(_get_factor(s.generate_task_factor))
    if contains_merge:
        priority += COMMIT_QUEUE_PRIORITY_BOOST

    # computeRankValue (planner.go:223-268)
    rank = 1
    if contains_patch:
        rank += int(_get_factor(s.patch_factor))
        rank += int(_get_factor(s.patch_time_in_queue_factor)) * int(
            math.floor((time_in_queue_s / 60.0) / unit_len)
        )
    elif contains_merge:
        rank += int(_get_factor(s.commit_queue_factor))
    else:
        avg_life_s = time_in_queue_s / unit_len
        week_s = 7 * 24 * 3600.0
        if avg_life_s < week_s:
            rank += int(_get_factor(s.mainline_time_in_queue_factor)) * int(
                (week_s - avg_life_s) / 3600.0
            )
        if contains_stepback:
            rank += int(_get_factor(s.stepback_task_factor))
    rank += int(_get_factor(s.num_dependents_factor) * max_num_dependents)
    rank += int(_get_factor(s.expected_runtime_factor)) * int(
        math.floor((expected_runtime_s / 60.0) / unit_len)
    )

    return float(priority * rank + unit_len)


def _task_list_key(t: Task):
    """Within-unit ordering (planner.go TaskList.Less): group order asc,
    num dependents desc, priority desc, expected duration desc."""
    return (
        t.task_group_order,
        -t.num_dependents,
        -t.priority,
        -t.fetch_expected_duration().average_s,
    )


def plan_distro_queue(
    distro: Distro, tasks: List[Task], now: float
) -> Tuple[List[Task], Dict[str, float]]:
    """PrepareTasksForPlanning(…).Export(…) — the ordered queue for one
    distro (planner.go:462-481). Returns (ordered tasks, task_id → sort value).
    """
    by_id = {t.id: t for t in tasks}
    units, _ = prepare_units(distro, tasks)

    scored: List[Tuple[float, int, Unit]] = []
    for u in units:
        val = unit_value(distro, [by_id[i] for i in u.task_ids], now)
        scored.append((val, u.index, u))
    # Unit order: value desc; ties broken by creation index (deterministic
    # stand-in for Go's unstable sort.Sort).
    scored.sort(key=lambda x: (-x[0], x[1]))

    out: List[Task] = []
    sort_values: Dict[str, float] = {}
    seen: set = set()
    # Final tie-break: task creation index. The reference's within-unit
    # ordering on full ties is nondeterministic (Unit.tasks is a Go map);
    # both of our paths pin it to the queue's task order.
    index = {t.id: i for i, t in enumerate(tasks)}
    for val, _, u in scored:
        members = [by_id[i] for i in u.task_ids]
        members.sort(key=lambda t: (*_task_list_key(t), index[t.id]))
        for t in members:
            if t.id in seen:
                continue
            seen.add(t.id)
            sort_values[t.id] = val
            out.append(t)
    return out, sort_values


# --------------------------------------------------------------------------- #
# Queue aggregate info (reference scheduler/scheduler.go:57-164)
# --------------------------------------------------------------------------- #


def get_distro_queue_info(
    distro: Distro,
    plan: List[Task],
    deps_met: Dict[str, bool],
    now: float,
    includes_dependencies: bool = True,
) -> DistroQueueInfo:
    max_duration_threshold_s = distro.planner_settings.max_duration_per_host_s()
    infos: Dict[str, TaskGroupInfo] = {}
    order: List[str] = []

    total_expected = 0.0
    total_over_count = 0
    total_over_dur = 0.0
    total_wait_over = 0
    n_deps_met = 0
    n_merge = 0

    for t in plan:
        name = t.task_group_string() if t.task_group else ""
        info = infos.get(name)
        if info is None:
            info = TaskGroupInfo(name=name, max_hosts=t.task_group_max_hosts)
            infos[name] = info
            order.append(name)

        met = deps_met.get(t.id, True)
        counted = (not includes_dependencies) or met
        if counted:
            info.count += 1
            info.expected_duration_s += t.fetch_expected_duration().average_s

        if met:
            n_deps_met += 1
            if is_github_merge_queue_requester(t.requester):
                n_merge += 1
                info.count_dep_filled_merge_queue += 1

        if counted:
            dur = t.fetch_expected_duration().average_s
            total_expected += dur
            if dur > max_duration_threshold_s:
                info.count_duration_over_threshold += 1
                info.duration_over_threshold_s += dur
                total_over_count += 1
                total_over_dur += dur
            if met:
                wait = t.wait_since_dependencies_met(now)
                if wait > max_duration_threshold_s:
                    info.count_wait_over_threshold += 1
                    total_wait_over += 1

    return DistroQueueInfo(
        length=len(plan),
        length_with_dependencies_met=n_deps_met,
        count_dep_filled_merge_queue=n_merge,
        expected_duration_s=total_expected,
        max_duration_threshold_s=max_duration_threshold_s,
        count_duration_over_threshold=total_over_count,
        duration_over_threshold_s=total_over_dur,
        count_wait_over_threshold=total_wait_over,
        task_group_infos=[infos[n] for n in order],
    )


# --------------------------------------------------------------------------- #
# Utilization-based host allocator
# (reference scheduler/utilization_based_host_allocator.go)
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class RunningTaskEstimate:
    """Duration estimate for a host's running task, resolved by the caller
    (the reference resolves via task.Find + FetchExpectedDuration,
    utilization_based_host_allocator.go:309-379)."""

    elapsed_s: float
    expected_s: float
    std_dev_s: float
    #: absolute start time when known (0 = unknown)
    start_s: float = 0.0


@dataclasses.dataclass
class AllocatorInput:
    distro: Distro
    existing_hosts: List[Host]
    queue_info: DistroQueueInfo
    #: host id → estimate for its running task ("" running task → absent)
    running_estimates: Dict[str, RunningTaskEstimate] = dataclasses.field(
        default_factory=dict
    )


def _soon_to_be_free(
    hosts: List[Host],
    estimates: Dict[str, RunningTaskEstimate],
    future_host_fraction: float,
    max_duration_per_host_s: float,
) -> float:
    """Fractional soon-free hosts (utilization_based_host_allocator.go:309-379),
    with the 3σ long-tail guard at :352-358."""
    total = 0.0
    for h in hosts:
        if not h.running_task:
            continue
        est = estimates.get(h.id)
        if est is None:
            continue
        time_left = est.expected_s - est.elapsed_s
        if (
            est.elapsed_s > MAX_DURATION_PER_DISTRO_HOST_S
            and est.std_dev_s > 0
            and est.elapsed_s > est.expected_s + 3 * est.std_dev_s
        ):
            frac = 0.0
        else:
            frac = (max_duration_per_host_s - time_left) / max_duration_per_host_s
        frac = min(1.0, max(0.0, frac))
        total += future_host_fraction * frac
    return total


def _calc_new_hosts_needed(
    short_dur_s: float,
    max_duration_per_host_s: float,
    expected_free: int,
    n_long: int,
    n_overdue: int,
    n_merge: int,
    round_down: bool,
) -> int:
    """utilization_based_host_allocator.go:253-281."""
    needed = (
        short_dur_s / max_duration_per_host_s
        - float(expected_free)
        + float(n_long)
        + float(n_overdue)
        + float(n_merge)
    )
    if expected_free < 1 and 0 < needed < 1:
        return 1
    n = math.floor(needed) if round_down else math.ceil(needed)
    return max(0, int(n))


def utilization_based_host_allocator(inp: AllocatorInput) -> Tuple[int, int]:
    """Returns (num new hosts to request, approx free hosts).

    Reference: UtilizationBasedHostAllocator
    (scheduler/utilization_based_host_allocator.go:26-131).
    """
    d = inp.distro
    settings = d.host_allocator_settings
    n_existing = len(inp.existing_hosts)
    min_hosts = settings.minimum_hosts

    free_hosts = [h for h in inp.existing_hosts if h.is_free()]

    if d.provider != Provider.DOCKER.value and n_existing >= settings.maximum_hosts:
        return 0, len(free_hosts)

    if d.disabled:
        return max(0, min_hosts - n_existing), len(free_hosts)

    # group hosts by the task group of their running task (":" groupByTaskGroup)
    host_groups: Dict[str, List[Host]] = {}
    for h in inp.existing_hosts:
        name = ""
        if h.running_task and h.running_task_group:
            name = h.task_group_string()
        host_groups.setdefault(name, []).append(h)
    group_names = set(host_groups)
    infos_by_name = {g.name: g for g in inp.queue_info.task_group_infos}
    group_names.update(infos_by_name)

    round_down = settings.rounding_rule != RoundingRule.UP.value
    feedback = settings.feedback_rule == FeedbackRule.WAITS_OVER_THRESH.value

    required = 0
    free_approx = 0
    for name in group_names:
        info = infos_by_name.get(name, TaskGroupInfo(name=name))
        hosts = host_groups.get(name, [])
        if name == "":
            max_hosts = settings.maximum_hosts
        else:
            if info.count == 0:
                continue  # skip groups with no queued work (:84-86)
            max_hosts = info.max_hosts

        if not d.is_ephemeral():
            continue  # only dynamic providers allocate (:146-148)

        expected_free = len([h for h in hosts if h.is_free()]) + int(
            math.floor(
                _soon_to_be_free(
                    hosts,
                    inp.running_estimates,
                    settings.future_host_fraction,
                    inp.queue_info.max_duration_threshold_s,
                )
            )
        )

        n_overdue = info.count_wait_over_threshold if feedback else 0
        short_dur = info.expected_duration_s - info.duration_over_threshold_s
        n = _calc_new_hosts_needed(
            short_dur,
            inp.queue_info.max_duration_threshold_s,
            expected_free,
            info.count_duration_over_threshold,
            n_overdue,
            info.count_dep_filled_merge_queue,
            round_down,
        )
        n = min(n, info.count)
        if n + len(hosts) > max_hosts:
            n = max_hosts - len(hosts)
        n = max(0, n)
        if max_hosts < 1:
            n = 0

        required += n
        free_approx += expected_free
        info.count_free = expected_free
        info.count_required = n

    # never request more hosts than deps-met tasks (:113-118)
    if required + len(free_hosts) > inp.queue_info.length_with_dependencies_met:
        required = inp.queue_info.length_with_dependencies_met - len(free_hosts)
    required = max(0, required)

    # minimum-hosts top-up (:121-128)
    if n_existing + required < min_hosts:
        required += min_hosts - (n_existing + required)

    return required, free_approx


# --------------------------------------------------------------------------- #
# Whole-tick serial driver
# --------------------------------------------------------------------------- #


def queue_info_and_new_hosts(
    d: Distro,
    plan: List[Task],
    deps_met: Dict[str, bool],
    hosts: List[Host],
    running_estimates: Dict[str, RunningTaskEstimate],
    now: float,
) -> Tuple[DistroQueueInfo, int]:
    """Queue info + utilization allocation for one planned distro — the
    per-distro tail every planner shares (serial tick and the cmp-based
    path in the tick wrapper), kept in one place so allocator wiring
    changes cannot diverge between them."""
    info = get_distro_queue_info(d, plan, deps_met, now)
    n_new, _ = utilization_based_host_allocator(
        AllocatorInput(
            distro=d,
            existing_hosts=hosts,
            queue_info=info,
            running_estimates=running_estimates,
        )
    )
    return info, n_new


def serial_tick(
    distros: List[Distro],
    tasks_by_distro: Dict[str, List[Task]],
    hosts_by_distro: Dict[str, List[Host]],
    running_estimates: Dict[str, RunningTaskEstimate],
    deps_met: Dict[str, bool],
    now: float,
) -> Dict[str, Tuple[List[Task], DistroQueueInfo, int, Dict[str, float]]]:
    """One full scheduling tick, serial per distro — the shape of the
    reference's fan-out (units/crons.go:274-331) collapsed into a loop.
    Returns distro id → (ordered queue, queue info, new hosts, sort values).
    """
    out: Dict[str, Tuple[List[Task], DistroQueueInfo, int, Dict[str, float]]] = {}
    for d in distros:
        tasks = tasks_by_distro.get(d.id, [])
        plan, sort_values = plan_distro_queue(d, tasks, now)
        info, n_new = queue_info_and_new_hosts(
            d, plan, deps_met, hosts_by_distro.get(d.id, []),
            running_estimates, now,
        )
        out[d.id] = (plan, info, n_new, sort_values)
    return out
