"""The batched scheduling solve, one pass over ALL distros, on tensors.

Counterpart of ``evergreen_tpu/ops/solve.py``:

  planner            — unit scoring via segment reductions over task→unit
                       membership edges, then one lexicographic sort (three
                       packed 64-bit keys) giving every distro's queue;
  allocator          — utilization-based host allocation via segment
                       reductions over distro × task-group segments; the
                       seven per-distro queue statistics come from
                       ``fused_distro_stats`` (a Hopper kernel on the card);
  capacity_affinity  — the capacity program's damped-Newton relaxation
                       (``ops/capacity.py::relax``, the fused rung) and
                       the task-group → pool affinity anneal.

Inputs are the named tensors ``ops/packing.py::unpack`` makes from the
snapshot arena; ``_packed_solve`` returns one i32 result buffer laid out
by ``OUTPUT_SPEC``. Everything is static-shaped and branch-free over the
data; the capacity trip count is a host integer read off the snapshot.
Real-valued per-segment sums that feed floors and ceilings go through
``ops/segment.py`` so their rounding equals the CPU's on every run.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..globals import MAX_DURATION_PER_DISTRO_HOST_S
from .capacity import (
    C_AFF_ANNEAL,
    C_AFF_T0,
    C_BUCKET,
    C_BUDGET_BASE,
    C_ITERS,
    C_SPLIT_BUDGET,
    C_VALID,
    C_W_CHURN,
    C_W_PRICE,
    P_BUCKET,
    _BIG,
    effective_caps,
    relax,
)
from .distro_stats import fused_distro_stats
from .packing import unpack
from .segment import segment_plan, segment_sum

#: anneal sweeps of the advisory task-group→pool affinity block
AFFINITY_ITERS_MAX = 12

_F32 = torch.float32
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def _seg_sum(x, seg, n):
    """Per-segment sum by ``index_add_``; used only where every term is
    integer-valued (counts), so the f32 result is exact in any order."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, seg, x)


def _seg_max(x, seg, n):
    fill = -float("inf") if x.is_floating_point() else _I32_MIN
    init = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    return init.scatter_reduce_(0, seg, x, reduce="amax")


def _seg_min(x, seg, n):
    fill = float("inf") if x.is_floating_point() else _I32_MAX
    init = torch.full((n,), fill, dtype=x.dtype, device=x.device)
    return init.scatter_reduce_(0, seg, x, reduce="amin")


# --------------------------------------------------------------------------- #
# Planner
# --------------------------------------------------------------------------- #

_U32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def _f32_sortable(x):
    """Order-preserving f32 → u32 (IEEE-754 total order incl. ±inf), held
    in int64: negative floats flip all bits, the others set the sign bit."""
    b = x.contiguous().view(torch.int32).long() & _U32
    return torch.where((b >> 31) == 1, b ^ _U32, b | _SIGN32)


def _i32_sortable(x):
    """Order-preserving i32 → u32 (flip the sign bit), held in int64."""
    return (x.to(torch.int32).long() & _U32) ^ _SIGN32


def _u64_key(hi, lo):
    """int64 whose signed order is the unsigned order of ``hi << 32 | lo``
    (hi, lo < 2**32): the u64 shifted down by 2**63."""
    return (hi - 2**31) * 2**32 + lo


def _stable_argsort_lex(keys):
    """Indices sorting by ``keys`` lexicographically (first key most
    significant), ties by index: stable sorts, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _sort_packed(d_key, neg_value, unit, group_order, num_dependents,
                 priority, expected_s, bits_u):
    """The planner's 7-field lexicographic order as THREE 64-bit keys

      key1 = distro | sortable(neg value) | unit        (asc, asc, asc)
      key2 = sortable(group order) | sortable(-numdep)  (asc, asc)
      key3 = sortable(-priority)   | sortable(-expected)

    exactly as the JAX package packs them, each held as an int64 whose
    signed order is its unsigned order. Needs bits(D+1) + bits_u ≤ 32."""
    sv = _f32_sortable(neg_value)
    unit = unit.long()
    # key1 = d << (32 + B) | sv << B | unit, split into its u32 halves
    hi1 = d_key.long() * 2**bits_u + (sv >> (32 - bits_u))
    lo1 = ((sv << bits_u) & _U32) | unit
    k1 = _u64_key(hi1, lo1)
    k2 = _u64_key(
        _i32_sortable(group_order),
        _i32_sortable(-num_dependents.to(torch.int32)),
    )
    k3 = _u64_key(
        _i32_sortable(-priority.to(torch.int32)), _f32_sortable(-expected_s)
    )
    return _stable_argsort_lex((k1, k2, k3))


def _sort_variadic(keys):
    """The same order over the eight unpacked keys, for dims too wide to
    pack. Floats compare with -0.0 == 0.0, as the JAX comparator does."""
    ks = [
        _f32_sortable(k + 0.0) if k.is_floating_point() else _i32_sortable(k)
        for k in keys
    ]
    return _stable_argsort_lex(ks)


def planner(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-unit sorting values and the global queue ordering."""
    N = a["t_valid"].shape[0]
    U = a["u_distro"].shape[0]
    D = a["d_valid"].shape[0]
    dev = a["t_valid"].device

    m_task, m_unit = a["m_task"].long(), a["m_unit"].long()
    m_valid = a["m_valid"]

    def gather(x):
        return torch.where(m_valid, x[m_task], 0)

    # ---- unit aggregates --------------------------------------------------- #
    u_len = _seg_sum(m_valid.to(_F32), m_unit, U)
    u_merge = _seg_max(gather(a["t_is_merge"].int()), m_unit, U) > 0
    u_patch = _seg_max(gather(a["t_is_patch"].int()), m_unit, U) > 0
    u_non_group = _seg_max(gather((~a["t_in_group"]).int()), m_unit, U) > 0
    u_generate = _seg_max(gather(a["t_generate"].int()), m_unit, U) > 0
    u_stepback = _seg_max(gather(a["t_stepback"].int()), m_unit, U) > 0
    u_max_priority = _seg_max(gather(a["t_priority"]), m_unit, U).to(_F32)
    u_max_numdep = _seg_max(gather(a["t_num_dependents"]), m_unit, U).to(_F32)
    # rank terms arrive precomputed (exact f64) from the snapshot builder
    u_tiq_term = a["u_tiq_term"]
    u_mainline_hours = a["u_mainline_hours"]
    u_runtime_term = a["u_runtime_term"]

    ud = a["u_distro"].long()

    def factor(name):
        return torch.trunc(a[name][ud])

    # ---- computePriority --------------------------------------------------- #
    priority = 1.0 + u_max_priority
    priority = torch.where(~u_non_group, priority + u_len, priority)
    priority = torch.where(
        u_generate, priority * factor("d_generate_factor"), priority
    )
    priority = torch.where(u_merge, priority + 200.0, priority)

    # ---- computeRankValue -------------------------------------------------- #
    patch_rank = factor("d_patch_factor") + factor("d_patch_tiq_factor") * u_tiq_term
    merge_rank = factor("d_cq_factor")
    mainline_rank = (
        factor("d_mainline_tiq_factor") * u_mainline_hours
    ) + torch.where(u_stepback, factor("d_stepback_factor"), 0.0)

    rank = 1.0 + torch.where(
        u_patch, patch_rank, torch.where(u_merge, merge_rank, mainline_rank)
    )
    rank = rank + torch.trunc(a["d_numdep_factor"][ud] * u_max_numdep)
    rank = rank + factor("d_runtime_factor") * u_runtime_term

    # two rounded ops, as in the JAX package: a fused multiply-add would
    # round t_value differently and could reorder queues
    u_value = priority * rank
    u_value = u_value + u_len

    # ---- per-task claimed unit: max value, ties → smallest unit index ----- #
    m_value = torch.where(m_valid, u_value[m_unit], -float("inf"))
    t_best_value = _seg_max(m_value, m_task, N)
    is_best = m_valid & (m_value >= t_best_value[m_task])
    t_best_unit = _seg_min(torch.where(is_best, a["m_unit"], _I32_MAX), m_task, N)
    t_best_unit = torch.where(t_best_unit == _I32_MAX, 0, t_best_unit)

    # ---- global lexicographic sort ----------------------------------------- #
    t_valid = a["t_valid"]
    d_key = torch.where(t_valid, a["t_distro"], D).to(torch.int32)
    neg_value = torch.where(t_valid, -t_best_value, float("inf"))
    bits_d = int(D + 1).bit_length()
    bits_u = int(U).bit_length()
    if bits_d + bits_u <= 32:
        order = _sort_packed(
            d_key, neg_value, t_best_unit, a["t_group_order"],
            a["t_num_dependents"], a["t_priority"], a["t_expected_s"], bits_u,
        )
    else:  # astronomically wide dims: the unpacked form
        order = _sort_variadic((
            d_key, neg_value, t_best_unit, a["t_group_order"],
            -a["t_num_dependents"].to(torch.int32),
            -a["t_priority"].to(torch.int32), -a["t_expected_s"],
            torch.arange(N, dtype=torch.int32, device=dev),
        ))

    # ---- decision provenance: the claimed unit's score terms -------------- #
    bu = t_best_unit.long()
    return {
        "order": order.to(torch.int32),
        "t_value": torch.where(t_valid, t_best_value, 0.0),
        "t_unit": t_best_unit,
        "t_prio": torch.where(t_valid, priority[bu], 0.0),
        "t_rank": torch.where(t_valid, rank[bu], 0.0),
        "t_tiq": torch.where(t_valid, u_tiq_term[bu], 0.0),
        "t_stepback": torch.where(t_valid, u_stepback[bu].int(), 0),
    }


# --------------------------------------------------------------------------- #
# Allocator
# --------------------------------------------------------------------------- #


def distro_thresh(a: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each distro's duration threshold, with zeros clamped to 1.0."""
    return torch.where(a["d_thresh_s"] > 0, a["d_thresh_s"], 1.0)


def distro_host_counts(a: Dict[str, torch.Tensor]) -> Tuple:
    """(existing, free) hosts per distro, as f32 counts."""
    D = a["d_valid"].shape[0]
    h_distro = a["h_distro"].long()
    h_valid = a["h_valid"]
    return (
        _seg_sum(h_valid.to(_F32), h_distro, D),
        _seg_sum((h_valid & a["h_free"]).to(_F32), h_distro, D),
    )


def distro_task_offsets(t_valid: torch.Tensor, t_distro: torch.Tensor,
                        D: int) -> torch.Tensor:
    """(D+1,) i32 offsets whose range ``[offs[d], offs[d+1])`` holds every
    valid row of distro d and no valid row of another, on any layout
    that keeps each distro's rows contiguous and in distro order: the
    cold build's (distros back to back, then a padding tail with
    ``t_distro`` D−1) and the resident plane's slabs (holes and headroom
    inside, an arena tail of ``t_distro`` 0 after the last slab).
    ``offs[d+1]`` is one past the last valid row of the distros up to d,
    so on the cold layout the offsets equal ``cumsum(d_task_count)``
    bit for bit, the padding tails join no range, and an empty distro's
    range is empty. Invalid rows inside a range add nothing to any
    statistic. Computed on the device, with no wait on it."""
    n = t_valid.shape[0]
    rows = torch.arange(n, dtype=torch.int64, device=t_valid.device)
    last = torch.full((D,), -1, dtype=torch.int64, device=t_valid.device)
    last = last.scatter_reduce(
        0, t_distro.long(), torch.where(t_valid, rows, -1), "amax")
    hi = torch.cummax(last, 0).values + 1
    return torch.cat([hi.new_zeros(1), hi]).to(torch.int32)


def distro_stats_inputs(a: Dict[str, torch.Tensor]) -> Tuple:
    """The allocator's arguments to ``fused_distro_stats``: the five task
    columns as packed, each distro's range offsets
    (``distro_task_offsets``) and its threshold (``distro_thresh``)."""
    offsets = distro_task_offsets(
        a["t_valid"], a["t_distro"], a["d_valid"].shape[0])
    return (
        a["t_valid"], a["t_deps_met"], a["t_expected_s"],
        a["t_wait_dep_met_s"], a["t_is_merge"], offsets, distro_thresh(a),
    )


def allocator(a: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Batched utilization-based host allocation + queue aggregate info."""
    G = a["g_distro"].shape[0]
    D = a["d_valid"].shape[0]

    t_valid = a["t_valid"]
    t_seg = a["t_seg"].long()
    t_distro = a["t_distro"].long()
    deps_met = t_valid & a["t_deps_met"]
    dur = a["t_expected_s"]
    gd = a["g_distro"].long()
    stats_args = distro_stats_inputs(a)
    thresh_d = stats_args[-1]
    t_thresh = thresh_d[t_distro]

    # ---- per-segment queue aggregates (dependency-met tasks only) --------- #
    t_plan = segment_plan(t_seg, G, t_valid, name="task")
    cnt = _seg_sum(deps_met.to(_F32), t_seg, G)
    over = deps_met & (dur > t_thresh)
    exp_dur, over_dur = segment_sum(
        torch.stack([torch.where(deps_met, dur, 0.0), torch.where(over, dur, 0.0)]),
        t_plan,
    )
    over_cnt = _seg_sum(over.to(_F32), t_seg, G)
    wait_over = deps_met & (a["t_wait_dep_met_s"] > t_thresh)
    wait_over_cnt = _seg_sum(wait_over.to(_F32), t_seg, G)
    merge_met = deps_met & a["t_is_merge"]
    merge_cnt = _seg_sum(merge_met.to(_F32), t_seg, G)

    # ---- per-segment host aggregates -------------------------------------- #
    h_valid = a["h_valid"]
    h_seg = a["h_seg"].long()
    h_distro = a["h_distro"].long()
    h_free = h_valid & a["h_free"]
    free_cnt = _seg_sum(h_free.to(_F32), h_seg, G)
    host_cnt = _seg_sum(h_valid.to(_F32), h_seg, G)

    # soon-free fraction per running host, with the 3σ overrun guard
    h_running = h_valid & a["h_running"]
    time_left = a["h_expected_s"] - a["h_elapsed_s"]
    h_thresh = thresh_d[h_distro]
    frac = torch.clamp((h_thresh - time_left) / h_thresh, 0.0, 1.0)
    guard = (
        (a["h_elapsed_s"] > float(MAX_DURATION_PER_DISTRO_HOST_S))
        & (a["h_std_s"] > 0)
        & (a["h_elapsed_s"] > a["h_expected_s"] + 3.0 * a["h_std_s"])
    )
    frac = torch.where(guard, 0.0, frac)
    frac = torch.where(h_running, a["d_future_fraction"][h_distro] * frac, 0.0)
    soon_free = segment_sum(frac, segment_plan(h_seg, G, h_valid, name="host"))
    expected_free = free_cnt + torch.floor(soon_free)

    # ---- evalHostUtilization per segment ----------------------------------- #
    seg_active = a["g_unnamed"] | (cnt > 0)
    seg_eph = a["d_ephemeral"][gd] & seg_active & a["g_valid"]
    max_hosts_seg = torch.where(
        a["g_unnamed"], a["d_max_hosts"][gd], a["g_max_hosts"]
    ).to(_F32)

    overdue = torch.where(a["d_feedback"][gd], wait_over_cnt, 0.0)
    short_dur = exp_dur - over_dur
    needed = (
        short_dur / thresh_d[gd] - expected_free + over_cnt + overdue + merge_cnt
    )
    special = (expected_free < 1.0) & (needed > 0.0) & (needed < 1.0)
    rounded = torch.where(a["d_round_up"][gd], torch.ceil(needed), torch.floor(needed))
    n = torch.where(special, 1.0, rounded)
    n = torch.clamp_min(n, 0.0)
    n = torch.minimum(n, cnt)
    n = torch.where(n + host_cnt > max_hosts_seg, max_hosts_seg - host_cnt, n)
    n = torch.clamp_min(n, 0.0)
    n = torch.where(max_hosts_seg < 1.0, 0.0, n)
    n = torch.where(seg_eph, n, 0.0)
    free_contrib = torch.where(seg_eph, expected_free, 0.0)

    # ---- distro-level reduction (integer-valued terms) -------------------- #
    required = _seg_sum(n, gd, D)
    free_approx = _seg_sum(free_contrib, gd, D)
    d_existing, d_free = distro_host_counts(a)

    stats = fused_distro_stats(*stats_args)
    d_deps_met = stats["d_deps_met"]

    # never exceed the number of dependency-met tasks
    required = torch.where(
        required + d_free > d_deps_met, d_deps_met - d_free, required
    )
    required = torch.clamp_min(required, 0.0)

    # minimum-hosts top-up
    d_min = a["d_min_hosts"].to(_F32)
    required = required + torch.clamp_min(d_min - (d_existing + required), 0.0)

    # disabled distros only top up to the minimum
    required = torch.where(
        a["d_disabled"], torch.clamp_min(d_min - d_existing, 0.0), required
    )
    # at-max-hosts early return for non-docker providers wins even when
    # disabled
    at_max = (~a["d_is_docker"]) & (d_existing >= a["d_max_hosts"].to(_F32))
    required = torch.where(at_max, 0.0, required)
    required = torch.where(a["d_valid"], required, 0.0)

    i32 = torch.int32
    return {
        "d_new_hosts": required.to(i32),
        "d_free_approx": free_approx.to(i32),
        "d_length": stats["d_length"].to(i32),
        "d_deps_met": d_deps_met.to(i32),
        "d_expected_dur_s": stats["d_expected_dur_s"],
        "d_over_count": stats["d_over_count"].to(i32),
        "d_over_dur_s": stats["d_over_dur_s"],
        "d_wait_over": stats["d_wait_over"].to(i32),
        "d_merge": stats["d_merge"].to(i32),
        "g_count": cnt.to(i32),
        "g_expected_dur_s": exp_dur,
        "g_count_free": expected_free.to(i32),
        "g_count_required": n.to(i32),
        "g_over_count": over_cnt.to(i32),
        "g_over_dur_s": over_dur,
        "g_wait_over": wait_over_cnt.to(i32),
        "g_merge": merge_cnt.to(i32),
    }


# --------------------------------------------------------------------------- #
# Fused capacity + affinity block
# --------------------------------------------------------------------------- #


def capacity_affinity(
    a: Dict[str, torch.Tensor],
    out: Dict[str, torch.Tensor],
    cap_iters: int,
) -> Dict[str, torch.Tensor]:
    """The capacity program + task-group→pool affinity, fed by the
    allocator's own aggregates. ``cap_iters`` damped-Newton steps
    (``ops/capacity.py``) over the eligible distros give ``cap_x``; then
    ``min(cap_iters, AFFINITY_ITERS_MAX)`` sweeps of a mean-field annealed
    softmax over the P_BUCKET pools per unit give the advisory
    ``aff_pool``. With ``cap_iters == 0`` both collapse to the projected
    warm start and a uniform softmax, keeping the output layout."""
    U = a["u_distro"].shape[0]
    P = P_BUCKET
    dev = a["d_valid"].device
    c = a["c_cfg"].to(_F32)

    d_valid = a["d_valid"]
    alias = a["d_alias"]
    single = a["d_single_task"]
    maxh_raw = a["d_max_hosts"].to(_F32)
    existing, free = distro_host_counts(a)
    required = out["d_new_hosts"].to(_F32)
    deps = out["d_deps_met"].to(_F32)
    demand = out["d_expected_dur_s"].to(_F32)
    thresh = distro_thresh(a)

    # eligibility: valid, opted in, not an alias or single-task row,
    # ephemeral, enabled, with a host cap
    elig = (
        d_valid
        & a["d_cap_on"]
        & ~alias
        & ~single
        & a["d_ephemeral"]
        & ~a["d_disabled"]
        & (maxh_raw > 0)
    )

    # instance columns (integer-valued ⇒ f32-exact)
    demand_u = demand / thresh
    lo = torch.clamp_min(a["d_min_hosts"].to(_F32), 0.0)
    new_cap = torch.clamp_min(deps - free, 0.0)
    maxh = torch.where(maxh_raw > 0, maxh_raw, _BIG)
    hi = torch.maximum(lo, torch.minimum(maxh, existing + new_cap))
    anchor = torch.clamp(existing + required, lo, hi)

    pool = a["d_pool"].long()
    plan = segment_plan(pool, P, elig, name="pool")

    def pool_sum(x):
        return segment_sum(x, plan)

    # reserved: non-eligible rows draw from the same intent budget first —
    # single-task rows want their 1:1 bypass count, the rest their
    # heuristic count
    bypass = torch.clamp_min(
        torch.minimum(deps, torch.where(maxh_raw > 0, maxh_raw, deps) - existing),
        0.0,
    )
    want = torch.where(single, bypass, required)
    reserved = torch.where(
        d_valid & ~alias & ~elig, torch.clamp_min(want, 0.0), 0.0
    ).sum()
    base = c[C_BUDGET_BASE]
    budget = torch.where(
        base >= 0,
        torch.minimum(c[C_SPLIT_BUDGET], torch.clamp_min(base - reserved, 0.0)),
        c[C_SPLIT_BUDGET],
    )
    # effective quota / budget (min hosts are hard and floor both)
    quota, budget = effective_caps(
        lo, existing, elig, a["p_quota"], budget, pool_sum
    )

    cap_a = {
        "demand_u": demand_u,
        "existing": existing,
        "lo": lo,
        "hi": hi,
        "anchor": anchor,
        "pool": pool,
        "elig": elig,
        "price": a["p_price"].to(_F32),
        "quota": quota,
        "budget": budget,
        "w_price": c[C_W_PRICE],
        "w_churn": c[C_W_CHURN],
    }
    cap_x = relax(cap_a, pool_sum, cap_iters)

    # ---- task-group → pool affinity (anneal over the finished x) ---------- #
    ud = a["u_distro"].long()
    u_valid = _seg_sum(a["m_valid"].to(_F32), a["m_unit"].long(), U) > 0
    home = (
        torch.arange(P, device=dev)[None, :] == pool[ud][:, None]
    ).to(_F32)
    pool_x = pool_sum(torch.where(elig, cap_x, 0.0))
    headroom = pool_x / torch.clamp_min(pool_x.sum(), 1.0)
    n_units = torch.clamp_min(u_valid.to(_F32).sum(), 1.0)
    t0 = torch.where(c[C_AFF_T0] > 0, c[C_AFF_T0], 1.0)
    anneal = torch.clamp(
        torch.where(c[C_AFF_ANNEAL] > 0, c[C_AFF_ANNEAL], 0.92), 0.5, 1.0
    )
    price_term = c[C_W_PRICE] * cap_a["price"][None, :]

    def util(A):
        load = torch.where(u_valid[:, None], A, 0.0).sum(0) / n_units
        return 2.0 * home - price_term + headroom[None, :] - load[None, :]

    A = torch.full((U, P), 1.0 / P, dtype=_F32, device=dev)
    # a dozen sweeps settle the mean-field fixed point; the hints are
    # rounded host-side either way
    for k in range(min(cap_iters, AFFINITY_ITERS_MAX)):
        t = torch.clamp_min(t0 * anneal ** float(k), 1e-3)
        A = torch.softmax(util(A) / t, dim=-1)
    aff = torch.where(u_valid[:, None], A, 0.0)
    return {"cap_x": cap_x, "aff_pool": aff.reshape(U * P)}


# --------------------------------------------------------------------------- #
# Combined solve
# --------------------------------------------------------------------------- #


def solve(a: Dict[str, torch.Tensor], cap_iters: int = 0) -> Dict[str, torch.Tensor]:
    """The whole scheduling tick on device: ordered queues + spawn counts
    + capacity targets + pool affinities. ``cap_iters`` is the capacity
    block's trip count (0 when no capacity page rode the snapshot)."""
    out = planner(a)
    out.update(allocator(a))
    out.update(capacity_affinity(a, out, cap_iters))
    return out


def capacity_iters(snapshot) -> int:
    """The capacity trip count read off the snapshot's c_cfg page."""
    return page_capacity_iters(snapshot.arrays.get("c_cfg"))


def page_capacity_iters(c_cfg) -> int:
    """The capacity trip count of a packed c_cfg page (0 ⇔ no page rode
    this solve), clamped to [0, 512]."""
    if c_cfg is None or len(c_cfg) < C_BUCKET or float(c_cfg[C_VALID]) <= 0.0:
        return 0
    return max(0, min(512, int(float(c_cfg[C_ITERS]))))


#: output name → (dtype kind, dim symbol); dims resolve from the shape key
#: (N tasks, G segments, D distros, U units; "UP" = U·P_BUCKET, the
#: flattened per-unit pool-affinity block — see with_output_dims).
OUTPUT_SPEC = (
    ("order", "i32", "N"),
    ("t_unit", "i32", "N"),
    ("t_stepback", "i32", "N"),
    ("d_new_hosts", "i32", "D"),
    ("d_free_approx", "i32", "D"),
    ("d_length", "i32", "D"),
    ("d_deps_met", "i32", "D"),
    ("d_over_count", "i32", "D"),
    ("d_wait_over", "i32", "D"),
    ("d_merge", "i32", "D"),
    ("g_count", "i32", "G"),
    ("g_count_free", "i32", "G"),
    ("g_count_required", "i32", "G"),
    ("g_over_count", "i32", "G"),
    ("g_wait_over", "i32", "G"),
    ("g_merge", "i32", "G"),
    ("t_value", "f32", "N"),
    ("t_prio", "f32", "N"),
    ("t_rank", "f32", "N"),
    ("t_tiq", "f32", "N"),
    ("d_expected_dur_s", "f32", "D"),
    ("d_over_dur_s", "f32", "D"),
    ("g_expected_dur_s", "f32", "G"),
    ("g_over_dur_s", "f32", "G"),
    ("cap_x", "f32", "D"),
    ("aff_pool", "f32", "UP"),
)


def with_output_dims(dims: Dict) -> Dict:
    """Resolve the derived output dims OUTPUT_SPEC references: "UP" is
    the flattened [U, P_BUCKET] affinity block."""
    out = dict(dims)
    out["UP"] = int(dims["U"]) * P_BUCKET
    return out


@torch.inference_mode()
def _packed_solve(bufs: Dict, layout_key, cap_iters: int, device) -> torch.Tensor:
    """One fused i32 result buffer on ``device``: the i32 outputs, then
    the f32 outputs bit-viewed as i32, in OUTPUT_SPEC order."""
    a = unpack(bufs, layout_key, device)
    out = solve(a, cap_iters)
    parts = [out[name].to(torch.int32) for name, kind, _ in OUTPUT_SPEC if kind == "i32"]
    parts += [
        out[name].to(_F32).contiguous().view(torch.int32)
        for name, kind, _ in OUTPUT_SPEC
        if kind == "f32"
    ]
    return torch.cat(parts)


@torch.inference_mode()
def dispatch_stacked_solve(staging: Dict, layout_key, cap_iters: int,
                           device) -> torch.Tensor:
    """Enqueue the solves of S blocks of one layout and return their
    [S, n_out] fused result buffers on ``device`` without waiting.

    ``staging`` maps each kind to an [S, n_kind] numpy buffer whose row s
    is block s's typed region buffer; each goes up in one host→device
    copy. Every row's ``solve(a, cap_iters)`` is then enqueued back to
    back, with no host sync in between, and the rows' results stacked.
    ``cap_iters`` is the same for every block: the one-card form of the
    JAX package's stacked ``shard_map`` program, which has no
    collectives."""
    dev = torch.device(device)
    tens = {
        kind: torch.as_tensor(np.ascontiguousarray(buf)).to(dev)
        for kind, buf in staging.items()
    }
    n_blocks = next(iter(tens.values())).shape[0]
    return torch.stack([
        _packed_solve({k: t[s] for k, t in tens.items()}, layout_key,
                      cap_iters, dev)
        for s in range(n_blocks)
    ])


def split_packed(buf_np: np.ndarray, dims: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """Split the fused result buffer into (i32 half, f32 half)."""
    i32_total = sum(dims[dim] for _, kind, dim in OUTPUT_SPEC if kind == "i32")
    return buf_np[:i32_total], buf_np[i32_total:].view(np.float32)


def dispatch_solve_packed(snapshot, device=None) -> torch.Tensor:
    """Enqueue one solve (three H2D copies and the device work) and
    return the result buffer on the device without waiting for it. Pair
    with ``fetch_solve_packed``."""
    return _packed_solve(
        snapshot.arena.buffers, snapshot.arena.layout_key(),
        capacity_iters(snapshot), resolve_device(device),
    )


def fetch_solve_packed(buf: torch.Tensor, snapshot) -> Dict[str, np.ndarray]:
    """Block on an in-flight result buffer and split it into named numpy
    outputs."""
    return split_outputs(result_to_host(buf), snapshot.shape_key())


def result_to_host(buf: torch.Tensor) -> np.ndarray:
    """The result buffer on the host, in one D2H copy — into pinned
    memory from the card, which copies several times faster than into
    pageable memory."""
    if buf.device.type == "cuda":
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(buf.device).synchronize()
        buf = host
    return buf.numpy()


def split_outputs(buf_np: np.ndarray, shape_key) -> Dict[str, np.ndarray]:
    """A result buffer as named numpy views, for snapshot dims
    ``shape_key`` = (N, M, U, G, H, D, P, C)."""
    N, _, U, G, _, D = shape_key[:6]
    dims = with_output_dims({"N": N, "U": U, "G": G, "D": D})
    halves = dict(zip(("i32", "f32"), split_packed(buf_np, dims)))
    out: Dict[str, np.ndarray] = {}
    offs = {"i32": 0, "f32": 0}
    for name, kind, dim in OUTPUT_SPEC:
        size = dims[dim]
        out[name] = halves[kind][offs[kind] : offs[kind] + size]
        offs[kind] += size
    return out


def run_solve_packed(snapshot, device=None) -> Dict[str, np.ndarray]:
    """One solve: three arena buffers up, one packed result down. On the
    card it synchronises before the fetch, so a span around this call
    owns the device time. ``device=None`` is the CUDA card (and raises
    without one); pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    buf = dispatch_solve_packed(snapshot, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return fetch_solve_packed(buf, snapshot)
