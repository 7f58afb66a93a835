"""The global capacity program — one batched device solve for host counts.

Counterpart of ``evergreen_tpu/ops/capacity.py``: the pool vocabulary, the
``c_cfg`` page slots, the problem instance ``CapacityInputs``, the
damped-Newton relaxation on tensors, and the host-side rounding and
feasibility repair. The relaxation runs in two programs that share its
code (``effective_caps``, ``relax``): inside the packed solve
(``ops/solve.py::capacity_affinity``, the fused rung) and on its own in
``run_capacity_solve`` (the two-call rung). Both sum per pool with the
``segment_sum`` pool plan, so at the same padded D they give the same
bits on one device.

Decision ``x[d]`` = total hosts distro ``d`` should hold. The objective is
queue drain (demand_u / x) + pool price + churn, subject to min/max
hosts, per-pool quotas and a fleet intent budget; each Newton step is
followed by a projection (box clamp, per-pool scale-down, budget
scale-down).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..globals import Provider
from .segment import segment_plan, segment_sum

#: pools ARE providers, in enum declaration order; index P_BUCKET-1 is
#: the "other" pool for unknown provider strings
POOL_NAMES: Tuple[str, ...] = tuple(p.value for p in Provider)
P_BUCKET = 8
_POOL_INDEX: Dict[str, int] = {name: i for i, name in enumerate(POOL_NAMES)}
assert len(POOL_NAMES) < P_BUCKET


def pool_index_of(provider: str) -> int:
    """Deterministic provider → pool index (unknown → the 'other' slot)."""
    return _POOL_INDEX.get(provider, P_BUCKET - 1)


def pool_name_of(index: int) -> str:
    return POOL_NAMES[index] if 0 <= index < len(POOL_NAMES) else "other"


#: a "no limit" stand-in that survives f32 arithmetic without inf-minus-inf
_BIG = 1.0e7

#: the ``c_cfg`` arena column: a C_BUCKET-wide f32 page of the capacity
#: program's scalars; slot indices are part of the sidecar wire format
C_BUCKET = 8
C_VALID = 0          # > 0 ⇔ a capacity page rode this solve
C_BUDGET_BASE = 1    # intent allowance BEFORE reserving non-eligible rows
C_SPLIT_BUDGET = 2   # this shard's split of the fleet intent budget
C_W_PRICE = 3
C_W_CHURN = 4
C_AFF_T0 = 5         # affinity softmax temperature (annealed)
C_AFF_ANNEAL = 6     # per-iteration temperature decay factor
C_ITERS = 7          # damped-Newton iteration count


@dataclasses.dataclass
class CapacityInputs:
    """The capacity program's problem instance, real-sized (unpadded)
    numpy columns aligned with ``distro_ids``. Built by the capacity
    plane from the tick's existing aggregates (QueueInfoView /
    DistroQueueInfo + host counts) — no store reads of its own."""

    distro_ids: List[str]
    #: dependency-met expected work, seconds (d_expected_dur_s)
    demand_s: np.ndarray
    #: per-distro target time (max_duration_per_host_s)
    thresh_s: np.ndarray
    existing: np.ndarray  # active hosts
    free: np.ndarray      # free hosts (is_free)
    min_hosts: np.ndarray
    max_hosts: np.ndarray  # 0 = no allocation (heuristic semantics)
    #: dependency-met task count — new hosts never exceed deps_met − free
    deps_met: np.ndarray
    pool: np.ndarray      # int32 pool index per distro
    elig: np.ndarray      # bool: row participates in the joint solve
    #: heuristic new-host counts (warm start + the fallback allocation)
    heuristic_new: np.ndarray
    #: pool price vector [P_BUCKET] (relative $/host-hour)
    price: np.ndarray
    #: pool quota vector [P_BUCKET] (0 = unlimited), over ELIGIBLE rows
    quota: np.ndarray
    #: fleet-wide cap on NEW hosts this solve may request
    fleet_budget: float
    #: mild regularizers by default: the drain term (host-rounds) must
    #: dominate — a churn weight that rivals the marginal drain value
    #: (demand_u/x², quadratic in the increment here) pins every distro
    #: near its current fleet and the program degrades to "do nothing"
    #: (the capacity-parity gate's clamped-heuristic comparison catches
    #: it)
    w_price: float = 0.02
    w_churn: float = 0.001
    iterations: int = 48

    @property
    def n(self) -> int:
        return len(self.distro_ids)

    def demand_units(self) -> np.ndarray:
        thresh = np.where(self.thresh_s > 0, self.thresh_s, 1.0)
        return self.demand_s / thresh

    def bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """(lo, hi) in hosts. hi folds the max-hosts cap AND the
        heuristic's demand guard (new ≤ deps_met − free); min hosts are
        hard and win conflicts."""
        lo = np.maximum(self.min_hosts.astype(np.float64), 0.0)
        new_cap = np.maximum(self.deps_met - self.free, 0.0)
        maxh = np.where(self.max_hosts > 0, self.max_hosts, _BIG)
        hi = np.minimum(maxh, self.existing + new_cap)
        return lo, np.maximum(lo, hi)

    def effective_quota(self) -> np.ndarray:
        """Quota floored at the eligible rows' min-hosts mass per pool
        (min hosts are hard); 0 stays 'unlimited'."""
        lo, _ = self.bounds()
        lo_mass = np.zeros(P_BUCKET)
        np.add.at(lo_mass, self.pool[self.elig], lo[self.elig])
        return np.where(self.quota > 0,
                        np.maximum(self.quota, lo_mass), _BIG)

    def effective_budget(self) -> float:
        """The fleet budget floored at the hard min-hosts increments
        (mins win, like the heuristic's min-hosts top-up). When that
        floor exceeds the tick's in-flight intent allowance, the
        wrapper's creation loop still clamps — the same policy
        conflict the classic heuristic's top-up has always had with
        the global cap."""
        lo, _ = self.bounds()
        lo_inc = np.maximum(lo - self.existing, 0.0)
        return max(float(self.fleet_budget), float(lo_inc[self.elig].sum()))


def _capacity_step_fns(
    pool_sum: Callable[[torch.Tensor], torch.Tensor],
) -> Tuple[Callable, Callable]:
    """``(newton, project)`` over a dict ``a`` of [D] columns and scalars.
    ``pool_sum`` reduces [D] columns ([k, D]) to their [P] per-pool sums
    ([k, P])."""

    def project(x, a):
        lo, hi = a["lo"], a["hi"]
        elig, pool = a["elig"], a["pool"]
        existing = a["existing"]
        x = torch.clamp(x, lo, hi)
        # per-pool quota: scale the above-minimum mass of over-quota
        # pools so the pool lands exactly on its (effective) quota
        xm = torch.where(elig, x, 0.0)
        lom = torch.where(elig, lo, 0.0)
        p_sum, lo_sum = pool_sum(torch.stack([xm, lom]))
        over = p_sum > a["quota"]
        f = torch.where(
            over,
            torch.clamp_min(a["quota"] - lo_sum, 0.0)
            / torch.clamp_min(p_sum - lo_sum, 1e-9),
            1.0,
        )
        x = torch.where(elig, lo + (x - lo) * f[pool], x)
        # fleet intent budget: scale the above-minimum part of the
        # increments (never below the hard min-hosts increments)
        inc = torch.clamp_min(x - existing, 0.0)
        inc_min = torch.clamp_min(lo - existing, 0.0)
        tot = torch.where(elig, inc, 0.0).sum()
        tot_min = torch.where(elig, inc_min, 0.0).sum()
        g = torch.where(
            tot > a["budget"],
            torch.clamp_min(a["budget"] - tot_min, 0.0)
            / torch.clamp_min(tot - tot_min, 1e-9),
            1.0,
        )
        scaled = inc_min + (inc - inc_min) * g
        x = torch.where(elig & (x > existing), existing + scaled, x)
        return torch.clamp(x, lo, hi)

    def newton(x, a):
        demand_u, existing = a["demand_u"], a["existing"]
        price_d = a["price"][a["pool"]]
        g = (
            -demand_u / (x * x + 1e-6)
            + a["w_price"] * price_d
            + a["w_churn"] * (x - existing)
        )
        h = 2.0 * demand_u / (x * x * x + 1e-6) + a["w_churn"]
        dx = torch.clamp(g / (h + 1e-3), -8.0, 8.0)
        return x - dx

    return newton, project


def effective_caps(lo, existing, elig, quota, budget, pool_sum):
    """The per-pool quota [P] and fleet budget (0-dim) the projections
    hold the relaxation to. Minimum hosts are hard, so each pool's quota
    is floored at its eligible rows' min-hosts mass (a quota of 0 stays
    unlimited) and the budget at their min-hosts increments."""
    lo_mass = pool_sum(torch.where(elig, lo, 0.0))
    quota = torch.where(quota > 0, torch.maximum(quota, lo_mass), _BIG)
    lo_inc = torch.clamp_min(lo - existing, 0.0)
    budget = torch.maximum(budget, torch.where(elig, lo_inc, 0.0).sum())
    return quota, budget


def relax(a, pool_sum, iterations: int):
    """The relaxation over the instance ``a`` (the [D] columns and scalars
    ``_capacity_step_fns`` reads, caps from ``effective_caps``): the
    projected warm start, then ``iterations`` damped-Newton + projection
    steps; non-eligible rows report their anchor untouched."""
    newton, project = _capacity_step_fns(pool_sum)
    x = project(torch.clamp(a["anchor"], a["lo"], a["hi"]), a)
    for _ in range(iterations):
        x = project(newton(x, a), a)
    return torch.where(a["elig"], x, a["anchor"])


def _pad_bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


#: the [D] rows of run_capacity_solve's upload, in order
_ROWS = ("demand_u", "existing", "lo", "hi", "anchor", "pool", "elig")


@torch.inference_mode()
def run_capacity_solve(inp: CapacityInputs, d_pad: Optional[int] = None,
                       device=None) -> np.ndarray:
    """The fractional relaxation on the device: returns x[n] (total hosts
    per distro, real-sized). Deterministic for fixed inputs.

    The instance goes up in one f32 host→device copy and x comes back in
    one device→host copy; in between run the effective caps, the
    projected warm start and ``inp.iterations`` Newton + projection steps
    as torch ops, each projection's pool sums one ``segment_sum`` launch
    on the pool plan (2 + iterations launches on the card).

    ``d_pad`` pins the padded row count: run at the fused program's padded
    D, the sums run over the same shapes, so x is bit-identical to the
    packed solve's ``cap_x`` on the same device (padding rows are zeros
    outside the pool plan). ``device=None`` is the CUDA card, and raises
    without one; pass ``device="cpu"`` for the CPU."""
    dev = resolve_device(device)
    n = inp.n
    D = _pad_bucket(max(n, 1)) if d_pad is None else int(d_pad)
    assert D >= n, f"d_pad {D} < instance rows {n}"
    P = P_BUCKET
    lo, hi = inp.bounds()
    host = np.zeros(len(_ROWS) * D + 2 * P + 3, np.float32)
    cols = dict(zip(_ROWS, host[: len(_ROWS) * D].reshape(len(_ROWS), D)))
    cols["demand_u"][:n] = inp.demand_units()
    cols["existing"][:n] = inp.existing
    cols["lo"][:n] = lo
    cols["hi"][:n] = hi
    cols["anchor"][:n] = np.clip(inp.existing + inp.heuristic_new, lo, hi)
    cols["pool"][:] = P - 1
    cols["pool"][:n] = inp.pool
    cols["elig"][:n] = inp.elig
    tail = host[len(_ROWS) * D:]
    tail[:P] = inp.price
    tail[P:2 * P] = inp.quota
    tail[2 * P:] = (inp.fleet_budget, inp.w_price, inp.w_churn)

    buf = torch.from_numpy(host).to(dev)
    t = dict(zip(_ROWS, buf[: len(_ROWS) * D].view(len(_ROWS), D)))
    tail = buf[len(_ROWS) * D:]
    elig = t["elig"] > 0
    pool = t["pool"].long()
    plan = segment_plan(pool, P, elig, name="pool")

    def pool_sum(x):
        return segment_sum(x, plan)

    quota, budget = effective_caps(
        t["lo"], t["existing"], elig, tail[P:2 * P], tail[2 * P], pool_sum
    )
    a = {
        "demand_u": t["demand_u"],
        "existing": t["existing"],
        "lo": t["lo"],
        "hi": t["hi"],
        "anchor": t["anchor"],
        "pool": pool,
        "elig": elig,
        "price": tail[:P],
        "quota": quota,
        "budget": budget,
        "w_price": tail[2 * P + 1],
        "w_churn": tail[2 * P + 2],
    }
    x = relax(a, pool_sum, int(inp.iterations))
    return x.cpu().numpy().astype(np.float64)[:n]


# --------------------------------------------------------------------------- #
# Deterministic rounding + exact feasibility repair (host-side)
# --------------------------------------------------------------------------- #


def _marginal_loss(demand_u: float, t: float) -> float:
    """Drain-time increase from removing one host at target ``t`` —
    the greedy repair removes from the smallest-loss distro first."""
    if t <= 1.0:
        return demand_u * _BIG  # removing the last host is always worst
    return demand_u / (t * (t - 1.0))


def round_allocation(x: np.ndarray, inp: CapacityInputs) -> np.ndarray:
    """Fractional x → integral per-distro host targets satisfying every
    hard constraint exactly: box, per-pool effective quota, fleet
    effective budget. Fully deterministic (largest-remainder add-back,
    index tie-breaks; greedy smallest-marginal-loss repair)."""
    n = inp.n
    lo, hi = inp.bounds()
    lo_i = np.ceil(lo - 1e-6).astype(np.int64)
    hi_i = np.floor(hi + 1e-6).astype(np.int64)
    hi_i = np.maximum(lo_i, hi_i)
    demand_u = inp.demand_units()
    quota = inp.effective_quota()
    budget = inp.effective_budget()

    t = np.clip(np.floor(x + 1e-6).astype(np.int64), lo_i, hi_i)
    # ineligible rows are pass-through: the heuristic allocation stands
    t = np.where(inp.elig, t, (inp.existing + inp.heuristic_new).astype(
        np.int64))

    def pool_use():
        use = np.zeros(P_BUCKET, np.int64)
        np.add.at(use, inp.pool[inp.elig], t[inp.elig])
        return use

    def fleet_inc():
        inc = np.maximum(t - inp.existing.astype(np.int64), 0)
        return int(inc[inp.elig].sum())

    # largest-remainder add-back, bounded by box/quota/budget headroom
    rem = x - np.floor(x + 1e-6)
    order = sorted(
        (i for i in range(n) if inp.elig[i]),
        key=lambda i: (-rem[i], i),
    )
    use = pool_use()
    inc_total = fleet_inc()
    for i in order:
        if t[i] >= hi_i[i]:
            continue
        p = int(inp.pool[i])
        if use[p] + 1 > quota[p]:
            continue
        extra_inc = 1 if t[i] + 1 > inp.existing[i] else 0
        if inc_total + extra_inc > budget:
            continue
        if rem[i] < 0.5 - 1e-9:
            break  # remainders below half never round up
        t[i] += 1
        use[p] += 1
        inc_total += extra_inc

    # exact repair: pools over quota, then the fleet budget — remove the
    # smallest-marginal-loss host each step, never below the hard minimum
    def removable(i):
        return inp.elig[i] and t[i] > lo_i[i]

    use = pool_use()
    for p in range(P_BUCKET):
        while use[p] > quota[p]:
            cands = [
                i for i in range(n) if removable(i) and inp.pool[i] == p
            ]
            if not cands:
                break  # min-hosts mass exceeds quota: mins win
            i = min(
                cands,
                key=lambda j: (_marginal_loss(demand_u[j], float(t[j])), j),
            )
            t[i] -= 1
            use[p] -= 1
    while fleet_inc() > budget:
        cands = [
            i for i in range(n)
            if removable(i) and t[i] > inp.existing[i]
        ]
        if not cands:
            break
        i = min(
            cands,
            key=lambda j: (_marginal_loss(demand_u[j], float(t[j])), j),
        )
        t[i] -= 1
    return t


def check_feasible(targets: np.ndarray, inp: CapacityInputs) -> List[str]:
    """Hard-constraint audit of an integral allocation over the ELIGIBLE
    rows; returns human-readable violations (empty = feasible)."""
    problems: List[str] = []
    lo, hi = inp.bounds()
    lo_i = np.ceil(lo - 1e-6)
    hi_i = np.maximum(lo_i, np.floor(hi + 1e-6))
    for i in range(inp.n):
        if not inp.elig[i]:
            continue
        if targets[i] < lo_i[i] - 1e-9:
            problems.append(
                f"{inp.distro_ids[i]}: {targets[i]} < min {lo_i[i]:.0f}"
            )
        if targets[i] > hi_i[i] + 1e-9:
            problems.append(
                f"{inp.distro_ids[i]}: {targets[i]} > max {hi_i[i]:.0f}"
            )
    quota = inp.effective_quota()
    use = np.zeros(P_BUCKET)
    np.add.at(use, inp.pool[inp.elig], targets[inp.elig])
    for p in range(P_BUCKET):
        if use[p] > quota[p] + 1e-9:
            problems.append(
                f"pool {pool_name_of(p)}: {use[p]:.0f} > quota {quota[p]:.0f}"
            )
    inc = np.maximum(targets - inp.existing, 0.0)
    total_inc = float(inc[inp.elig].sum())
    if total_inc > inp.effective_budget() + 1e-9:
        problems.append(
            f"fleet: {total_inc:.0f} new hosts > budget "
            f"{inp.effective_budget():.0f}"
        )
    return problems


def drain_seconds(
    targets: np.ndarray, inp: CapacityInputs
) -> Tuple[float, float]:
    """(total, worst) time-to-empty over the eligible rows: each
    distro's dependency-met work divided by its allocated hosts — the
    objective the program minimizes and the metric the capacity-parity
    gate compares against the heuristic."""
    total = 0.0
    worst = 0.0
    for i in range(inp.n):
        if not inp.elig[i]:
            continue
        tte = float(inp.demand_s[i]) / max(float(targets[i]), 1.0)
        total += tte
        worst = max(worst, tte)
    return total, worst


def heuristic_allocation(inp: CapacityInputs) -> np.ndarray:
    """The per-distro utilization heuristic's implied targets
    (existing + heuristic new hosts) — the fallback allocation and the
    baseline the parity gate compares against."""
    return (inp.existing + inp.heuristic_new).astype(np.int64)


def solve_capacity_from_x(
    inp: CapacityInputs, x: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Rounding + matches-or-beats guard over a precomputed fractional
    relaxation ``x`` — the host half shared by the two-call pipeline
    (``solve_capacity``) and the fused consumer, which slices x out of
    the packed solve's ``cap_x`` column instead of launching a second
    device call. Returns (targets, x, chosen)."""
    x = np.asarray(x, dtype=np.float64)[: inp.n]
    targets = round_allocation(x, inp)
    heur = heuristic_allocation(inp)
    if check_feasible(targets, inp):
        # the repair pass should make this unreachable; fail safe anyway
        return heur, x, "heuristic"
    heur_problems = check_feasible(heur, inp)
    s_total, s_worst = drain_seconds(targets, inp)
    h_total, h_worst = drain_seconds(heur, inp)
    if heur_problems:
        return targets, x, "solver"
    if s_total <= h_total + 1e-6:
        return targets, x, "solver"
    return heur, x, "heuristic"


def solve_capacity(
    inp: CapacityInputs, d_pad: Optional[int] = None, device=None
) -> Tuple[np.ndarray, np.ndarray, str]:
    """The full two-call pipeline: device relaxation → deterministic
    rounding → matches-or-beats guard. Returns (targets, fractional x,
    chosen) where ``chosen`` is "solver" or "heuristic".

    The guard makes "matches or beats" true by construction: the solver
    allocation is adopted only when it is feasible AND its total drain
    does not regress the heuristic's (or the heuristic itself violates
    a pool/fleet constraint — the coupled caps the per-distro loop is
    blind to — in which case the solver's feasible answer wins).
    ``device`` is ``run_capacity_solve``'s."""
    x = run_capacity_solve(inp, d_pad=d_pad, device=device)
    return solve_capacity_from_x(inp, x)


def round_affinity(aff: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Deterministic largest-remainder rounding of the fused program's
    per-unit pool affinities: ``aff`` [U, P_BUCKET] soft assignment,
    ``counts`` [U] integral task counts per unit → integral [U, P_BUCKET]
    task placements summing exactly to ``counts`` per row. Advisory
    placement hints (trade partners / provenance), so the only hard
    constraint is the row-sum; ties break by pool index."""
    aff = np.asarray(aff, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.int64)
    u = len(counts)
    out = np.zeros((u, P_BUCKET), dtype=np.int64)
    act = counts > 0
    if not act.any():
        return out
    # vectorized over the active rows: a fused tick rounds thousands of
    # units, and a per-row Python loop was the dominant host cost of the
    # whole fused consume (~45ms at 4k units vs <1ms here)
    rows = np.maximum(aff[act, :P_BUCKET], 0.0)
    c = counts[act]
    s = rows.sum(axis=1)
    nosig = s <= 0.0
    want = rows / np.where(nosig, 1.0, s)[:, None] * c[:, None]
    base = np.floor(want + 1e-9).astype(np.int64)
    rem = want - base
    left = c - base.sum(axis=1)
    # largest remainder, ties by pool index: stable sort on -rem keeps
    # equal remainders in pool order, so rank<left picks the same pools
    # the sequential sweep did
    order = np.argsort(-rem, axis=1, kind="stable")
    rank = np.empty_like(order)
    k = order.shape[0]
    rank[np.arange(k)[:, None], order] = np.arange(P_BUCKET)[None, :]
    base += rank < left[:, None]
    base[nosig] = 0
    base[nosig, P_BUCKET - 1] = c[nosig]
    out[act] = base
    return out
