"""Capacity plane driver: the tick-side consumer of ops/capacity.py.

A copy of ``evergreen_tpu/scheduler/capacity_plane.py``. The tick hands
this plane its per-distro aggregates (the queue-info views and heuristic
spawn counts it already computed) and gets back the spawn counts with
every capacity-opted distro's count replaced by the joint program's
answer.

FUSED mode (the default on packed-solve ticks): the capacity program
runs INSIDE the one packed planning solve (ops/solve.py
``capacity_affinity``) — the tick ships the plane's config as packed
``p_price``/``p_quota``/``c_cfg`` columns (``build_capacity_page``) and
hands back the solve's ``cap_x`` relaxation plus the task-group→pool
affinity block (``extract_fused_view``). This plane then slices the
precomputed fractional answer and runs only the host-side rounding +
feasibility repair (``solve_capacity_from_x``) — zero extra device
calls per tick (``scheduler_capacity_solves_total`` stays flat;
``scheduler_fused_solves_total{mode="fused"}`` counts).

Fallback ladder, each rung per tick:

    fused       cap_x sliced from the packed solve; one device call total
    two_call    the separate ``run_capacity_solve`` device program — on
                solve ticks it runs the SAME full-row instance at the
                SAME padded D, and shares the fused block's relaxation
                code, so its targets and rounded allocations are
                identical to fused
    heuristic   the per-distro utilization counts, returned untouched

The plane still owns:

  * eligibility — a distro joins the joint solve only when it opted in
    (``planner_settings.capacity == "tpu"``), is ephemeral, is not
    disabled, is not a single-task distro (those allocate 1:1 with
    dependency-met tasks, reference units/host_allocator.go:174-181 —
    the bypass keeps identical semantics under either allocator), and
    has ``maximum_hosts > 0`` (the heuristic's at-max early return
    treats 0 as "never allocate"); the device mirrors this predicate
    over the packed settings columns;
  * the circuit breakers — a raising or infeasible solve falls this
    tick down the ladder (fused failures have their own breaker so a
    broken fused program degrades to two-call, not to the heuristic),
    and repeated failures open the breaker so later ticks skip the
    failing rung entirely (the PR-1 shape, same knobs);
  * kernel faults — a kernel that fails to build or launch
    (``KernelError``) is no capacity failure and raises out of the tick;
  * provenance — every applied solve leaves a ``CapacityProvenance`` on
    the store (``scheduler/provenance.py``) so "why did distro X get k
    hosts" is answerable after the tick.

Sharding: a shard's plane solves its own distros; the caller passes the
shard's slice of the fleet-level coupling as ``intent_budget`` (an
absolute budget) and ``quota_scale`` (the 1/n_shards quota share), so
the fleet-wide caps hold exactly even though the solve is per-shard.
"""
from __future__ import annotations

import time as _time
import weakref
from typing import Dict, List, Optional

import numpy as np

from ..cloud.manager import default_pool_prices
from ..globals import ALIAS_SUFFIX, MAX_INTENT_HOSTS_IN_FLIGHT
from ..models.distro import Distro
from ..ops import capacity as cap_ops
from ..ops._build import KernelError
from ..settings import CapacityConfig
from ..storage.store import Store
from ..utils import faults
from ..utils import lockcheck as _lockcheck
from ..utils import metrics as _metrics
from ..utils.circuit import CircuitBreaker
from ..utils.log import get_logger
from .provenance import CapacityProvenance

CAPACITY_SOLVES = _metrics.counter(
    "scheduler_capacity_solves_total",
    "Capacity-plane joint solves by outcome: 'applied' (solver targets "
    "adopted), 'matched' (solver chose the heuristic allocation), "
    "'skipped' (no eligible distros / disabled).",
    labels=("outcome",),
)
CAPACITY_FALLBACKS = _metrics.counter(
    "scheduler_capacity_fallbacks_total",
    "Ticks where the capacity plane fell back to the per-distro "
    "utilization heuristic, by cause (breaker_open / solve_failed / "
    "infeasible / degraded_tick).",
    labels=("cause",),
)
CAPACITY_SOLVE_MS = _metrics.histogram(
    "scheduler_capacity_solve_duration_ms",
    "Wall time of the joint capacity solve (input build through "
    "rounded, feasibility-checked targets).",
)
CAPACITY_INTENTS = _metrics.counter(
    "scheduler_capacity_intents_total",
    "New-host intents requested by the capacity plane, labeled by "
    "provider pool.",
    labels=("pool",),
)
FUSED_SOLVES = _metrics.counter(
    "scheduler_fused_solves_total",
    "Capacity ticks by the fallback-ladder rung that served them: "
    "'fused' (targets sliced from the packed solve — zero extra device "
    "calls), 'two_call' (the classic separate capacity device call), "
    "'heuristic' (per-distro utilization counts).",
    labels=("mode",),
)

#: breaker knobs mirror the solve breaker (scheduler/wrapper.py)
CAPACITY_BREAKER_THRESHOLD = 3
CAPACITY_BREAKER_COOLDOWN_S = 60.0


class CapacityPlane:
    """Per-store capacity solver wrapper (see module docstring)."""

    def __init__(self, store: Store) -> None:
        self._store_ref = weakref.ref(store)  # weak, as the TickCache's
        self.breaker = CircuitBreaker(
            "scheduler.capacity",
            failure_threshold=CAPACITY_BREAKER_THRESHOLD,
            cooldown_s=CAPACITY_BREAKER_COOLDOWN_S,
        )
        # a broken fused program must degrade to two-call, not to the
        # heuristic — its failures get their own breaker so the main
        # one keeps meaning "the capacity program itself is failing"
        self.fused_breaker = CircuitBreaker(
            "scheduler.capacity_fused",
            failure_threshold=CAPACITY_BREAKER_THRESHOLD,
            cooldown_s=CAPACITY_BREAKER_COOLDOWN_S,
        )

    @property
    def store(self) -> Store:
        return self._store_ref()

    # -- eligibility --------------------------------------------------------- #

    @staticmethod
    def eligible(d: Distro, packed_cols=None) -> bool:
        # the opt-in bit prefers the packed d_cap_on column when this
        # tick's solve shipped one (the capacity inputs ride the arena
        # buffer); serial/cmp ticks re-derive from the distro object
        if packed_cols is not None and d.id in packed_cols:
            opted = packed_cols[d.id][1]
        else:
            opted = d.planner_settings.capacity == "tpu"
        return (
            opted
            and not d.id.endswith(ALIAS_SUFFIX)
            and d.is_ephemeral()
            and not d.disabled
            and not getattr(d, "single_task_distro", False)
            and d.host_allocator_settings.maximum_hosts > 0
        )

    # -- the tick hook ------------------------------------------------------- #

    def apply(
        self,
        distros: List[Distro],
        infos: Dict[str, object],
        new_hosts: Dict[str, int],
        hosts_by_distro: Dict[str, List],
        now: float,
        degraded: bool = False,
        quota_scale: float = 1.0,
        intent_budget: Optional[int] = None,
        packed_cols: Optional[Dict[str, tuple]] = None,
        fused: Optional[Dict] = None,
        device=None,
    ) -> Dict[str, int]:
        """Replace eligible distros' heuristic spawn counts with the
        joint solve's; any failure but a ``KernelError`` (a kernel that
        fails to build or launch, which raises) returns ``new_hosts``
        untouched (the bit-identical heuristic fallback the breaker gate
        pins) and marks the last provenance stale.

        ``packed_cols`` is the solve tick's distro id → (d_pool,
        d_cap_on) read off the packed buffer (scheduler/wrapper.py);
        absent on serial/cmp ticks, where the plane re-derives both
        from the distro objects.

        ``fused`` is ``extract_fused_view``'s capture of the packed
        solve's capacity outputs + input columns; when present and
        healthy the tick is served from it with NO extra device call,
        and even the two-call rung runs the same full-row instance at
        the same padded D so the fallback stays bit-identical.

        ``device`` is where the two-call rung's program runs
        (``run_capacity_solve``: the card when None)."""
        def mark_stale() -> None:
            # the decomposition stays readable, flagged as no longer
            # maintained
            prev = getattr(self.store, "_last_capacity", None)
            if prev is not None:
                prev.stale = True

        def fallback(cause: str) -> Dict[str, int]:
            CAPACITY_FALLBACKS.inc(cause=cause)
            FUSED_SOLVES.inc(mode="heuristic")
            mark_stale()
            return new_hosts

        cfg = CapacityConfig.get(self.store)
        if not cfg.enabled:
            # the master switch flipped off: old targets go stale
            # immediately, same as a solver fallback
            CAPACITY_SOLVES.inc(outcome="skipped")
            mark_stale()
            return new_hosts
        elig_distros = [
            d for d in distros
            if self.eligible(d, packed_cols)
            and d.id in new_hosts and d.id in infos
        ]
        if not elig_distros:
            CAPACITY_SOLVES.inc(outcome="skipped")
            mark_stale()
            return new_hosts
        if degraded:
            # the planning solve already fell back to the serial oracle
            # this tick; the capacity program's inputs would be stale —
            # the heuristic counts stand
            return fallback("degraded_tick")
        if not self.breaker.allow(now=now):
            return fallback("breaker_open")

        t0 = _time.perf_counter()
        # On a mixed fleet the NON-capacity distros draw from the same
        # tick intent budget in the wrapper's creation loop: reserve
        # their heuristic wants up front so solver wants + reserved
        # wants ≤ budget and the first-come-first-served loop never
        # clamps (and so never mangles the computed trade). If the
        # reserved wants alone exhaust the budget, the solver correctly
        # gets (almost) nothing.
        solve_budget = intent_budget
        if solve_budget is not None:
            elig_ids = {d.id for d in elig_distros}
            reserved = sum(
                max(0, int(n)) for did, n in new_hosts.items()
                if did not in elig_ids
            )
            solve_budget = max(0, int(solve_budget) - reserved)
        mode = "two_call"
        try:
            # the whole-plane fault seam: an armed "capacity.solve"
            # fails the solve step no matter which rung would have
            # served it (the heuristic fallback the breaker tests pin);
            # "capacity.fused" below sabotages ONLY the fused rung
            faults.fire("capacity.solve")
            targets = x = chosen = inp = None
            if (
                fused is not None
                and cfg.fused == "auto"
                and self.fused_breaker.allow(now=now)
            ):
                # -- fused rung: slice the packed solve's answer ------------ #
                try:
                    faults.fire("capacity.fused")
                    inp = build_fused_inputs(fused)
                    for i, did in enumerate(inp.distro_ids):
                        if inp.elig[i] and (
                            did not in new_hosts or did not in infos
                        ):
                            # a packed-eligible row the tick cannot
                            # adopt (distro vanished mid-tick): the
                            # device's joint trade is unredeemable
                            raise ValueError(
                                f"fused row {did!r} absent from tick outputs"
                            )
                    targets, x, chosen = cap_ops.solve_capacity_from_x(
                        inp, fused["cap_x"]
                    )
                    if cap_ops.check_feasible(targets, inp):
                        raise ValueError("infeasible fused targets")
                    mode = "fused"
                except KernelError:
                    raise
                except Exception as exc:  # noqa: BLE001 — fused failures
                    # degrade one rung (to two-call), never straight to
                    # the heuristic
                    self.fused_breaker.record_failure(
                        now=now, error=repr(exc)
                    )
                    get_logger("resilience").warning(
                        "capacity-fused-failed", error=repr(exc)[-300:]
                    )
                    targets = inp = None
            if targets is None:
                # -- two-call rung: the classic separate device call -------- #
                if fused is not None:
                    # same full-row instance, same padded D as fused ⇒
                    # identical integral targets and rounded
                    # allocations — the capacity-parity gate pins it
                    inp = build_fused_inputs(fused)
                    targets, x, chosen = cap_ops.solve_capacity(
                        inp, d_pad=fused["d_pad"], device=device
                    )
                else:
                    inp = self.build_inputs(
                        elig_distros, infos, new_hosts, hosts_by_distro,
                        cfg, quota_scale=quota_scale,
                        intent_budget=solve_budget,
                        packed_cols=packed_cols,
                    )
                    targets, x, chosen = cap_ops.solve_capacity(
                        inp, device=device
                    )
                problems = cap_ops.check_feasible(targets, inp)
                if problems:
                    raise ValueError(
                        "infeasible capacity targets: "
                        + "; ".join(problems[:3])
                    )
            # adoption stays INSIDE the guard: a raise in the
            # provenance decomposition or the intent loop must degrade
            # to the heuristic like any other capacity failure, never
            # abort the tick (the wrapper calls apply() unguarded)
            out = dict(new_hosts)
            prov = CapacityProvenance.build(inp, targets, x, chosen, now)
            if mode == "fused":
                rounded = cap_ops.round_affinity(
                    fused["aff_pool"], fused["unit_counts"]
                )
                pool_tasks = rounded.sum(axis=0)
                prov.affinity = {
                    "units": int((fused["unit_counts"] > 0).sum()),
                    "pools": {
                        cap_ops.pool_name_of(p): int(pool_tasks[p])
                        for p in range(cap_ops.P_BUCKET)
                        if pool_tasks[p] > 0
                    },
                }
            for i, did in enumerate(inp.distro_ids):
                if not bool(inp.elig[i]) or did not in new_hosts:
                    # full-row fused instances carry pass-through rows
                    # (and, on the two-call rung, possibly rows the
                    # tick can no longer adopt)
                    continue
                intents = int(max(0, targets[i] - inp.existing[i]))
                out[did] = intents
                if intents:
                    CAPACITY_INTENTS.inc(
                        intents,
                        pool=cap_ops.pool_name_of(int(inp.pool[i])),
                    )
        except KernelError:
            # a kernel that fails to build or launch is a fault of the
            # card, not a capacity failure: it raises out of the tick
            raise
        except Exception as exc:  # noqa: BLE001 — ANY other capacity
            # failure degrades to the heuristic; it must never touch the
            # tick
            self.breaker.record_failure(now=now, error=repr(exc))
            cause = (
                "infeasible"
                if isinstance(exc, ValueError)
                and "infeasible" in str(exc) else "solve_failed"
            )
            get_logger("resilience").error(
                "capacity-solve-failed",
                cause=cause,
                error=repr(exc)[-300:],
            )
            return fallback(cause)
        self.breaker.record_success(now=now)
        CAPACITY_SOLVE_MS.observe((_time.perf_counter() - t0) * 1e3)
        if mode == "fused":
            # the acceptance signal that fused saved the device call:
            # scheduler_capacity_solves_total stays FLAT on fused ticks
            self.fused_breaker.record_success(now=now)
        else:
            CAPACITY_SOLVES.inc(
                outcome="applied" if chosen == "solver" else "matched"
            )
        FUSED_SOLVES.inc(mode=mode)
        self.store._last_capacity = prov
        return out

    # -- input construction -------------------------------------------------- #

    def build_inputs(
        self,
        elig_distros: List[Distro],
        infos: Dict[str, object],
        new_hosts: Dict[str, int],
        hosts_by_distro: Dict[str, List],
        cfg,
        quota_scale: float = 1.0,
        intent_budget: Optional[int] = None,
        packed_cols: Optional[Dict[str, tuple]] = None,
    ):
        """Problem instance from the tick's existing aggregates — the
        info views (device outputs on solve ticks, dataclasses on
        serial ones) expose the same three aggregate fields, so the
        capacity program sees identical numbers either way. Pool
        indices come off the packed d_pool column when the solve
        shipped one."""
        n = len(elig_distros)
        demand_s = np.zeros(n)
        thresh_s = np.zeros(n)
        existing = np.zeros(n)
        free = np.zeros(n)
        min_h = np.zeros(n)
        max_h = np.zeros(n)
        deps_met = np.zeros(n)
        pool = np.zeros(n, np.int32)
        heur = np.zeros(n)
        for i, d in enumerate(elig_distros):
            info = infos[d.id]
            hosts = hosts_by_distro.get(d.id, [])
            demand_s[i] = float(info.expected_duration_s)
            thresh_s[i] = d.planner_settings.max_duration_per_host_s()
            existing[i] = len(hosts)
            free[i] = sum(1 for h in hosts if h.is_free())
            min_h[i] = d.host_allocator_settings.minimum_hosts
            max_h[i] = d.host_allocator_settings.maximum_hosts
            deps_met[i] = int(info.length_with_dependencies_met)
            pool[i] = (
                packed_cols[d.id][0]
                if packed_cols is not None and d.id in packed_cols
                else cap_ops.pool_index_of(d.provider)
            )
            heur[i] = int(new_hosts.get(d.id, 0))

        price, quota, split = self._pool_vectors(cfg, quota_scale)
        budget = (
            cfg.fleet_intent_budget
            if cfg.fleet_intent_budget > 0 else MAX_INTENT_HOSTS_IN_FLIGHT
        )
        budget = split(float(budget))
        if intent_budget is not None:
            budget = min(budget, float(max(0, int(intent_budget))))
        return cap_ops.CapacityInputs(
            distro_ids=[d.id for d in elig_distros],
            demand_s=demand_s,
            thresh_s=thresh_s,
            existing=existing,
            free=free,
            min_hosts=min_h,
            max_hosts=max_h,
            deps_met=deps_met,
            pool=pool,
            elig=np.ones(n, bool),
            heuristic_new=heur,
            price=price,
            quota=quota,
            fleet_budget=budget,
            w_price=cfg.price_weight,
            w_churn=cfg.preemption_cost,
            iterations=cfg.iterations,
        )

    def _pool_vectors(self, cfg, quota_scale: float):
        """price[P], per-shard-split quota[P], and the split function —
        shared by the classic instance builder and the fused capacity
        page so both paths see identical pool economics."""
        price = np.zeros(cap_ops.P_BUCKET)
        quota = np.zeros(cap_ops.P_BUCKET)
        prices = dict(cfg.pool_prices or {})
        quotas = dict(cfg.pool_quotas or {})
        if not prices:
            prices = default_pool_prices()
        # EXACT per-shard split: quota_scale = 1/n_shards; shard k gets
        # q//n + (1 if k < q%n) so the shares sum to the configured
        # quota precisely — a max(1, …) floor would let an N-shard
        # plane exceed a small quota by up to N. A zero share must
        # still mean "configured and closed", not 0 = unlimited: the
        # 0.5 sentinel is positive (the convention survives) but below
        # one host, so the integral repair admits nothing above the
        # hard-minimum mass on this shard.
        n_shards = max(1, round(1.0 / quota_scale)) if (
            0 < quota_scale < 1.0
        ) else 1
        shard_k = getattr(self.store, "shard_id", None) or 0
        shard_k = shard_k % n_shards

        def split(total: float) -> float:
            whole = int(total)
            share = whole // n_shards + (
                1 if shard_k < whole % n_shards else 0
            )
            return float(share) if share > 0 else 0.5

        for name, value in prices.items():
            price[cap_ops.pool_index_of(name)] = float(value)
        for name, value in quotas.items():
            q = float(value)
            quota[cap_ops.pool_index_of(name)] = split(q) if q > 0 else 0.0
        return price, quota, split

    # -- fused-solve capacity page ------------------------------------------- #

    def build_capacity_page(
        self,
        quota_scale: float = 1.0,
        intent_budget: Optional[int] = None,
    ) -> Optional[Dict[str, np.ndarray]]:
        """The fused solve's packed capacity config: the pool
        price/quota vectors plus the ``c_cfg`` scalar page
        (ops/capacity.py ``C_*`` slots) that ride the snapshot arena
        into ``capacity_affinity``. None when the plane is off or
        pinned to the classic two-call pipeline (``cfg.fused ==
        "never"``) — the wrapper then packs zeros and the device
        capacity block is a shape-preserving no-op."""
        cfg = CapacityConfig.get(self.store)
        if not cfg.enabled or cfg.fused == "never":
            return None
        price, quota, split = self._pool_vectors(cfg, quota_scale)
        budget = (
            cfg.fleet_intent_budget
            if cfg.fleet_intent_budget > 0 else MAX_INTENT_HOSTS_IN_FLIGHT
        )
        c = np.zeros(cap_ops.C_BUCKET, np.float32)
        c[cap_ops.C_VALID] = 1.0
        # −1 encodes "no tick allowance" (``intent_budget`` is None):
        # the device then uses the split budget alone, exactly
        # like build_inputs' min() with an absent intent_budget
        c[cap_ops.C_BUDGET_BASE] = (
            float(max(0, int(intent_budget)))
            if intent_budget is not None else -1.0
        )
        c[cap_ops.C_SPLIT_BUDGET] = split(float(budget))
        c[cap_ops.C_W_PRICE] = cfg.price_weight
        c[cap_ops.C_W_CHURN] = cfg.preemption_cost
        c[cap_ops.C_AFF_T0] = cfg.affinity_temperature
        c[cap_ops.C_AFF_ANNEAL] = cfg.affinity_anneal
        c[cap_ops.C_ITERS] = float(max(1, min(int(cfg.iterations), 512)))
        return {
            "p_price": price.astype(np.float32),
            "p_quota": quota.astype(np.float32),
            "c_cfg": c,
        }


# --------------------------------------------------------------------------- #
# Fused-view capture + full-row instance
# --------------------------------------------------------------------------- #


def extract_fused_view(snapshot, out) -> Optional[Dict]:
    """Capture everything the fused consumer needs from the packed
    solve, COPIED out while the arena views are still alive (the
    wrapper closes the arena right after unpack): the device's
    ``cap_x`` relaxation + affinity block, the raw allocator outputs
    (pre alias-deletion / single-task override — the device saw these),
    and the packed input columns the full-row instance mirrors. Returns
    None when no capacity page rode this solve."""
    a = snapshot.arrays
    if "cap_x" not in out or "c_cfg" not in a:
        return None
    page_c = np.asarray(a["c_cfg"], np.float32)
    if (
        page_c.shape[0] <= cap_ops.C_ITERS
        or float(page_c[cap_ops.C_VALID]) <= 0.0
    ):
        return None
    D = int(np.asarray(a["d_valid"]).shape[0])
    U = int(np.asarray(a["u_distro"]).shape[0])
    h_valid = np.asarray(a["h_valid"], bool)
    h_free = np.asarray(a["h_free"], bool)
    h_distro = np.asarray(a["h_distro"], np.int64)
    m_valid = np.asarray(a["m_valid"], bool)
    m_unit = np.asarray(a["m_unit"], np.int64)
    # integer-exact mirrors of the device's segment sums
    existing = np.bincount(h_distro[h_valid], minlength=D)[:D]
    free = np.bincount(
        h_distro[h_valid & h_free], minlength=D
    )[:D]
    unit_counts = np.bincount(m_unit[m_valid], minlength=U)[:U]
    return {
        "distro_ids": list(snapshot.distro_ids),
        "d_pad": D,
        "cap_x": np.asarray(out["cap_x"], np.float64).copy(),
        "aff_pool": np.asarray(out["aff_pool"], np.float64).reshape(
            U, cap_ops.P_BUCKET
        ).copy(),
        "unit_counts": unit_counts.astype(np.int64),
        # raw allocator outputs, padded [D]
        "required": np.asarray(out["d_new_hosts"], np.float64).copy(),
        "deps_met": np.asarray(out["d_deps_met"], np.float64).copy(),
        "demand_s": np.asarray(out["d_expected_dur_s"], np.float64).copy(),
        # packed input columns, padded [D]
        "valid": np.asarray(a["d_valid"], bool).copy(),
        "cap_on": np.asarray(a["d_cap_on"], bool).copy(),
        "alias": np.asarray(a["d_alias"], bool).copy(),
        "single": np.asarray(a["d_single_task"], bool).copy(),
        "ephemeral": np.asarray(a["d_ephemeral"], bool).copy(),
        "disabled": np.asarray(a["d_disabled"], bool).copy(),
        "min_hosts": np.asarray(a["d_min_hosts"], np.float64).copy(),
        "max_hosts": np.asarray(a["d_max_hosts"], np.float64).copy(),
        # the f32 threshold column — the host instance MUST consume the
        # f32 value the device divided by, or demand_u diverges
        "thresh_s": np.asarray(a["d_thresh_s"], np.float64).copy(),
        "pool": np.asarray(a["d_pool"], np.int32).copy(),
        "existing": existing.astype(np.float64),
        "free": free.astype(np.float64),
        "p_price": np.asarray(a["p_price"], np.float64).copy(),
        "p_quota": np.asarray(a["p_quota"], np.float64).copy(),
        "c_cfg": page_c.copy(),
    }


def build_fused_inputs(fused: Dict):
    """The full-row CapacityInputs mirroring EXACTLY what the device
    capacity block computed from the packed columns — every operand
    comes from the fused view (the packed page, never the live config),
    so fused and two-call consume bit-identical instances (the parity
    gate verifies a single Newton step matches bit for bit). Rows
    beyond the real distro count are zero either way
    (run_capacity_solve pads with zeros at ``d_pad``; the device's
    padding rows have zero columns)."""
    n = len(fused["distro_ids"])
    sl = slice(0, n)
    valid = fused["valid"][sl]
    maxh = fused["max_hosts"][sl]
    elig = (
        valid
        & fused["cap_on"][sl]
        & ~fused["alias"][sl]
        & ~fused["single"][sl]
        & fused["ephemeral"][sl]
        & ~fused["disabled"][sl]
        & (maxh > 0)
    )
    existing = fused["existing"][sl]
    deps = fused["deps_met"][sl]
    required = fused["required"][sl]
    c = fused["c_cfg"]
    # the device's budget arithmetic, replayed in f64 over the same
    # integer-valued f32 operands (exact): reserve the non-eligible
    # rows' wants off the tick allowance, cap at the shard split
    bypass = np.maximum(
        0.0,
        np.minimum(deps, np.where(maxh > 0, maxh, deps) - existing),
    )
    want = np.where(fused["single"][sl], bypass, required)
    reserved = float(
        np.where(valid & ~fused["alias"][sl] & ~elig,
                 np.maximum(want, 0.0), 0.0).sum()
    )
    base = float(c[cap_ops.C_BUDGET_BASE])
    split = float(c[cap_ops.C_SPLIT_BUDGET])
    budget = (
        min(split, max(np.float32(base) - np.float32(reserved), 0.0))
        if base >= 0 else split
    )
    return cap_ops.CapacityInputs(
        distro_ids=list(fused["distro_ids"]),
        demand_s=fused["demand_s"][sl],
        thresh_s=fused["thresh_s"][sl],
        existing=existing,
        free=fused["free"][sl],
        min_hosts=fused["min_hosts"][sl],
        max_hosts=maxh,
        deps_met=deps,
        pool=fused["pool"][sl],
        elig=elig,
        heuristic_new=required,
        price=fused["p_price"],
        quota=fused["p_quota"],
        fleet_budget=float(budget),
        w_price=float(c[cap_ops.C_W_PRICE]),
        w_churn=float(c[cap_ops.C_W_CHURN]),
        iterations=int(c[cap_ops.C_ITERS]),
    )


#: per-store planes (keyed weakly, like the solve breakers)
_planes: "weakref.WeakKeyDictionary[Store, CapacityPlane]" = weakref.WeakKeyDictionary()
_planes_lock = _lockcheck.make_lock("scheduler.capacity_planes")


def capacity_plane_for(store: Store) -> CapacityPlane:
    with _planes_lock:
        plane = _planes.get(store)
        if plane is None:
            plane = _planes[store] = CapacityPlane(store)
        return plane
