"""Solve decision provenance: why is task X at rank Y, and why did
distro X get k hosts?

A copy of ``evergreen_tpu/scheduler/provenance.py``. ``TickProvenance``
captures, per planned task in queue order, the claimed unit's score
terms the packed solve returns beside ``t_value`` (``t_prio``,
``t_rank``, ``t_tiq``, ``t_stepback``); ``_unpack_solve``
(scheduler/wrapper.py) builds one per solve tick. ``CapacityProvenance``
decomposes each applied capacity solve (scheduler/capacity_plane.py) and
is kept on the store as ``store._last_capacity``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ops import capacity as cap_ops


class TickProvenance:
    """Per-distro solve score terms, aligned with the planned queues.

    ``tasks`` is the tick's globally ordered task list (the same list
    ``_unpack_solve`` slices into plans), ``bounds[i]:bounds[i+1]`` is
    distro ``distro_ids[i]``'s segment, and the term arrays are aligned
    with ``tasks`` — so every accessor is a slice, never a scan.
    """

    __slots__ = (
        "distro_ids", "_bounds", "_tasks",
        "_value", "_prio", "_rank", "_tiq", "_stepback",
    )

    def __init__(
        self,
        distro_ids: List[str],
        bounds: np.ndarray,
        tasks: list,
        value: np.ndarray,
        prio: np.ndarray,
        rank: np.ndarray,
        tiq: np.ndarray,
        stepback: np.ndarray,
    ) -> None:
        self.distro_ids = list(distro_ids)
        self._bounds = bounds
        self._tasks = tasks
        self._value = value
        self._prio = prio
        self._rank = rank
        self._tiq = tiq
        self._stepback = stepback

    # -- accessors ----------------------------------------------------------- #

    def _segment(self, distro_id: str) -> Optional[range]:
        try:
            di = self.distro_ids.index(distro_id)
        except ValueError:
            return None
        return range(int(self._bounds[di]), int(self._bounds[di + 1]))

    def _term_doc(self, i: int, rank_pos: int) -> Dict:
        t = self._tasks[i]
        return {
            "task": t.id,
            "rank": rank_pos,
            # the decomposition of the claimed unit's sort value
            # (serial.py unit_value: value = priority * rank + len)
            "value": round(float(self._value[i]), 4),
            "priority_term": round(float(self._prio[i]), 4),
            "rank_term": round(float(self._rank[i]), 4),
            "time_in_queue_term": round(float(self._tiq[i]), 4),
            "stepback": bool(self._stepback[i]),
            # raw task fields that feed the tie-break sort keys
            "task_priority": int(t.priority),
            "num_dependents": int(t.num_dependents),
            "expected_duration_s": round(float(t.expected_duration_s), 2),
            "in_task_group": bool(t.task_group),
        }

    def to_doc(self, distro_id: str, limit: int = 25) -> Optional[Dict]:
        """Admin-surface payload: the distro's queue head with terms."""
        seg = self._segment(distro_id)
        if seg is None:
            return None
        return {
            "distro": distro_id,
            "queue_length": len(seg),
            "tasks": [
                self._term_doc(i, pos)
                for pos, i in enumerate(seg)
                if pos < max(0, int(limit))
            ],
        }


def build_provenance(snapshot, out: Dict, real: np.ndarray,
                     ordered_tasks: list, vals: np.ndarray,
                     bounds: np.ndarray) -> TickProvenance:
    """Gather the solve's per-task score terms into queue order.
    ``real``/``ordered_tasks``/``vals``/``bounds`` come straight from
    ``_unpack_solve``'s existing work — only the four extra term columns
    are gathered here."""
    def g(name, dtype=float):
        return np.asarray(out[name])[real].astype(dtype, copy=False)

    return TickProvenance(
        snapshot.distro_ids,
        bounds,
        ordered_tasks,
        vals,
        g("t_prio"),
        g("t_rank"),
        g("t_tiq"),
        g("t_stepback", dtype=np.int32),
    )


def provenance_for(store) -> Optional[TickProvenance]:
    """The most recent solve tick's provenance on this store (None
    before the first solve tick, or after a serial/degraded tick that
    produced none — the previous solve tick's answer is kept)."""
    return getattr(store, "_last_provenance", None)


# --------------------------------------------------------------------------- #
# Capacity provenance: why did distro X get k hosts?
# --------------------------------------------------------------------------- #


class CapacityProvenance:
    """Per-distro decomposition of the joint capacity solve
    (ops/capacity.py via scheduler/capacity_plane.py): for every distro
    in the program, the objective terms at its adopted target, which
    constraint bound it, and — when a shared pool quota was binding —
    the trade partners that gained what it gave up (or vice versa).
    Kept as ``store._last_capacity``."""

    __slots__ = ("at", "chosen", "fleet", "stale", "affinity", "_rows")

    def __init__(self, at: float, chosen: str, fleet: Dict,
                 rows: Dict[str, Dict]) -> None:
        self.at = at
        self.chosen = chosen
        self.fleet = fleet
        #: fused solves only: the rounded task-group→pool placement
        #: hints ({"pools": {pool: tasks}, "units": U}) — advisory, so
        #: they live beside the decomposition, never inside it
        self.affinity = None
        #: set by the capacity plane when a later tick FELL BACK to the
        #: heuristic: the decomposition stays readable, flagged as no
        #: longer maintained
        self.stale = False
        self._rows = rows

    @classmethod
    def build(cls, inp, targets, x, chosen: str,
              now: float) -> "CapacityProvenance":
        """Decompose one solve. ``inp`` is the ops.capacity
        CapacityInputs, ``targets`` the adopted integral allocation,
        ``x`` the device relaxation's fractional answer."""
        lo, hi = inp.bounds()
        quota = inp.effective_quota()
        budget = inp.effective_budget()
        pool_use = np.zeros(cap_ops.P_BUCKET)
        np.add.at(pool_use, inp.pool[inp.elig], targets[inp.elig])
        inc = np.maximum(targets - inp.existing, 0.0)
        fleet_used = float(inc[inp.elig].sum())
        fleet_bound = fleet_used >= budget - 1e-9
        anchor = inp.existing + inp.heuristic_new
        demand_u = inp.demand_units()

        rows: Dict[str, Dict] = {}
        for i, did in enumerate(inp.distro_ids):
            if not inp.elig[i]:
                # full-row fused instances carry every snapshot row;
                # only program participants get a decomposition
                continue
            p = int(inp.pool[i])
            t = float(targets[i])
            binding = []
            hi_i = max(np.ceil(lo[i] - 1e-6), np.floor(hi[i] + 1e-6))
            demand_cap = inp.existing[i] + max(
                inp.deps_met[i] - inp.free[i], 0.0
            )
            if t >= hi_i - 1e-9:
                # which upper bound actually bit: the configured max or
                # the heuristic's deps-met demand guard
                binding.append(
                    "demand" if demand_cap < inp.max_hosts[i] else "max"
                )
            elif t <= np.ceil(lo[i] - 1e-6) + 1e-9 and lo[i] > 0:
                binding.append("min")
            if quota[p] < cap_ops._BIG and pool_use[p] >= quota[p] - 1e-9:
                binding.append("quota")
            if fleet_bound and targets[i] > inp.existing[i]:
                binding.append("fleet")
            rows[did] = {
                "distro": did,
                "pool": cap_ops.pool_name_of(p),
                "existing": int(inp.existing[i]),
                "min_hosts": int(inp.min_hosts[i]),
                "max_hosts": int(inp.max_hosts[i]),
                "demand_s": round(float(inp.demand_s[i]), 1),
                "deps_met": int(inp.deps_met[i]),
                "heuristic_new": int(inp.heuristic_new[i]),
                "target": int(targets[i]),
                "intents": int(max(0, targets[i] - inp.existing[i])),
                "fractional": round(float(x[i]), 3),
                # the objective terms AT the adopted target — the
                # decomposition of why k hosts and not k±1
                "demand_term": round(
                    float(demand_u[i]) / max(t, 1.0), 4
                ),
                "price_term": round(
                    float(inp.w_price * inp.price[p] * t), 4
                ),
                "churn_term": round(
                    float(
                        0.5 * inp.w_churn * (t - inp.existing[i]) ** 2
                    ),
                    4,
                ),
                "binding": binding,
                "partners": [],
            }
        # trade partners: within a quota-bound pool, who gained what a
        # shrunk-vs-heuristic distro gave up (and vice versa)
        for p in range(cap_ops.P_BUCKET):
            members = [
                i for i in range(inp.n)
                if inp.elig[i] and int(inp.pool[i]) == p
            ]
            if len(members) < 2 or pool_use[p] < quota[p] - 1e-9:
                continue
            gained = [
                inp.distro_ids[i] for i in members
                if targets[i] > anchor[i]
            ]
            lost = [
                inp.distro_ids[i] for i in members
                if targets[i] < anchor[i]
            ]
            for i in members:
                did = inp.distro_ids[i]
                if targets[i] > anchor[i]:
                    rows[did]["partners"] = [d for d in lost if d != did]
                elif targets[i] < anchor[i]:
                    rows[did]["partners"] = [
                        d for d in gained if d != did
                    ]
        fleet = {
            "chosen": chosen,
            "budget": int(budget),
            "new_hosts": int(fleet_used),
            "n_distros": int(np.count_nonzero(inp.elig)),
            "pool_use": {
                cap_ops.pool_name_of(p): int(pool_use[p])
                for p in range(cap_ops.P_BUCKET)
                if pool_use[p] > 0
            },
        }
        return cls(now, chosen, fleet, rows)

    # -- accessors ----------------------------------------------------------- #

    def explain(self, distro_id: str) -> Optional[Dict]:
        row = self._rows.get(distro_id)
        if row is None:
            return None
        return {
            **row, "chosen": self.chosen, "at": self.at,
            "stale": self.stale,
        }

    def to_doc(self, limit: int = 50) -> Dict:
        doc = {
            "at": self.at,
            "stale": self.stale,
            "fleet": self.fleet,
            "distros": [
                self._rows[k]
                for k in sorted(self._rows)[: max(0, int(limit))]
            ],
        }
        if self.affinity is not None:
            doc["affinity"] = self.affinity
        return doc


def capacity_provenance_for(store) -> Optional[CapacityProvenance]:
    """The most recent applied capacity solve on this store (None before
    the first one, or after the plane fell back — the last applied
    answer is kept, stamped with its ``at`` time so consumers can
    judge freshness)."""
    return getattr(store, "_last_capacity", None)


def explain_capacity(store, distro_id: str) -> Optional[Dict]:
    """Why did ``distro_id`` get k hosts: the capacity program's term
    decomposition + binding constraints for the distro, or None when no
    capacity solve has run (or the distro was not in the program)."""
    prov = capacity_provenance_for(store)
    return None if prov is None else prov.explain(distro_id)
