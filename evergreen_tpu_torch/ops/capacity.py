"""The capacity program's constants and its damped-Newton step, on tensors.

Counterpart of ``evergreen_tpu/ops/capacity.py``: the pool vocabulary, the
``c_cfg`` page slots and ``_capacity_step_fns``. The fused solve
(``ops/solve.py::capacity_affinity``) drives the step closures.

Decision ``x[d]`` = total hosts distro ``d`` should hold. The objective is
queue drain (demand_u / x) + pool price + churn, subject to min/max
hosts, per-pool quotas and a fleet intent budget; each Newton step is
followed by a projection (box clamp, per-pool scale-down, budget
scale-down).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..globals import Provider

#: pools ARE providers, in enum declaration order; index P_BUCKET-1 is
#: the "other" pool for unknown provider strings
POOL_NAMES: Tuple[str, ...] = tuple(p.value for p in Provider)
P_BUCKET = 8
_POOL_INDEX: Dict[str, int] = {name: i for i, name in enumerate(POOL_NAMES)}
assert len(POOL_NAMES) < P_BUCKET


def pool_index_of(provider: str) -> int:
    """Deterministic provider → pool index (unknown → the 'other' slot)."""
    return _POOL_INDEX.get(provider, P_BUCKET - 1)


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
