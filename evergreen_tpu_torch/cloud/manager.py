"""Provider pool prices for the capacity program.

A copy of ``evergreen_tpu/cloud/manager.py``'s ``default_pool_prices``
and its table; the cloud managers themselves are not ported.
"""
from __future__ import annotations

from typing import Dict

#: relative $/host-hour per provider pool when the ``capacity`` config
#: section carries no explicit prices (ops/capacity.py price term).
#: Ratios, not dollars: on-demand EC2 costs more than fleet (spot-mixed)
#: capacity, containers are cheap marginal capacity on parent hosts, and
#: static/mock capacity is sunk cost the optimizer should prefer to use.
_DEFAULT_POOL_PRICES: Dict[str, float] = {
    "ec2-ondemand": 1.0,
    "ec2-fleet": 0.4,
    "docker": 0.1,
    "docker-mock": 0.1,
    "static": 0.0,
    "mock": 0.0,
}


def default_pool_prices() -> Dict[str, float]:
    """Provider → relative price defaults for the capacity program."""
    return dict(_DEFAULT_POOL_PRICES)
