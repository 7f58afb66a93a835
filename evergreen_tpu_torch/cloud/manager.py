"""Provider-agnostic cloud manager interface and the pool price table.

A copy of ``evergreen_tpu/cloud/manager.py``: ``CloudHostStatus``, the
``CloudManager`` surface the recovery pass reads (the instance status
probe; terminate and stop), ``register_manager`` / ``get_manager``
(reference cloud/cloud.go:147-177 GetManager factory) and
``default_pool_prices``. The spawn, start and DNS calls come with the
provisioning plane, and so do the real providers (docker, ec2, static):
``cloud/mock.py`` is the one ported provider, so ``get_manager`` of any
other provider raises ``KeyError``.
"""
from __future__ import annotations

import abc
from typing import Callable, Dict

from ..models.host import Host
from ..storage.store import Store


class CloudHostStatus:
    """Provider-view instance states (reference cloud/cloud.go CloudStatus)."""

    UNKNOWN = "unknown"
    INITIALIZING = "initializing"
    STARTING = "starting"
    RUNNING = "running"
    STOPPING = "stopping"
    STOPPED = "stopped"
    TERMINATED = "terminated"
    NONEXISTENT = "nonexistent"


class CloudManager(abc.ABC):
    provider: str = ""

    @abc.abstractmethod
    def get_instance_status(self, store: Store, host: Host) -> str:
        """The provider's truth about the instance — the reconciliation
        source for the recovery pass (and host monitoring)."""

    @abc.abstractmethod
    def terminate_instance(self, store: Store, host: Host, reason: str) -> None:
        ...

    def stop_instance(self, store: Store, host: Host) -> None:
        raise NotImplementedError(f"{self.provider} cannot stop instances")


_REGISTRY: Dict[str, Callable[[], CloudManager]] = {}


def register_manager(provider: str, factory: Callable[[], CloudManager]) -> None:
    _REGISTRY[provider] = factory


def get_manager(provider: str) -> CloudManager:
    factory = _REGISTRY.get(provider)
    if factory is None:
        raise KeyError(f"no cloud manager registered for provider {provider!r}")
    return factory()


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
