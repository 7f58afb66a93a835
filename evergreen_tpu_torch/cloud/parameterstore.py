"""Parameter store: secrets management.

A copy of ``evergreen_tpu/cloud/parameterstore.py``, whole (reference
cloud/parameterstore/: an SSM-backed parameter manager with a DB-backed
fake for tests, fakeparameter, testutil/config.go:56-60). The client is
pluggable; ``FakeSSMClient`` keeps the parameters in the store's
``parameters`` collection with the same get/put/delete surface, so a
real SSM client slots in unchanged. As in the JAX package, only the
tests call it; the ``parameter_store`` config section names its prefix.
"""
from __future__ import annotations

import abc
import time as _time
from typing import Dict, List, Optional

from ..storage.store import Store

COLLECTION = "parameters"


class ParameterClient(abc.ABC):
    @abc.abstractmethod
    def put_parameter(self, name: str, value: str) -> None: ...

    @abc.abstractmethod
    def get_parameter(self, name: str) -> Optional[str]: ...

    @abc.abstractmethod
    def delete_parameter(self, name: str) -> bool: ...


class FakeSSMClient(ParameterClient):
    """Store-backed stand-in (the fakeparameter seam)."""

    def __init__(self, store: Store) -> None:
        self.store = store

    def put_parameter(self, name: str, value: str) -> None:
        self.store.collection(COLLECTION).upsert(
            {"_id": name, "value": value, "updated_at": _time.time()}
        )

    def get_parameter(self, name: str) -> Optional[str]:
        doc = self.store.collection(COLLECTION).get(name)
        return doc["value"] if doc else None

    def delete_parameter(self, name: str) -> bool:
        return self.store.collection(COLLECTION).remove(name)


class ParameterManager:
    """Namespaced parameter access with an in-process cache (reference
    parameterstore.ParameterManager)."""

    def __init__(self, client: ParameterClient, prefix: str = "/evergreen") -> None:
        self.client = client
        self.prefix = prefix.rstrip("/")
        self._cache: Dict[str, str] = {}

    def _full(self, name: str) -> str:
        return name if name.startswith("/") else f"{self.prefix}/{name}"

    def put(self, name: str, value: str) -> None:
        full = self._full(name)
        self.client.put_parameter(full, value)
        self._cache[full] = value

    def get(self, name: str, use_cache: bool = True) -> Optional[str]:
        full = self._full(name)
        if use_cache and full in self._cache:
            return self._cache[full]
        value = self.client.get_parameter(full)
        if value is not None:
            self._cache[full] = value
        return value

    def delete(self, name: str) -> bool:
        full = self._full(name)
        self._cache.pop(full, None)
        return self.client.delete_parameter(full)
