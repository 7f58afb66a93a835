"""User documents: the part the provisioning plane reads.

A copy of ``evergreen_tpu/models/user.py``'s ``User`` (field for field),
``coll`` and ``get_user``: the create pass reads a spawn host's owner to
put the owner's SSH public keys into its user data
(``cloud/provisioning.py::create_hosts_from_intents``). Users, API keys,
roles and the key checks come with the REST surface.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..storage.store import Collection, Store

COLLECTION = "users"


@dataclasses.dataclass
class User:
    id: str
    display_name: str = ""
    email: str = ""
    api_key: str = ""
    roles: List[str] = dataclasses.field(default_factory=list)
    created_at: float = 0.0
    banned: bool = False
    #: named SSH public keys ([{name, key, created_at}]) — injected into
    #: the user's spawn hosts at provision time
    public_keys: List[dict] = dataclasses.field(default_factory=list)

    @classmethod
    def from_doc(cls, doc: dict) -> "User":
        doc = dict(doc)
        doc["id"] = doc.pop("_id")
        return cls(**doc)


def coll(store: Store) -> Collection:
    return store.collection(COLLECTION)


def get_user(store: Store, user_id: str) -> Optional[User]:
    doc = coll(store).get(user_id)
    return User.from_doc(doc) if doc else None
