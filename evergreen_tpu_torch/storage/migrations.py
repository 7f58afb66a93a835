"""Data migrations: ordered, recorded, idempotent.

A copy of ``evergreen_tpu/storage/migrations.py`` (the reference runs DB
migrations through anser): migrations register under names that sort in
application order, apply once per store (recorded in the ``migrations``
collection) and run in ``env.py::Environment.build`` before the job
plane starts. The same four built-in migrations under the same names,
so a store one package migrated is migrated for the other.
"""
from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Tuple

from .store import Store

COLLECTION = "migrations"
#: the machine-to-machine Okta section migration 0004 reads (its
#: ``section_id`` in the JAX package's settings)
OKTA_SERVICE_SECTION = "okta_service"

_REGISTRY: Dict[str, Callable[[Store], None]] = {}


def register_migration(name: str):
    """Decorator: names must sort in application order (e.g.
    ``0001-add-field``)."""

    def wrap(fn: Callable[[Store], None]):
        if name in _REGISTRY:
            raise KeyError(f"duplicate migration {name!r}")
        _REGISTRY[name] = fn
        return fn

    return wrap


def pending_migrations(store: Store) -> List[str]:
    applied = {d["_id"] for d in store.collection(COLLECTION).find()}
    return [n for n in sorted(_REGISTRY) if n not in applied]


def apply_migrations(store: Store) -> List[Tuple[str, str]]:
    """Run every unapplied migration in order; returns
    [(name, "applied"|"failed: …")]. A failure stops the chain (later
    migrations may depend on earlier ones)."""
    out: List[Tuple[str, str]] = []
    coll = store.collection(COLLECTION)
    for name in pending_migrations(store):
        try:
            _REGISTRY[name](store)
        except Exception as e:  # record and halt
            out.append((name, f"failed: {e}"))
            break
        coll.upsert({"_id": name, "applied_at": _time.time()})
        out.append((name, "applied"))
    return out


# --------------------------------------------------------------------------- #
# Built-in migrations (the live examples; new schema changes append here)
# --------------------------------------------------------------------------- #


@register_migration("0001-task-execution-platform-default")
def _m0001(store: Store) -> None:
    """Tasks created before execution_platform existed default to host."""
    store.collection("tasks").update_where(
        lambda d: "execution_platform" not in d,
        {"execution_platform": "host"},
    )


@register_migration("0002-queue-docs-to-columnar")
def _m0002(store: Store) -> None:
    """Rewrite legacy item-list queue docs into the columnar format."""
    from ..models.task_queue import TaskQueue, _ITEM_FIELDS

    for coll_name in ("task_queues", "task_secondary_queues"):
        coll = store.collection(coll_name)
        for doc in coll.find(lambda d: "cols" not in d and "queue" in d):
            items = doc.get("queue", [])
            cols = {
                name: [item.get(name) for item in items]
                for name in _ITEM_FIELDS
            }
            coll.update(doc["_id"], {"cols": cols})
            coll.mutate(doc["_id"], lambda d: d.pop("queue", None))


@register_migration("0003-backfill-host-secrets")
def _m0003(store: Store) -> None:
    """Hosts created before agent credentials existed get a secret minted,
    so enabling ``require_auth`` does not lock out a pre-existing fleet
    (their agents pick it up on the next monitor-driven respawn)."""
    import uuid

    coll = store.collection("hosts")
    for doc in coll.find(lambda d: not d.get("secret")):
        coll.update(doc["_id"], {"secret": uuid.uuid4().hex})


@register_migration("0004-okta-service-gates-to-auth")
def _m0004(store: Store) -> None:
    """The interactive-login gates (``user_group`` /
    ``expected_email_domains``) once lived on the okta_service section;
    they moved to the auth section (AuthConfig.okta_user_group /
    okta_expected_email_domains) where load_user_manager enforces them.
    A store upgraded with the old keys set would silently lose the gate
    — the section loader drops unknown fields. Copy the stored values
    into the auth section (never clobbering values an admin already set
    there) and leave the stale keys in place for the loud load-time
    warning the JAX package's settings.OktaServiceConfig.get_base gives
    (the port does not read the okta_service section)."""
    from ..settings import CONFIG_COLLECTION, AuthConfig

    doc = store.collection(CONFIG_COLLECTION).get(OKTA_SERVICE_SECTION)
    if not doc:
        return
    group = doc.get("user_group") or ""
    domains = doc.get("expected_email_domains") or []
    if not group and not domains:
        return
    auth = AuthConfig.get_base(store)
    changed = False
    if group and not auth.okta_user_group:
        auth.okta_user_group = group
        changed = True
    if domains and not auth.okta_expected_email_domains:
        auth.okta_expected_email_domains = list(domains)
        changed = True
    if changed:
        auth.set(store)
        from ..utils.log import get_logger

        get_logger("config").warning(
            "migrated okta_service login gates into the auth section",
            user_group=group,
            expected_email_domains=domains,
        )
