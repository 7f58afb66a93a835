"""Document store: collections of plain dicts, and the journal hooks
the durable engine writes its WAL through.

A copy of ``evergreen_tpu/storage/store.py``: ``Collection`` and
``Store`` keep the same semantics, so a tick's gather reads the same
documents in the same order from either package's store. ``find``
returns the stored documents themselves, in insertion order, without
copying them (``snapshot`` is the deep-copying read); an upsert of an
existing id keeps its place. The delta persister's write shapes
(``bulk_update``, ``patch``, ``patch_list``, ``splice_queue``) apply
their changes as the JAX store's do. Every write path notifies the
collection's change listeners (``add_listener``) inside the collection
lock, at the same points as the JAX store; the TickCache
(``scheduler/cache.py``) tracks its dirty sets through them.

``Collection(name, journal=fn)`` hands ``fn`` one record per write,
still under the collection lock, so a WAL's order is its apply order:
``p`` a full-document put, ``pm`` a batch of puts, ``um`` one field
update over many ids, ``u`` a field patch (with ``pv``, the doc version
it expects, when it advances ``v``), ``pl`` a sparse list patch, ``qs``
a queue splice, ``r`` a removal and ``x`` a clear — the JAX package's
records, key for key. ``apply_wal_record`` replays one of them (or a
group frame ``g``) into a store. The durable engine
(``storage/durable.py``) overrides the base ``Store``'s no-op hooks
(``begin_tick``, ``end_tick``, ``end_tick_async``, ``sync_persist``,
``heal_durability``, ``assert_not_fenced``, ``fenced``). ``shard_id``
names the store's shard in a sharded plane (None outside one).

Thread-safety: a single re-entrant lock guards each collection. The scheduler
tick itself never blocks on this lock for long — the snapshot builder reads
whole collections in one lock acquisition.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

from ..utils import lockcheck as _lockcheck


class Collection:
    """A named map of id -> document (a plain dict).

    ``journal`` (optional) receives one record per write while the
    collection lock is held. All mutation goes through this API (an
    in-place edit of a document returned by ``get``/``find`` would dodge
    the journal), and a ``mutate`` callback must not touch other
    collections (the compactor takes collection locks in bulk)."""

    def __init__(self, name: str, journal=None) -> None:
        self.name = name
        self._docs: Dict[str, dict] = {}
        self._journal = journal
        self._lock = _lockcheck.make_rlock("store.collection")
        #: change listeners: fn(doc_id) called after any write touching the
        #: doc. Callbacks MUST be trivial (set a dirty flag) — they run
        #: under the collection lock.
        self._listeners: List[Callable[[str], None]] = []
        #: memoized id → monotonic insertion rank, maintained incrementally:
        #: consumers only SORT by it, so ranks need monotonicity, not
        #: contiguity — inserts append the next counter value and removals
        #: just drop the key (relative order of survivors is unchanged).
        self._key_order_cache: Optional[Dict[str, int]] = None
        self._order_rank = 0

    def add_listener(self, fn: Callable[[str], None]) -> None:
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, doc_id: str) -> None:
        for fn in self._listeners:
            fn(doc_id)

    def _log_put(self, doc: dict) -> None:
        if self._journal is not None:
            self._journal({"c": self.name, "o": "p", "d": doc})

    def _log_remove(self, doc_id: str) -> None:
        if self._journal is not None:
            self._journal({"c": self.name, "o": "r", "i": doc_id})

    # -- basic CRUD --------------------------------------------------------- #

    def insert(self, doc: dict) -> None:
        doc_id = doc["_id"]
        with self._lock:
            if doc_id in self._docs:
                raise KeyError(f"duplicate _id {doc_id!r} in {self.name}")
            self._docs[doc_id] = doc
            if self._key_order_cache is not None:
                self._key_order_cache[doc_id] = self._order_rank
            self._order_rank += 1
            self._log_put(doc)
            self._notify(doc_id)

    def upsert(self, doc: dict) -> None:
        with self._lock:
            if doc["_id"] not in self._docs:
                if self._key_order_cache is not None:
                    self._key_order_cache[doc["_id"]] = self._order_rank
                self._order_rank += 1
            self._docs[doc["_id"]] = doc
            self._log_put(doc)
            self._notify(doc["_id"])

    def insert_many(self, docs: Iterable[dict]) -> None:
        docs = list(docs)  # may be a generator; two passes below
        with self._lock:
            seen = set()
            for doc in docs:
                if doc["_id"] in self._docs or doc["_id"] in seen:
                    raise KeyError(f"duplicate _id {doc['_id']!r} in {self.name}")
                seen.add(doc["_id"])
            for doc in docs:
                self._docs[doc["_id"]] = doc
                if self._key_order_cache is not None:
                    self._key_order_cache[doc["_id"]] = self._order_rank
                self._order_rank += 1
            # journal after applying: an inline auto-compaction the
            # append triggers must already snapshot the batch
            if docs and self._journal is not None:
                self._journal({"c": self.name, "o": "pm", "ds": docs})
            for doc in docs:
                self._notify(doc["_id"])

    def get(self, doc_id: str) -> Optional[dict]:
        with self._lock:
            return self._docs.get(doc_id)

    def find(self, pred: Optional[Callable[[dict], bool]] = None) -> List[dict]:
        with self._lock:
            if pred is None:
                return list(self._docs.values())
            return [d for d in self._docs.values() if pred(d)]

    def find_ids(self, ids: Iterable[str]) -> List[dict]:
        with self._lock:
            return [self._docs[i] for i in ids if i in self._docs]

    def key_order(self) -> Dict[str, int]:
        """id → monotonic insertion rank (dicts preserve insertion order);
        the deterministic ordering contract incremental caches must
        reproduce. The returned mapping is a shared memo — treat it as
        read-only."""
        with self._lock:
            if self._key_order_cache is None:
                self._key_order_cache = {
                    k: i for i, k in enumerate(self._docs)
                }
                self._order_rank = len(self._docs)
            return self._key_order_cache

    def remove(self, doc_id: str) -> bool:
        with self._lock:
            gone = self._docs.pop(doc_id, None) is not None
            if gone:
                if self._key_order_cache is not None:
                    self._key_order_cache.pop(doc_id, None)
                self._log_remove(doc_id)
                self._notify(doc_id)
            return gone

    def remove_where(self, pred: Callable[[dict], bool]) -> int:
        with self._lock:
            doomed = [i for i, d in self._docs.items() if pred(d)]
            for i in doomed:
                del self._docs[i]
                if self._key_order_cache is not None:
                    self._key_order_cache.pop(i, None)
                self._log_remove(i)
                self._notify(i)
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            ids = list(self._docs)
            self._docs.clear()
            self._key_order_cache = None
            self._order_rank = 0
            if ids and self._journal is not None:
                self._journal({"c": self.name, "o": "x"})
            for i in ids:
                self._notify(i)

    def count(self, pred: Optional[Callable[[dict], bool]] = None) -> int:
        with self._lock:
            if pred is None:
                return len(self._docs)
            return sum(1 for d in self._docs.values() if pred(d))

    def __len__(self) -> int:
        return len(self._docs)

    def __iter__(self) -> Iterator[dict]:
        return iter(self.find())

    # -- atomic primitives --------------------------------------------------- #

    def compare_and_set(
        self,
        doc_id: str,
        expect: Dict[str, Any],
        update: Dict[str, Any],
    ) -> bool:
        """Atomically apply ``update`` iff every field in ``expect`` matches.

        This is the dispatch-correctness primitive: the reference's atomic
        ``host.RunningTask`` assignment (rest/route/host_agent.go:311-420) and
        task state transitions use Mongo conditional updates the same way.
        """
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            for key, val in expect.items():
                if doc.get(key) != val:
                    return False
            doc.update(update)
            self._log_put(doc)
            self._notify(doc_id)
            return True

    def update(self, doc_id: str, update: Dict[str, Any]) -> bool:
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            doc.update(update)
            self._log_put(doc)
            self._notify(doc_id)
            return True

    def update_where(
        self, pred: Callable[[dict], bool], update: Dict[str, Any]
    ) -> int:
        with self._lock:
            n = 0
            for doc in self._docs.values():
                if pred(doc):
                    doc.update(update)
                    n += 1
                    self._log_put(doc)
                    self._notify(doc["_id"])
            return n

    def bulk_update(
        self,
        ids: Iterable[str],
        fields: Dict[str, Any],
        only_if: Optional[Callable[[dict], bool]] = None,
    ) -> int:
        """Apply the SAME ``fields`` to every existing doc in ``ids``
        (optionally gated per-doc by ``only_if``, checked under the lock)
        in one lock acquisition and one journal record (``um``) — the
        tick's task stamping. Returns the number of docs updated."""
        with self._lock:
            hit: List[str] = []
            for doc_id in ids:
                doc = self._docs.get(doc_id)
                if doc is None or (only_if is not None and not only_if(doc)):
                    continue
                doc.update(fields)
                hit.append(doc_id)
            # journal after applying (as insert_many)
            if hit and self._journal is not None:
                self._journal(
                    {"c": self.name, "o": "um", "is": hit, "f": fields}
                )
            for doc_id in hit:
                self._notify(doc_id)
            return len(hit)

    def patch(self, doc_id: str, fields: Dict[str, Any]) -> bool:
        """Field-level doc update that journals only the patched fields
        (``u``) — the delta persister's column patch for big docs whose
        dynamic columns churn while the bulk stays put (queue docs:
        sort_value/dependencies_met vs 50k rows). When ``fields`` advances
        the version ``v``, the record carries the expected previous
        version so replay drops a patch whose base write was lost."""
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            rec = {"c": self.name, "o": "u", "i": doc_id, "f": fields}
            if "v" in fields:
                rec["pv"] = doc.get("v")
            doc.update(fields)
            if self._journal is not None:
                self._journal(rec)
            self._notify(doc_id)
            return True

    def patch_list(
        self,
        doc_id: str,
        elems: Dict[str, Any],
        fields: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Sparse element-level patch of list fields (``pl``): ``elems``
        maps field name → ``(indices, values)`` applied positionally, so
        the journal carries only the changed entries; ``fields`` are
        whole-field patches applied with them (version bump,
        generated_at), with ``patch``'s version guard. Refuses (False)
        when an index is past its list."""
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            for name, (idx, vals) in elems.items():
                lst = doc.get(name)
                if lst is None or (idx and idx[-1] >= len(lst)):
                    return False  # base shape mismatch: caller rewrites
            rec = {"c": self.name, "o": "pl", "i": doc_id, "el": elems}
            if fields:
                rec["f"] = fields
                if "v" in fields:
                    rec["pv"] = doc.get("v")
            for name, (idx, vals) in elems.items():
                lst = doc[name]
                for i, v in zip(idx, vals):
                    lst[i] = v
            if fields:
                doc.update(fields)
            if self._journal is not None:
                self._journal(rec)
            self._notify(doc_id)
            return True

    def splice_queue(
        self,
        doc_id: str,
        rm_idx: List[int],
        inserts: List[tuple],
        fields: Optional[Dict[str, Any]] = None,
        elems: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Row-level splice of a queue doc's three aligned columns
        (``rows`` / ``sort_value`` / ``dependencies_met``), journaling
        only the delta (``qs``) — the churn-tick write shape of the delta
        persister. ``rm_idx``
        (ascending, pre-splice indices) removes rows; ``inserts`` is
        ``[(idx, row, sort, met), ...]`` with ``idx`` the position in the
        FINAL list (ascending); ``fields`` are whole-field patches (order
        permutation, version bump) and ``elems`` sparse element patches
        applied AFTER the splice."""
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            rows = doc.get("rows")
            sv = doc.get("sort_value")
            dm = doc.get("dependencies_met")
            if rows is None or sv is None or dm is None:
                return False
            n = len(rows)
            if len(sv) != n or len(dm) != n:
                return False
            if rm_idx and (rm_idx[-1] >= n or rm_idx[0] < 0):
                return False
            rec = {
                "c": self.name, "o": "qs", "i": doc_id,
                "rm": rm_idx, "ins": inserts,
            }
            if fields:
                rec["f"] = fields
                if "v" in fields:
                    rec["pv"] = doc.get("v")
            if elems:
                rec["el"] = elems
            for i in reversed(rm_idx):
                del rows[i]
                del sv[i]
                del dm[i]
            for i, row, s, m in inserts:
                rows.insert(i, row)
                sv.insert(i, s)
                dm.insert(i, m)
            if elems:
                for name, (idx, vals) in elems.items():
                    lst = doc[name]
                    for i, v in zip(idx, vals):
                        lst[i] = v
            if fields:
                doc.update(fields)
            if self._journal is not None:
                self._journal(rec)
            self._notify(doc_id)
            return True

    def mutate(self, doc_id: str, fn: Callable[[dict], None]) -> bool:
        """Run ``fn`` on the document under the collection lock."""
        with self._lock:
            doc = self._docs.get(doc_id)
            if doc is None:
                return False
            fn(doc)
            self._log_put(doc)
            self._notify(doc_id)
            return True

    def snapshot(self) -> List[dict]:
        """Deep-copied point-in-time view (for the snapshot builder)."""
        with self._lock:
            return copy.deepcopy(list(self._docs.values()))


def apply_wal_record(store: "Store", rec: dict, skip=()) -> None:
    """Replay one journal record into a store — the WAL op decoder of
    crash recovery (``storage/durable.py``). ``skip`` filters
    collections, applied per group member too. A ``u``/``pl``/``qs``
    record whose document is gone, or whose ``pv`` is not the
    document's version (its base write was lost with a torn group
    frame), is dropped rather than applied to the wrong document; ``g``
    is a tick's group frame, whose members replay in order."""
    op = rec["o"]
    if op == "g":
        for sub in rec["rs"]:
            if sub.get("c") not in skip:
                apply_wal_record(store, sub, skip)
        return
    coll = store.collection(rec["c"])
    if op == "p":
        coll.upsert(rec["d"])
    elif op == "pm":
        for d in rec["ds"]:
            coll.upsert(d)
    elif op == "u":
        doc = coll.get(rec["i"])
        if doc is None:
            return  # base write lost (dropped group): skip the patch
        if "pv" in rec and doc.get("v") != rec["pv"]:
            return  # version gap: the patch's base is not this doc
        coll.update(rec["i"], rec["f"])
    elif op == "um":
        coll.bulk_update(rec["is"], rec["f"])
    elif op == "pl":
        doc = coll.get(rec["i"])
        if doc is None:
            return
        f = rec.get("f")
        if f and "pv" in rec and doc.get("v") != rec["pv"]:
            return
        coll.patch_list(rec["i"], rec["el"], f)
    elif op == "qs":
        doc = coll.get(rec["i"])
        if doc is None:
            return
        f = rec.get("f")
        if f and "pv" in rec and doc.get("v") != rec["pv"]:
            return
        coll.splice_queue(
            rec["i"], rec["rm"], [tuple(i) for i in rec["ins"]],
            f, rec.get("el"),
        )
    elif op == "r":
        coll.remove(rec["i"])
    elif op == "x":
        coll.clear()


class Store:
    """A namespace of collections, analogous to one Mongo database."""

    #: the shard this store serves in a sharded plane (None: unsharded)
    shard_id: Optional[int] = None

    def __init__(self) -> None:
        self._collections: Dict[str, Collection] = {}
        self._lock = _lockcheck.make_lock("store.db")

    def collection(self, name: str) -> Collection:
        with self._lock:
            coll = self._collections.get(name)
            if coll is None:
                coll = Collection(name)
                self._collections[name] = coll
            return coll

    def clear_collections(self, *names: str) -> None:
        """Test seam, mirroring the reference's db.ClearCollections pattern
        (reference testutil usage throughout *_test.go). Collections are
        cleared outside the store lock, as in the JAX store."""
        with self._lock:
            if not names:
                targets = list(self._collections.values())
            else:
                targets = [
                    self._collections[n] for n in names
                    if n in self._collections
                ]
        for coll in targets:
            coll.clear()

    def __getitem__(self, name: str) -> Collection:
        return self.collection(name)

    # -- durability hooks (no-ops for the in-memory engine) ------------------ #
    # The tick calls these unconditionally; the durable engine overrides
    # them with the WAL's group commit.

    def begin_tick(self) -> None:
        """Open a tick-scoped journal group (durable engine only)."""

    def end_tick(self) -> None:
        """Commit the tick's journal group synchronously."""

    def end_tick_async(self) -> None:
        """Commit the tick's journal group on a background flusher."""

    def sync_persist(self) -> None:
        """Barrier for async commits; raises a deferred write error."""

    def heal_durability(self) -> bool:
        """Best-effort repair after a failed group commit."""
        return True

    #: split-brain fence state (the durable engine checks its lease
    #: epoch); an in-memory store can never be superseded
    fenced: bool = False

    def assert_not_fenced(self, read_lease_file: bool = False) -> None:
        """Raise EpochFencedError when this writer's lease epoch was
        superseded (durable engine only)."""


_GLOBAL_STORE: Optional[Store] = None
_GLOBAL_LOCK = _lockcheck.make_lock("store.global")


def global_store() -> Store:
    """Process-wide default store (the reference's evergreen.GetEnvironment().DB()
    analog, reference environment.go:93)."""
    global _GLOBAL_STORE
    with _GLOBAL_LOCK:
        if _GLOBAL_STORE is None:
            _GLOBAL_STORE = Store()
        return _GLOBAL_STORE


def reset_global_store() -> Store:
    global _GLOBAL_STORE
    with _GLOBAL_LOCK:
        _GLOBAL_STORE = Store()
        return _GLOBAL_STORE


def set_global_store(store: Store) -> Store:
    """Install a specific store (e.g. a DurableStore) as the process-wide
    default."""
    global _GLOBAL_STORE
    with _GLOBAL_LOCK:
        _GLOBAL_STORE = store
        return store
