"""Packed transfer layout for the solve.

The snapshot builder allocates every input array as a view into one of
three typed arenas (f32 / i32 / u8-bool), so one solve ships exactly
three host→device buffers. ``unpack`` carries those buffers, built by
this package or by the JAX package (``evergreen_tpu/ops/packing.py``, the
same layout), onto a device as named tensors. ``ArenaPool`` keeps two
zeroed buffer sets per layout for the tick's snapshots, as the JAX
package's does.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import metrics as _metrics

ARENA_FORCED_ROTATIONS = _metrics.counter(
    "arena_forced_rotations_total",
    "Transfer-arena leases forcibly reclaimed because every slot of a "
    "layout was still leased (a leak-anomaly signal, not a steady-state "
    "path).",
    legacy="arena.pool.forced_rotation",
)

_DTYPES = {
    "f32": np.float32,
    "i32": np.int32,
    "u8": np.uint8,
}


class Arena:
    """Allocates named 1-D views out of three typed buffers."""

    def __init__(self) -> None:
        self._plan: List[Tuple[str, str, int]] = []  # (name, kind, size)
        self._bufs: Dict[str, np.ndarray] = {}
        self._layout: Dict[str, Tuple[str, int, int]] = {}
        self._sizes = {"f32": 0, "i32": 0, "u8": 0}
        self._finalized = False
        self._pool: "ArenaPool" = None
        self._lease: "_ArenaLease" = None

    def alloc(self, name: str, size: int, kind: str) -> None:
        assert not self._finalized
        self._plan.append((name, kind, size))
        self._layout[name] = (kind, self._sizes[kind], size)
        self._sizes[kind] += size

    def sizes(self) -> Dict[str, int]:
        """Elements of each typed buffer (at least 1)."""
        return {kind: max(total, 1) for kind, total in self._sizes.items()}

    def finalize(self, pool: "ArenaPool" = None) -> None:
        """Allocate the buffers: fresh zeroed ones, or a zeroed set
        leased from ``pool`` (returned by ``close``)."""
        if pool is not None:
            self._lease = pool.take(self.sizes())
            self._bufs = self._lease.bufs
            self._pool = pool
        else:
            for kind, size in self.sizes().items():
                self._bufs[kind] = np.zeros(size, dtype=_DTYPES[kind])
        self._finalized = True

    def close(self) -> None:
        """Return the leased buffer set to the pool. Idempotent; callers
        wrap the tick in try/finally so fault paths (a raising solve, a
        snapshot build that dies mid-fill) can never strand a slot."""
        if self._pool is not None:
            self._pool.give_back(self._lease)
            self._pool = None
            self._lease = None

    def view(self, name: str) -> np.ndarray:
        kind, off, size = self._layout[name]
        return self._bufs[kind][off : off + size]

    def field(self, name: str) -> Tuple[str, int, int]:
        """(kind, offset, size) of one field."""
        return self._layout[name]

    @property
    def buffers(self) -> Dict[str, np.ndarray]:
        return self._bufs

    def layout_key(self) -> Tuple:
        """Hashable static layout: ((name, kind, size), ...)."""
        return tuple(self._plan)


class _ArenaLease:
    """One outstanding claim on a pooled buffer set. The lease OBJECT —
    not the buffer dict — is the return token: after a forced rotation
    the same dict is live under the thief's newer lease, so dict
    identity cannot tell the victim's (now void) return from the
    thief's legitimate one."""

    __slots__ = ("key", "bufs", "revoked")

    def __init__(self, key: Tuple, bufs: Dict[str, np.ndarray]) -> None:
        self.key = key
        self.bufs = bufs
        self.revoked = False


class ArenaPool:
    """Double-buffered arena backing store with explicit leases.

    A tick keeps at most two snapshots alive (the one being packed and
    the one a solve still reads), so two buffer sets per layout suffice;
    reusing them costs one memset per buffer instead of a fresh multi-MB
    allocation. On the CPU the solve reads a numpy buffer in place
    (``unpack``), so a snapshot published from mutable host state (the
    resident plane's truth) is copied into a leased set first. ``take``
    leases a free set and ``Arena.close`` returns it; when no set is free
    the oldest outstanding lease is forcibly rotated and counted in
    ``forced_rotations``, so a leak shows in telemetry instead of as a
    silently overwritten buffer.
    """

    #: distinct layouts kept before the oldest is dropped
    MAX_LAYOUTS = 4
    #: buffer sets per layout (the packing snapshot and the solving one)
    DEPTH = 2

    def __init__(self) -> None:
        #: layout key → list of free buffer sets
        self._free: Dict[Tuple, List[Dict[str, np.ndarray]]] = {}
        #: layout key → outstanding leases (oldest first)
        self._leased: Dict[Tuple, List[_ArenaLease]] = {}
        self.forced_rotations = 0

    def _key_slots(self, key: Tuple):
        if key not in self._free:
            while len(self._free) >= self.MAX_LAYOUTS:
                oldest = next(iter(self._free))
                del self._free[oldest]
                self._leased.pop(oldest, None)
            self._free[key] = []
            self._leased[key] = []
        return self._free[key], self._leased[key]

    def take(self, sizes: Dict[str, int]) -> _ArenaLease:
        key = tuple(sorted(sizes.items()))
        free, leased = self._key_slots(key)
        if free:
            bufs = free.pop()
            for b in bufs.values():
                b.fill(0)
        elif len(leased) < self.DEPTH:
            bufs = {
                kind: np.zeros(total, dtype=_DTYPES[kind])
                for kind, total in sizes.items()
            }
        else:
            # every set is still leased: reclaim the oldest, visibly. The
            # victim lease is marked revoked so its eventual give_back is
            # a no-op — the same dict is live again under the new lease.
            victim = leased.pop(0)
            victim.revoked = True
            bufs = victim.bufs
            self.forced_rotations += 1
            ARENA_FORCED_ROTATIONS.inc()
            for b in bufs.values():
                b.fill(0)
        lease = _ArenaLease(key, bufs)
        leased.append(lease)
        return lease

    def give_back(self, lease: _ArenaLease) -> None:
        if lease.revoked:
            return  # forcibly reclaimed: the set is live elsewhere
        leased = self._leased.get(lease.key)
        if leased is None:
            return  # layout was evicted while leased: drop the buffers
        for i, held in enumerate(leased):
            if held is lease:
                del leased[i]
                self._free[lease.key].append(lease.bufs)
                return


def unpack(bufs: Dict, layout_key: Tuple, device) -> Dict[str, torch.Tensor]:
    """Slice the three buffers into the named fields, on ``device``.

    ``bufs`` maps "f32"/"i32"/"u8" to numpy arrays, each uploaded here in
    one host→device copy, or to tensors, which are used in place when
    they already lie on ``device`` (a device mirror's resident buffers)
    and copied once otherwise. Offsets come from ``layout_key`` alone; u8
    fields come back as bool (nonzero ⇔ True), the others as views of the
    buffer. On the CPU a numpy buffer is used in place too, so a caller
    whose buffer may change under the solve (a shared-memory segment)
    hands over a copy."""
    dev = torch.device(device)
    tens = {
        kind: (buf if isinstance(buf, torch.Tensor)
               else torch.as_tensor(np.ascontiguousarray(buf))).to(dev)
        for kind, buf in bufs.items()
    }
    offsets = {"f32": 0, "i32": 0, "u8": 0}
    out = {}
    for name, kind, size in layout_key:
        off = offsets[kind]
        sl = tens[kind][off : off + size]
        offsets[kind] = off + size
        out[name] = sl != 0 if kind == "u8" else sl
    return out
