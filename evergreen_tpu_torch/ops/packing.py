"""Packed transfer layout for the solve.

The snapshot builder allocates every input array as a view into one of
three typed arenas (f32 / i32 / u8-bool), so one solve ships exactly
three host→device buffers. ``unpack`` carries those buffers, built by
this package or by the JAX package (``evergreen_tpu/ops/packing.py``, the
same layout), onto a device as named tensors.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

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

    def alloc(self, name: str, size: int, kind: str) -> None:
        assert not self._finalized
        self._plan.append((name, kind, size))
        self._layout[name] = (kind, self._sizes[kind], size)
        self._sizes[kind] += size

    def sizes(self) -> Dict[str, int]:
        """Elements of each typed buffer (at least 1)."""
        return {kind: max(total, 1) for kind, total in self._sizes.items()}

    def finalize(self) -> None:
        for kind, size in self.sizes().items():
            self._bufs[kind] = np.zeros(size, dtype=_DTYPES[kind])
        self._finalized = True

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
