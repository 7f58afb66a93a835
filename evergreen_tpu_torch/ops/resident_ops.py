"""Device-resident arena buffers, updated by dirty spans.

Counterpart of ``evergreen_tpu/ops/resident_ops.py``. The resident plane
keeps the snapshot's three typed arena buffers as persistent host truth
across ticks; shipping all three every tick costs more than the solve
when a churn tick touches a few hundred rows. ``DeviceMirror`` keeps the
three buffers resident on the card and ships only the changed spans:

  * merged dirty runs of at least ``SLICE_RUN_MIN`` elements (the
    per-tick time columns, whole-column dirty by design) are value-only
    ``copy_`` into views of the resident buffer;
  * the sparse remainder of each kind is one ``index_copy_`` with a
    deduplicated int64 index vector;
  * a kind whose sparse part covers half of it or more, a change of
    layout, or ``spans=None`` is a full upload.

An upload that fails on the card raises ``MirrorError``: callers that
degrade on other failures let it through, like ``KernelError`` — a card
that cannot take its uploads is a fault to fix, not work to move to the
host. The host copies here are synchronous: every upload comes from pageable
memory, so ``copy_`` returns only once the bytes have left the truth
buffer, and the host may change the truth for the next tick at once.
The returned buffers feed the packed solve directly (``ops/packing.py::
unpack`` takes device tensors in place).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

#: a merged dirty run at least this long ships as a slice update instead
#: of joining the index vector
SLICE_RUN_MIN = 64


class MirrorError(RuntimeError):
    """An upload of the device mirror failed on its device."""


def merge_spans(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sort and merge overlapping/adjacent ``[lo, hi)`` spans."""
    merged: List[Tuple[int, int]] = []
    for lo, hi in sorted(spans):
        if hi <= lo:
            continue
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def coalesce_spans(
    spans: List[Tuple[int, int]], total: int
) -> Optional[np.ndarray]:
    """Merge dirty ``[lo, hi)`` spans into one sorted, deduplicated index
    vector; None when they cover half of the buffer or more (a full
    upload is cheaper then)."""
    if not spans:
        return np.empty(0, np.int32)
    covered = sum(hi - lo for lo, hi in spans)
    if covered * 2 >= total:
        return None
    parts = [np.arange(lo, hi, dtype=np.int32) for lo, hi in spans if hi > lo]
    if not parts:
        return np.empty(0, np.int32)
    return np.unique(np.concatenate(parts))


def _upload(buf: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A device copy of ``buf`` that shares no memory with it (on the CPU
    too, where ``.to`` would alias the numpy buffer)."""
    return torch.tensor(np.ascontiguousarray(buf), device=dev)


class DeviceMirror:
    """Persistent device copies of the three typed arena buffers.

    ``sync(truth, spans)`` returns the device buffer dict to feed the
    packed solve. Counters: ``full_uploads`` (kinds uploaded whole, and
    cold syncs), ``slice_rows`` (elements shipped as slice runs),
    ``delta_rows`` (elements shipped through ``index_copy_``), and
    ``bytes_uploaded`` (host → device bytes, indices included).
    ``device`` is where the buffers live: None is the CUDA card, and
    ``sync`` raises without one; "cpu" is the CPU."""

    def __init__(self, device=None) -> None:
        self.device = device
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        self._shapes: Dict[str, int] = {}
        self.delta_rows = 0
        self.slice_rows = 0
        self.full_uploads = 0
        self.bytes_uploaded = 0

    def reset(self) -> None:
        """Drop the resident buffers: the next sync uploads in full."""
        self._bufs = None
        self._shapes = {}

    def sync(
        self,
        truth: Dict[str, np.ndarray],
        spans_by_kind: Optional[Dict[str, List[Tuple[int, int]]]],
    ) -> Dict[str, torch.Tensor]:
        """Bring the mirror to ``truth``; ``spans_by_kind`` lists each
        kind's dirty ``[lo, hi)`` spans since the last sync (None: a
        rebuild, everything is dirty). A copy that fails raises
        ``MirrorError``, and the next sync uploads in full."""
        dev = resolve_device(self.device)
        try:
            return self._sync(truth, spans_by_kind, dev)
        except RuntimeError as exc:
            self.reset()
            raise MirrorError(
                f"device mirror upload to {dev} failed: {exc}") from exc

    def _sync(self, truth, spans_by_kind, dev) -> Dict[str, torch.Tensor]:
        shapes = {k: len(v) for k, v in truth.items()}
        if self._bufs is None or shapes != self._shapes or spans_by_kind is None:
            self._bufs = {k: _upload(v, dev) for k, v in truth.items()}
            self._shapes = shapes
            self.full_uploads += 1
            self.bytes_uploaded += sum(v.nbytes for v in truth.values())
            return dict(self._bufs)
        for kind, buf in self._bufs.items():
            src = truth[kind]
            merged = merge_spans(spans_by_kind.get(kind, []))
            runs = [r for r in merged if r[1] - r[0] >= SLICE_RUN_MIN]
            sparse = [r for r in merged if r[1] - r[0] < SLICE_RUN_MIN]
            idx = coalesce_spans(sparse, shapes[kind])
            if idx is None:  # the sparse part alone dirtied too much
                self._bufs[kind] = _upload(src, dev)
                self.full_uploads += 1
                self.bytes_uploaded += src.nbytes
                continue
            for lo, hi in runs:
                buf[lo:hi].copy_(torch.from_numpy(src[lo:hi]))
                self.slice_rows += hi - lo
                self.bytes_uploaded += src[lo:hi].nbytes
            if len(idx):
                idx64 = idx.astype(np.int64)
                vals = src[idx64]
                buf.index_copy_(0, torch.from_numpy(idx64).to(dev),
                                torch.from_numpy(vals).to(dev))
                self.delta_rows += int(len(idx))
                self.bytes_uploaded += idx64.nbytes + vals.nbytes
        return dict(self._bufs)
