"""Solver-leader plane: one card serving N worker processes.

Counterpart of ``evergreen_tpu/runtime/solver.py``, with the same wire
format, so either package's leader serves either package's workers:

  * the LEADER (``SolverService``) holds the ``solver.lease`` FileLease
    and runs one stacked solve per fleet round on the card
    (``parallel/sharded.py::StackedSolveCache``);
  * each WORKER (``SolverClient``) publishes its packed snapshot arenas
    into a per-shard ``multiprocessing.shared_memory`` segment and reads
    its solved block back from the same segment;
  * every publication and every returned block carries an epoch and
    sequence header and a CRC32, so a torn or stale write is detected and
    that shard falls back to its local solve.

Failure ladder (a per-round, per-shard decision):

    stacked           the leader validated the publication and solved it,
                      and the worker validated the returned block
    local:<cause>     anything else (timeout / capacity / stale-epoch /
                      torn-result / declined:*): the worker runs
                      ``run_solve_packed`` on the same snapshot

A deposed leader's writes carry a superseded epoch and are rejected at
the segment header; a successor steals ``solver.lease`` at a strictly
higher epoch. Segments are named per (data_dir, shard), registered in
the fleet manifest (``shm`` + ``shm_bytes``), unlinked on a clean worker
exit and reaped from dead pids by ``reap_orphan_segments``.

The fleet supervisor (``runtime/supervisor.py``) is the leader of its
workers: it builds ``SolverService(..., supervisor=self)``, and serving
stops at the next seam check once that supervisor has crashed or been
deposed. Not ported: the zero-copy publish through an arena pool
(``SolverClient.arena_backing``; the port's client copies into its
segment, or syncs dirty spans through ``ShmResidentSink``, and both give
the same documents), and the process-wide metrics registry (the
per-instance counters ``fallbacks``, ``round_outcomes`` and
``stale_accepted`` are kept).
"""
from __future__ import annotations

import hashlib
import os
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..ops.packing import _DTYPES
from ..ops.solve import OUTPUT_SPEC, run_solve_packed, with_output_dims
from ..parallel.sharded import StackedSolveCache
from ..scheduler.snapshot import _DIM_OF_FIELD, _FIXED_DIMS, FIELD_KINDS
from ..storage.lease import FileLease, solver_lease_path
from ..utils import faults
from . import manifest

# --------------------------------------------------------------------------- #
# segment wire format
# --------------------------------------------------------------------------- #

_MAGIC = 0x45564753  # "EVGS"
#: version 2: the shape key carries 8 dims (N, M, U, G, H, D, P, C); a
#: reader of another version rejects the segment outright
_VERSION = 2

#: header slots (uint64 each); the header is one 256-byte page so the
#: payload regions start 8-aligned
H_MAGIC, H_VERSION, H_STATE, H_EPOCH, H_SEQ = 0, 1, 2, 3, 4
H_SHAPE = 5  # 5..12: shape key (N, M, U, G, H, D, P, C)
H_N_F32, H_N_I32, H_N_U8, H_IN_CRC = 13, 14, 15, 16
H_OUT_EPOCH, H_OUT_SEQ, H_OUT_N_I32, H_OUT_N_F32, H_OUT_CRC = (
    17, 18, 19, 20, 21,
)
H_DECLINE = 22
H_CAP_F32, H_CAP_I32, H_CAP_U8, H_CAP_OUT = 23, 24, 25, 26
HEADER_SLOTS = 32
HEADER_BYTES = HEADER_SLOTS * 8

#: publication / result states
S_IDLE, S_PUBLISHED, S_SOLVED, S_DECLINED = 0, 1, 2, 3

#: decline causes (leader → worker), code ↔ cause
DECLINE_CAUSES = {
    1: "shape-drift",
    2: "partial",
    3: "torn-publication",
    4: "leader-abort",
}
_DIM_NAMES = ("N", "M", "U", "G", "H", "D", "P", "C")


def segment_name(data_dir: str, shard: int) -> str:
    """Deterministic per-(data_dir, shard) segment name, so a restarted
    worker or a successor leader finds the segment by name alone."""
    digest = hashlib.sha1(
        os.path.abspath(data_dir).encode()
    ).hexdigest()[:10]
    return f"evg-sol-{digest}-{shard}"


def sizes_for_dims(dims: Dict[str, int]) -> Dict[str, int]:
    """Element totals per arena kind of the FIELD_KINDS layout at
    ``dims`` (the fixed P/C dims filled in when absent)."""
    dims = {**_FIXED_DIMS, **dims}
    sizes = {"f32": 0, "i32": 0, "u8": 0}
    for name, kind in FIELD_KINDS.items():
        sizes[kind] += dims[_DIM_OF_FIELD[name[:2]]]
    return sizes


def out_elems_for_dims(dims: Dict[str, int]) -> Tuple[int, int]:
    """(i32 elements, f32 elements) of the result block at ``dims``, in
    the OUTPUT_SPEC layout."""
    dims = with_output_dims(dims)
    n_i32 = sum(dims[d] for _, kind, d in OUTPUT_SPEC if kind == "i32")
    n_f32 = sum(dims[d] for _, kind, d in OUTPUT_SPEC if kind == "f32")
    return n_i32, n_f32


def _crc(arrays) -> int:
    c = 0
    for a in arrays:
        c = zlib.crc32(memoryview(np.ascontiguousarray(a)).cast("B"), c)
    return c & 0xFFFFFFFF


def _unregister_from_tracker(name: str) -> None:
    """Keep the segment's lifetime ours: Python's resource_tracker would
    otherwise unlink it when the creating (or, on 3.10+, attaching)
    process exits, under a live worker or leader."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(f"/{name}", "shared_memory")
    except Exception:  # pragma: no cover - tracker bookkeeping only
        pass


class Segment:
    """One shard's publication segment: header + three typed input
    regions + one packed output region, in one shared-memory block."""

    def __init__(self, shm, name: str, created: bool) -> None:
        self.shm = shm
        self.name = name
        self.created = created
        self.hdr = np.frombuffer(
            shm.buf, dtype=np.uint64, count=HEADER_SLOTS
        )

    # -- lifecycle --------------------------------------------------------- #

    @classmethod
    def create(cls, name: str, caps: Dict[str, int],
               cap_out: int) -> "Segment":
        from multiprocessing import shared_memory

        total = cls._total_bytes(caps, cap_out)
        try:
            shm = shared_memory.SharedMemory(
                name=name, create=True, size=total
            )
            created = True
        except FileExistsError:
            # a previous incarnation left one behind: reuse it when big
            # enough, else replace it
            shm = shared_memory.SharedMemory(name=name)
            if shm.size >= total:
                created = False
            else:
                shm.close()
                stale = shared_memory.SharedMemory(name=name)
                stale.unlink()
                stale.close()
                shm = shared_memory.SharedMemory(
                    name=name, create=True, size=total
                )
                created = True
        _unregister_from_tracker(name)
        seg = cls(shm, name, created)
        seg.hdr[:] = 0
        seg.hdr[H_MAGIC] = _MAGIC
        seg.hdr[H_VERSION] = _VERSION
        seg.hdr[H_CAP_F32] = caps["f32"]
        seg.hdr[H_CAP_I32] = caps["i32"]
        seg.hdr[H_CAP_U8] = caps["u8"]
        seg.hdr[H_CAP_OUT] = cap_out
        return seg

    @classmethod
    def attach(cls, name: str) -> Optional["Segment"]:
        from multiprocessing import shared_memory

        try:
            shm = shared_memory.SharedMemory(name=name)
        except (FileNotFoundError, OSError):
            return None
        _unregister_from_tracker(name)  # 3.10+ registers on attach too
        seg = cls(shm, name, False)
        if (int(seg.hdr[H_MAGIC]) != _MAGIC
                or int(seg.hdr[H_VERSION]) != _VERSION):
            seg.close()
            return None
        return seg

    @staticmethod
    def _total_bytes(caps: Dict[str, int], cap_out: int) -> int:
        u8_padded = (caps["u8"] + 7) & ~7  # 8-align the out region
        return (
            HEADER_BYTES
            + caps["f32"] * 4 + caps["i32"] * 4 + u8_padded
            + cap_out * 4
        )

    def close(self) -> None:
        # drop our numpy view before shm.close(): SharedMemory raises
        # BufferError while exported views are alive
        self.hdr = None
        try:
            self.shm.close()
        except (OSError, BufferError, ValueError):
            # payload views are still alive elsewhere (a resident sink):
            # drop the fd now and neutralise the handle so a GC-time
            # __del__ cannot raise; the mapping dies with the last view
            shm = self.shm
            fd = getattr(shm, "_fd", -1)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                shm._fd = -1
            shm._mmap = None
            shm._buf = None

    def unlink(self) -> None:
        # balance the unregister that SharedMemory.unlink is about to
        # send: a tracker that never heard of the name prints a KeyError
        try:
            from multiprocessing import resource_tracker

            resource_tracker.register(f"/{self.name}", "shared_memory")
        except Exception:  # pragma: no cover - tracker bookkeeping only
            pass
        try:
            self.shm.unlink()
        except (FileNotFoundError, OSError):
            pass

    # -- regions ------------------------------------------------------------ #

    @property
    def caps(self) -> Dict[str, int]:
        return {
            "f32": int(self.hdr[H_CAP_F32]),
            "i32": int(self.hdr[H_CAP_I32]),
            "u8": int(self.hdr[H_CAP_U8]),
        }

    @property
    def cap_out(self) -> int:
        return int(self.hdr[H_CAP_OUT])

    def _offsets(self) -> Dict[str, int]:
        caps = self.caps
        off_f32 = HEADER_BYTES
        off_i32 = off_f32 + caps["f32"] * 4
        off_u8 = off_i32 + caps["i32"] * 4
        off_out = off_u8 + ((caps["u8"] + 7) & ~7)
        return {"f32": off_f32, "i32": off_i32, "u8": off_u8,
                "out": off_out}

    def region(self, kind: str, n: Optional[int] = None) -> np.ndarray:
        """A prefix view of one typed input region (``n`` elements, or
        the full capacity)."""
        offs = self._offsets()
        caps = self.caps
        n = caps[kind] if n is None else n
        return np.frombuffer(
            self.shm.buf, dtype=_DTYPES[kind], count=n, offset=offs[kind]
        )

    def out_region(self, n: Optional[int] = None) -> np.ndarray:
        offs = self._offsets()
        n = self.cap_out if n is None else n
        return np.frombuffer(
            self.shm.buf, dtype=np.int32, count=n, offset=offs["out"]
        )

    def shape_key(self) -> Tuple[int, ...]:
        return tuple(
            int(self.hdr[H_SHAPE + i]) for i in range(len(_DIM_NAMES))
        )


def input_arrays(seg: Segment, dims: Dict[str, int]) -> Dict[str, np.ndarray]:
    """The named snapshot arrays over a segment's input regions at
    ``dims`` (the FIELD_KINDS order fixes the layout); u8 fields come
    back as bool views."""
    dims = {**_FIXED_DIMS, **dims}
    sizes = sizes_for_dims(dims)
    regions = {kind: seg.region(kind, n) for kind, n in sizes.items()}
    offs = {"f32": 0, "i32": 0, "u8": 0}
    out: Dict[str, np.ndarray] = {}
    for name, kind in FIELD_KINDS.items():
        size = dims[_DIM_OF_FIELD[name[:2]]]
        view = regions[kind][offs[kind]: offs[kind] + size]
        offs[kind] += size
        out[name] = view.view(np.bool_) if kind == "u8" else view
    return out


# --------------------------------------------------------------------------- #
# worker side
# --------------------------------------------------------------------------- #


class ShmResidentSink:
    """The resident plane's shared-memory publication target: ``sync``
    copies only the dirty spans of the truth buffers into the segment's
    input regions and hands back the segment views, so an unchanged
    round publishes no full repack (``full_syncs`` stays at the cold
    publication)."""

    def __init__(self, client: "SolverClient") -> None:
        self._client = client
        self._views: Optional[Dict[str, np.ndarray]] = None
        self._lens: Dict[str, int] = {}
        self.full_syncs = 0
        self.span_syncs = 0
        self.bytes_synced = 0

    def sync(self, truth_bufs: Dict[str, np.ndarray],
             spans: Optional[Dict[str, List[Tuple[int, int]]]]):
        lens = {k: len(v) for k, v in truth_bufs.items()}
        seg = self._client.ensure_capacity(lens)
        if seg is None:
            return None  # the segment cannot host these dims
        if self._views is None or self._lens != lens:
            self._views = {
                kind: seg.region(kind, max(n, 1))
                for kind, n in lens.items()
            }
            self._lens = dict(lens)
            spans = None  # fresh views: the one full publication
        if spans is None:
            for kind, src in truth_bufs.items():
                np.copyto(self._views[kind][: len(src)], src)
                self.bytes_synced += src.nbytes
            self.full_syncs += 1
        else:
            for kind, ranges in spans.items():
                dst, src = self._views[kind], truth_bufs[kind]
                for start, end in ranges:
                    np.copyto(dst[start:end], src[start:end])
                    self.bytes_synced += src[start:end].nbytes
            self.span_syncs += 1
        return self._views

    def owns(self, bufs) -> bool:
        return self._views is not None and bufs is self._views


class SolverClient:
    """Worker-side half of the solver-leader plane (one per shard).
    Its local fallback solves on ``device`` (None: the CUDA card, which
    raises without one; "cpu" for the CPU)."""

    #: poll cadence while waiting for the leader's result
    _POLL_S = 0.002

    def __init__(self, data_dir: str, shard: int,
                 on_segment_change=None, device=None) -> None:
        self.data_dir = data_dir
        self.shard = shard
        self.name = segment_name(data_dir, shard)
        self.device = device
        self._seg: Optional[Segment] = None
        self._sink: Optional[ShmResidentSink] = None
        #: highest solver epoch this worker has observed: publications
        #: stamp it, and a result block below it is a stale leader's
        self.epoch_seen = 0
        #: outcome of the most recent round: "stacked" or "local"
        self.last_solve = "none"
        self.last_cause = ""
        self.fallbacks: Dict[str, int] = {}
        #: stale-epoch result blocks accepted (the fence held iff 0)
        self.stale_accepted = 0
        #: called with (name, nbytes) after a create or a growth, so the
        #: worker can refresh its manifest entry
        self._on_segment_change = on_segment_change

    # -- segment management ------------------------------------------------- #

    def ensure_capacity(self, sizes: Dict[str, int],
                        dims: Optional[Dict[str, int]] = None
                        ) -> Optional[Segment]:
        """Make the segment exist and fit ``sizes`` (element totals per
        kind). Growth replaces the segment (unlink + create at the new
        caps); the old mapping lives on in this process while its views
        do."""
        need = {k: int(sizes.get(k, 0)) for k in ("f32", "i32", "u8")}
        if self._seg is not None:
            caps = self._seg.caps
            if all(need[k] <= caps[k] for k in need):
                return self._seg
            self._seg.unlink()
            self._seg.close()
            self._seg = None
            self._sink = None
        # headroom so steady dim-bucket churn does not thrash recreation
        caps = {k: max(int(v * 5 // 4), 1) for k, v in need.items()}
        if dims is not None:
            n_i32, n_f32 = out_elems_for_dims(dims)
            cap_out = (n_i32 + n_f32) * 5 // 4
        else:
            # every output column is one of N/G/D, each at most the i32
            # input total
            cap_out = max(caps["i32"] * 4, 1024)
        try:
            self._seg = Segment.create(self.name, caps, cap_out)
        except OSError:
            return None
        if self._on_segment_change is not None:
            self._on_segment_change(self.name, self._seg.shm.size)
        return self._seg

    def resident_sink(self) -> ShmResidentSink:
        """The resident-plane hook: dirty spans sync straight into the
        segment."""
        if self._sink is None:
            self._sink = ShmResidentSink(self)
        return self._sink

    def close(self, unlink: bool) -> None:
        if self._seg is not None:
            if unlink:
                self._seg.unlink()
            self._seg.close()
            self._seg = None
            self._sink = None

    # -- the per-round solve_fn --------------------------------------------- #

    def _fallback(self, cause: str):
        self.last_solve = "local"
        self.last_cause = cause
        self.fallbacks[cause] = self.fallbacks.get(cause, 0) + 1
        return None

    def solve_fn(self, epoch: int, seq: int, timeout_s: float):
        """A solve function bound to one fleet round: publish, wait for
        the leader's block, validate, unpack; or return the local
        ``run_solve_packed`` result with the cause counted. Never raises
        for solver-plane reasons: the local solve is the floor."""
        self.epoch_seen = max(self.epoch_seen, int(epoch))

        def solve(snapshot):
            out = self._try_stacked(snapshot, int(epoch), int(seq),
                                    float(timeout_s))
            if out is not None:
                return out
            return run_solve_packed(snapshot, device=self.device)

        return solve

    def _try_stacked(self, snapshot, epoch: int, seq: int,
                     timeout_s: float) -> Optional[Dict]:
        if epoch < self.epoch_seen:
            return self._fallback("stale-epoch")
        bufs = snapshot.arena.buffers
        sizes = {k: len(v) for k, v in bufs.items()}
        key = snapshot.shape_key()
        dims = dict(zip(_DIM_NAMES, key))
        seg = self.ensure_capacity(sizes, dims)
        if seg is None:
            return self._fallback("capacity")
        n_i32, n_f32 = out_elems_for_dims(dims)
        if n_i32 + n_f32 > seg.cap_out:
            return self._fallback("capacity")

        # -- publish -------------------------------------------------------- #
        hdr = seg.hdr
        hdr[H_STATE] = S_IDLE
        if not (self._sink is not None and self._sink.owns(bufs)):
            for kind in ("f32", "i32", "u8"):
                n = sizes.get(kind, 0)
                if n:
                    np.copyto(seg.region(kind, n), bufs[kind])
        for i, v in enumerate(key):
            hdr[H_SHAPE + i] = v
        hdr[H_N_F32] = sizes.get("f32", 0)
        hdr[H_N_I32] = sizes.get("i32", 0)
        hdr[H_N_U8] = sizes.get("u8", 0)
        hdr[H_IN_CRC] = _crc(
            seg.region(k, sizes.get(k, 0)) for k in ("f32", "i32", "u8")
            if sizes.get(k, 0)
        )
        hdr[H_EPOCH] = epoch
        hdr[H_SEQ] = seq
        hdr[H_STATE] = S_PUBLISHED  # last: readers gate on this

        # -- await the leader ------------------------------------------------ #
        deadline = time.monotonic() + timeout_s
        while True:
            state = int(hdr[H_STATE])
            if state in (S_SOLVED, S_DECLINED):
                out_epoch = int(hdr[H_OUT_EPOCH])
                out_seq = int(hdr[H_OUT_SEQ])
                if out_seq != seq:
                    # a stale round's leftover write took the state slot;
                    # the payload is untouched, so re-arm and keep waiting
                    hdr[H_STATE] = S_PUBLISHED
                elif out_epoch < epoch:
                    # a stale leader wrote after a newer epoch was issued
                    hdr[H_STATE] = S_PUBLISHED
                else:
                    self.epoch_seen = max(self.epoch_seen, out_epoch)
                    if state == S_DECLINED:
                        cause = DECLINE_CAUSES.get(
                            int(hdr[H_DECLINE]), "declined"
                        )
                        return self._fallback(f"declined:{cause}")
                    out = self._read_result(seg, dims, epoch, seq)
                    if out is not None:
                        self.last_solve = "stacked"
                        self.last_cause = ""
                        return out
                    return self._fallback("torn-result")
            if time.monotonic() >= deadline:
                return self._fallback("timeout")
            time.sleep(self._POLL_S)

    def _read_result(self, seg: Segment, dims: Dict[str, int],
                     epoch: int, seq: int) -> Optional[Dict]:
        hdr = seg.hdr
        n_i32 = int(hdr[H_OUT_N_I32])
        n_f32 = int(hdr[H_OUT_N_F32])
        if (n_i32, n_f32) != out_elems_for_dims(dims):
            return None
        block = np.array(seg.out_region(n_i32 + n_f32), copy=True)
        # validate after copying: an overwrite between the check and the
        # copy cannot hand over a half-new block unnoticed
        if _crc([block]) != int(hdr[H_OUT_CRC]):
            return None
        if int(hdr[H_OUT_SEQ]) != seq:
            return None
        if int(hdr[H_OUT_EPOCH]) < epoch:
            # unreachable while the pre-copy fence holds
            self.stale_accepted += 1
            return None
        dims = with_output_dims(dims)
        halves = {"i32": block[:n_i32], "f32": block[n_i32:].view(np.float32)}
        out: Dict[str, np.ndarray] = {}
        offs = {"i32": 0, "f32": 0}
        for name, kind, dim in OUTPUT_SPEC:
            size = dims[dim]
            out[name] = halves[kind][offs[kind]: offs[kind] + size]
            offs[kind] += size
        return out


# --------------------------------------------------------------------------- #
# leader side
# --------------------------------------------------------------------------- #


class SolverService:
    """Leader-side half: holds ``solver.lease`` and the card, and serves
    one stacked solve per fleet round over the workers' shared-memory
    publications. ``device=None`` is the CUDA card and raises without
    one; pass ``device="cpu"`` for the CPU."""

    #: poll cadence while collecting publications
    _POLL_S = 0.005
    #: rounds between re-probes of the common-dims floor
    _FLOOR_REPROBE_ROUNDS = 32

    def __init__(self, data_dir: str, n_shards: int, *,
                 lease_ttl_s: float = 5.0, timeout_s: float = 10.0,
                 device=None, supervisor=None) -> None:
        self.device = resolve_device(device)
        #: the fleet supervisor this leader serves, if any: serving stops
        #: once it has crashed or been deposed
        self._sup = supervisor
        self.data_dir = data_dir
        self.n_shards = n_shards
        self.timeout_s = timeout_s
        self.lease = FileLease(
            solver_lease_path(data_dir), ttl_s=lease_ttl_s
        )
        self._lost = False
        self._segments: Dict[int, Tuple[Segment, tuple]] = {}
        self._cache = StackedSolveCache(self.device)
        self.common_dims: Optional[Dict[str, int]] = None
        self._floor_rounds = 0
        self.seq = 0
        self.last_outcome = "none"
        self.round_outcomes: Dict[str, int] = {}

    # -- election ------------------------------------------------------------ #

    def acquire(self, timeout_s: Optional[float] = None) -> bool:
        """Take (or steal after TTL expiry, at a strictly higher epoch)
        the solver lease. Failure only disables the stacked path."""
        budget = (
            self.lease.ttl_s * 3 + 2.0 if timeout_s is None else timeout_s
        )
        if not self.lease.acquire(timeout_s=budget, poll_s=0.25):
            return False
        self._lost = False
        self.lease.start_renewing(on_lost=self._deposed)
        return True

    def _deposed(self) -> None:
        # a newer leader exists: serving stops at the next seam check;
        # the workers' header fence rejects anything still written
        self._lost = True

    @property
    def epoch(self) -> int:
        return self.lease.epoch if not self._lost else 0

    def leading(self) -> bool:
        return self.lease.epoch > 0 and not self._lost

    def stamp(self) -> Optional[dict]:
        """The per-round solver field of a round command; None when the
        stacked path is unavailable."""
        if not self.leading():
            return None
        self.seq += 1
        out = {
            "epoch": self.lease.epoch,
            "seq": self.seq,
            "timeout_s": self.timeout_s,
        }
        if self.common_dims is not None:
            self._floor_rounds += 1
            if self._floor_rounds >= self._FLOOR_REPROBE_ROUNDS:
                self.common_dims = None
                self._floor_rounds = 0
            else:
                out["dims"] = self.common_dims
        return out

    # -- serving ------------------------------------------------------------- #

    def _aborted(self) -> bool:
        if self._lost:
            return True
        sup = self._sup
        if sup is not None and (sup.crashed or sup.deposed):
            return True
        if self.lease.superseded():
            self._deposed()
            return True
        return False

    def _segment(self, shard: int) -> Optional[Segment]:
        entry = manifest.read_entry(self.data_dir, shard)
        if entry is None or not entry.get("shm"):
            return None
        # a mapping is reused only for the worker that registered it: a
        # restarted worker makes a new segment under the same name, often
        # of the same size (the JAX package keys on the size alone)
        want = (entry["shm"], int(entry.get("shm_bytes", 0)),
                int(entry.get("pid", 0)))
        cached = self._segments.get(shard)
        if cached is not None and cached[1] == want:
            return cached[0]
        if cached is not None:
            cached[0].close()
            self._segments.pop(shard, None)
        seg = Segment.attach(entry["shm"])
        if seg is None:
            return None
        self._segments[shard] = (seg, want)
        return seg

    def serve_round(self, shards: List[int], seq: Optional[int] = None,
                    budget_s: Optional[float] = None) -> str:
        """Serve one fleet round: collect the publications stamped
        (epoch, seq), solve them stacked, return each shard its block.
        Returns the outcome; every early exit leaves the affected workers
        to their local fallback, never a corrupted block."""
        seq = self.seq if seq is None else seq
        budget = self.timeout_s if budget_s is None else budget_s
        outcome = self._serve(shards, seq, budget)
        self.last_outcome = outcome
        self.round_outcomes[outcome] = (
            self.round_outcomes.get(outcome, 0) + 1
        )
        return outcome

    def _serve(self, shards: List[int], seq: int, budget: float) -> str:
        faults.fire("solver.round")
        if self._aborted():
            return "aborted"
        epoch = self.lease.epoch
        # collect every expected publication, leaving ~1/4 of the budget
        # for the solve and the return
        deadline = time.monotonic() + budget * 0.75
        pending = set(shards)
        pubs: Dict[int, Segment] = {}
        while pending and time.monotonic() < deadline:
            for shard in sorted(pending):
                seg = self._segment(shard)
                if seg is None:
                    continue
                hdr = seg.hdr
                if int(hdr[H_STATE]) != S_PUBLISHED:
                    continue
                if (int(hdr[H_SEQ]), int(hdr[H_EPOCH])) != (seq, epoch):
                    continue  # another round's, or another epoch's
                pubs[shard] = seg
                pending.discard(shard)
            if pending:
                if self._aborted():
                    return "aborted"
                time.sleep(self._POLL_S)
        faults.fire("solver.publish")
        if self._aborted():
            return "aborted"
        if not pubs:
            return "idle"
        partial = bool(pending)

        # validate checksums and shape agreement
        valid: Dict[int, Segment] = {}
        for shard, seg in pubs.items():
            sizes = {
                "f32": int(seg.hdr[H_N_F32]),
                "i32": int(seg.hdr[H_N_I32]),
                "u8": int(seg.hdr[H_N_U8]),
            }
            crc = _crc(
                seg.region(k, n) for k, n in sizes.items() if n
            )
            if crc != int(seg.hdr[H_IN_CRC]):
                self._decline(seg, seq, 3)  # torn-publication
            else:
                valid[shard] = seg
        if len(valid) < 2:
            # a one-shard stack is a local solve with extra steps
            for seg in valid.values():
                self._decline(seg, seq, 2)  # partial
            return "declined"
        keys = {shard: seg.shape_key() for shard, seg in valid.items()}
        if len(set(keys.values())) > 1:
            self.common_dims = {
                name: max(int(keys[s][i]) for s in valid)
                for i, name in enumerate(_DIM_NAMES)
            }
            self._floor_rounds = 0
            for seg in valid.values():
                self._decline(seg, seq, 1)  # shape-drift
            return "declined"
        dims = dict(zip(_DIM_NAMES, next(iter(keys.values()))))
        if self.common_dims is None:
            self.common_dims = dims
            self._floor_rounds = 0

        blocks = {
            shard: input_arrays(seg, dims)
            for shard, seg in valid.items()
        }
        try:
            solved = self._cache.solve_blocks(blocks)
        except Exception:
            for seg in valid.values():
                self._decline(seg, seq, 4)  # leader-abort
            return "declined"
        faults.fire("solver.solve")
        if self._aborted():
            return "aborted"

        first = True
        for shard in sorted(valid):
            if self._aborted():
                # stop writing the moment a newer epoch exists; the other
                # shards fall back locally
                return "aborted"
            self._write_result(valid[shard], solved[shard], dims, seq)
            if first:
                faults.fire("solver.return")
                first = False
        return "partial" if partial else "stacked"

    def _decline(self, seg: Segment, seq: int, cause: int) -> None:
        if self._aborted():
            return
        hdr = seg.hdr
        hdr[H_DECLINE] = cause
        hdr[H_OUT_EPOCH] = self.lease.epoch
        hdr[H_OUT_SEQ] = seq
        hdr[H_STATE] = S_DECLINED

    def _write_result(self, seg: Segment, outputs: Dict,
                      dims: Dict[str, int], seq: int) -> None:
        n_i32, n_f32 = out_elems_for_dims(dims)
        block = seg.out_region(n_i32 + n_f32)
        block[:n_i32] = np.concatenate([
            np.asarray(outputs[name], dtype=np.int32)
            for name, kind, _ in OUTPUT_SPEC if kind == "i32"
        ])
        block[n_i32:] = np.concatenate([
            np.asarray(outputs[name], dtype=np.float32)
            for name, kind, _ in OUTPUT_SPEC if kind == "f32"
        ]).view(np.int32)
        hdr = seg.hdr
        hdr[H_OUT_N_I32] = n_i32
        hdr[H_OUT_N_F32] = n_f32
        hdr[H_OUT_CRC] = _crc([block])
        hdr[H_OUT_EPOCH] = self.lease.epoch
        hdr[H_OUT_SEQ] = seq
        hdr[H_STATE] = S_SOLVED  # last: the worker gates on this

    # -- teardown ------------------------------------------------------------ #

    def detach(self) -> None:
        """Drop the mappings without releasing the lease (a crash: the
        successor must steal at a higher epoch)."""
        self.lease.stop_renewing()
        for seg, _ in self._segments.values():
            seg.close()
        self._segments.clear()

    def stop(self, release: bool = True) -> None:
        self.lease.stop_renewing()
        if release and not self._lost:
            try:
                self.lease.release()
            except OSError:
                pass
        for seg, _ in self._segments.values():
            seg.close()
        self._segments.clear()


# --------------------------------------------------------------------------- #
# hygiene
# --------------------------------------------------------------------------- #


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    return True


def reap_orphan_segments(data_dir: str, n_shards: int) -> List[str]:
    """Unlink solver segments whose creating worker is dead: manifest
    entries with a dead pid, and deterministically named segments whose
    entry vanished. Run by a starting leader before workers spawn;
    returns the reaped names."""
    entries = manifest.read_all(data_dir)
    reaped: List[str] = []
    for shard in range(n_shards):
        name = segment_name(data_dir, shard)
        entry = entries.get(shard)
        registered = entry.get("shm") if entry else None
        live = entry is not None and _pid_alive(int(entry.get("pid", 0)))
        if live:
            continue
        for cand in {c for c in (name, registered) if c}:
            seg = Segment.attach(cand)
            if seg is None:
                continue
            seg.unlink()
            seg.close()
            reaped.append(cand)
    return reaped
