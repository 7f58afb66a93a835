"""Solver sidecar: the packed solve behind a socket, on the CUDA card.

A non-Python control plane ships the snapshot's three arena buffers and
gets back queue orderings + spawn counts. The wire format is byte for
byte the JAX package's (``evergreen_tpu/api/sidecar.py``), so its
``SidecarClient`` and the C++ client in ``native/evgsolve`` talk to this
server unchanged; the arena layout is fully determined by the shape key.

Wire format (little-endian):
  request:  magic "EVGS" | u32 version=2 | 8×u32 shape key (N,M,U,G,H,D,P,C)
            | u64 n_f32 | f32 data | u64 n_i32 | i32 data | u64 n_u8 | u8 data
  response: u32 status (0=ok) |
            ok   → u64 n_i32 | i32 data | u64 n_f32 | f32 data
            err  → u32 msg_len | msg bytes

The capacity trip count rides in-band on the c_cfg page inside the f32
payload.
"""
from __future__ import annotations

import socket
import socketserver
import struct
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.solve import (
    _packed_solve,
    page_capacity_iters,
    result_to_host,
    split_packed,
    with_output_dims,
)
from ..scheduler.snapshot import layout_for_dims
from ..utils import lockcheck as _lockcheck

MAGIC = b"EVGS"
VERSION = 2

#: i32 index columns → the dim their values index into; checked before
#: upload, since an out-of-range index faults the device
_INDEX_FIELDS = {
    "t_distro": "D", "t_seg": "G", "m_task": "N", "m_unit": "U",
    "u_distro": "D", "g_distro": "D", "h_distro": "D", "h_seg": "G",
    "d_pool": "P",
}


def _read_exact(sock_file, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock_file.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _solve_buffers(
    shape: Tuple[int, ...],
    f32_buf: np.ndarray,
    i32_buf: np.ndarray,
    u8_buf: np.ndarray,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the packed solve on raw arena buffers; (i32 half, f32 half)."""
    dims = dict(zip("NMUGHDPC", shape))
    layout = layout_for_dims(dims)
    want = layout.sizes()
    got = {"f32": f32_buf.shape[0], "i32": i32_buf.shape[0], "u8": u8_buf.shape[0]}
    if want != got:
        raise ValueError(f"buffer sizes {got} do not match shape key (want {want})")
    for name, dim in _INDEX_FIELDS.items():
        _, off, size = layout.field(name)
        col = i32_buf[off: off + size]
        if size and (col.min() < 0 or col.max() >= dims[dim]):
            raise ValueError(f"{name} holds an index outside [0, {dims[dim]})")
    # the capacity trip count rides in-band on the c_cfg page
    _, c_off, c_size = layout.field("c_cfg")
    cap_iters = page_capacity_iters(f32_buf[c_off: c_off + c_size])
    bufs = {"f32": f32_buf, "i32": i32_buf, "u8": u8_buf}
    out = _packed_solve(bufs, layout.layout_key(), cap_iters, device)
    return split_packed(result_to_host(out), with_output_dims(dims))


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        while True:
            try:
                header = self.rfile.read(4)
            except ConnectionError:
                return
            if not header:
                return
            try:
                if header != MAGIC:
                    raise ValueError(f"bad magic {header!r}")
                (version,) = struct.unpack("<I", _read_exact(self.rfile, 4))
                if version != VERSION:
                    raise ValueError(f"unsupported protocol version {version}")
                shape = struct.unpack("<8I", _read_exact(self.rfile, 32))
                bufs = []
                for dtype, itemsize in ((np.float32, 4), (np.int32, 4), (np.uint8, 1)):
                    (count,) = struct.unpack("<Q", _read_exact(self.rfile, 8))
                    if count > 1 << 31:
                        raise ValueError(f"buffer too large: {count}")
                    data = _read_exact(self.rfile, count * itemsize)
                    bufs.append(np.frombuffer(data, dtype=dtype).copy())
                with self.server.solve_lock:
                    out_i32, out_f32 = _solve_buffers(shape, *bufs, self.server.device)
                self.wfile.write(struct.pack("<I", 0))
                self.wfile.write(struct.pack("<Q", out_i32.shape[0]))
                self.wfile.write(out_i32.astype("<i4").tobytes())
                self.wfile.write(struct.pack("<Q", out_f32.shape[0]))
                self.wfile.write(out_f32.astype("<f4").tobytes())
                self.wfile.flush()
            except (ValueError, ConnectionError, struct.error) as e:
                try:
                    msg = str(e).encode()[:4096]
                    self.wfile.write(struct.pack("<I", 1))
                    self.wfile.write(struct.pack("<I", len(msg)))
                    self.wfile.write(msg)
                    self.wfile.flush()
                except OSError:
                    pass
                return


class SidecarServer(socketserver.ThreadingTCPServer):
    """One server per device; connections are threads, solves take turns
    on the device."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, address: Tuple[str, int], device: torch.device) -> None:
        self.device = device
        self.solve_lock = _lockcheck.make_lock("sidecar.solve")
        super().__init__(address, _Handler)


def serve(host: str = "127.0.0.1", port: int = 9091, device=None) -> SidecarServer:
    """A bound server; ``device=None`` is the CUDA card (raises without
    one), ``device="cpu"`` the CPU."""
    return SidecarServer((host, port), resolve_device(device))


def serve_background(
    host: str = "127.0.0.1", port: int = 0, device=None
) -> Tuple[SidecarServer, int]:
    """``serve`` on a daemon thread; returns (server, bound port). Stop it
    with ``server.shutdown()`` and ``server.server_close()``."""
    server = serve(host, port, device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server, server.server_address[1]


class SidecarClient:
    """Python reference client."""

    def __init__(self, host: str, port: int) -> None:
        self.addr = (host, port)
        self._sock: Optional[socket.socket] = None

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=120)
            self._file = self._sock.makefile("rwb")
        return self._file

    def solve(self, snapshot) -> Tuple[np.ndarray, np.ndarray]:
        f = self._connect()
        bufs = snapshot.arena.buffers
        f.write(MAGIC)
        f.write(struct.pack("<I", VERSION))
        f.write(struct.pack("<8I", *snapshot.shape_key()))
        for kind, dtype in (("f32", "<f4"), ("i32", "<i4"), ("u8", "u1")):
            arr = np.ascontiguousarray(bufs[kind])
            f.write(struct.pack("<Q", arr.shape[0]))
            f.write(arr.astype(dtype).tobytes())
        f.flush()
        (status,) = struct.unpack("<I", _read_exact(f, 4))
        if status != 0:
            (mlen,) = struct.unpack("<I", _read_exact(f, 4))
            raise RuntimeError(
                f"sidecar error: {_read_exact(f, mlen).decode()}"
            )
        (n_i32,) = struct.unpack("<Q", _read_exact(f, 8))
        i32 = np.frombuffer(_read_exact(f, 4 * n_i32), dtype="<i4").copy()
        (n_f32,) = struct.unpack("<Q", _read_exact(f, 8))
        f32 = np.frombuffer(_read_exact(f, 4 * n_f32), dtype="<f4").copy()
        return i32, f32

    def close(self) -> None:
        if self._sock is not None:
            self._file.close()
            self._sock.close()
            self._sock = None
