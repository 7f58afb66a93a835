"""Fleet manifest: how the solver leader finds each shard's
shared-memory segment, and how a restarted supervisor finds live workers.

A copy of ``evergreen_tpu/runtime/manifest.py``. Each shard worker
records itself under ``<data_dir>/fleet/shard<k>.json`` (pid, spawn
generation, shard-lease epoch, the path of its re-attachable control
socket, and its solver segment's name and size), written atomically with
a ``"k"`` CRC stamp, so a supervisor that crashed and came back can
**adopt** the still-running worker over the socket instead of
cold-respawning it (``runtime/supervisor.py::_try_adopt``). The entry
format is the JAX package's, so either package's leader or supervisor
reads either package's workers.

The control socket is a unix-domain socket. Its path lives in the system
temp dir keyed by a hash of the data dir (not inside the data dir),
because ``sun_path`` is limited to ~107 bytes; the manifest entry records
the real path.
"""
from __future__ import annotations

import hashlib
import json
import os
import socket
import tempfile
from typing import Dict, Optional

from ..storage import integrity

#: subdirectory of the data dir holding one entry file per shard
FLEET_DIR = "fleet"


def fleet_dir(data_dir: str) -> str:
    return os.path.join(data_dir, FLEET_DIR)


def entry_path(data_dir: str, shard: int) -> str:
    return os.path.join(fleet_dir(data_dir), f"shard{shard}.json")


def socket_path(data_dir: str, shard: int) -> str:
    """A per-(data dir, shard) UDS path short enough for sun_path."""
    key = hashlib.sha1(
        os.path.abspath(data_dir).encode("utf-8")
    ).hexdigest()[:10]
    return os.path.join(
        tempfile.gettempdir(), f"evg-fleet-{key}-{shard}.sock"
    )


def write_entry(data_dir: str, shard: int, *, pid: int, sock: str,
                generation: int, epoch: int, shm: str = "",
                shm_bytes: int = 0) -> None:
    """Atomically record one worker (tmp + rename, CRC-stamped; the
    ``manifest.write`` fault seam fires mid-write)."""
    os.makedirs(fleet_dir(data_dir), exist_ok=True)
    integrity.atomic_write_json(
        entry_path(data_dir, shard),
        {
            "shard": shard,
            "pid": pid,
            "sock": sock,
            "generation": generation,
            "epoch": epoch,
            "shm": shm,
            "shm_bytes": shm_bytes,
        },
        seam="manifest.write",
        tmp_tag=str(pid),
    )


def read_entry(data_dir: str, shard: int) -> Optional[dict]:
    """One shard's entry, or None when it is absent, unreadable or
    fails its CRC."""
    try:
        with open(entry_path(data_dir, shard), encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if integrity.verify_doc(doc) is False:
        return None
    return doc if isinstance(doc, dict) and doc.get("pid") else None


def read_all(data_dir: str) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(fleet_dir(data_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("shard") and name.endswith(".json")):
            continue
        try:
            shard = int(name[len("shard"):-len(".json")])
        except ValueError:
            continue
        entry = read_entry(data_dir, shard)
        if entry is not None:
            out[shard] = entry
    return out


def remove_entry(data_dir: str, shard: int,
                 sock: Optional[str] = None) -> None:
    """Best-effort cleanup on a clean worker exit."""
    for path in (entry_path(data_dir, shard), sock):
        if not path:
            continue
        try:
            os.unlink(path)
        except OSError:
            pass


def connect(sock_path: str, timeout_s: float = 5.0) -> socket.socket:
    """Connect to a worker's control socket; raises OSError when the
    worker is gone (the adoption probe's failure path). The JAX package's
    ``sock.adopt`` transport-fault seam is left out with the other
    transport faults (``ipc.send`` / ``ipc.recv``)."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout_s)
    conn.connect(sock_path)
    conn.settimeout(None)
    return conn
