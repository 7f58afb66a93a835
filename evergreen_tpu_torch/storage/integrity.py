"""Checksummed control documents and their atomic writer.

The part of ``evergreen_tpu/storage/integrity.py`` that the solver-leader
plane needs: lease files and fleet-manifest entries carry a ``"k"`` CRC32
over their own canonical serialization, and are published by tmp +
rename. The bytes are the JAX package's, so a lease or a manifest entry
written by either package verifies in the other.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Optional


def crc32_hex(data) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return "%08x" % (zlib.crc32(data) & 0xFFFFFFFF)


def stamped_doc(doc: dict) -> dict:
    """A copy of ``doc`` carrying a ``"k"`` CRC over its own canonical
    serialization (sorted keys, ``"k"`` excluded)."""
    body = {k: v for k, v in doc.items() if k != "k"}
    payload = dict(body)
    payload["k"] = crc32_hex(
        json.dumps(body, sort_keys=True, separators=(",", ":"), default=str)
    )
    return payload


def verify_doc(doc) -> Optional[bool]:
    """``None`` = no stamp (accepted), ``True`` = the stamp matches,
    ``False`` = corrupt."""
    if not isinstance(doc, dict) or "k" not in doc:
        return None
    return stamped_doc(doc)["k"] == doc["k"]


def corrupt_byte(path: str, offset: Optional[int] = None) -> None:
    """Flip one byte of ``path`` in place (the ``bitrot`` directive)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    if offset is None or not (0 <= offset < size):
        offset = size // 2
    with open(path, "r+b") as fh:
        fh.seek(offset)
        byte = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([byte[0] ^ 0xFF]))
        fh.flush()
        os.fsync(fh.fileno())


def atomic_write_json(
    path: str,
    doc: dict,
    seam: Optional[str] = None,
    tmp_tag: Optional[str] = None,
    fsync: bool = False,
) -> dict:
    """Write ``doc`` plus its ``"k"`` stamp to ``path`` by tmp + rename.

    ``seam`` names a ``utils/faults.py`` seam fired with the tmp file
    open: an injected ``enospc``/``eio`` raises from inside the write and
    the tmp is unlinked; ``short`` truncates the tmp before the rename and
    ``bitrot`` flips a byte after it, both caught by ``verify_doc`` on
    read. Returns the stamped payload."""
    payload = stamped_doc(doc)
    tmp = "%s.%s" % (path, tmp_tag or "tmp")
    directive = None
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            if seam:
                from ..utils import faults

                directive = faults.fire(seam)
            json.dump(payload, fh, separators=(",", ":"), default=str)
            fh.flush()
            if fsync:
                os.fsync(fh.fileno())
        if directive == "short":
            size = os.path.getsize(tmp)
            with open(tmp, "r+b") as fh:
                fh.truncate(max(1, size // 2))
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if directive == "bitrot":
        corrupt_byte(path)
    return payload
