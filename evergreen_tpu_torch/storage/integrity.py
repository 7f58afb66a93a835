"""Storage integrity: CRC32 stamps on WAL lines, snapshot digests,
checksummed control documents and their atomic writer.

A copy of ``evergreen_tpu/storage/integrity.py``, byte for byte in what
it writes, so a WAL, a snapshot, a lease or a manifest entry written by
either package verifies in the other:

- every WAL line gains a trailing ``"k":"<crc32 hex>"`` over the line as
  it stood before the splice (``stamp_wal_line``); ``verify_wal_line``
  says ``None`` for an unstamped line (accepted), ``True`` for a match
  and ``False`` for corruption, which ends the WAL's valid prefix
  (``storage/durable.py``);
- a checkpoint records its snapshot's whole-file CRC (``file_crc32``)
  in the ``.meta`` sidecar, and a snapshot that fails it is moved aside
  by ``quarantine``;
- lease files and fleet-manifest entries carry a ``"k"`` CRC over their
  own canonical serialization and are published by tmp + rename
  (``atomic_write_json``).

The port stamps every WAL line: it has no switch to turn the stamp off
(the JAX package's ``set_wal_crc_enabled`` serves its measurement tools).
"""
from __future__ import annotations

import json
import os
import re
import time
import zlib
from typing import Optional

#: a stamped WAL line ends with the stamp, spliced after the ``"s"``
#: ordinal
_WAL_STAMP_RE = re.compile(r',"k":"([0-9a-f]{8})"\}$')

def crc32_hex(data) -> str:
    if isinstance(data, str):
        data = data.encode("utf-8")
    return "%08x" % (zlib.crc32(data) & 0xFFFFFFFF)


def stamp_wal_line(line: str) -> str:
    """Splice the CRC stamp into a serialized WAL line (which must end
    ``}``); the digest covers the line before the splice."""
    return '%s,"k":"%s"}' % (line[:-1], crc32_hex(line))


def verify_wal_line(line) -> Optional[bool]:
    """Verdict on one terminated WAL line (str or bytes, trailing newline
    tolerated): ``None`` = unstamped (accepted), ``True`` = the stamp
    matches, ``False`` = corrupt."""
    if isinstance(line, bytes):
        try:
            line = line.decode("utf-8")
        except UnicodeDecodeError:
            # a rotted byte can break the encoding itself: a line with a
            # stamp-shaped tail claims integrity it cannot prove
            return False if b'"k":"' in line else None
    line = line.rstrip("\n")
    m = _WAL_STAMP_RE.search(line)
    if m is None:
        return None
    return crc32_hex(line[: m.start()] + "}") == m.group(1)


def file_crc32(path: str) -> str:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return "%08x" % (crc & 0xFFFFFFFF)


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


def quarantine(path: str) -> Optional[str]:
    """Move a corrupt file aside as ``<path>.corrupt-<ms>`` (never
    deleted); returns where it went, or None if it was already gone."""
    dest = "%s.corrupt-%d" % (path, int(time.time() * 1000))
    try:
        os.replace(path, dest)
    except OSError:
        return None
    return dest


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
