"""Loader of the evgpack C packer: built at first use, never in silence.

The port's counterpart of ``evergreen_tpu/utils/native.py``.
``csrc/evgpack.cpp`` (a byte-for-byte copy of ``native/evgpack/``'s
source) fills the snapshot's per-task columns, its planner-unit
memberships and its deps-met flags in C (``pack_task_static_columns``,
``build_memberships``, ``fill_deps_met``, ``pack_host_columns``). It is
compiled with ``g++`` against the CPython headers the first time a
snapshot needs it, into ``build/evgpack-<hash>.so`` (the hash covers the
source, the flags and the interpreter's ABI, so an edited source
rebuilds), under an exclusive ``flock`` on ``build/evgpack.lock`` so that
processes starting together compile it once. Nothing is built at import.

``EVG_DISABLE_NATIVE`` (any non-empty value) keeps the pure-Python packer,
as in the JAX package. Unlike the JAX loader, a fallback is never silent:
a failed build logs ``native-unavailable`` with the compiler's last lines,
and ``evgpack_status()`` says which packer runs: ``"native"``,
``"disabled"`` or ``"build-failed"``. The snapshot's buffers are
byte-identical either way (``scheduler/snapshot.py``).
"""
from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from typing import Optional

from . import lockcheck as _lockcheck
from .log import get_logger

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "evgpack.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = _lockcheck.make_lock("native.loader")
_module = None
_attempted = False
_status = "not-loaded"
#: the compiler's last lines when the build failed
build_error = ""


def _so_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(sysconfig.get_config_var("SOABI").encode() if
             sysconfig.get_config_var("SOABI") else sys.version.encode())
    return os.path.join(BUILD_DIR, f"evgpack-{h.hexdigest()[:16]}.so")


def _compile(out: str) -> str:
    """Build ``out``; returns "" or the compiler's last lines."""
    include = sysconfig.get_paths()["include"]
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *CXX_FLAGS, f"-I{include}", SOURCE, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return repr(exc)
    if r.returncode != 0:
        return (r.stderr or r.stdout)[-2000:] or f"g++ exited {r.returncode}"
    os.replace(tmp, out)
    return ""


def get_evgpack() -> Optional[object]:
    """The compiled evgpack module, or None: the pure-Python packer then
    runs, and ``evgpack_status()`` says why."""
    global _module, _attempted, _status, build_error
    if _attempted:
        return _module
    with _lock:
        if _attempted:
            return _module
        if os.environ.get("EVG_DISABLE_NATIVE"):
            _status = "disabled"
            _attempted = True
            return None
        try:
            so = _so_path()
            os.makedirs(BUILD_DIR, exist_ok=True)
            if not os.path.exists(so):
                with open(os.path.join(BUILD_DIR, "evgpack.lock"), "a") as fh:
                    fcntl.flock(fh, fcntl.LOCK_EX)
                    try:
                        if not os.path.exists(so):
                            build_error = _compile(so)
                    finally:
                        fcntl.flock(fh, fcntl.LOCK_UN)
            if not build_error:
                spec = importlib.util.spec_from_file_location("evgpack", so)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                _module = mod
        except (OSError, ImportError) as exc:
            build_error = build_error or repr(exc)
        if _module is None:
            _status = "build-failed"
            get_logger("native").error(
                "native-unavailable", packer="evgpack",
                fallback="pure-python", error=build_error[-1000:])
        else:
            _status = "native"
        _attempted = True
        return _module


def evgpack_status() -> str:
    """``"native"``, ``"disabled"`` (``EVG_DISABLE_NATIVE``) or
    ``"build-failed"``; asking builds the packer if no snapshot has."""
    get_evgpack()
    return _status
