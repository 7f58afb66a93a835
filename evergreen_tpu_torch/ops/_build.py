"""Build the package's CUDA kernels from ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exports plain C launch functions. It is compiled
with ``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so``
at first use (the hash covers the source and the flags, so an edited
source rebuilds) and loaded with ``ctypes``. Nothing is built or loaded
at import time; ``build`` compiles several sources in parallel, one
``nvcc`` process each. Processes that build at once (a fleet's leader and
its shard workers on one card) take an exclusive ``flock`` on
``build/lock`` around the compile and look for each library again once
they hold it, so each source is compiled once; each build writes the
compiler's report to a log of its own, named like its library, so a
failed build reports its own log.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

from ..utils import lockcheck as _lockcheck

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = _lockcheck.make_lock("ops.build")
_libs: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of the package failed to build, load or launch. Callers
    that degrade on other failures re-raise it: a card that cannot run
    its kernels is a fault to fix, not work to move to the host."""


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _flags(defines: Mapping[str, int]) -> Tuple[str, ...]:
    return tuple(f"-D{k}={v}" for k, v in sorted(defines.items()))


def _lib_path(name: str, defines: Mapping[str, int]) -> str:
    h = hashlib.sha256()
    with open(source_path(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + _flags(defines)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise KernelError(
            "nvcc not found: set CUDA_HOME to the CUDA toolkit to build "
            "the package's kernels"
        )
    return nvcc


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every source of ``names`` whose library is missing, all
    in parallel; returns each build's wall seconds (0.0 = already built).
    The compiler's resource report (registers, shared memory, spills)
    lands in ``build_log(name)``. Raises if any build fails."""
    names = list(names)
    return dict(zip(names, _compile([(name, {}) for name in names])))


def build_variants(variants: Sequence[Tuple[str, Mapping[str, int]]]) -> List[str]:
    """Compile ``csrc/<name>.cu`` for each ``(name, defines)`` of
    ``variants``, ``defines`` mapping macro names to values (passed as
    ``-D``), all in parallel, to measure a kernel's design constants;
    returns the libraries' paths, each with its compiler report beside it
    (``.log``). Raises if any build fails."""
    _compile(variants)
    return [_lib_path(name, d) for name, d in variants]


@contextlib.contextmanager
def _build_lock():
    """Hold the exclusive lock on ``build/lock`` (released by the kernel
    if the holder dies, so a killed build never wedges the next one)."""
    with open(os.path.join(BUILD_DIR, "lock"), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def _compile(jobs: Sequence[Tuple[str, Mapping[str, int]]]) -> List[float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    if all(os.path.exists(_lib_path(name, d)) for name, d in jobs):
        return [0.0] * len(jobs)
    with _build_lock():
        return _compile_locked(jobs)


def _compile_locked(jobs: Sequence[Tuple[str, Mapping[str, int]]]) -> List[float]:
    procs = []
    for name, defines in jobs:
        out = _lib_path(name, defines)
        if os.path.exists(out):  # another process built it while we waited
            procs.append(None)
            continue
        log_path = out[:-3] + ".log"
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *_flags(defines), "-o", tmp, source_path(name)]
        with open(log_path, "w") as log:  # the child keeps its own fd
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        procs.append((proc, tmp, out, log_path, time.perf_counter()))
    seconds = [0.0] * len(jobs)
    failed = []
    for i, job in enumerate(procs):
        if job is None:
            continue
        proc, tmp, out, log_path, t0 = job
        rc = proc.wait()
        seconds[i] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)  # atomic: a reader sees all or nothing
        else:
            failed.append((jobs[i], log_path))
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        msgs = []
        for (name, defines), log_path in failed:
            with open(log_path) as f:
                msgs.append(f"{name} {' '.join(_flags(defines))}:\n{f.read()[-4000:]}")
        raise KernelError("nvcc failed for " + "\n".join(msgs))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report of ``csrc/<name>.cu``'s own build."""
    return _lib_path(name, {})[:-3] + ".log"


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            try:
                lib = ctypes.CDLL(_lib_path(name, {}))
            except OSError as exc:
                raise KernelError(f"cannot load the {name} kernel: {exc}") from exc
            _libs[name] = lib
        return lib


def check_launch(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA launch failed with cudaError_t {rc}")
