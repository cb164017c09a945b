"""Builds the port's CUDA sources with ``nvcc`` and loads them with
``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so`` with a plain C
interface (no PyTorch headers, so one source compiles in seconds).  The
hash covers every source and header under ``csrc/`` and the flags, so an
edit rebuilds and an unchanged tree reuses the library.  A lock file per
library keeps two processes from racing on one build.  Nothing here runs
at import time: a library is built at first use, or up front (all sources
in parallel) with :func:`build_all`.

A missing or failing ``nvcc`` raises with its stderr; the port never falls
back to another implementation when a kernel does not build."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: Hopper only; the ``a`` keeps wgmma/setmaxnreg available to later kernels.
#: No --use_fast_math: its __expf/__logf would break the kernels'
#: tolerances against their plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the port's CUDA kernels need the CUDA "
        "toolkit to build")


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise BuildError(f"no CUDA source {src}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every listed source (default: all of ``csrc/*.cu``) that is
    not built yet, one ``nvcc`` per source, all started together; returns
    ``{name: library path}``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    locks, procs = {}, {}
    try:
        for n, path in paths.items():
            fh = open(BUILD_DIR / f"{n}.lock", "w")
            locks[n] = fh
            fcntl.flock(fh, fcntl.LOCK_EX)
            if not path.exists():
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                procs[n] = (_start(n, tmp), tmp)
        errors = []
        for n, (proc, tmp) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed on csrc/{n}.cu "
                              f"(exit {proc.returncode}):\n{err}")
            else:
                os.replace(tmp, paths[n])
        if errors:
            raise BuildError("\n".join(errors))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for fh in locks.values():
            fcntl.flock(fh, fcntl.LOCK_UN)
            fh.close()
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
