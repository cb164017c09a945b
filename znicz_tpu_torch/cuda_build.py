"""Builds the port's CUDA sources with ``nvcc`` and loads them with
``ctypes``; :func:`build_host` builds a host C++ library the same way.

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
_functions: dict = {}
_lock = threading.Lock()


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class LaunchError(RuntimeError):
    """The CUDA runtime refused a kernel launch (its error code in the
    message)."""


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


def kernel(library: str, name: str, argtypes: list):
    """The C entry point ``name`` of ``csrc/<library>.cu`` with its ctypes
    signature (the launch stream last, an int status returned), built at
    first use.  Each pointer and the stream must be ``c_void_p``: ctypes
    passes an untyped Python int as a 32-bit int and cuts a pointer."""
    fn = _functions.get((library, name))
    if fn is None:
        fn = getattr(load(library), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(library, name)] = fn
    return fn


def launch(fn, device, *args) -> None:
    """Call a kernel's entry point on ``device``'s current stream and raise
    :class:`LaunchError` if the launch was refused (its
    ``cudaGetLastError``); it does not synchronise."""
    import torch
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise LaunchError(f"{fn.__name__} launch failed: CUDA error "
                          f"{status}")


#: the host compiler's flags, as ``native/Makefile`` gives them
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared")


def build_host(name: str, source: Path, headers=(), flags=CXX_FLAGS,
               libs=("-lpthread",), force: bool = False) -> Path:
    """Build the host C++ ``source`` (``$CXX``, default ``g++``) into
    ``build/<name>-<hash>.so`` unless it is built already (``force``:
    build again) and return its path; the hash covers the source,
    ``headers`` and the flags, a lock file keeps two processes from
    racing on one build, and the library lands by one rename, so a
    loader never sees a partial file.  A failing compiler raises
    :class:`BuildError` with its stderr; nothing is written beside the
    source."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    h = hashlib.sha256(" ".join((*flags, *libs)).encode())
    for p in (Path(source), *map(Path, headers)):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    with open(BUILD_DIR / f"{name}.lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if force or not out.exists():
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                try:
                    proc = subprocess.run(
                        [cxx, *flags, "-o", str(tmp), str(source), *libs],
                        capture_output=True, text=True)
                except OSError as e:
                    raise BuildError(f"{cxx} could not run: {e}") from e
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise BuildError(f"{cxx} failed on {source} (exit "
                                     f"{proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, out)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return out
