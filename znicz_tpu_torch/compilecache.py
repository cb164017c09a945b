"""Persistent kernel-build cache (serve/train start-up).

The reference wires JAX's on-disk compilation cache here; the port's
compiled artifacts are its hand-written kernels' shared libraries
(``cuda_build``: one ``nvcc`` per ``csrc/*.cu``, ``g++`` for the host
libraries of ``build_host``), keyed by a hash of their sources and
flags.  :func:`enable` points the directory those builds land in and
load from at ``DIR``, so a second cold start of any process that shares
it finds every library built and runs no compiler at all
(``cuda_build.BUILDS`` counts the compiler runs of a process).

Opt-in by path: ``--compile-cache-dir DIR`` on ``serve`` and on the
train CLI, or ``$ZNICZ_COMPILE_CACHE`` for deployments that cannot
touch the launch command.  Off by default: kernels then build into the
package's own ``build/`` directory, as before.

Never raises into start-up: a directory that cannot be made or written
logs a warning and the process runs uncached, exactly as before.  A
kernel that fails to build still raises, wherever it builds.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from . import cuda_build

_log = logging.getLogger("znicz.compilecache")

#: the deployment-side channel (same pattern as $ZNICZ_PROFILE_DIR)
ENV_VAR = "ZNICZ_COMPILE_CACHE"

#: the directory enable() actually activated (introspection/tests)
_active_dir: str | None = None


def dir_from_env() -> str | None:
    return os.environ.get(ENV_VAR) or None


def active_dir() -> str | None:
    """The cache directory this process builds kernels into, or None
    when running uncached (surfaced on /statusz)."""
    return _active_dir


def enable(cache_dir: str | None = None) -> str | None:
    """Build and load kernels from ``cache_dir`` (default:
    ``$ZNICZ_COMPILE_CACHE``).  Returns the activated directory, or
    None when no directory was configured or it is unusable — callers
    treat None as "running uncached", never as an error."""
    global _active_dir
    path = os.fspath(cache_dir) if cache_dir is not None \
        else dir_from_env()
    if not path:
        return None
    try:
        os.makedirs(path, exist_ok=True)
        if not os.access(path, os.W_OK | os.X_OK):
            raise PermissionError(f"{path} is not writable")
    except OSError as e:
        _log.warning("persistent kernel-build cache unavailable (%s); "
                     "running uncached", e)
        return None
    path = os.path.abspath(path)
    cuda_build.BUILD_DIR = Path(path)
    _active_dir = path
    _log.info("persistent kernel-build cache at %s", path)
    return path
