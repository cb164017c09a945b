"""Host-side thread pool for I/O and decode work (port of
``znicz_tpu/thread_pool.py``).

Units do not run on threads: the fused step runs a whole train step on the
card and the unit graph's tick loop stays synchronous, so its results are
deterministic.  What threads are for is hiding host latency under device
compute: image decode, augmentation and disk reads overlap the running
step.  This module is that pool, a thin shutdown-safe wrapper over
``concurrent.futures`` shared by the streaming loaders
(``loader.streaming``) and open to user code."""

from __future__ import annotations

import atexit
import threading
from concurrent.futures import ThreadPoolExecutor


class ThreadPool:
    """A named ThreadPoolExecutor with idempotent shutdown.

    ``map``/``submit`` mirror concurrent.futures; ``shutdown`` is safe
    to call twice (the reference pool's pause/resume lifecycle collapses
    to plain shutdown — nothing blocks on device queues anymore)."""

    def __init__(self, workers: int = 4, name: str = "znicz"):
        self.workers = int(workers)
        self.name = name
        self._executor: ThreadPoolExecutor | None = None
        self._lock = threading.Lock()

    def _ensure(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    self.workers, thread_name_prefix=self.name)
            return self._executor

    def submit(self, fn, /, *args, **kwargs):
        return self._ensure().submit(fn, *args, **kwargs)

    def map(self, fn, *iterables):
        return self._ensure().map(fn, *iterables)

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=wait)


_default: ThreadPool | None = None
_default_lock = threading.Lock()


def get(workers: int = 4) -> ThreadPool:
    """Process-wide shared pool (reference ``thread_pool.pool`` UX).
    The first caller fixes the worker count."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ThreadPool(workers, name="znicz-shared")
            atexit.register(_default.shutdown, wait=False)
        return _default
