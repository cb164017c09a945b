"""Opt-in ``torch.profiler`` trace capture for training (port of the JAX
package's ``telemetry/profiler.py``, on ``torch.profiler`` instead of
``jax.profiler``):

* :func:`start_trace` / :func:`stop_trace` — one process-wide capture
  (refuses to nest, as the reference's does);
* :func:`trace` — context-manager form (``None`` dir → null context),
  the launcher's ``--profile DIR``;
* :class:`StepTraceHook` — a window of ``duration`` steps every ``every``
  steps into ``<dir>/step<N>``, which ``run_fused`` drives once an epoch
  (``profile_every``).

Each capture is written as Chrome-trace JSON (``*.pt.trace.json``, read by
``chrome://tracing``, Perfetto or TensorBoard; no TensorBoard package is
needed to write it).  Its activities are CPU and CUDA when the run is on
the card and CPU only when the caller asked for the CPU; a capture on the
card that recorded no CUDA activity raises at :func:`stop_trace`, after
the file is written, instead of passing as a CPU-only trace.

Knobs, most specific first: explicit arguments, then the
``ZNICZ_PROFILE_DIR`` / ``ZNICZ_PROFILE_EVERY`` environment variables."""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import signal as _signal
import threading

import torch

_log = logging.getLogger(__name__)

PROFILE_DIR_ENV = "ZNICZ_PROFILE_DIR"
PROFILE_EVERY_ENV = "ZNICZ_PROFILE_EVERY"

_lock = threading.Lock()
#: (directory, profiler, whether it records CUDA) of the running capture
_active: tuple[str, object, bool] | None = None


def dir_from_env() -> str | None:
    """``$ZNICZ_PROFILE_DIR`` or None (empty string means unset)."""
    return os.environ.get(PROFILE_DIR_ENV, "").strip() or None


def every_from_env() -> int | None:
    raw = os.environ.get(PROFILE_EVERY_ENV, "").strip()
    try:
        return int(raw) if raw else None
    except ValueError:
        _log.warning("ignoring non-integer %s=%r", PROFILE_EVERY_ENV, raw)
        return None


@contextlib.contextmanager
def _shutdown_signals_blocked():
    """Block SIGINT/SIGTERM on the calling thread while the profiler
    starts, so the threads it spawns inherit the mask and never become
    the target of a process-directed Ctrl-C/SIGTERM."""
    try:
        old = _signal.pthread_sigmask(
            _signal.SIG_BLOCK, {_signal.SIGINT, _signal.SIGTERM})
    except (ValueError, OSError):
        yield
        return
    try:
        yield
    finally:
        _signal.pthread_sigmask(_signal.SIG_SETMASK, old)


def start_trace(trace_dir: str, device=None) -> bool:
    """Begin capturing into ``trace_dir`` (created if needed) for a run on
    ``device`` (default: the CUDA card, raising without one; ``"cpu"``
    records the CPU only).  Returns False when a capture is running
    already."""
    from ..backends import resolve
    global _active
    cuda = resolve(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _lock:
        if _active is not None:
            _log.warning("profiler already tracing into %s; ignoring "
                         "start_trace(%s)", _active[0], trace_dir)
            return False
        os.makedirs(trace_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        with _shutdown_signals_blocked():
            prof.start()
        _active = (trace_dir, prof, cuda)
        return True


def stop_trace() -> str | None:
    """End the running capture and write it; returns its directory (None
    when no capture was running).  Raises RuntimeError when a capture on
    the card recorded no CUDA activity."""
    global _active
    with _lock:
        if _active is None:
            return None
        (trace_dir, prof, cuda), _active = _active, None
    prof.stop()
    path = os.path.join(trace_dir, f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError(f"the profile in {path} recorded no CUDA "
                           "activity for a run on the card")
    return trace_dir


class trace:
    """``with trace(dir, device):`` — whole-block capture; ``dir=None`` is
    a null context, so call sites stay unconditional."""

    def __init__(self, trace_dir: str | None, device=None):
        self.trace_dir = trace_dir
        self.device = device
        self._started = False

    def __enter__(self):
        if self.trace_dir is not None:
            self._started = start_trace(self.trace_dir, self.device)
        return self

    def __exit__(self, *exc):
        if self._started:
            stop_trace()


class StepTraceHook:
    """Capture ``duration`` steps every ``every`` steps into
    ``<profile_dir>/step<N>``.

    Drive it with :meth:`on_step` once per step and :meth:`close` when the
    loop ends (closing mid-window stops the capture cleanly).
    ``start``/``stop`` are injectable for tests; by default ``start`` is
    :func:`start_trace` for ``device``."""

    def __init__(self, profile_dir: str, every: int = 100,
                 duration: int = 1, start=None, stop=stop_trace,
                 device=None):
        if every < 1 or duration < 1:
            raise ValueError(f"every/duration must be >= 1, got "
                             f"{every}/{duration}")
        self.profile_dir = profile_dir
        self.every = int(every)
        self.duration = int(duration)
        self._start = start or functools.partial(start_trace,
                                                 device=device)
        self._stop = stop
        self._capturing_until: int | None = None
        #: directories of completed captures
        self.captured: list[str] = []
        self._current: str | None = None

    def on_step(self, step: int) -> None:
        if self._capturing_until is not None:
            if step >= self._capturing_until:
                self._finish()
            else:
                return
        if step % self.every == 0:
            d = os.path.join(self.profile_dir, f"step{step}")
            if self._start(d):
                self._current = d
                self._capturing_until = step + self.duration

    def _finish(self) -> None:
        self._stop()
        if self._current is not None:
            self.captured.append(self._current)
        self._current = None
        self._capturing_until = None

    def close(self) -> None:
        if self._capturing_until is not None:
            self._finish()
