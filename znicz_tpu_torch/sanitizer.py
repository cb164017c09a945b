"""zsan runtime layer: instrumented locks that catch real deadlocks
(the port's copy of ``znicz_tpu/sanitizer.py``).

The static rules (:mod:`znicz_tpu_torch.analysis.concurrency`) prove what
the AST can prove; this module watches what actually happens.  With
the sanitizer enabled, every ``threading.Lock`` / ``RLock`` /
``Condition`` *created from package code* is replaced by a tracked
wrapper that records, per thread, the ordered set of locks currently
held.  From those observations it builds the **observed acquisition
graph** keyed by lock *creation site* (the lockdep "lock class": every
``MicroBatcher`` instance's ``_cond`` is one node, so an inversion
between two instances still counts):

* **order inversion** — site B acquired while A is held *and* site A
  acquired while B is held, anywhere in the run.  Both acquisition
  stacks are kept (the first observation of each direction), so the
  report shows the two call paths that can deadlock each other.  Any
  inversion fails the run (:func:`assert_clean`).
* **long hold** — a lock held longer than ``ZNICZ_SAN_HOLD_MS``
  (default 150 ms) is reported with its acquisition stack: a lock held
  across a blocking call is a latency cliff even when ordering is
  consistent.  Report-only, never fatal (a CUDA-graph capture under the
  process-wide capture lock is *designed* to hold).

Reentrant re-acquisition of an already-held lock (RLock, or a
Condition re-entering its own lock around ``wait()``) never records an
edge — reentrancy is not an inversion.  Same-site pairs (two instances
of the same lock attribute) are skipped, matching the static rule.

Activation:

* ``ZNICZ_SAN=1`` in the environment — :mod:`znicz_tpu_torch`'s own
  ``__init__`` enables the sanitizer *before* any package module
  creates a lock, and an ``atexit`` hook prints the report (``python
  -m znicz_tpu_torch serve`` under it is chip_smoke's ``san_serve``
  phase, gated on zero inversions);
* ``pytest -m san`` — ``tests/test_torch_sanitizer.py`` enables it
  per-test around real concurrency (batcher, zoo).

Changes from the reference's copy: the watched directories end with a
separator (``.../znicz_tpu`` would also match ``.../znicz_tpu_torch``);
the real primitives come from ``_thread``, not from whatever
``threading.Lock`` is when this module is imported; :func:`enable`
refuses while another sanitizer (the reference's, say, in the same
test process) has ``threading.Lock``/``RLock``/``Condition`` patched —
two sanitizers never patch ``threading`` at once; and an acquisition
stack is taken without reading source lines (the same report text at a
fraction of the cost).

The sanitizer's own bookkeeping is guarded by one *raw* (untracked)
lock that is only ever taken as a leaf — it can appear in no cycle.
"""

from __future__ import annotations

import _thread
import collections
import os
import sys
import threading
import time
import traceback


def _condition_class():
    cond = threading.Condition
    if isinstance(cond, type):
        return cond
    # another sanitizer's factory is installed: given a lock, it makes
    # a real Condition over it
    return type(cond(_thread.allocate_lock()))


#: the real primitives, whatever ``threading`` holds at import
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_REAL_CONDITION = _condition_class()

_THIS_FILE = os.path.abspath(__file__)
_PKG_DIR = os.path.dirname(_THIS_FILE)

_MAX_INVERSIONS = 100
_STACK_DEPTH = 14


class SanError(RuntimeError):
    """A lock-order inversion (or sanitizer misuse) — the report text
    carries both acquisition stacks."""


class _State:
    def __init__(self, watch, hold_ms: float):
        self.mu = _REAL_LOCK()              # leaf-only, never tracked
        #: directories, each with a trailing separator
        self.watch = tuple(os.path.join(os.path.abspath(w), "")
                           for w in watch)
        self.hold_ms = float(hold_ms)
        self.tls = threading.local()
        #: (site_held, site_acquired) -> first observation
        self.edges: dict = {}
        self.inversions: list = []
        self.long_holds = collections.deque(maxlen=64)
        self.created = 0
        self.acquires = 0

    def held(self) -> list:
        h = getattr(self.tls, "held", None)
        if h is None:
            h = self.tls.held = []
        return h


_state: _State | None = None
#: threading's own Lock/RLock/Condition, saved by enable() for disable()
_saved: dict = {}


# -- bookkeeping ------------------------------------------------------------

class _Held:
    __slots__ = ("obj", "site", "t0", "count", "stack")

    def __init__(self, obj, site, t0, stack):
        self.obj = obj
        self.site = site
        self.t0 = t0
        self.count = 1
        self.stack = stack


def _capture_stack() -> tuple:
    """The acquisition stack, sanitizer frames stripped, innermost
    last — small tuples of pre-formatted lines (cheap to keep per
    edge, formatted once).  The source lines are never read (the
    reference's ``extract_stack`` stats every frame's file through
    linecache on each acquire, its largest cost under load)."""
    frames = traceback.StackSummary.extract(
        traceback.walk_stack(sys._getframe(1)), limit=_STACK_DEPTH,
        lookup_lines=False)
    frames.reverse()
    return tuple(f"{fr.filename}:{fr.lineno} in {fr.name}"
                 for fr in frames
                 if os.path.abspath(fr.filename) != _THIS_FILE)


def _note_acquire(obj, site: str) -> None:
    st = _state
    if st is None:
        return
    held = st.held()
    for h in held:
        if h.obj is obj:
            h.count += 1          # reentrant: no edge, no new entry
            return
    stack = _capture_stack()
    tname = threading.current_thread().name
    with st.mu:
        st.acquires += 1
        for h in held:
            if h.site == site:
                continue          # same lock class: instance ordering
            key = (h.site, site)
            rev = (site, h.site)
            if rev in st.edges and key not in st.edges \
                    and len(st.inversions) < _MAX_INVERSIONS:
                prev = st.edges[rev]
                st.inversions.append({
                    "sites": (h.site, site),
                    "thread": tname,
                    "stack": stack,
                    "other_thread": prev["thread"],
                    "other_stack": prev["stack"],
                })
            if key not in st.edges:
                st.edges[key] = {"stack": stack, "thread": tname,
                                 "count": 0}
            st.edges[key]["count"] += 1
    held.append(_Held(obj, site, time.monotonic(), stack))


def _note_release(obj) -> None:
    st = _state
    if st is None:
        return
    held = st.held()
    for i in range(len(held) - 1, -1, -1):
        h = held[i]
        if h.obj is obj:
            h.count -= 1
            if h.count == 0:
                del held[i]
                dur_ms = (time.monotonic() - h.t0) * 1e3
                if dur_ms > st.hold_ms:
                    with st.mu:
                        st.long_holds.append({
                            "site": h.site, "ms": round(dur_ms, 1),
                            "thread": threading.current_thread().name,
                            "stack": h.stack})
            return
    # releasing a lock this thread never tracked (acquired before
    # enable(), or handed across threads): nothing to unwind


def _note_release_all(obj) -> int:
    """Condition.wait's _release_save: the lock leaves this thread
    entirely; returns the reentrancy count to restore."""
    st = _state
    if st is None:
        return 1
    held = st.held()
    for i in range(len(held) - 1, -1, -1):
        if held[i].obj is obj:
            count = held[i].count
            del held[i]
            return count
    return 1


def _note_acquire_restore(obj, site: str, count: int) -> None:
    _note_acquire(obj, site)
    st = _state
    if st is None:
        return
    for h in st.held():
        if h.obj is obj:
            h.count = count
            return


# -- wrappers ---------------------------------------------------------------

class SanLock:
    """Tracked ``threading.Lock``."""

    _reentrant = False

    def __init__(self, site: str):
        self._lk = _REAL_LOCK()
        self._san_site = site

    def acquire(self, blocking=True, timeout=-1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _note_acquire(self, self._san_site)
        return ok

    def release(self):
        _note_release(self)
        self._lk.release()

    def locked(self):
        return self._lk.locked()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanLock {self._san_site} {self._lk!r}>"


class SanRLock:
    """Tracked ``threading.RLock`` — also usable as a Condition's lock
    (delegates ``_is_owned`` / ``_release_save`` /
    ``_acquire_restore`` so ``Condition.wait()`` stays tracked)."""

    _reentrant = True

    def __init__(self, site: str):
        self._lk = _REAL_RLOCK()
        self._san_site = site

    def acquire(self, blocking=True, timeout=-1):
        ok = self._lk.acquire(blocking, timeout)
        if ok:
            _note_acquire(self, self._san_site)
        return ok

    def release(self):
        _note_release(self)
        self._lk.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition-lock protocol
    def _is_owned(self):
        return self._lk._is_owned()

    def _release_save(self):
        count = _note_release_all(self)
        return (count, self._lk._release_save())

    def _acquire_restore(self, saved):
        count, state = saved
        self._lk._acquire_restore(state)
        _note_acquire_restore(self, self._san_site, count)

    def __repr__(self):
        return f"<SanRLock {self._san_site} {self._lk!r}>"


# -- creation-site factories ------------------------------------------------

def _creation_site():
    """(site string, creating filename) of the nearest frame outside
    this module."""
    f = sys._getframe(2)
    while f is not None and \
            os.path.abspath(f.f_code.co_filename) == _THIS_FILE:
        f = f.f_back
    if f is None:
        return "<unknown>:0", ""
    fname = os.path.abspath(f.f_code.co_filename)
    try:
        rel = os.path.relpath(fname, os.path.dirname(_PKG_DIR))
    except ValueError:
        rel = fname
    return f"{rel.replace(os.sep, '/')}:{f.f_lineno}", fname


def _watched(fname: str) -> bool:
    st = _state
    return (st is not None and fname != _THIS_FILE
            and fname.startswith(st.watch))


def _san_lock():
    site, fname = _creation_site()
    if _watched(fname):
        return SanLock(site)
    return _REAL_LOCK()


def _san_rlock():
    site, fname = _creation_site()
    if _watched(fname):
        return SanRLock(site)
    return _REAL_RLOCK()


def _san_condition(lock=None):
    if lock is not None:
        return _REAL_CONDITION(lock)
    site, fname = _creation_site()
    if _watched(fname):
        # a real Condition over a tracked RLock: wait()'s release/
        # reacquire flows through the delegate protocol above
        return _REAL_CONDITION(SanRLock(site))
    return _REAL_CONDITION()


def make_lock(name: str = "lock") -> SanLock:
    """An explicitly tracked lock (tests / out-of-package callers)."""
    return SanLock(name)


def make_rlock(name: str = "rlock") -> SanRLock:
    return SanRLock(name)


def make_condition(name: str = "cond"):
    return _REAL_CONDITION(SanRLock(name))


# -- lifecycle --------------------------------------------------------------

def enabled() -> bool:
    return _state is not None


def _patched_by_others() -> list:
    """``threading.X (module)`` for each primitive someone else patched."""
    current = {"Lock": threading.Lock, "RLock": threading.RLock,
               "Condition": threading.Condition}
    own = {"Lock": current["Lock"] is _thread.allocate_lock,
           "RLock": getattr(current["RLock"], "__module__", None)
           == "threading",
           "Condition": current["Condition"] is _REAL_CONDITION}
    return [f"threading.{k} ({getattr(v, '__module__', '?')})"
            for k, v in current.items() if not own[k]]


def enable(watch=None, hold_ms: float | None = None) -> None:
    """Patch ``threading.Lock/RLock/Condition`` with creation-site-
    filtered tracked factories.  Only locks created *after* this call,
    from files under ``watch`` (default: the znicz_tpu_torch package),
    are wrapped — foreign and stdlib lock creations get the real
    primitive.  Raises :class:`SanError` when already enabled, or when
    another module has the primitives patched."""
    global _state
    if _state is not None:
        raise SanError("sanitizer already enabled")
    others = _patched_by_others()
    if others:
        raise SanError(f"{', '.join(others)} already patched by another "
                       f"sanitizer; disable it first")
    if hold_ms is None:
        hold_ms = float(os.environ.get("ZNICZ_SAN_HOLD_MS", "150"))
    _state = _State(watch or (_PKG_DIR,), hold_ms)
    _saved.update(Lock=threading.Lock, RLock=threading.RLock,
                  Condition=threading.Condition)
    threading.Lock = _san_lock
    threading.RLock = _san_rlock
    threading.Condition = _san_condition


def disable() -> dict:
    """Unpatch and drop tracking; returns the final report.  Wrappers
    already handed out keep working (they just stop recording).  Not
    enabled: the report of nothing, and ``threading`` is left alone."""
    global _state
    rep = report()
    if _state is not None:
        threading.Lock = _saved["Lock"]
        threading.RLock = _saved["RLock"]
        threading.Condition = _saved["Condition"]
        _state = None
    return rep


def reset() -> None:
    """Clear observations, keep tracking (test isolation)."""
    st = _state
    if st is None:
        return
    with st.mu:
        st.edges.clear()
        st.inversions.clear()
        st.long_holds.clear()
        st.acquires = 0


def report() -> dict:
    st = _state
    if st is None:
        return {"enabled": False, "edges": 0, "acquires": 0,
                "inversions": [], "long_holds": []}
    with st.mu:
        return {
            "enabled": True,
            "hold_ms": st.hold_ms,
            "acquires": st.acquires,
            "edges": len(st.edges),
            "inversions": [dict(i) for i in st.inversions],
            "long_holds": [dict(h) for h in st.long_holds],
        }


def format_report(rep: dict | None = None) -> str:
    rep = rep if rep is not None else report()
    lines = [f"zsan: {rep['acquires']} acquires, "
             f"{rep['edges']} order edges, "
             f"{len(rep['inversions'])} inversion(s), "
             f"{len(rep['long_holds'])} long hold(s)"]
    for inv in rep["inversions"]:
        a, b = inv["sites"]
        lines.append(f"  INVERSION: {b} acquired while holding {a} "
                     f"(thread {inv['thread']}), but {a} is also "
                     f"acquired while holding {b} "
                     f"(thread {inv['other_thread']})")
        lines.append(f"    stack ({a} -> {b}):")
        lines.extend(f"      {s}" for s in inv["stack"])
        lines.append(f"    stack ({b} -> {a}):")
        lines.extend(f"      {s}" for s in inv["other_stack"])
    for h in rep["long_holds"]:
        lines.append(f"  LONG HOLD: {h['site']} held {h['ms']} ms "
                     f"(> {rep.get('hold_ms')} ms) by {h['thread']}")
        lines.extend(f"      {s}" for s in h["stack"])
    return "\n".join(lines)


def assert_clean(rep: dict | None = None) -> None:
    """Fail the run on any observed inversion (long holds are
    report-only)."""
    rep = rep if rep is not None else report()
    if rep["inversions"]:
        raise SanError(format_report(rep))
