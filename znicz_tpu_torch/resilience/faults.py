"""Seeded, deterministic fault injection at named sites.

Serving heavy traffic means preemption, relay drops, and transient
device errors are the steady state (SURVEY.md §5 — the reference's
master/slave protocol existed largely to survive lost slaves).  Testing
the recovery machinery therefore needs a way to *cause* those failures
on demand, deterministically, in pytest — the same mechanism and plan
format as the JAX package's, so a plan drives both.

Instrumented code calls :func:`inject` with a site name::

    from znicz_tpu_torch.resilience import faults
    faults.inject("engine.forward")

which is a near-free no-op until a :class:`FaultPlan` is installed
(explicitly, or via the ``ZNICZ_FAULT_PLAN`` environment variable —
inline JSON or ``@/path/to/plan.json``).  A plan is a list of
:class:`FaultSpec` entries; each spec matches one site and fires an
exception or an added latency with seeded pseudo-randomness, so a chaos
test replays bit-identically across runs.

Instrumented sites in this package:

=====================  ====================================================
``engine.forward``     ServingEngine's device forward (per attempt —
                       retries re-trigger it; the native fallback path
                       deliberately does NOT pass through this site)
``batcher.dispatch``   MicroBatcher just before an engine call (latency
                       injection point for deadline/backpressure tests)
``checkpoint.save``    SnapshotterToFile.save and TrainerCheckpointer.save
                       (crash-during-checkpoint, fired BEFORE any
                       filesystem mutation)
``checkpoint.load``    SnapshotterToFile.load and TrainerCheckpointer.
                       restore (corrupt/unreadable resume)
``checkpoint.write_torn``  inside SnapshotterToFile.save's torn window,
                       between the blob rename and the manifest rename
                       — an error fault dies torn (new blob, no
                       manifest), a latency fault holds the window open
                       for a SIGKILL crash test
``artifact.bitflip``   durability.chaos_bitflip, called on every
                       just-committed .znn or snapshot blob — an error
                       fault here is *interpreted*: one mid-file byte is
                       flipped in place (deterministic storage rot;
                       verify-on-load must quarantine or refuse it)
=====================  ====================================================

The JAX package instruments more sites (the relay, the promotion
controller, replicas, the capture tap, the fleet journal); they arrive
with the subsystems that own them.
"""

from __future__ import annotations

import builtins
import collections
import json
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass, field

from ..telemetry.registry import REGISTRY

_injected = REGISTRY.counter(
    "faults_injected_total",
    "chaos faults actually fired, by site and kind (a fault plan's "
    "specs that skip/exhaust do not count)")


class FaultInjected(RuntimeError):
    """Default exception type raised by an ``error`` fault."""


@dataclass
class FaultSpec:
    """One fault rule.  ``site`` names the injection point; ``kind`` is
    ``"error"`` (raise) or ``"latency"`` (sleep ``latency_s``); ``p`` is
    the per-hit firing probability under the plan's seeded stream;
    ``after`` skips the first N hits and ``times`` caps total firings
    (``None`` = unlimited) — together they script "fails K times, then
    recovers", the breaker's half-open-probe scenario."""

    site: str
    kind: str = "error"
    p: float = 1.0
    times: int | None = None
    after: int = 0
    exc: str = "FaultInjected"
    message: str = "injected fault"
    latency_s: float = 0.0
    # per-spec runtime state (not part of the plan's identity)
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in ("error", "latency"):
            raise ValueError(f"fault kind {self.kind!r}; expected "
                             f"'error' or 'latency'")
        if not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"fault probability {self.p!r} not in [0,1]")

    def exception(self) -> BaseException:
        """The exception instance this spec raises — a builtin by name,
        else :class:`FaultInjected` (never an arbitrary import: plans
        come from env vars)."""
        cls = getattr(builtins, self.exc, None)
        if not (isinstance(cls, type) and issubclass(cls, BaseException)):
            cls = FaultInjected
        return cls(f"{self.message} [site={self.site}]")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules plus firing stats.

    Deterministic: each spec draws from its own ``random.Random``
    stream keyed ``(plan seed, site crc32, spec index)``, so adding a
    spec never perturbs another's firing pattern.  Thread-safe — the
    serving path injects from many handler threads.

    Use as a context manager to install/uninstall around a test::

        with FaultPlan([FaultSpec("engine.forward", times=3)]):
            ...
    """

    def __init__(self, faults, seed: int = 0):
        self.seed = int(seed)
        self.faults = list(faults)
        self._lock = threading.Lock()
        self.stats = collections.Counter()        # f"{site}:{kind}" → n
        self._rngs = [
            random.Random((self.seed << 32)
                          ^ zlib.crc32(f.site.encode()) ^ i)
            for i, f in enumerate(self.faults)]

    # -- construction -----------------------------------------------------
    @classmethod
    def from_dict(cls, obj: dict) -> "FaultPlan":
        """``{"seed": 0, "faults": [{"site": ..., ...}, ...]}``."""
        return cls([FaultSpec(**spec) for spec in obj.get("faults", [])],
                   seed=obj.get("seed", 0))

    @classmethod
    def from_env(cls, var: str = "ZNICZ_FAULT_PLAN") -> "FaultPlan | None":
        """Plan from ``$ZNICZ_FAULT_PLAN`` — inline JSON, or a JSON file
        path prefixed ``@`` — or None when unset/empty."""
        raw = os.environ.get(var, "").strip()
        return parse_plan(raw) if raw else None

    # -- firing -----------------------------------------------------------
    def fire(self, site: str) -> None:
        """Apply every matching spec for one hit of ``site`` — sleeps
        for latency faults, raises for error faults."""
        delay, boom, fired = 0.0, None, []
        with self._lock:
            for spec, rng in zip(self.faults, self._rngs):
                if spec.site != site:
                    continue
                spec.hits += 1
                if spec.hits <= spec.after:
                    continue
                if spec.times is not None and spec.fired >= spec.times:
                    continue
                if spec.p < 1.0 and rng.random() >= spec.p:
                    continue
                spec.fired += 1
                self.stats[f"{site}:{spec.kind}"] += 1
                fired.append(spec.kind)
                if spec.kind == "latency":
                    delay += spec.latency_s
                elif boom is None:        # first error spec wins
                    boom = spec.exception()
        for kind in fired:       # registry event, outside the plan lock
            _injected.inc(site=site, kind=kind)
        if delay > 0.0:
            time.sleep(delay)
        if boom is not None:
            raise boom

    def snapshot(self) -> dict:
        """Firing stats keyed ``site:kind`` (for logs / chaos report)."""
        with self._lock:
            return dict(self.stats)

    # -- install/uninstall ------------------------------------------------
    def __enter__(self) -> "FaultPlan":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)


def parse_plan(raw: str) -> FaultPlan:
    """THE one parser for user-supplied plans — inline JSON or a JSON
    file path prefixed ``@`` (shared by ``$ZNICZ_FAULT_PLAN``,
    ``serve --fault-plan`` and ``chaos --plan``)."""
    if raw.startswith("@"):
        with open(raw[1:]) as fh:
            raw = fh.read()
    return FaultPlan.from_dict(json.loads(raw))


_active: FaultPlan | None = None
_env_checked = False
_install_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (replacing any)."""
    global _active, _env_checked
    with _install_lock:
        _active, _env_checked = plan, True
    return plan


def uninstall(plan: FaultPlan | None = None) -> None:
    """Deactivate injection (optionally only if ``plan`` is active —
    so a context manager never tears down a newer plan)."""
    global _active
    with _install_lock:
        if plan is None or _active is plan:
            _active = None


def active() -> FaultPlan | None:
    """The current plan; resolves ``$ZNICZ_FAULT_PLAN`` on first call so
    subprocess workers (elastic fleets, the serve CLI) pick plans up
    with zero wiring."""
    global _active, _env_checked
    if _active is None and not _env_checked:
        with _install_lock:
            if _active is None and not _env_checked:
                _env_checked = True
                try:
                    _active = FaultPlan.from_env()
                except Exception as e:          # a broken plan must not
                    import logging              # take the process down
                    logging.getLogger(__name__).warning(
                        "ignoring unparseable ZNICZ_FAULT_PLAN: %s", e)
    return _active


def inject(site: str) -> None:
    """The one call instrumented code makes — no-op without a plan."""
    plan = active()
    if plan is not None:
        plan.fire(site)
