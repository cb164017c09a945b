"""Workflow: unit container + run loop (port of ``znicz_tpu/workflow.py``).

``Workflow`` owns units, ``StartPoint`` / ``EndPoint`` delimit the control
graph, ``run()`` drives the dataflow loop (one tick = one minibatch),
``initialize()`` binds the device, and ``time_table()`` gives the per-unit
wall time after a run.

Scheduler semantics: a unit fires in a tick once ALL its forward-edge
parents have fired; ``gate_block`` stops both the unit and flow through
it; ``gate_skip`` passes flow without running.  Loop back-edges (e.g. the
last GD unit → Loader) are detected at initialize time and excluded from
the within-tick AND; they are what makes the tick loop iterate.  The loop
ends when ``EndPoint`` fires (Decision drops its block when training
completes)."""

from __future__ import annotations

from . import backends
from .units import Container, Unit


class StartPoint(Unit):
    """Control-flow source (reference parity)."""


class EndPoint(Unit):
    """Control-flow sink; firing it ends the run loop (reference parity)."""


class Workflow(Container):
    """Unit container with the dataflow run loop."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.start_point = StartPoint(self, name="start_point")
        self.end_point = EndPoint(self, name="end_point")
        self.device: backends.Device | None = None
        self._topo: list[Unit] | None = None
        self.stopped = False

    # -- graph analysis --------------------------------------------------------
    def _compute_topology(self) -> None:
        """Classify edges by DFS from start_point (an edge to a node on the
        current DFS stack is a loop back-edge), then Kahn-topo-sort the
        remaining DAG."""
        back: set[tuple[Unit, Unit]] = set()
        visited: set[Unit] = set()
        on_stack: set[Unit] = set()
        stack: list[tuple[Unit, int]] = [(self.start_point, 0)]
        visited.add(self.start_point)
        on_stack.add(self.start_point)
        while stack:
            u, i = stack[-1]
            if i < len(u._children):
                stack[-1] = (u, i + 1)
                c = u._children[i]
                if c in on_stack:
                    back.add((u, c))
                elif c not in visited:
                    visited.add(c)
                    on_stack.add(c)
                    stack.append((c, 0))
            else:
                stack.pop()
                on_stack.discard(u)
        for u in visited:
            u._fwd_parents = [p for p in u._parents
                              if p in visited and (p, u) not in back]
        # Kahn over forward edges only
        indeg = {u: len(u._fwd_parents) for u in visited}
        ready = [u for u in visited if indeg[u] == 0]
        order: list[Unit] = []
        while ready:
            u = ready.pop()
            order.append(u)
            for c in u._children:
                if c in visited and (u, c) not in back:
                    indeg[c] -= 1
                    if indeg[c] == 0:
                        ready.append(c)
        if len(order) != len(visited):
            raise RuntimeError(
                f"workflow {self.name}: control graph has a cycle not "
                f"broken by a back-edge from start_point's DFS")
        self._topo = order

    # -- lifecycle -------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Bind every unit to ``device`` (default: the CUDA card, raising
        without it; ``"cpu"`` or ``"numpy"`` when asked) in topological
        order, then the data-only units."""
        self.device = backends.get(device)
        self._compute_topology()
        for u in self._topo:
            if u is not self and not u.initialized:
                u.initialize(device=self.device, **kwargs)
        # Data-only units (consumed via link_attrs, no control edge) still
        # need their resources bound.
        for u in self.units:
            if u is not self and not u.initialized:
                u.initialize(device=self.device, **kwargs)
        self.initialized = True

    def run_tick(self) -> set[Unit]:
        """One pass of the dataflow graph (= one minibatch in training)."""
        fired: set[Unit] = set()
        for u in self._topo:
            parents = u._fwd_parents
            if parents and not all(p in fired for p in parents):
                continue
            if bool(u.gate_block):
                continue
            if not bool(u.gate_skip):
                u.run_timed()
            fired.add(u)
            if self.stopped:
                break
        return fired

    def run(self, max_ticks: int | None = None) -> None:
        if not self.initialized:
            self.initialize()
        self.stopped = False
        ticks = 0
        while not self.stopped:
            fired = self.run_tick()
            ticks += 1
            if self.end_point in fired:
                break
            if max_ticks is not None and ticks >= max_ticks:
                break
            if len(fired) <= 1:   # only start_point fired: graph is stuck
                raise RuntimeError(
                    f"workflow {self.name} deadlocked after {ticks} ticks: "
                    f"no unit past start_point can fire")
        self.stop()

    def stop(self) -> None:
        self.stopped = True
        for u in self.units:
            if u is not self:
                u.stop()

    # -- introspection ---------------------------------------------------------
    def time_table(self) -> list[tuple[str, int, float]]:
        """(name, run_count, seconds) per unit, slowest first."""
        rows = [(u.name, u.run_count, u.time_spent) for u in self.units]
        return sorted(rows, key=lambda r: -r[2])
