"""Steps replayed from CUDA graphs: the port's counterpart of the
reference's ``jax.jit`` of a whole epoch.

A ``StepPlan`` holds one kind of step (a train, eval or SOM step at one
batch size over one resident dataset) in static device buffers: the
epoch's plan, one int32 row a step that the caller packs (indices, mask
bits, learning-rate scale bits), copied in once a call; a device step
counter; and one output slot a step for each metric.  The step function
reads its row at the counter, writes its metrics at the counter and
advances it, so a graph of it replays step after step with no host work
but the replay.

Each variant of the step is captured at its first use: the step runs once
eagerly on a side stream — a real step of the epoch, which loads the
kernels and builds the libraries' handles and workspaces on the stream
the capture then uses — and is then captured from the state it left, so
the capture moves nothing and the captured epoch equals the eager one
bit for bit.  The kernel wrappers count their launches as they are
called; what they count during the capture is recorded apart
(``ops.recording``) and added on every replay, so the counts stay the
launches the card ran, also while other threads launch.  A capture or a
replay that fails raises; nothing falls back to the eager step.  The
serving engine captures its bucket forwards through :func:`capture`
too."""

from __future__ import annotations

import gc
import threading

import numpy as np
import torch

from .. import ops

#: one capture at a time in the process: the serving batchers, their
#: callers and a trainer may capture from several threads
_LOCK = threading.Lock()


class StepGraph:
    """A captured step and the launches each replay makes, by counter."""

    def __init__(self, graph, launches: list):
        self.graph = graph
        #: [(ops module, counter name, launches a replay)]
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        for mod, attr, n in self.launches:
            ops.add_launches(mod, attr, n)


def capture(fn, stream, pool) -> StepGraph:
    """Run ``fn`` eagerly once on ``stream``, then capture it there into a
    graph of memory ``pool`` (None: a pool of its own); the caller's
    stream waits for both.  The capture's error mode is
    ``"thread_local"``: other threads (the serving batcher's, its
    callers') keep using the card while this one captures.  Captures
    take the process-wide lock, so one runs at a time.

    The garbage collector is off while the graph records: a collection
    would run the destructors of unreachable graphs on this thread, and
    destroying a graph while this thread captures invalidates the
    capture.  Under the lock no other capture turns it back on early."""
    with _LOCK:
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        collecting = gc.isenabled()
        try:
            with torch.cuda.stream(stream):
                fn()
                graph = torch.cuda.CUDAGraph()
                with ops.recording() as counted:  # the capture runs nothing
                    gc.disable()
                    with torch.cuda.graph(graph, pool=pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        fn()
        finally:
            if collecting:
                gc.enable()
            current.wait_stream(stream)
    return StepGraph(graph, [(ops._module(m), a, n)
                             for (m, a), n in counted.items() if n])


class StepPlan:
    """Static buffers and captured variants of one kind of step."""

    def __init__(self, device, width: int, capacity: int, outputs: dict):
        self.device = torch.device(device)
        self.width = width
        #: name → dtype of each per-step metric slot
        self.outputs = outputs
        self.step = torch.zeros((1,), dtype=torch.int64, device=device)
        self.graphs: dict[str, StepGraph] = {}
        #: the side stream the captures run on and their memory pool,
        #: shared by the variants (their memory is scratch between steps)
        self.stream = self.pool = None
        self._allocate(capacity)

    def _allocate(self, capacity: int) -> None:
        self.capacity = capacity
        self.plan = torch.zeros((capacity, self.width), dtype=torch.int32,
                                device=self.device)
        self.out = {k: torch.zeros((capacity,), dtype=dt, device=self.device)
                    for k, dt in self.outputs.items()}
        self.graphs.clear()           # they read the buffers they replaced

    def load(self, rows: np.ndarray) -> None:
        """Copy a call's plan in and set the counter to its first step; a
        longer plan than the buffers hold replaces them (and so the
        graphs, which are captured again at their next use)."""
        if rows.shape[0] > self.capacity:
            self._allocate(rows.shape[0])
        self.plan[:rows.shape[0]].copy_(torch.from_numpy(
            np.ascontiguousarray(rows, np.int32)))
        self.step.zero_()

    def row(self) -> torch.Tensor:
        """The current step's plan row (int32), read at the counter."""
        return self.plan.index_select(0, self.step).view(-1)

    def put(self, name: str, value: torch.Tensor) -> None:
        """Write the current step's ``name`` metric."""
        self.out[name].index_copy_(0, self.step, value.reshape(1))

    def advance(self) -> None:
        self.step.add_(1)

    def run(self, variant: str, fn) -> None:
        """One step: a replay of ``variant``'s graph, captured (after an
        eager step) at its first use."""
        graph = self.graphs.get(variant)
        if graph is None:
            self.graphs[variant] = self.capture(fn)
        else:
            graph.replay()

    def capture(self, fn) -> StepGraph:
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()
        return capture(fn, self.stream, self.pool)

    def take(self, n: int) -> dict:
        """The first ``n`` steps' metrics, copied out of the slots the next
        call overwrites."""
        return {k: v[:n].clone() for k, v in self.out.items()}
