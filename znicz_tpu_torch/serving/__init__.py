"""Batched inference serving of exported models (port of the in-process
half of ``znicz_tpu/serving``):

* ``engine``  — forward-only engine over a ``.znn`` file or a live
  workflow, one executable per shape bucket in an LRU: a CUDA graph on
  the card, the eager forward with ``backend="cpu"``; falls back to the
  native CPU engine when its circuit breaker opens on transient faults.
* ``batcher`` — dynamic micro-batcher coalescing concurrent requests
  into one engine call, with a bounded admission queue, backpressure
  and per-request deadlines.

The wire formats, response memoization, the model zoo, replica sets,
the HTTP server and the ``serve`` command come with the next serving
slice (ROADMAP.md queue 1 item 7).
"""

from ..resilience.breaker import EngineUnavailable
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import ServingEngine

__all__ = ["DeadlineExceeded", "EngineUnavailable", "MicroBatcher",
           "QueueFull", "ServingEngine"]
