"""Batched inference serving of exported models (port of
``znicz_tpu/serving``):

* ``engine``  — forward-only engine over a ``.znn`` file or a live
  workflow, one executable per shape bucket in an LRU: a CUDA graph on
  the card, the eager forward with ``backend="cpu"``; falls back to the
  native CPU engine when its circuit breaker opens on transient faults.
* ``batcher`` — dynamic micro-batcher coalescing concurrent requests
  into one engine call, with a bounded admission queue, backpressure
  and per-request deadlines.
* ``server``  — stdlib HTTP front: ``POST /predict``, ``GET /healthz``,
  ``GET /metrics``, ``/statusz``, ``/alertz``, ``/tracez``,
  ``/debug/*``, ``POST /admin/reload`` and ``/admin/placement``;
  HTTP/1.1 persistent connections.
* ``wire``    — the request-path wire formats: the zero-copy binary
  tensor protocol (``application/x-znicz-tensor``) and the
  single-buffer JSON response encoder (byte-identical to
  ``json.dumps``).
* ``memo``    — generation-keyed response memoization (``serve
  --memoize``); a hot reload swaps the key space.
* ``zoo``     — the multi-tenant model registry: ``X-Model`` routing,
  token-bucket quotas, criticality and deadline classes, and a
  weight-residency LRU under a memory budget.
* ``replicas`` — N engine replicas behind one batcher, round robin,
  sick-replica ejection, rolling reload and hedged dispatch.

CLI: ``python -m znicz_tpu_torch serve --model path.znn --port N`` (or
``--zoo DIR`` / repeated ``--model name=path,...`` for a zoo).
"""

from ..resilience.breaker import EngineUnavailable
from .batcher import DeadlineExceeded, MicroBatcher, QueueFull
from .engine import ServingEngine
from .memo import ResponseCache
from .replicas import EngineReplicaSet
from .server import ServingServer
from .wire import WireError
from .zoo import ModelEntry, ModelZoo, QuotaExceeded, UnknownModel

__all__ = ["DeadlineExceeded", "EngineReplicaSet", "EngineUnavailable",
           "MicroBatcher", "ModelEntry", "ModelZoo", "QueueFull",
           "QuotaExceeded", "ResponseCache", "ServingEngine",
           "ServingServer", "UnknownModel", "WireError"]
