"""Generation-keyed response memoization for the serving hot path (a
copy of the JAX package's ``serving/memo.py``).

Production traffic repeats itself — health probes, retried requests,
hot rows — and every repeat of an identical input pays the full
batcher/device round trip for an answer the process already computed.
This module is the bounded cache that answers those repeats at the
HTTP front, without a device call:

* **Keying**: ``(model generation, digest of the raw input bytes +
  shape + dtype)``.  Generation pinning is what makes this safe
  to serve from: a hot reload bumps the generation and therefore the
  whole key space — a swapped model can never answer with its
  predecessor's outputs, with no invalidation protocol needed (the
  hit-after-reload-miss contract is pinned by tests).
* **Bounding**: per-model LRU over both entry count and byte size
  (per-tenant isolation means each zoo entry carries its OWN
  cache — one tenant's hot set cannot evict another's).
* **Accounting**: ``response_cache_hits_total`` /
  ``response_cache_misses_total`` / ``response_cache_bytes``
  (``{model=...}``-labeled for explicit zoos, label-free on the
  single-model surface, same rule as every other ``model_*`` family).

Opt-in: ``serve --memoize N`` (entries per model); the default-off
keeps the pre-existing single-model contracts byte-identical.
"""

from __future__ import annotations

import collections
import hashlib
import threading

import numpy as np

from ..telemetry.registry import REGISTRY

_hits = REGISTRY.counter(
    "response_cache_hits_total",
    "/predict answers served from the generation-keyed response "
    "memoization cache (no device call), by model for explicit zoos")
_misses = REGISTRY.counter(
    "response_cache_misses_total",
    "/predict lookups that missed the response cache and took the "
    "full batcher/device path, by model for explicit zoos")
_bytes = REGISTRY.gauge(
    "response_cache_bytes",
    "bytes of memoized response tensors currently retained, by model "
    "for explicit zoos (bounded by --memoize / --memoize-mb)")


class ResponseCache:
    """Bounded (entries AND bytes) LRU of ``input digest → output
    array`` for one model.  Thread-safe; stored arrays are marked
    read-only — N concurrent hits share one buffer, and a caller
    scribbling on a response must fail loudly rather than poison
    every later hit."""

    def __init__(self, max_entries: int = 1024,
                 max_bytes: int = 32_000_000,
                 model: str | None = None,
                 instruments: tuple | None = None):
        if int(max_entries) < 1 or int(max_bytes) < 1:
            raise ValueError(f"cache bounds must be >= 1, got "
                             f"max_entries={max_entries!r} "
                             f"max_bytes={max_bytes!r}")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        #: label value for the registry families (None = the
        #: single-model surface: label-free series)
        self._labels = {} if model is None else {"model": model}
        #: (hits counter, misses counter, bytes gauge) — default the
        #: serving families; the fleet router reuses this cache with
        #: its own fleet_response_cache_* instruments so the two
        #: tiers' hit rates never mix in one series
        self._hits, self._misses, self._bytes = (
            instruments if instruments is not None
            else (_hits, _misses, _bytes))
        self._lock = threading.Lock()
        self._od: collections.OrderedDict[bytes, np.ndarray] = \
            collections.OrderedDict()
        self._nbytes = 0
        self._stats = collections.Counter()

    @staticmethod
    def key_for(generation: int, x: np.ndarray) -> bytes:
        """Digest of one request's input under one generation.  The
        generation number is part of the digest, so a reload swaps the
        entire key space atomically; shape and dtype are folded in so
        a (2, 8) input can never alias a (4, 4) one with equal
        bytes."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((int(generation), x.shape,
                       str(x.dtype))).encode())
        h.update(np.ascontiguousarray(x).data)
        return h.digest()

    def get(self, key: bytes) -> np.ndarray | None:
        with self._lock:
            y = self._od.get(key)
            if y is None:
                self._stats["misses"] += 1
            else:
                self._od.move_to_end(key)
                self._stats["hits"] += 1
        if y is None:
            self._misses.inc(**self._labels)
        else:
            self._hits.inc(**self._labels)
        return y

    def put(self, key: bytes, y: np.ndarray) -> None:
        y = np.ascontiguousarray(y)
        if y.base is not None:
            # the batcher hands each request a VIEW of the coalesced
            # batch's output; caching the view would pin the whole
            # batch array alive while accounting only the slice's
            # bytes — up to max_batch× beyond the byte budget
            y = y.copy()
        if y.nbytes > self.max_bytes:
            return                    # larger than the whole budget
        y.setflags(write=False)
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self._nbytes -= old.nbytes
            self._od[key] = y
            self._nbytes += y.nbytes
            while (len(self._od) > self.max_entries
                   or self._nbytes > self.max_bytes):
                _k, evicted = self._od.popitem(last=False)
                self._nbytes -= evicted.nbytes
                self._stats["evictions"] += 1
            nbytes = self._nbytes
        self._bytes.set(nbytes, **self._labels)

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
            self._nbytes = 0
        self._bytes.set(0, **self._labels)

    def metrics(self) -> dict:
        with self._lock:
            return {"entries": len(self._od), "bytes": self._nbytes,
                    "hits": self._stats["hits"],
                    "misses": self._stats["misses"],
                    "evictions": self._stats["evictions"],
                    "max_entries": self.max_entries,
                    "max_bytes": self.max_bytes}
