"""Replay: tail the capture log into training batches.

The reader half of the live-data loop: :class:`ReplayReader` tails the
capture ring's segment files (:mod:`znicz_tpu_torch.online.capture`),
shuffles within a bounded window under a seed, and **degrades
honestly** when the log is cold — a bounded poll returns what exists
(possibly nothing) instead of parking the trainer forever.

Torn-tail policy (the crash-consistency half of the capture format):

* an *incomplete* record at the tail of the **newest** segment is a
  writer that may still be mid-append — the reader holds its offset
  and retries on the next poll;
* an incomplete or crc-torn tail on a segment that is **no longer the
  newest** can never complete — it is counted
  (``replay_torn_records_total``) and the reader moves on;
* a crc mismatch anywhere stops consumption of that segment at the
  torn offset (the length field itself may be garbage — skipping past
  it is guessing).

Locks never span file I/O: the reader parses segments outside its
buffer lock and only takes the lock to splice parsed records in or
sample a batch out (the zlint lock/deadline rules patrol this module —
see ``znicz_tpu_torch/analysis``).

:class:`ReplayLoader` adapts a snapshot of the log to the repo's
loader protocol (:class:`~znicz_tpu_torch.loader.streaming.StreamingLoader`)
— train/validation ``class_lengths`` with every ``holdback_every``-th
record held back as the validation slice, labels derived from the
served outputs' argmax — so the unit-graph path can train from
captured traffic exactly like any other dataset.
"""

from __future__ import annotations

import os
import random
import threading
import time

import numpy as np

from ..loader.streaming import StreamingLoader
from ..telemetry.registry import REGISTRY
from . import capture as cap

_loaded = REGISTRY.counter(
    "replay_records_total",
    "capture-log records loaded by a replay tailer (complete, "
    "crc-verified frames handed to the continual trainer)")
_torn = REGISTRY.counter(
    "replay_torn_records_total",
    "unusable capture-log tails skipped by a replay tailer: a crc or "
    "framing mismatch, or an incomplete record on a segment the "
    "writer has already rolled past (crash debris, not data loss of "
    "the retained ring)")


class ReplayReader:
    """Single-consumer tailer over a capture directory.

    ``window`` bounds the pending-record buffer: when the trainer
    falls behind, the oldest unconsumed records are dropped (the point
    of replaying *live* traffic is recency, and an unbounded buffer
    would just be the queue-growth failure mode again).  Batches are
    drawn without replacement from the window by a seeded shuffle, so
    a fixed log + seed + call sequence replays bit-identically.
    """

    def __init__(self, directory: str, *, seed: int = 0,
                 window: int = 4096, model: str | None = None):
        self.directory = os.path.abspath(os.fspath(directory))
        self.window = int(window)
        self.model = model
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._buf: list[cap.CaptureRecord] = []
        #: per-segment consumed offset (path -> bytes); segments that
        #: disappeared from disk (ring-trimmed) are forgotten
        self._offsets: dict[str, int] = {}
        self._finished: set[str] = set()
        self.records_loaded = 0
        self.records_dropped = 0
        self.torn = 0

    # -- tailing -----------------------------------------------------------
    def poll(self) -> int:
        """Scan for new bytes once (no waiting): parse every readable
        new record into the window.  Returns how many records were
        loaded.  All file I/O happens lock-free; the buffer splice at
        the end is the only locked region."""
        segments = cap.segment_files(self.directory)
        live = set(segments)
        fresh: list[cap.CaptureRecord] = []
        torn = 0
        newest = segments[-1] if segments else None
        for path in segments:
            if path in self._finished:
                continue
            offset = self._offsets.get(path, 0)
            try:
                records, new_offset, status = cap.read_records(path,
                                                               offset)
            except OSError:
                continue                    # trimmed under us
            fresh.extend(records)
            self._offsets[path] = new_offset
            if status == "ok":
                if path != newest:
                    # fully consumed and the writer moved on: done
                    self._finished.add(path)
            elif status == "torn":
                torn += 1
                self._finished.add(path)
            elif status == "partial" and path != newest:
                # the writer rolled past a half-written tail — it will
                # never complete; count it and move on
                torn += 1
                self._finished.add(path)
        # forget state for ring-trimmed segments
        for path in list(self._offsets):
            if path not in live:
                self._offsets.pop(path, None)
                self._finished.discard(path)
        if self.model is not None:
            fresh = [r for r in fresh if r.model == self.model]
        with self._lock:
            self._buf.extend(fresh)
            overflow = len(self._buf) - self.window
            if overflow > 0:
                del self._buf[:overflow]
                self.records_dropped += overflow
            self.records_loaded += len(fresh)
            self.torn += torn
        if fresh:
            _loaded.inc(len(fresh))
        if torn:
            _torn.inc(torn)
        return len(fresh)

    def pending(self) -> int:
        with self._lock:
            return len(self._buf)

    def take(self, n: int, *, timeout_s: float = 0.0,
             poll_interval_s: float = 0.05
             ) -> list[cap.CaptureRecord]:
        """Up to ``n`` records, drawn without replacement from the
        window by the seeded shuffle.  Polls the log until ``n`` are
        pending or ``timeout_s`` elapses, then returns **what exists**
        — an empty list on a cold log, never an unbounded block (the
        honest-degradation contract the trainer's ``starved`` outcome
        builds on)."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        self.poll()
        while self.pending() < n and time.monotonic() < deadline:
            time.sleep(min(poll_interval_s,
                           max(0.0, deadline - time.monotonic())))
            self.poll()
        with self._lock:
            k = min(n, len(self._buf))
            if k == 0:
                return []
            picks = self._rng.sample(range(len(self._buf)), k)
            picks.sort()
            out = [self._buf[i] for i in picks]
            for i in reversed(picks):
                del self._buf[i]
            return out

    def status(self) -> dict:
        with self._lock:
            return {"pending": len(self._buf),
                    "loaded": self.records_loaded,
                    "dropped": self.records_dropped,
                    "torn": self.torn,
                    "window": self.window}


def records_to_arrays(records) -> tuple[np.ndarray, np.ndarray]:
    """Stack records into ``(x, y)`` float32 batches.  Multi-row
    requests contribute one row per sample; ragged feature widths (a
    mixed-model capture read without a ``model=`` filter) raise."""
    xs, ys = [], []
    for r in records:
        x = np.asarray(r.x, np.float32)
        y = np.asarray(r.y, np.float32)
        if x.ndim == 1:
            x = x[None]
        if y.ndim == 1:
            y = y[None]
        xs.append(x)
        ys.append(y)
    if not xs:
        return (np.zeros((0, 0), np.float32),
                np.zeros((0, 0), np.float32))
    return np.concatenate(xs), np.concatenate(ys)


class ReplayLoader(StreamingLoader):
    """Loader-protocol view of one capture-log snapshot.

    ``load_data`` materializes everything currently replayable: every
    ``holdback_every``-th row becomes the *validation* class (the
    held-back slice the blessing evaluation judges), the rest train;
    labels are the served outputs' argmax — the "chosen label" of
    self-training on one's own traffic.  ``refresh()`` re-polls the
    log and rebuilds the classes in place for the next epoch."""

    def __init__(self, directory: str, *, minibatch_size: int = 32,
                 holdback_every: int = 8, seed: int = 0,
                 model: str | None = None, window: int = 65536,
                 max_rows: int | None = None, **kwargs):
        super().__init__(None, "replay_loader",
                         minibatch_size=minibatch_size, **kwargs)
        if holdback_every < 2:
            raise ValueError(f"holdback_every must be >= 2 (1 would "
                             f"hold back EVERY row), got "
                             f"{holdback_every}")
        self.holdback_every = int(holdback_every)
        self.reader = ReplayReader(directory, seed=seed, model=model,
                                   window=window)
        #: backing-array row bound: every other stage of the loop is
        #: byte- or window-bounded, and a loader refreshed every epoch
        #: against a live ring must not concatenate toward OOM —
        #: oldest rows FIFO-trim past this (default: one window)
        self.max_rows = int(max_rows) if max_rows is not None \
            else int(window)
        self._data = np.zeros((0, 0), np.float32)
        self._labels = np.zeros((0,), np.int32)

    def refresh(self) -> int:
        """Pull everything newly replayable into the backing arrays;
        returns the number of rows added."""
        fresh = self.reader.take(self.reader.window, timeout_s=0.0)
        if not fresh:
            return 0
        x, y = records_to_arrays(fresh)
        labels = np.argmax(y, axis=1).astype(np.int32)
        if self._data.size == 0:
            self._data, self._labels = x, labels
        else:
            self._data = np.concatenate([self._data, x])
            self._labels = np.concatenate([self._labels, labels])
        if len(self._data) > self.max_rows:
            # FIFO trim (recency wins, same stance as the reader's
            # window).  The holdback pattern is positional, so a trim
            # can migrate a surviving row between classes — this
            # adapter feeds generic loader-protocol training, not the
            # OnlineTrainer's never-trained eval slice (that one keeps
            # its own FIFO-capped holdback)
            self._data = self._data[-self.max_rows:]
            self._labels = self._labels[-self.max_rows:]
        n = len(self._data)
        hold = np.zeros(n, bool)
        hold[::self.holdback_every] = True
        # base-class index space: test | validation | train
        self._valid_rows = np.flatnonzero(hold)
        self._train_rows = np.flatnonzero(~hold)
        self.class_lengths = [0, len(self._valid_rows),
                              len(self._train_rows)]
        return len(x)

    # -- StreamingLoader contract -----------------------------------------
    def load_meta(self) -> None:
        self.refresh()
        if not any(self.class_lengths):
            raise ValueError(
                f"capture log {self.reader.directory!r} holds no "
                f"replayable records yet (cold log) — retry after "
                f"traffic has flowed")
        self.sample_shape = tuple(self._data.shape[1:])
        self.raw_sample_shape = self.sample_shape
        self.label_dtype = np.int32

    def read_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        rows = np.concatenate([self._valid_rows, self._train_rows])
        picked = rows[np.asarray(indices, np.int64)]
        return self._data[picked], self._labels[picked]
