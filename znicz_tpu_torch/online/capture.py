"""Traffic capture: a bounded, sampled, fsync'd replay log of /predict.

The paper's lineage made *serving traffic* the training feed — VELES's
master–slave topology existed to stream data into training
(``apply_data_from_slave`` aggregation, PAPER.md), and its Kohonen
units are explicitly online learners.  This module is the serving-side
half of that loop: a **tap** on the request path that appends every
served ``(input tensor, chosen outputs)`` pair to an append-only log
the continual trainer (:mod:`znicz_tpu_torch.online.trainer`) replays.

Design constraints, in priority order:

1. **Fail-open.**  The tap rides the request path: a full disk, a slow
   fsync, a log-roll error — or the injected ``capture.append`` chaos
   fault — must never fail or delay a ``/predict`` answer.  ``append``
   only enqueues into a bounded in-memory ring and swallows every
   exception (counted in ``capture_dropped_total{reason}``); all file
   I/O happens on one background writer thread.
2. **Bounded.**  The log is a byte-budgeted ring of segment files
   (``seg-<n>.zcap``): when the retained bytes exceed ``max_bytes``
   the oldest *closed* segments are deleted.  The in-memory queue is
   bounded too — a stalled disk drops records (``reason=backlog``),
   it does not grow the heap.
3. **Durable enough to replay.**  The writer fsyncs after every write
   batch and on every segment roll, so a crashed serving process loses
   at most the last in-flight batch; the record framing (length +
   crc32) lets the replay tailer detect and tolerate a torn tail.
4. **Sampled.**  ``sample < 1.0`` keeps a seeded fraction of served
   answers (``reason=sampled`` counts the rest) — heavy fleets don't
   need every request to fine-tune on.

Record framing (one segment = a run of records)::

    magic   b"ZCR1"             4 bytes
    u32     payload length
    u32     crc32(payload)
    payload:
        u8   model-name length, name bytes (utf-8; 0 = single-model)
        u32  x length,  x as a serving.wire binary tensor
        u32  y length,  y as a serving.wire binary tensor

Tensors reuse the binary wire format (:mod:`znicz_tpu_torch.serving.wire`) —
one encoder/decoder for the HTTP hot path and the replay log.  The
framing is the reference's byte for byte, so a ring written by either
package replays in the other.
"""

from __future__ import annotations

import collections
import os
import random
import struct
import threading
import time
import zlib

import numpy as np

from ..resilience import faults
from ..serving import wire
from ..telemetry.registry import REGISTRY

#: record framing header: magic, payload length, crc32(payload)
REC_HEADER = struct.Struct("<4sII")
REC_MAGIC = b"ZCR1"
SEGMENT_PREFIX = "seg-"
SEGMENT_SUFFIX = ".zcap"

_records = REGISTRY.counter(
    "capture_records_total",
    "served /predict (input, outputs) pairs committed to the traffic "
    "capture log (after sampling; the continual trainer's feed)")
_dropped = REGISTRY.counter(
    "capture_dropped_total",
    "served answers NOT captured, by reason (sampled = the --capture-"
    "sample coin | backlog = the bounded writer queue was full | "
    "error = an append/write/roll/fsync failure, incl. the injected "
    "capture.append fault | closed = tap already shut down) — the tap "
    "is fail-open, so every drop lands here instead of in a client's "
    "answer")
_bytes_g = REGISTRY.gauge(
    "capture_bytes",
    "bytes currently retained across the capture log's segment files "
    "(the ring deletes the oldest closed segments past --capture-mb)")
_segments_g = REGISTRY.gauge(
    "capture_segments",
    "segment files currently retained in the capture log ring")


class CaptureRecord:
    """One replayable traffic sample."""

    __slots__ = ("model", "x", "y")

    def __init__(self, model: str | None, x: np.ndarray, y: np.ndarray):
        self.model = model
        self.x = x
        self.y = y


def encode_record(model: str | None, x: np.ndarray,
                  y: np.ndarray) -> bytes:
    """One framed record: header + (name, x-wire, y-wire) payload."""
    name = (model or "").encode("utf-8")
    if len(name) > 255:
        raise ValueError(f"model name too long for the record frame "
                         f"({len(name)} bytes)")
    xb = wire.encode_tensor(np.ascontiguousarray(x, np.float32))
    yb = wire.encode_tensor(np.ascontiguousarray(y, np.float32))
    payload = (struct.pack("<B", len(name)) + name
               + struct.pack("<I", len(xb)) + xb
               + struct.pack("<I", len(yb)) + yb)
    return REC_HEADER.pack(REC_MAGIC, len(payload),
                           zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> CaptureRecord:
    (nlen,) = struct.unpack_from("<B", payload, 0)
    off = 1
    name = payload[off:off + nlen].decode("utf-8") or None
    off += nlen
    (xlen,) = struct.unpack_from("<I", payload, off)
    off += 4
    x = wire.decode_tensor(payload[off:off + xlen])
    off += xlen
    (ylen,) = struct.unpack_from("<I", payload, off)
    off += 4
    y = wire.decode_tensor(payload[off:off + ylen])
    return CaptureRecord(name, x, y)


def segment_files(directory: str) -> list[str]:
    """Retained segment paths, oldest first (names sort by sequence)."""
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(SEGMENT_PREFIX)
                       and n.endswith(SEGMENT_SUFFIX))
    except FileNotFoundError:
        return []
    return [os.path.join(directory, n) for n in names]


def read_records(path: str, offset: int = 0):
    """Parse complete records from ``path`` starting at ``offset``.

    Returns ``(records, new_offset, status)`` where status is

    * ``"ok"`` — the segment parsed cleanly to its end;
    * ``"partial"`` — an incomplete record at the tail (a writer may
      still be mid-append; retry from ``new_offset`` later);
    * ``"torn"`` — a crc/magic mismatch at ``new_offset``: the bytes
      from there on are unusable (a crashed writer's torn tail — the
      length field itself may be garbage, so skipping past it is not
      safe).

    The replay tailer maps these onto its degradation policy; this
    function never raises for content problems (an unreadable FILE
    still raises OSError — the caller owns that policy).
    """
    with open(path, "rb") as fh:
        fh.seek(offset)
        blob = fh.read()
    records: list[CaptureRecord] = []
    pos = 0
    n = len(blob)
    while True:
        if pos + REC_HEADER.size > n:
            status = "ok" if pos == n else "partial"
            return records, offset + pos, status
        magic, plen, crc = REC_HEADER.unpack_from(blob, pos)
        if magic != REC_MAGIC:
            return records, offset + pos, "torn"
        end = pos + REC_HEADER.size + plen
        if end > n:
            return records, offset + pos, "partial"
        payload = blob[pos + REC_HEADER.size:end]
        if zlib.crc32(payload) != crc:
            return records, offset + pos, "torn"
        try:
            records.append(decode_payload(payload))
        except Exception:
            # a record that framed cleanly but decodes rotten: skip it
            # alone (the frame told us exactly where the next starts)
            pass
        pos = end


class CaptureLog:
    """The serving tap: bounded queue in front of one writer thread.

    ``append`` is the only request-path call and it cannot raise or
    block on I/O; everything else (encode, write, fsync, roll, ring
    trim) happens on the ``znicz-capture-writer`` thread.
    """

    def __init__(self, directory: str, *, max_bytes: int = 64_000_000,
                 segment_bytes: int | None = None, sample: float = 1.0,
                 seed: int = 0, queue_depth: int = 512,
                 flush_interval_s: float = 0.2):
        if not 0.0 < sample <= 1.0:
            raise ValueError(f"sample must be in (0, 1], got {sample}")
        if int(max_bytes) < 4096:
            raise ValueError(f"max_bytes must be >= 4096, got "
                             f"{max_bytes}")
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_bytes = int(max_bytes)
        #: segments roll well under the budget so the ring always has
        #: closed segments to delete — a single giant open segment
        #: could never be trimmed
        self.segment_bytes = int(segment_bytes) if segment_bytes \
            else max(4096, self.max_bytes // 8)
        self.sample = float(sample)
        self.queue_depth = int(queue_depth)
        self.flush_interval_s = float(flush_interval_s)
        self._lock = threading.Lock()
        self._q: collections.deque = collections.deque()
        self._inflight = 0
        self._stats = collections.Counter()
        self._rng = random.Random(seed)
        self._closed = False
        # writer-thread-only file state (never touched under _lock —
        # the writer owns it; metrics() reads the two scalars lock-free
        # as a deliberately racy-but-benign snapshot)
        self._fh = None
        self._seg_seq = 0
        self._seg_open_bytes = 0
        self._retained: list = []         # [(path, bytes)] closed segs
        self._retained_bytes = 0
        self._adopt_existing()
        self._wake = threading.Event()
        self._done = threading.Event()
        self._writer = threading.Thread(target=self._writer_loop,
                                        daemon=True,
                                        name="znicz-capture-writer")
        self._writer.start()

    # -- request path ------------------------------------------------------
    def append(self, x, y, model: str | None = None) -> bool:
        """Enqueue one served sample.  Fail-open: never raises, never
        does file I/O; a False return means the sample was dropped
        (sampled out, queue full, tap closed, or an injected/real
        failure) and counted in ``capture_dropped_total``."""
        try:
            faults.inject("capture.append")
            with self._lock:
                if self._closed:
                    self._stats["dropped_closed"] += 1
                    reason = "closed"
                elif self.sample < 1.0 \
                        and self._rng.random() >= self.sample:
                    self._stats["dropped_sampled"] += 1
                    reason = "sampled"
                elif len(self._q) >= self.queue_depth:
                    self._stats["dropped_backlog"] += 1
                    reason = "backlog"
                else:
                    self._q.append((model, x, y))
                    reason = None
            if reason is None:
                self._wake.set()
                return True
            _dropped.inc(reason=reason)
            return False
        except Exception:
            # the fail-open contract: ANY failure here (including the
            # capture.append chaos fault) is a dropped sample, never a
            # failed or delayed answer
            try:
                with self._lock:
                    self._stats["dropped_error"] += 1
                _dropped.inc(reason="error")
            except Exception:
                pass
            return False

    # -- writer thread -----------------------------------------------------
    def _writer_loop(self) -> None:
        while True:
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            batch = self._drain()
            if batch:
                self._write_batch(batch)
            with self._lock:
                closed = self._closed and not self._q
            if closed:
                break
        self._close_segment()
        self._done.set()

    def _drain(self) -> list:
        with self._lock:
            batch = list(self._q)
            self._q.clear()
            self._inflight = len(batch)
        return batch

    def _write_batch(self, batch: list) -> None:
        wrote = 0
        for model, x, y in batch:
            try:
                blob = encode_record(model, x, y)
                if self._fh is not None \
                        and self._seg_open_bytes + len(blob) \
                        > self.segment_bytes:
                    self._close_segment()
                if self._fh is None:
                    self._open_segment()
                self._fh.write(blob)
                self._seg_open_bytes += len(blob)
                wrote += 1
            except Exception:
                with self._lock:
                    self._stats["dropped_error"] += 1
                _dropped.inc(reason="error")
        if wrote:
            try:
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except Exception:
                # durability degraded, service intact: the records are
                # in the page cache at worst — count, keep serving
                with self._lock:
                    self._stats["fsync_errors"] += 1
            with self._lock:
                self._stats["records"] += wrote
            _records.inc(wrote)
        self._trim_ring()
        self._publish_gauges()
        with self._lock:
            self._inflight = 0

    def _adopt_existing(self) -> None:
        """A restarted server appends AFTER the existing ring instead
        of clobbering it — the replay log outlives one process."""
        for path in segment_files(self.directory):
            try:
                nbytes = os.path.getsize(path)
            except OSError:
                continue
            name = os.path.basename(path)
            try:
                seq = int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
            except ValueError:
                continue
            self._seg_seq = max(self._seg_seq, seq + 1)
            self._retained.append((path, nbytes))
            self._retained_bytes += nbytes

    def _open_segment(self) -> None:
        path = os.path.join(
            self.directory,
            f"{SEGMENT_PREFIX}{self._seg_seq:08d}{SEGMENT_SUFFIX}")
        self._seg_seq += 1
        self._fh = open(path, "ab")
        self._seg_path = path
        self._seg_open_bytes = 0

    def _close_segment(self) -> None:
        if self._fh is None:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        except Exception:
            with self._lock:
                self._stats["fsync_errors"] += 1
        self._retained.append((self._seg_path, self._seg_open_bytes))
        self._retained_bytes += self._seg_open_bytes
        self._fh = None
        self._seg_open_bytes = 0

    def _trim_ring(self) -> None:
        """Delete oldest closed segments until retained + open bytes
        fit the budget."""
        while self._retained and (self._retained_bytes
                                  + self._seg_open_bytes
                                  > self.max_bytes):
            path, nbytes = self._retained.pop(0)
            try:
                os.unlink(path)
            except OSError:
                pass
            self._retained_bytes -= nbytes
            with self._lock:
                self._stats["segments_deleted"] += 1

    def _publish_gauges(self) -> None:
        _bytes_g.set(self._retained_bytes + self._seg_open_bytes)
        _segments_g.set(len(self._retained)
                        + (1 if self._fh is not None else 0))

    # -- introspection / lifecycle ----------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            stats = dict(self._stats)
            queued = len(self._q)
        return {"directory": self.directory,
                "records": stats.get("records", 0),
                "queued": queued,
                "dropped_sampled": stats.get("dropped_sampled", 0),
                "dropped_backlog": stats.get("dropped_backlog", 0),
                "dropped_error": stats.get("dropped_error", 0),
                "dropped_closed": stats.get("dropped_closed", 0),
                "fsync_errors": stats.get("fsync_errors", 0),
                "segments_deleted": stats.get("segments_deleted", 0),
                # benign racy snapshot of writer-owned state: a scrape
                # mid-roll may be one record stale, never torn
                "bytes": self._retained_bytes + self._seg_open_bytes,
                "segments": len(self._retained)
                + (1 if self._fh is not None else 0),
                "max_bytes": self.max_bytes,
                "segment_bytes": self.segment_bytes,
                "sample": self.sample}

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Block (bounded) until the queue has drained and the bytes
        are fsync'd — the tests' and the drill's barrier, not a
        request-path call."""
        deadline = time.monotonic() + timeout_s
        self._wake.set()
        while time.monotonic() < deadline:
            with self._lock:
                settled = not self._q and self._inflight == 0
            if settled:
                return True
            self._wake.set()
            time.sleep(0.01)
        return False

    def close(self, timeout_s: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._done.wait(timeout_s)
        self._publish_gauges()
