"""Streaming loaders: datasets bigger than device memory, served from disk
(port of ``znicz_tpu/loader/streaming.py``).

* :class:`StreamingLoader`: a ``Loader`` whose backing store is not
  resident; subclasses implement ``read_batch(global_indices)``.  The unit
  graph works unchanged (``fill_minibatch`` reads through it); the fused
  path streams through :class:`BatchPrefetcher`.
* :class:`RecordLoader`: ``.znr`` shards (``loader.records``).
* :class:`OnTheFlyImageLoader`: directory-per-class images decoded per
  minibatch in a thread pool.
* :class:`BatchPrefetcher`: the host-to-card pipeline.  A producer thread
  reads (and, unless ``raw``, augments) minibatch *i + depth* into a ring
  of pinned host buffers while the card computes minibatch *i*, and copies
  each buffer to the card with ``non_blocking=True`` on a side stream.  The
  consumer's stream waits for the copy's event, never the host; a pinned
  buffer is refilled only once its copy's event has completed.  The copy
  lands in a fresh device tensor (``record_stream`` on the consumer's
  stream keeps it alive until the step that reads it ends) or, given a
  :class:`StagingRing` with device slots, in the slot a captured step
  reads; a slot is written again only after the step that read it, whose
  end the consumer records when it asks for the next minibatch."""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from ..thread_pool import ThreadPool
from .base import TEST, TRAIN, VALID, Loader
from .image import IMAGE_EXTS, decode_image
from .records import RecordFile

__all__ = ["TEST", "TRAIN", "VALID", "StreamingLoader", "RecordLoader",
           "OnTheFlyImageLoader", "StagingRing", "BatchPrefetcher"]


class StreamingLoader(Loader):
    """Minibatch scheduler over a non-resident backing store.

    Subclass contract: ``load_meta()`` sets ``class_lengths``,
    ``sample_shape``, ``label_dtype``; ``read_batch(indices)`` returns
    materialized ``(data, labels)`` for *global* indices (test rows first,
    then validation, then train: the base class's index space)."""

    def __init__(self, workflow=None, name=None, augment=None, **kwargs):
        super().__init__(workflow, name or "streaming_loader", **kwargs)
        self.sample_shape: tuple = ()
        self.raw_sample_shape: tuple = ()
        self.label_shape: tuple = ()      # () = scalar class labels
        self.label_dtype = np.int32
        #: optional train-time policy (loader.augment.RandomCropFlip):
        #: applied on the host per fetch; train and eval rows told apart by
        #: global index, so eval rows are deterministic in any batch
        self.augment = augment

    # -- subclass API ----------------------------------------------------------
    def load_meta(self) -> None:
        raise NotImplementedError

    def read_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def read_data(self, indices) -> np.ndarray:
        """Data rows only; overridden where skipping the label block saves
        real I/O (RecordLoader)."""
        return self.read_batch(indices)[0]

    def read_batch_into(self, indices, data_out: np.ndarray,
                        labels_out: np.ndarray | None) -> None:
        """Un-augmented rows into caller buffers (the prefetcher's pinned
        ring); ``labels_out`` None skips the labels.  Overridden where the
        reader can write there directly (RecordLoader)."""
        if labels_out is None:
            data_out[...] = self.read_data(indices)
        else:
            data, labels = self.read_batch(indices)
            data_out[...] = data
            labels_out[...] = labels

    # -- augmentation ----------------------------------------------------------
    def _train_base(self) -> int:
        return self.class_lengths[TEST] + self.class_lengths[VALID]

    def _augmented(self, data, indices, epoch):
        if self.augment is None:
            return data
        idx = np.asarray(indices)
        return self.augment.apply(data, idx, epoch,
                                  idx >= self._train_base())

    def fetch(self, indices, epoch=None):
        """read_batch and augmentation: what consumers should call."""
        data, labels = self.read_batch(indices)
        return self._augmented(data, indices, epoch), labels

    def fetch_data(self, indices, epoch=None):
        return self._augmented(self.read_data(indices), indices, epoch)

    # -- Loader plumbing -------------------------------------------------------
    def load_data(self) -> None:
        self.load_meta()
        #: decoded (pre-augmentation) shape, what read_batch returns;
        #: sample_shape is what the model sees
        self.raw_sample_shape = self.sample_shape
        if self.augment is not None:
            if len(self.label_shape) >= 2:
                # a spatial label block (denoising targets) would stay
                # uncropped and misalign with the augmented input
                raise ValueError(
                    f"{self.name}: augmentation with spatial labels "
                    f"{self.label_shape} is unsupported — targets would "
                    "not follow the input crops")
            self.sample_shape = self.augment.out_shape(self.sample_shape)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        self.minibatch_data.mem = np.zeros(
            (self.max_minibatch_size, *self.sample_shape), np.float32)
        self.minibatch_labels.mem = np.zeros(
            (self.max_minibatch_size, *self.label_shape), self.label_dtype)
        self.minibatch_data.initialize(self.device)
        self.minibatch_labels.initialize(self.device)

    def fill_minibatch(self, indices: np.ndarray, klass: int) -> None:
        data, labels = self.fetch(indices, epoch=self.epoch_number)
        size = len(indices)
        if size < self.max_minibatch_size:       # static-shape padding
            pad = self.max_minibatch_size - size
            data = np.concatenate([data, np.repeat(data[-1:], pad, axis=0)])
            labels = np.concatenate(
                [labels, np.repeat(labels[-1:], pad, axis=0)])
        self.minibatch_data.mem = np.ascontiguousarray(data, np.float32)
        self.minibatch_labels.mem = np.ascontiguousarray(labels,
                                                         self.label_dtype)


class RecordLoader(StreamingLoader):
    """``.znr`` shards with train/valid/test shard lists; the global index
    space is the base class's (test | validation | train, in shard
    order)."""

    def __init__(self, workflow=None, name=None, train_paths=(),
                 validation_paths=(), test_paths=(), **kwargs):
        super().__init__(workflow, name or "record_loader", **kwargs)
        self.split_paths = (list(test_paths), list(validation_paths),
                            list(train_paths))

    def load_meta(self) -> None:
        self._files: list[RecordFile] = []
        self._file_base: list[int] = []        # global index of row 0
        base = 0
        lengths = [0, 0, 0]
        for klass, paths in ((TEST, self.split_paths[0]),
                             (VALID, self.split_paths[1]),
                             (TRAIN, self.split_paths[2])):
            for p in paths:
                rf = RecordFile(p)
                self._files.append(rf)
                self._file_base.append(base)
                base += len(rf)
                lengths[klass] += len(rf)
        if not self._files:
            raise ValueError(f"{self.name}: no record shards given")
        shapes = {f.data_shape for f in self._files}
        if len(shapes) != 1:
            raise ValueError(f"{self.name}: shards disagree on sample "
                             f"shape: {shapes}")
        # the native scatter writes each shard's own label row width into
        # one buffer, so the label geometry must agree too
        lshapes = {f.label_shape for f in self._files}
        if len(lshapes) != 1:
            raise ValueError(f"{self.name}: shards disagree on label "
                             f"shape: {lshapes}")
        ldtypes = {np.dtype(f.label_dtype) for f in self._files}
        if len(ldtypes) != 1:
            raise ValueError(f"{self.name}: shards disagree on label "
                             f"dtype: {ldtypes}")
        self.class_lengths = lengths
        self.sample_shape = self._files[0].data_shape
        self.label_shape = self._files[0].label_shape
        self.label_dtype = self._files[0].label_dtype
        self._bounds = np.asarray(self._file_base + [base])

    @property
    def reader(self) -> str:
        """``"native"`` when every shard has the native reader, else
        ``"numpy"``."""
        return ("native" if all(f.reader == "native" for f in self._files)
                else "numpy")

    def served(self) -> dict:
        """Rows served by each reader over every shard."""
        out = {"native": 0, "numpy": 0}
        for f in self._files:
            for k, v in f.served.items():
                out[k] += v
        return out

    def _split(self, indices):
        """(rows, each row's shard, the shards) of global ``indices``."""
        idx = np.asarray(indices, np.int64)
        if len(idx) and (idx.min() < 0 or idx.max() >= self._bounds[-1]):
            raise IndexError(f"{self.name}: rows outside [0, "
                             f"{self._bounds[-1]})")
        which = np.searchsorted(self._bounds, idx, side="right") - 1
        return idx, which, np.unique(which)

    def read_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        idx, which, files = self._split(indices)
        if len(files) == 1 and self._files[files[0]].data_dtype \
                == np.float32:
            # one shard (the common case): its gather is the result
            f_i = files[0]
            return self._files[f_i].read_batch(idx - self._file_base[f_i])
        data = np.empty((len(idx), *self.raw_sample_shape), np.float32)
        labels = np.empty((len(idx), *self.label_shape), self.label_dtype)
        self.read_batch_into(idx, data, labels)
        return data, labels

    def read_data(self, indices) -> np.ndarray:
        """Data rows only: the label block's I/O is skipped."""
        idx, which, files = self._split(indices)
        if len(files) == 1 and self._files[files[0]].data_dtype \
                == np.float32:
            f_i = files[0]
            return self._files[f_i].read_data(idx - self._file_base[f_i])
        data = np.empty((len(idx), *self.raw_sample_shape), np.float32)
        self.read_batch_into(idx, data, None)
        return data

    def read_batch_into(self, indices, data_out, labels_out) -> None:
        """Each shard's rows scattered straight into the buffers by the
        native reader where the dtypes match, else copied."""
        idx, which, files = self._split(indices)
        for f_i in files:
            sel = which == f_i
            local = idx[sel] - self._file_base[f_i]
            rf = self._files[f_i]
            if rf.read_batch_into(local, data_out, labels_out,
                                  np.flatnonzero(sel)):
                continue
            if labels_out is None:
                data_out[sel] = rf.read_data(local)
            else:
                d, lab = rf.read_batch(local)
                data_out[sel] = d
                labels_out[sel] = lab


class OnTheFlyImageLoader(StreamingLoader):
    """Directory-per-class images decoded per minibatch in a thread pool
    (PIL releases the GIL around decode); the directory convention and
    options of ``FullBatchImageLoader``."""

    def __init__(self, workflow=None, name=None, train_paths=(),
                 validation_paths=(), test_paths=(), size=None,
                 grayscale=False, crop=None, scale=1.0 / 255.0,
                 decode_workers: int = 8, **kwargs):
        super().__init__(workflow, name or "otf_image_loader", **kwargs)
        self.train_paths = list(train_paths)
        self.validation_paths = list(validation_paths)
        self.test_paths = list(test_paths)
        self.size = size
        self.grayscale = grayscale
        self.crop = crop
        self.scale = scale
        self.decode_workers = decode_workers
        self.label_map: dict[str, int] = {}
        self._pool: ThreadPool | None = None

    def _scan_split(self, paths) -> list[tuple[str, str]]:
        found = []
        for root_dir in paths:
            for sub in sorted(os.listdir(root_dir)):
                full = os.path.join(root_dir, sub)
                if os.path.isdir(full):
                    for f in sorted(os.listdir(full)):
                        if f.lower().endswith(IMAGE_EXTS):
                            found.append((os.path.join(full, f), sub))
                elif sub.lower().endswith(IMAGE_EXTS):
                    found.append((full, ""))
        return found

    def load_meta(self) -> None:
        splits = [self._scan_split(p) for p in
                  (self.test_paths, self.validation_paths,
                   self.train_paths)]
        classes = sorted({c for split in splits for _, c in split})
        self.label_map = {c: i for i, c in enumerate(classes)}
        self._paths = [p for split in splits for p, _ in split]
        self._labels = np.asarray(
            [self.label_map[c] for split in splits for _, c in split],
            np.int32)
        if not self._paths:
            raise ValueError(f"{self.name}: no images found")
        self.class_lengths = [len(s) for s in splits]
        probe = self._decode(self._paths[0])
        self.sample_shape = probe.shape
        self.label_dtype = np.int32

    def _decode(self, path: str) -> np.ndarray:
        return decode_image(path, self.size, self.grayscale,
                            self.crop) * self.scale

    def read_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        idx = np.asarray(indices)
        if self._pool is None:
            self._pool = ThreadPool(self.decode_workers, name=self.name)
        imgs = list(self._pool.map(self._decode,
                                   [self._paths[i] for i in idx]))
        shapes = {a.shape for a in imgs}
        if len(shapes) != 1:
            raise ValueError(f"{self.name}: mixed image shapes {shapes};"
                             " pass size=(w, h) to rescale")
        return np.stack(imgs).astype(np.float32), self._labels[idx]

    @property
    def n_classes(self) -> int:
        return len(self.label_map)


class StagingRing:
    """The buffers a stream of minibatches moves through, kept across the
    calls of one trainer: ``slots`` pinned host buffers of
    (batch, *x_shape) float32 (and labels of ``t_shape``/``t_dtype``; None:
    no labels), the side stream their copies run on, and with ``dest`` as
    many device slots, ``x[k]``/``t[k]``, that the copies fill.  Each host
    buffer keeps the event of its last copy, each device slot the event of
    the last step that read it.  On the CPU the buffers are plain tensors
    and nothing waits."""

    def __init__(self, device, slots: int, batch: int, x_shape, t_shape=None,
                 t_dtype=np.int32, dest: bool = False):
        self.device = torch.device(device)
        self.slots, self.batch = int(slots), int(batch)
        self.cuda = self.device.type == "cuda"
        tdt = None if t_shape is None else torch.from_numpy(
            np.zeros((), t_dtype)).dtype

        def buffers(device, pin):
            xs = torch.empty((self.slots, self.batch, *x_shape),
                             dtype=torch.float32, device=device,
                             pin_memory=pin)
            ts = None if tdt is None else torch.empty(
                (self.slots, self.batch, *t_shape), dtype=tdt,
                device=device, pin_memory=pin)
            return xs, ts
        self.host_x = self.host_t = None
        if self.cuda:
            self.host_x, self.host_t = buffers("cpu", True)
            self.stream = torch.cuda.Stream(self.device)
        self.x = self.t = None
        if dest:
            self.x, self.t = buffers(self.device, False)
        #: per host buffer: the event of its last copy; per device slot:
        #: the event recorded after the last step that read it
        self.copied: list = [None] * self.slots
        self.read: list = [None] * self.slots


class BatchPrefetcher:
    """Host-to-card pipeline over a streaming loader.

    Iterates ``(x, t)`` tensors on ``device`` (default: the CUDA card,
    raising without one) for a sequence of index rows of equal length: a
    daemon thread reads batch *i + depth* while the consumer computes batch
    *i* (module docstring).  ``skip_labels`` yields ``(x, None)`` and reads
    only the data rows; ``raw`` ships un-augmented rows (the consumer crops
    on the card); ``epoch`` is the augmentation coordinate (None: eval
    center crops).  ``ring`` (a :class:`StagingRing`) is reused across
    calls; without one the prefetcher makes its own, of depth + 1 slots.
    With a ring that has device slots, each yielded ``x``/``t`` is the
    slot's view ``ring.x[i % slots]``, valid until the next item is asked
    for.  ``stats`` holds the host read seconds, the batches and, on the
    card, the copies' start and end events."""

    def __init__(self, loader: StreamingLoader, index_rows, depth: int = 2,
                 device=None, skip_labels: bool = False, epoch=None,
                 raw: bool = False, ring: StagingRing | None = None):
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        self.loader = loader
        self.rows = [np.asarray(r) for r in index_rows]
        widths = {len(r) for r in self.rows}
        if len(widths) > 1:
            raise ValueError(f"index rows of unequal length {widths}")
        self.depth = depth
        self.device = torch.device(device)
        #: augmentation coordinate (None: eval center crops)
        self.epoch = epoch
        #: raw=True ships unaugmented decode-size rows: the consumer
        #: applies the policy on the card (StreamTrainer device_augment)
        self.raw = raw
        #: the consumer reconstructs its input: yield (x, None) and skip
        #: the label block's I/O
        self.skip_labels = skip_labels
        if ring is None and self.rows:
            ring = StagingRing(
                self.device, depth + 1, len(self.rows[0]),
                loader.raw_sample_shape if raw else loader.sample_shape,
                None if skip_labels else loader.label_shape,
                loader.label_dtype)
        self.ring = ring
        self.stats = {"read_s": 0.0, "batches": 0, "copies": []}
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        #: device slots the producer may write (released by the consumer)
        self._slots = threading.Semaphore(ring.slots if ring else 1)
        self._err = None
        self._stopped = False
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="znicz-prefetch")
        self._thread.start()

    # -- producer --------------------------------------------------------------
    def _read(self, row, x_out, t_out) -> tuple:
        """Rows into ``x_out``/``t_out`` (numpy views of the host buffer, or
        None for fresh arrays); returns the arrays holding the batch."""
        ld = self.loader
        if x_out is not None and (self.raw or ld.augment is None):
            ld.read_batch_into(row, x_out, t_out)     # no copy between
            return x_out, t_out
        if self.skip_labels:
            x, t = (ld.read_data(row) if self.raw else
                    ld.fetch_data(row, epoch=self.epoch)), None
        else:
            x, t = (ld.read_batch(row) if self.raw else
                    ld.fetch(row, epoch=self.epoch))
        if x_out is None:
            return x, t
        x_out[...] = x
        if t_out is not None:
            t_out[...] = t
        return x_out, t_out

    def _wait(self, acquire) -> bool:
        """Block on ``acquire(timeout)`` until it succeeds or the consumer
        stops; returns False when stopped."""
        while not self._stopped:
            if acquire(0.2):
                return True
        return False

    def _item(self, j: int, row):
        ring = self.ring
        k = j % ring.slots
        if ring.cuda:
            if ring.copied[k] is not None:
                ring.copied[k].synchronize()      # the buffer's last copy
            hx = ring.host_x[k]
            ht = None if ring.host_t is None else ring.host_t[k]
            t0 = time.perf_counter()
            self._read(row, hx.numpy(), None if ht is None else ht.numpy())
            self.stats["read_s"] += time.perf_counter() - t0
            if ring.x is not None and not self._wait(
                    lambda s: self._slots.acquire(timeout=s)):
                return None
            with torch.cuda.stream(ring.stream):
                if ring.read[k] is not None:       # the slot's last reader
                    ring.stream.wait_event(ring.read[k])
                start = torch.cuda.Event(enable_timing=True)
                start.record(ring.stream)
                if ring.x is not None:
                    x = ring.x[k]
                    t = None if ht is None else ring.t[k]
                else:
                    x = torch.empty(hx.shape, dtype=hx.dtype,
                                    device=self.device)
                    t = None if ht is None else torch.empty(
                        ht.shape, dtype=ht.dtype, device=self.device)
                x.copy_(hx, non_blocking=True)
                if t is not None:
                    t.copy_(ht, non_blocking=True)
                done = torch.cuda.Event(enable_timing=True)
                done.record(ring.stream)
            ring.copied[k] = done
            self.stats["copies"].append((start, done))
            return x, t, done, k
        t0 = time.perf_counter()
        if ring.x is not None:
            if not self._wait(lambda s: self._slots.acquire(timeout=s)):
                return None
            x = ring.x[k]
            t = None if ring.t is None else ring.t[k]
            self._read(row, x.numpy(), None if t is None else t.numpy())
        else:
            x, t = self._read(row, None, None)
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            t = None if self.skip_labels else torch.from_numpy(
                np.ascontiguousarray(t))
        self.stats["read_s"] += time.perf_counter() - t0
        return x, t, None, k

    def _produce(self) -> None:
        try:
            for j, row in enumerate(self.rows):
                item = self._item(j, row)
                if item is None or not self._wait(
                        lambda s: self._put(item, s)):
                    return
                self.stats["batches"] += 1
            self._wait(lambda s: self._put(None, s))
        except BaseException as e:          # surface in the consumer
            self._err = e
            self._wait(lambda s: self._put(None, s))

    def _put(self, item, timeout) -> bool:
        try:
            self._q.put(item, timeout=timeout)
            return True
        except queue.Full:
            return False

    # -- consumer --------------------------------------------------------------
    def _release(self, k: int) -> None:
        """The consumer is done enqueueing its work on slot ``k``: the next
        copy into it waits for that work's end."""
        ring = self.ring
        if ring.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ring.read[k] = ev
        self._slots.release()

    def close(self) -> None:
        """Release the producer: an abandoned iteration (the consumer raised
        mid-epoch) must not leave a thread blocked on a full queue holding
        device batches.  Joins it."""
        self._stopped = True
        while True:                          # drain whatever is buffered
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not threading.current_thread():
            self._thread.join()

    def __iter__(self):
        held = None                          # the slot the consumer reads
        try:
            while True:
                if held is not None and self.ring.x is not None:
                    self._release(held)
                held = None
                item = self._q.get()
                if item is None:
                    if self._err is not None:
                        raise self._err
                    return
                x, t, done, held = item
                if done is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(done)
                    if self.ring.x is None:   # fresh tensors: keep them
                        x.record_stream(cur)  # alive for the consumer
                        if t is not None:
                            t.record_stream(cur)
                yield x, t
        finally:
            if held is not None and self.ring.x is not None:
                self._release(held)
            self.close()
