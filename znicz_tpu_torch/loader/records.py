""".znr record shards, the disk format behind the streaming loaders (port
of ``znicz_tpu/loader/records.py``; the files are the reference's byte for
byte, so either package reads what the other wrote).

A shard holds fixed-shape preprocessed tensors, so a record is one slice of
a memory map: no key/value store and no decode on the hot path.

Layout (little-endian)::

    magic  b"ZNR1"
    u32    header_json_len
    bytes  header json: {"n", "data_shape", "data_dtype",
                         "label_shape", "label_dtype"}
    pad    to 64-byte alignment
    data   n × prod(data_shape) × itemsize   (C-order, contiguous)
    labels n × prod(label_shape) × itemsize

Rows are gathered by the repository's native reader
(``native/znr_reader.cpp`` with ``native/parallel.h``: one mmap a shard and
a multithreaded row copy off the GIL), which :func:`_native` builds with
g++ into the port's build directory (``cuda_build.build_host``), never
beside the source.  ``ZNICZ_TPU_NO_NATIVE_IO=1`` selects the numpy memmap
path instead; without it a reader that does not build raises.  Each
:class:`RecordFile` says which reader it has (``reader``) and counts the
rows each served (``served``)."""

from __future__ import annotations

import ctypes
import json
import os

import numpy as np

from .. import cuda_build

_MAGIC = b"ZNR1"
_ALIGN = 64

NATIVE_DIR = cuda_build.PACKAGE_DIR.parent / "native"

#: the loaded native reader (None until first use, or under
#: ZNICZ_TPU_NO_NATIVE_IO=1)
_native_lib = None
_native_tried = False


def _native() -> ctypes.CDLL | None:
    """The native reader, built at first use; None under
    ``ZNICZ_TPU_NO_NATIVE_IO=1``.  A build that fails raises
    ``cuda_build.BuildError``: the numpy reader is chosen, never fallen
    back to."""
    global _native_lib, _native_tried
    if os.environ.get("ZNICZ_TPU_NO_NATIVE_IO") == "1":
        return None
    if _native_tried:
        return _native_lib
    so = cuda_build.build_host(
        "libznr_reader", NATIVE_DIR / "znr_reader.cpp",
        (NATIVE_DIR / "parallel.h",))
    lib = ctypes.CDLL(str(so))
    lib.znr_open.restype = ctypes.c_void_p
    lib.znr_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int64] * 5
    lib.znr_gather.restype = ctypes.c_int
    lib.znr_gather.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int]
    lib.znr_gather_scatter.restype = ctypes.c_int
    lib.znr_gather_scatter.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int]
    lib.znr_close.argtypes = [ctypes.c_void_p]
    _native_lib, _native_tried = lib, True
    return lib


def _io_workers() -> int:
    return int(os.environ.get("ZNICZ_TPU_IO_WORKERS", 0)) \
        or min(8, max(1, os.cpu_count() or 1))


def _align(n: int) -> int:
    return ((n + _ALIGN - 1) // _ALIGN) * _ALIGN


class RecordWriter:
    """Streams records into one ``.znr`` shard.

    >>> w = RecordWriter(path, (227, 227, 3), np.float32)
    >>> w.write(img, label)      # or w.write_batch(imgs, labels)
    >>> w.close()                # finalizes the header
    """

    def __init__(self, path: str, data_shape, data_dtype=np.float32,
                 label_shape=(), label_dtype=np.int32):
        self.path = path
        self.data_shape = tuple(int(d) for d in data_shape)
        self.data_dtype = np.dtype(data_dtype)
        self.label_shape = tuple(int(d) for d in label_shape)
        self.label_dtype = np.dtype(label_dtype)
        self.n = 0
        # labels buffer in memory (small); data streams straight to disk
        self._labels: list[np.ndarray] = []
        self._f = open(path, "wb")
        self._header_at = None
        self._write_header(placeholder=True)

    def _write_header(self, placeholder: bool) -> None:
        head = json.dumps({
            "n": 0 if placeholder else self.n,
            "data_shape": self.data_shape,
            "data_dtype": self.data_dtype.name,
            "label_shape": self.label_shape,
            "label_dtype": self.label_dtype.name,
        }).encode()
        if placeholder:
            # reserve a fixed-size header slot: the final n is patched in
            # on close, so pad the json out to a stable length
            head = head + b" " * 24
            self._header_at = len(_MAGIC) + 4
            self._head_len = len(head)
        else:
            head = head.ljust(self._head_len)
        self._f.write(_MAGIC)
        self._f.write(np.dtype("<u4").type(len(head)).tobytes())
        self._f.write(head)
        pad = _align(self._f.tell()) - self._f.tell()
        self._f.write(b"\0" * pad)
        self._data_at = self._f.tell()

    def write(self, data: np.ndarray, label) -> None:
        self.write_batch(np.asarray(data)[None],
                         np.asarray(label, self.label_dtype)[None])

    def write_batch(self, data: np.ndarray, labels: np.ndarray) -> None:
        data = np.ascontiguousarray(data, self.data_dtype)
        if data.shape[1:] != self.data_shape:
            raise ValueError(f"record shape {data.shape[1:]} != declared "
                             f"{self.data_shape}")
        labels = np.ascontiguousarray(labels, self.label_dtype)
        if len(labels) != len(data):
            raise ValueError("data/label count mismatch")
        self._f.write(data.tobytes())
        self._labels.append(labels.reshape(len(labels),
                                           *self.label_shape).copy())
        self.n += len(data)

    def close(self) -> None:
        if self._f is None:
            return
        if self._labels:
            self._f.write(np.concatenate(self._labels).tobytes())
        self._f.seek(0)
        self._write_header(placeholder=False)
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordFile:
    """Random access over one ``.znr`` shard: the native reader's mmap, or
    under ``ZNICZ_TPU_NO_NATIVE_IO=1`` numpy memmaps.  ``reader`` names the
    one it has; ``served`` counts the rows each returned (index forms the
    native reader does not take, such as boolean masks, go through numpy
    with numpy's meaning)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            if f.read(4) != _MAGIC:
                raise ValueError(f"{path}: not a .znr record file")
            head_len = int(np.frombuffer(f.read(4), "<u4")[0])
            head = json.loads(f.read(head_len))
        self.n = int(head["n"])
        self.data_shape = tuple(head["data_shape"])
        self.data_dtype = np.dtype(head["data_dtype"])
        self.label_shape = tuple(head["label_shape"])
        self.label_dtype = np.dtype(head["label_dtype"])
        data_at = _align(4 + 4 + head_len)
        row = int(np.prod(self.data_shape))
        labels_at = data_at + self.n * row * self.data_dtype.itemsize
        lrow = int(np.prod(self.label_shape)) if self.label_shape else 1
        expect = labels_at + self.n * lrow * self.label_dtype.itemsize
        if os.path.getsize(path) < expect:
            raise ValueError(f"{path}: truncated record file")
        self.data = np.memmap(path, self.data_dtype, "r",
                              offset=data_at, shape=(self.n, row)
                              ).reshape(self.n, *self.data_shape)
        self.labels = np.memmap(path, self.label_dtype, "r",
                                offset=labels_at, shape=(self.n, lrow))
        if not self.label_shape:
            self.labels = self.labels.reshape(self.n)
        else:
            self.labels = self.labels.reshape(self.n, *self.label_shape)
        self._row_bytes = row * self.data_dtype.itemsize
        self._label_row_bytes = lrow * self.label_dtype.itemsize
        self._h = None
        self.served = {"native": 0, "numpy": 0}
        # the CDLL is kept on the instance so close() frees the handle
        # through the library that opened it
        self._lib = _native()
        if self._lib is not None:
            self._h = self._lib.znr_open(
                path.encode(), self.n, data_at, labels_at,
                self._row_bytes, self._label_row_bytes)
            if not self._h:
                raise OSError(f"{path}: the native reader could not map "
                              f"the shard")

    @property
    def reader(self) -> str:
        """``"native"`` or ``"numpy"``."""
        return "native" if self._h is not None else "numpy"

    def __len__(self) -> int:
        return self.n

    def _native_gather(self, idx: np.ndarray, want_labels: bool):
        lib = self._lib
        k = len(idx)
        idx64 = np.ascontiguousarray(idx, np.int64)
        data = np.empty((k, *self.data_shape), self.data_dtype)
        labels = (np.empty((k, *self.label_shape), self.label_dtype)
                  if want_labels else None)
        workers = _io_workers()
        rc = lib.znr_gather(
            self._h, idx64.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)), k,
            data.ctypes.data_as(ctypes.c_char_p),
            labels.ctypes.data_as(ctypes.c_char_p)
            if labels is not None else None,
            workers)
        if rc != 0:
            raise IndexError(f"{self.path}: row index out of range")
        self.served["native"] += k
        return data, labels

    def _native_idx(self, idx: np.ndarray):
        """Index forms the native fast path serves: 1-D integer rows
        (negatives resolved).  Anything fancier (bool masks, 2-D index
        arrays) keeps numpy's meaning through the memmaps: the two paths
        must never mean different things for the same input."""
        if self._h is None or idx.ndim != 1 \
                or not np.issubdtype(idx.dtype, np.integer):
            return None
        return np.where(idx < 0, idx + self.n, idx)

    def read_batch(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """Materialized (copied) rows, safe to mutate or copy to the
        card."""
        idx = np.asarray(indices)
        nidx = self._native_idx(idx)
        if nidx is not None:
            return self._native_gather(nidx, want_labels=True)
        data, labels = np.asarray(self.data[idx]), np.asarray(self.labels[idx])
        self.served["numpy"] += len(data)
        return data, labels

    def read_data(self, indices) -> np.ndarray:
        """Data rows only — the label block is never touched (mmap pages
        stay cold), for consumers that reconstruct the input."""
        idx = np.asarray(indices)
        nidx = self._native_idx(idx)
        if nidx is not None:
            return self._native_gather(nidx, want_labels=False)[0]
        data = np.asarray(self.data[idx])
        self.served["numpy"] += len(data)
        return data

    def read_batch_into(self, indices, data_out: np.ndarray,
                        labels_out: np.ndarray | None,
                        positions: np.ndarray) -> bool:
        """Gather rows ``indices`` directly into caller buffers at row
        slots ``positions`` (the multi-shard scatter) — one memcpy per
        row in C++, no intermediate batch.  Returns False where the native
        reader does not serve (the numpy reader, another dtype or
        geometry): the caller then copies through :meth:`read_batch`."""
        idx = np.asarray(indices)
        nidx = self._native_idx(idx)
        if nidx is None or data_out.dtype != self.data_dtype \
                or not data_out.flags.c_contiguous \
                or (labels_out is not None
                    and (labels_out.dtype != self.label_dtype
                         or not labels_out.flags.c_contiguous)):
            return False
        # the C++ scatter trusts row widths blindly — refuse any
        # geometry mismatch here rather than corrupt the heap
        if tuple(data_out.shape[1:]) != tuple(self.data_shape):
            return False
        if labels_out is not None and \
                tuple(labels_out.shape[1:]) != tuple(self.label_shape):
            return False
        idx64 = np.ascontiguousarray(nidx, np.int64)
        pos64 = np.ascontiguousarray(positions, np.int64)
        workers = _io_workers()
        rc = self._lib.znr_gather_scatter(
            self._h,
            idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx64),
            data_out.ctypes.data_as(ctypes.c_char_p),
            labels_out.ctypes.data_as(ctypes.c_char_p)
            if labels_out is not None else None,
            pos64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(data_out), workers)
        if rc != 0:
            raise IndexError(f"{self.path}: row index/slot out of range")
        self.served["native"] += len(idx64)
        return True

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.znr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_records(path: str, data: np.ndarray, labels: np.ndarray,
                  shard_size: int | None = None) -> list[str]:
    """Convenience: dump arrays into one shard (or ``shard_size``-row
    shards, ``path`` gaining ``-00000`` suffixes).  Returns the paths."""
    data = np.asarray(data)
    labels = np.asarray(labels)
    if shard_size is None:
        shards = [(path, slice(0, len(data)))]
    else:
        base, ext = os.path.splitext(path)
        shards = [(f"{base}-{i // shard_size:05d}{ext}",
                   slice(i, min(i + shard_size, len(data))))
                  for i in range(0, len(data), shard_size)]
    out = []
    for p, sl in shards:
        with RecordWriter(p, data.shape[1:], data.dtype,
                          labels.shape[1:], labels.dtype) as w:
            w.write_batch(data[sl], labels[sl])
        out.append(p)
    return out
