"""Zero-copy binary wire protocol + fast JSON response encoding (a copy
of the JAX package's ``serving/wire.py``, numpy only; the frames and
the JSON bytes are the reference's, byte for byte).

On a small model most of a /predict's time is JSON decode, nested-list
→ ndarray conversion, thread scheduling and JSON encode, not the
forward.  This module keeps the wire format apart from the compute:

**Binary tensor format** (``application/x-znicz-tensor``): a fixed
little-endian header followed by raw row-major bytes —

====================  =======  =========================================
field                 size     meaning
====================  =======  =========================================
magic                 4 bytes  ``b"ZNTW"``
version               u8       format version, currently 1
dtype code            u8       see :data:`DTYPE_CODES`
ndim                  u8       1..8
flags                 u8       0, or :data:`TRAILER_FLAG` (0x1)
dims                  ndim×u32 shape, row-major (C) order
payload               —        exactly ``prod(dims) * itemsize`` bytes
trailer               u32+N    only with TRAILER_FLAG: length + bytes
====================  =======  =========================================

The **trailer** (flags bit 0) is a bounded JSON side channel
riding AFTER the tensor payload — the spill path for span summaries
too large for the ``X-Znicz-Spans`` response header.  Byte 7 was the
always-zero reserved byte through version 1, so every pre-trailer
decoder already rejects trailer-carrying frames loudly (WireError,
never silent corruption), and :func:`split_trailer` restores the
historical byte stream exactly (flags byte zeroed, trailer sliced
off) before a frame is forwarded to a client that didn't ask for it.

Decoding is a single bounds-checked ``np.frombuffer`` — zero copy, no
per-element Python objects.  Every malformed input (short header, bad
magic/version/dtype, junk ndim, dim overflow, truncated or oversized
payload) raises :class:`WireError`, which the HTTP front maps to a
400 — never a hang, never a raw 500.

**JSON fast path** (:func:`encode_json_outputs`): the historical
``json.dumps({"outputs": y.tolist()})`` materializes one Python float
per element into nested lists and then walks them again; the encoder
here writes the SAME bytes row-by-row into one preallocated buffer.
Byte-identity with ``json.dumps`` is pinned by tests — existing JSON
clients see an unchanged contract, just sooner.
"""

from __future__ import annotations

import struct

import numpy as np

#: the negotiated Content-Type / Accept value for binary tensors
CONTENT_TYPE = "application/x-znicz-tensor"

MAGIC = b"ZNTW"
VERSION = 1

#: wire dtype codes (the stable cross-language contract — numpy dtype
#: names would tie the format to numpy's spelling)
DTYPE_CODES = {
    1: np.dtype("<f4"),
    2: np.dtype("<f8"),
    3: np.dtype("<i4"),
    4: np.dtype("<i8"),
    5: np.dtype("i1"),
    6: np.dtype("u1"),
    7: np.dtype("<f2"),
}
_CODE_BY_DTYPE = {dt: code for code, dt in DTYPE_CODES.items()}

_HEADER = struct.Struct("<4sBBBB")   # magic, version, dtype, ndim, flags
MAX_NDIM = 8
#: flags bit 0: a u32-length-prefixed JSON trailer follows the payload
TRAILER_FLAG = 0x1
#: trailer size ceiling — the side channel must stay a footnote to the
#: tensor bytes, never a second body
MAX_TRAILER_BYTES = 64 * 1024
_FLAGS_OFFSET = 7                    # byte index of the flags field
#: element-count ceiling: a header claiming more rows than any real
#: request must fail the size check, not attempt an allocation (the
#: HTTP front's --max-body-mb already bounds the payload; this bounds
#: the arithmetic)
MAX_ELEMENTS = 1 << 31


class WireError(ValueError):
    """Malformed binary tensor payload — the HTTP front answers 400
    (a client bug, same contract as unparseable JSON)."""


def encode_tensor(arr: np.ndarray) -> bytes:
    """Serialize ``arr`` to header + raw little-endian row-major
    bytes.  The dtype must be one of :data:`DTYPE_CODES`."""
    a = np.ascontiguousarray(arr)
    code = _CODE_BY_DTYPE.get(a.dtype.newbyteorder("<"))
    if code is None:
        raise WireError(f"dtype {a.dtype} has no wire code "
                        f"(supported: "
                        f"{sorted(str(d) for d in _CODE_BY_DTYPE)})")
    if a.ndim < 1 or a.ndim > MAX_NDIM:
        raise WireError(f"ndim must be 1..{MAX_NDIM}, got {a.ndim}")
    header = _HEADER.pack(MAGIC, VERSION, code, a.ndim, 0) \
        + struct.pack(f"<{a.ndim}I", *a.shape)
    return header + a.astype(a.dtype.newbyteorder("<"),
                             copy=False).tobytes()


def decode_tensor(buf: bytes) -> np.ndarray:
    """Parse one binary tensor: bounds-check the header, then a single
    ``np.frombuffer`` over the payload (zero copy — the returned array
    is a read-only view of ``buf``).  Raises :class:`WireError` on any
    malformed input."""
    if len(buf) < _HEADER.size:
        raise WireError(f"truncated header: {len(buf)} bytes, need "
                        f"{_HEADER.size}")
    magic, version, code, ndim, reserved = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != VERSION:
        raise WireError(f"unsupported wire version {version} "
                        f"(this server speaks {VERSION})")
    dtype = DTYPE_CODES.get(code)
    if dtype is None:
        raise WireError(f"unknown dtype code {code} (supported: "
                        f"{sorted(DTYPE_CODES)})")
    if reserved not in (0, TRAILER_FLAG):
        raise WireError(f"unknown flags byte {reserved} (this decoder "
                        f"speaks 0 and {TRAILER_FLAG})")
    if ndim < 1 or ndim > MAX_NDIM:
        raise WireError(f"ndim must be 1..{MAX_NDIM}, got {ndim}")
    dims_end = _HEADER.size + 4 * ndim
    if len(buf) < dims_end:
        raise WireError(f"truncated shape: {len(buf)} bytes, header "
                        f"needs {dims_end}")
    shape = struct.unpack_from(f"<{ndim}I", buf, _HEADER.size)
    n = 1
    for d in shape:
        n *= int(d)
        if n > MAX_ELEMENTS:
            raise WireError(f"shape {shape} exceeds the "
                            f"{MAX_ELEMENTS}-element bound")
    if n == 0:
        raise WireError(f"empty tensor (shape {shape})")
    expected = dims_end + n * dtype.itemsize
    if reserved & TRAILER_FLAG:
        if len(buf) < expected + 4:
            raise WireError(f"flags claim a trailer but {len(buf)} "
                            f"bytes end before its length word at "
                            f"{expected}")
        (tlen,) = struct.unpack_from("<I", buf, expected)
        if tlen > MAX_TRAILER_BYTES:
            raise WireError(f"trailer length {tlen} exceeds the "
                            f"{MAX_TRAILER_BYTES}-byte bound")
        if len(buf) != expected + 4 + tlen:
            raise WireError(f"trailer size mismatch: {len(buf)} bytes,"
                            f" payload {expected} + trailer {tlen} "
                            f"needs {expected + 4 + tlen}")
    elif len(buf) != expected:
        raise WireError(f"payload size mismatch: {len(buf)} bytes, "
                        f"shape {shape} dtype {dtype} needs "
                        f"{expected}")
    return np.frombuffer(buf, dtype=dtype, count=n,
                         offset=dims_end).reshape(shape)


def append_trailer(frame: bytes, trailer: bytes) -> bytes:
    """Attach a bounded side-channel ``trailer`` to an encoded tensor
    ``frame``: sets :data:`TRAILER_FLAG` and appends ``u32 length +
    bytes``.  The frame must be flag-free (one trailer per frame)."""
    if len(trailer) > MAX_TRAILER_BYTES:
        raise WireError(f"trailer {len(trailer)} bytes exceeds the "
                        f"{MAX_TRAILER_BYTES}-byte bound")
    if len(frame) < _HEADER.size or frame[:4] != MAGIC:
        raise WireError("append_trailer needs an encoded tensor frame")
    if frame[_FLAGS_OFFSET] != 0:
        raise WireError(f"frame already carries flags "
                        f"{frame[_FLAGS_OFFSET]}")
    out = bytearray(frame)
    out[_FLAGS_OFFSET] = TRAILER_FLAG
    out += struct.pack("<I", len(trailer))
    out += trailer
    return bytes(out)


def split_trailer(buf: bytes):
    """``(tensor frame with flags cleared, trailer bytes | None)``.

    The forwarding-path inverse of :func:`append_trailer`: the router
    consumes the side channel and restores the exact byte stream a
    pre-trailer client expects.  Anything that doesn't parse as a
    trailer-carrying frame passes through untouched with ``None`` —
    this function must never fail a response it cannot improve."""
    if len(buf) < _HEADER.size:
        return buf, None
    magic, version, code, ndim, flags = _HEADER.unpack_from(buf)
    if magic != MAGIC or version != VERSION \
            or not (flags & TRAILER_FLAG):
        return buf, None
    dtype = DTYPE_CODES.get(code)
    if dtype is None or ndim < 1 or ndim > MAX_NDIM:
        return buf, None
    dims_end = _HEADER.size + 4 * ndim
    if len(buf) < dims_end + 4:
        return buf, None
    shape = struct.unpack_from(f"<{ndim}I", buf, _HEADER.size)
    n = 1
    for d in shape:
        n *= int(d)
        if n > MAX_ELEMENTS:
            return buf, None
    payload_end = dims_end + n * dtype.itemsize
    if len(buf) < payload_end + 4:
        return buf, None
    (tlen,) = struct.unpack_from("<I", buf, payload_end)
    if tlen > MAX_TRAILER_BYTES \
            or len(buf) != payload_end + 4 + tlen:
        return buf, None
    clean = bytearray(buf[:payload_end])
    clean[_FLAGS_OFFSET] = 0
    return bytes(clean), bytes(buf[payload_end + 4:])


def encode_json_outputs(y: np.ndarray) -> bytes:
    """``{"outputs": [[...], ...]}`` as bytes, byte-identical to
    ``json.dumps({"outputs": y.tolist()}, default=float).encode()``
    for the 2-D float arrays the engine produces (pinned by tests) —
    but built row-by-row into ONE buffer instead of materializing the
    full nested-list mirror and walking it a second time.  Python
    floats format through ``repr`` exactly as ``json.dumps`` formats
    them, so the bytes cannot drift."""
    if y.ndim != 2:
        # not the hot-path shape: defer to the reference encoder so
        # the bytes stay canonical whatever the caller passed
        import json
        return json.dumps({"outputs": y.tolist()},
                          default=float).encode()
    buf = bytearray(b'{"outputs": [')
    last = len(y) - 1
    for i, row in enumerate(y):
        buf += b"["
        buf += ", ".join(map(repr, row.tolist())).encode()
        buf += b"]" if i == last else b"], "
    buf += b"]}"
    return bytes(buf)
