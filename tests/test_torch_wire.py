"""The port's request-path wire formats (``znicz_tpu_torch.serving.wire``)
and response memoization (``serving.memo``) against the JAX package's,
on the CPU.

- every dtype code, with and without a trailer: the port's frames equal
  the reference's byte for byte, each package decodes the other's, and
  ``split_trailer`` restores the same trailer-free frame;
- every malformed frame the reference refuses raises ``WireError`` in
  both packages (truncated header, magic, version, dtype code, flags,
  ndim, truncated shape, element overflow, empty, payload and trailer
  sizes); ``append_trailer``'s refusals too;
- the JSON encoder's bytes equal the reference's and ``json.dumps``'s;
- ``ResponseCache``: the same keys, hits, misses and evictions."""

import json
import struct

import numpy as np
import pytest
import torch

from znicz_tpu.serving import memo as ref_memo
from znicz_tpu.serving import wire as ref_wire
from znicz_tpu_torch.serving import memo, wire


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


DTYPES = ["float32", "float64", "int32", "int64", "int8", "uint8",
          "float16"]


def _sample(dtype, shape=(2, 3, 4)):
    return (np.arange(int(np.prod(shape))).reshape(shape) * 3 - 7
            ).astype(dtype)


def test_dtype_codes_equal():
    assert wire.DTYPE_CODES == ref_wire.DTYPE_CODES
    assert (wire.MAGIC, wire.VERSION, wire.TRAILER_FLAG,
            wire.MAX_TRAILER_BYTES, wire.MAX_ELEMENTS, wire.MAX_NDIM,
            wire.CONTENT_TYPE) == (
        ref_wire.MAGIC, ref_wire.VERSION, ref_wire.TRAILER_FLAG,
        ref_wire.MAX_TRAILER_BYTES, ref_wire.MAX_ELEMENTS,
        ref_wire.MAX_NDIM, ref_wire.CONTENT_TYPE)


@pytest.mark.parametrize("trailer", [None, b"", b'{"v":1,"spans":[]}'])
@pytest.mark.parametrize("dtype", DTYPES)
def test_frames_equal_byte_for_byte(dtype, trailer):
    for shape in ((5,), (2, 3, 4), (1, 13), (4, 2, 2, 3)):
        x = _sample(dtype, shape)
        got, want = wire.encode_tensor(x), ref_wire.encode_tensor(x)
        if trailer is not None:
            got = wire.append_trailer(got, trailer)
            want = ref_wire.append_trailer(want, trailer)
        assert got == want
        for dec in (wire.decode_tensor, ref_wire.decode_tensor):
            y = dec(got)
            assert y.dtype == np.dtype(dtype) and not y.flags.writeable
            np.testing.assert_array_equal(y, x)
        assert wire.split_trailer(got) == ref_wire.split_trailer(got)
        clean, tail = wire.split_trailer(got)
        assert clean == wire.encode_tensor(x)
        assert tail == (None if trailer is None else trailer)


def test_big_endian_input_encodes_little_endian():
    x = np.arange(6, dtype=">f4").reshape(2, 3)
    assert wire.encode_tensor(x) == ref_wire.encode_tensor(x)


def _frame(**over):
    """A float32 (2, 3) frame with header fields replaced."""
    f = dict(magic=wire.MAGIC, version=1, code=1, ndim=2, flags=0,
             dims=(2, 3), payload=np.zeros(6, "<f4").tobytes(), tail=b"")
    f.update(over)
    head = struct.pack("<4sBBBB", f["magic"], f["version"], f["code"],
                       f["ndim"], f["flags"])
    return (head + struct.pack(f"<{len(f['dims'])}I", *f["dims"])
            + f["payload"] + f["tail"])


MALFORMED = {
    "truncated_header": b"ZNT",
    "bad_magic": _frame(magic=b"JUNK"),
    "bad_version": _frame(version=99),
    "unknown_dtype": _frame(code=200),
    "unknown_flags": _frame(flags=2),
    "ndim_zero": _frame(ndim=0, dims=()),
    "ndim_nine": _frame(ndim=9, dims=(1,) * 9),
    "truncated_shape": _frame(dims=(2,), payload=b""),
    "element_overflow": _frame(dims=(1 << 16, 1 << 16), payload=b""),
    "empty": _frame(dims=(0, 3), payload=b""),
    "short_payload": _frame(payload=b"\0" * 23),
    "long_payload": _frame(payload=b"\0" * 25),
    "trailer_without_length": _frame(flags=1),
    "trailer_too_long": _frame(flags=1, tail=struct.pack(
        "<I", wire.MAX_TRAILER_BYTES + 1)),
    "trailer_size_mismatch": _frame(flags=1, tail=struct.pack("<I", 4)
                                    + b"ab"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_frames_refused_by_both(case):
    buf = MALFORMED[case]
    with pytest.raises(ref_wire.WireError) as ref_err:
        ref_wire.decode_tensor(buf)
    with pytest.raises(wire.WireError) as err:
        wire.decode_tensor(buf)
    assert str(err.value) == str(ref_err.value)
    assert issubclass(wire.WireError, ValueError)
    # a frame split_trailer cannot improve passes through untouched
    assert wire.split_trailer(buf) == ref_wire.split_trailer(buf)


def test_encode_and_trailer_refusals():
    for bad in (np.zeros(3, np.complex64), np.zeros(3, bool)):
        with pytest.raises(wire.WireError):
            wire.encode_tensor(bad)
        with pytest.raises(ref_wire.WireError):
            ref_wire.encode_tensor(bad)
    frame = wire.encode_tensor(np.zeros(3, np.float32))
    for args in ((frame, b"x" * (wire.MAX_TRAILER_BYTES + 1)),
                 (b"JUNKJUNK", b"x"),
                 (wire.append_trailer(frame, b"x"), b"y")):
        with pytest.raises(wire.WireError):
            wire.append_trailer(*args)
        with pytest.raises(ref_wire.WireError):
            ref_wire.append_trailer(*args)


@pytest.mark.parametrize("arr", [
    np.array([[0.1, -2.5e-8, 3.0], [1e20, -0.0, 7.25]], np.float32),
    np.random.default_rng(0).standard_normal((9, 10)).astype(np.float32),
    np.random.default_rng(1).standard_normal((1, 1000)),
    np.zeros((0, 4), np.float32),
    np.arange(5, dtype=np.float32),
    np.ones((2, 2, 2), np.float32)], ids=["edge", "f32", "f64", "empty",
                                          "1d", "3d"])
def test_json_encoder_bytes_equal(arr):
    got = wire.encode_json_outputs(arr)
    assert got == ref_wire.encode_json_outputs(arr)
    assert got == json.dumps({"outputs": arr.tolist()},
                             default=float).encode()


def test_response_cache_matches_reference():
    caches = [memo.ResponseCache(max_entries=3, max_bytes=200),
              ref_memo.ResponseCache(max_entries=3, max_bytes=200)]
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 4)).astype(np.float32)
          for _ in range(5)]
    for c in caches:
        for gen in (1, 2):
            for x in xs + xs[:2]:
                key = c.key_for(gen, x)
                if c.get(key) is None:
                    c.put(key, x[:1] * 2)      # a view: stored as a copy
        c.put(c.key_for(1, xs[0]), np.zeros(100, np.float32))  # > budget
    assert caches[0].metrics() == caches[1].metrics()
    assert memo.ResponseCache.key_for(7, xs[0]) \
        == ref_memo.ResponseCache.key_for(7, xs[0])
    assert memo.ResponseCache.key_for(7, xs[0]) \
        != memo.ResponseCache.key_for(8, xs[0])
    hit = caches[0].get(caches[0].key_for(2, xs[1]))
    assert hit is not None and not hit.flags.writeable
    with pytest.raises(ValueError):
        memo.ResponseCache(max_entries=0)
