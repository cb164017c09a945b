"""The port's ``.znr`` record shards (znicz_tpu_torch.loader.records)
against the JAX package's: files written by either package are read by the
other with equal bytes and equal rows, the port's native reader (built
with g++ into the port's build directory) returns what its numpy path
returns, bit for bit, and a bad magic or a truncated file is refused."""

import os

import numpy as np
import pytest
import torch

from znicz_tpu.loader import records as ref_rec
from znicz_tpu_torch import cuda_build
from znicz_tpu_torch.loader import records as rec


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(seed, n=40, shape=(7, 5, 2), label_shape=(), label_dtype=None):
    gen = np.random.default_rng(seed)
    data = gen.standard_normal((n, *shape)).astype(np.float32)
    if label_dtype is None:
        labels = gen.integers(0, 9, (n, *label_shape)).astype(np.int32)
    else:
        labels = gen.standard_normal((n, *label_shape)).astype(label_dtype)
    return data, labels


@pytest.mark.parametrize("label_shape,label_dtype", [
    ((), None), ((3,), np.float32), ((2, 2), np.float64)])
@pytest.mark.parametrize("shard_size", [None, 16])
def test_files_equal_byte_for_byte(tmp_path, label_shape, label_dtype,
                                   shard_size):
    data, labels = _arrays(1, label_shape=label_shape,
                           label_dtype=label_dtype)
    mine = rec.write_records(str(tmp_path / "p.znr"), data, labels,
                             shard_size=shard_size)
    theirs = ref_rec.write_records(str(tmp_path / "r.znr"), data, labels,
                                   shard_size=shard_size)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_reads_the_others_files(tmp_path, writer):
    data, labels = _arrays(2, label_shape=(3,), label_dtype=np.float32)
    w = rec if writer == "port" else ref_rec
    path = w.write_records(str(tmp_path / "d.znr"), data, labels)[0]
    r = ref_rec if writer == "port" else rec
    rf = r.RecordFile(path)
    idx = [0, 39, 7, 7, 21, -1]
    d, lab = rf.read_batch(idx)
    np.testing.assert_array_equal(d, data[idx])
    np.testing.assert_array_equal(lab, labels[idx])
    assert (rf.data_shape, rf.label_shape) == ((7, 5, 2), (3,))


def test_streamed_writer_equals_the_references(tmp_path):
    data, labels = _arrays(3, n=10)
    paths = []
    for name, mod in (("p.znr", rec), ("r.znr", ref_rec)):
        p = str(tmp_path / name)
        with mod.RecordWriter(p, data.shape[1:], data.dtype, (),
                              labels.dtype) as w:
            for i in range(10):
                w.write(data[i], labels[i])
        paths.append(p)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_native_reader_equals_numpy_path(tmp_path, monkeypatch):
    data, labels = _arrays(4, label_shape=(3,), label_dtype=np.float32)
    p = rec.write_records(str(tmp_path / "n.znr"), data, labels)[0]
    rf = rec.RecordFile(p)
    assert rf.reader == "native"
    # built into the port's build directory: never the library beside the
    # source
    lib = os.path.realpath(rec._native_lib._name)
    assert os.path.dirname(lib) == os.path.realpath(cuda_build.BUILD_DIR)
    assert os.path.basename(lib).startswith("libznr_reader-")
    idx = [0, 39, 7, 7, 21, -1, -40]
    d_n, l_n = rf.read_batch(idx)
    x_n = rf.read_data(idx)
    assert rf.served == {"native": 2 * len(idx), "numpy": 0}
    # boolean masks keep numpy's meaning (served by the memmaps)
    mask = np.zeros(40, bool)
    mask[[2, 5]] = True
    np.testing.assert_array_equal(rf.read_batch(mask)[1], labels[[2, 5]])
    assert rf.served["numpy"] == 2
    # the scatter into caller buffers at given slots
    out = np.full((5, 7, 5, 2), np.nan, np.float32)
    lout = np.full((5, 3), np.nan, np.float32)
    assert rf.read_batch_into([3, 1], out, lout, np.asarray([4, 0]))
    np.testing.assert_array_equal(out[[4, 0]], data[[3, 1]])
    np.testing.assert_array_equal(lout[[4, 0]], labels[[3, 1]])
    monkeypatch.setenv("ZNICZ_TPU_NO_NATIVE_IO", "1")
    rf2 = rec.RecordFile(p)
    assert rf2.reader == "numpy"
    d_p, l_p = rf2.read_batch(idx)
    assert not rf2.read_batch_into([3], out, lout, np.asarray([0]))
    for a, b in ((d_n, d_p), (l_n, l_p), (x_n, d_p)):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(d_p, data[idx])
    assert rf2.served == {"native": 0, "numpy": len(idx)}


def test_native_reader_refuses_bad_rows(tmp_path):
    p = rec.write_records(str(tmp_path / "b.znr"),
                          np.zeros((4, 2, 2, 1), np.float32),
                          np.zeros(4, np.int32))[0]
    rf = rec.RecordFile(p)
    assert rf.reader == "native"
    with pytest.raises(IndexError):
        rf.read_batch([0, 4])
    with pytest.raises(IndexError):
        rf.read_batch([-5])


def test_a_reader_that_does_not_build_raises(tmp_path, monkeypatch):
    """No quiet fall back to the numpy reader: a compiler that fails
    raises, and only the variable selects numpy."""
    p = rec.write_records(str(tmp_path / "c.znr"),
                          np.zeros((4, 2), np.float32),
                          np.zeros(4, np.int32))[0]
    monkeypatch.setattr(rec, "_native_lib", None)
    monkeypatch.setattr(rec, "_native_tried", False)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(cuda_build.BuildError):
        rec.RecordFile(p)
    monkeypatch.setenv("ZNICZ_TPU_NO_NATIVE_IO", "1")
    assert rec.RecordFile(p).reader == "numpy"


@pytest.mark.parametrize("native", [True, False])
def test_bad_magic_rejected(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("ZNICZ_TPU_NO_NATIVE_IO", "1")
    p = tmp_path / "bad.znr"
    p.write_bytes(b"NOPE" + b"\0" * 100)
    for mod in (rec, ref_rec):
        with pytest.raises(ValueError, match="not a .znr"):
            mod.RecordFile(str(p))


@pytest.mark.parametrize("native", [True, False])
def test_truncated_rejected(tmp_path, monkeypatch, native):
    if not native:
        monkeypatch.setenv("ZNICZ_TPU_NO_NATIVE_IO", "1")
    data, labels = _arrays(5, n=10)
    p = str(tmp_path / "t.znr")
    rec.write_records(p, data, labels)
    blob = open(p, "rb").read()
    open(p, "wb").write(blob[:len(blob) - 8])
    for mod in (rec, ref_rec):
        with pytest.raises(ValueError, match="truncated"):
            mod.RecordFile(p)
