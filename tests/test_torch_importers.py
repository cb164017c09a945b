"""The port's importers (znicz_tpu_torch.loader.importers) against the JAX
package's, on an LMDB and a pickle that the tests build as
tests/test_importers.py builds them (its LMDB v0.9 writer and Datum
encoders): every import writes the same ``.znr`` bytes as the reference's
import of the same source, raw and PNG-encoded Datums, a branch tree,
overflow pages and shards alike; ``parse_datum`` and ``LMDBReader`` read
what the reference's read; the restricted unpickler refuses code; and the
command ``python -m znicz_tpu_torch.loader.importers`` writes the
reference's shards."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from znicz_tpu.loader import importers as ref_imp
from znicz_tpu_torch.loader import importers as imp
from znicz_tpu_torch.loader import records as rec

from test_importers import (_dataset, _encode_datum, _encode_datum_encoded,
                            write_lmdb)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(paths):
    return [open(p, "rb").read() for p in paths]


def _lmdb(tmp_path, layout, n=12):
    imgs, labels = _dataset(n=n, h=8, w=7)
    if layout == "encoded":
        items = [(b"%08d" % i, _encode_datum_encoded(
            imgs[i].transpose(1, 2, 0), int(labels[i])))
            for i in range(n)]
    else:
        items = [(b"%08d" % i, _encode_datum(imgs[i], int(labels[i])))
                 for i in range(n)]
    mdb = str(tmp_path / f"{layout}.mdb")
    write_lmdb(mdb, items, force_overflow=layout == "overflow",
               per_leaf=4 if layout == "branch" else None)
    return mdb, imgs, labels, items


@pytest.mark.parametrize("shard_size", [None, 5])
@pytest.mark.parametrize("layout", ["single_leaf", "branch", "overflow",
                                    "encoded"])
def test_lmdb_import_equals_the_references(tmp_path, layout, shard_size):
    mdb, imgs, labels, _ = _lmdb(tmp_path, layout)
    mine = imp.import_lmdb(mdb, str(tmp_path / "p.znr"),
                           shard_size=shard_size)
    theirs = ref_imp.import_lmdb(mdb, str(tmp_path / "r.znr"),
                                 shard_size=shard_size)
    assert len(mine) == len(theirs) == (1 if shard_size is None else 3)
    assert _bytes(mine) == _bytes(theirs)
    rf = rec.RecordFile(mine[0])
    got, got_labels = rf.read_batch(np.arange(rf.n))
    expect = imgs.transpose(0, 2, 3, 1).astype(np.float32)[:rf.n] / 255.0
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got_labels, labels[:rf.n].astype(np.int32))


@pytest.mark.parametrize("kw", [{"size": (5, 6)}, {"channels": "gray"},
                                {"channels": "rgb", "size": (4, 4)}])
def test_lmdb_resize_and_channels_equal_the_references(tmp_path, kw):
    mdb, _, _, _ = _lmdb(tmp_path, "encoded", n=4)
    mine = imp.import_lmdb(mdb, str(tmp_path / "p.znr"), **kw)
    theirs = ref_imp.import_lmdb(mdb, str(tmp_path / "r.znr"), **kw)
    assert _bytes(mine) == _bytes(theirs)


def test_reader_and_datum_parse_equal_the_references(tmp_path):
    mdb, _, _, items = _lmdb(tmp_path, "branch")
    got, want = list(imp.LMDBReader(mdb)), list(ref_imp.LMDBReader(mdb))
    assert got == want == items
    assert imp.LMDBReader(mdb).entries == 12
    for _, blob in items[:3]:
        assert imp.parse_datum(blob) == ref_imp.parse_datum(blob)
    encoded = tmp_path / "encoded"
    encoded.mkdir()
    with pytest.raises(NotImplementedError, match="decode_encoded"):
        imp.import_lmdb(_lmdb(encoded, "encoded")[0],
                        str(tmp_path / "no.znr"), decode_encoded=False)
    assert not os.path.exists(tmp_path / "no.znr")


@pytest.mark.parametrize("layout", ["tuple", "dict", "dict_no_labels",
                                    "array"])
def test_pickle_import_equals_the_references(tmp_path, layout):
    gen = np.random.default_rng(1)
    data = gen.normal(size=(9, 4, 4, 2)).astype(np.float32)
    labels = np.arange(9, dtype=np.int32)
    obj = {"tuple": (data, labels), "dict": {"x": data, "y": labels},
           "dict_no_labels": {"images": data}, "array": data}[layout]
    p = str(tmp_path / "ds.pickle")
    with open(p, "wb") as f:
        pickle.dump(obj, f)
    mine = imp.import_pickle(p, str(tmp_path / "p.znr"), shard_size=4)
    theirs = ref_imp.import_pickle(p, str(tmp_path / "r.znr"), shard_size=4)
    assert len(mine) == 3 and _bytes(mine) == _bytes(theirs)


def test_malicious_pickle_rejected(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))
    p = str(tmp_path / "evil.pickle")
    with open(p, "wb") as f:
        pickle.dump(Evil(), f)
    with pytest.raises(pickle.UnpicklingError, match="only numpy"):
        imp.import_pickle(p, str(tmp_path / "no.znr"))


def test_command_line_writes_the_references_shards(tmp_path):
    mdb, _, _, _ = _lmdb(tmp_path, "single_leaf", n=6)
    out = str(tmp_path / "cli.znr")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch.loader.importers", "lmdb",
         mdb, out, "--shard-size", "4"], capture_output=True, text=True,
        env=env, cwd=str(tmp_path), timeout=120)
    assert proc.returncode == 0, proc.stderr
    paths = proc.stdout.split()
    theirs = ref_imp.import_lmdb(mdb, str(tmp_path / "r.znr"), shard_size=4)
    assert len(paths) == 2 and _bytes(paths) == _bytes(theirs)
    bad = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch.loader.importers", "pickle",
         mdb, out, "--gray"], capture_output=True, text=True, env=env,
        cwd=str(tmp_path), timeout=120)
    assert bad.returncode != 0 and "format=lmdb only" in bad.stderr
