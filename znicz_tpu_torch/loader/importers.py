"""One-shot importers: datasets in the reference's on-disk formats to
``.znr`` shards (port of ``znicz_tpu/loader/importers.py``).

A migrating user converts once, then streams the shards natively:
``python -m znicz_tpu_torch.loader.importers {lmdb|pickle} SRC DST.znr``.
No external library is needed: :class:`LMDBReader` is a pure-Python
read-only walker of the LMDB v0.9 on-disk format (meta page, main-DB
B+tree, leaf nodes, ``F_BIGDATA`` overflow values), and
:func:`parse_datum` a hand-written protobuf-wire decoder of the Caffe
``Datum`` fields.  Pickles load through a restricted unpickler that
admits numpy array reconstruction only: a dataset file is data, not
code.  The shards equal the JAX package's importer's byte for byte."""

from __future__ import annotations

import io
import os
import pickle
import struct

import numpy as np

from .records import RecordWriter

# -- LMDB on-disk constants (lmdb.h / mdb.c, format version 1) -------------
_MDB_MAGIC = 0xBEEFC0DE
_P_BRANCH = 0x01
_P_LEAF = 0x02
_P_OVERFLOW = 0x04
_P_META = 0x08
_F_BIGDATA = 0x01
_PAGE_HDR = 16          # pgno u64, pad u16, flags u16, lower u16, upper u16
_NODE_HDR = 8           # lo u16, hi u16, flags u16, ksize u16


class LMDBReader:
    """Read-only iterator over an LMDB main database's (key, value) pairs.

    Covers what dataset files use: a single (non-DUPSORT) main DB,
    branch/leaf pages, and overflow (``F_BIGDATA``) values.  The page
    size is taken from the meta page's own offset layout (4096 in every
    file the reference tooling wrote)."""

    def __init__(self, path: str):
        # data file may be <dir>/data.mdb (default) or the path itself
        # (MDB_NOSUBDIR)
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        import mmap as mmap_mod
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 2 * 4096:
                raise ValueError(f"{path}: too small to be an LMDB file")
            # a real ImageNet LMDB is tens of GB: map it (O(1) memory,
            # lazily paged) instead of slurping it into a bytes object
            self._buf = mmap_mod.mmap(f.fileno(), 0,
                                      access=mmap_mod.ACCESS_READ)
        metas = []
        for pgno in (0, 1):
            m = self._parse_meta(pgno * 4096)
            if m is not None:
                metas.append(m)
        if not metas:
            raise ValueError(f"{path}: no valid LMDB meta page")
        # newest committed transaction wins (LMDB double-buffers metas)
        self._root = max(metas, key=lambda m: m["txnid"])["main_root"]
        self.entries = max(metas, key=lambda m: m["txnid"])["entries"]
        self.psize = 4096

    def _parse_meta(self, off: int):
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        if not flags & _P_META:
            return None
        # MDB_meta after the page header: magic u32, version u32,
        # address u64, mapsize u64, dbs[2] (48 bytes each), last_pg u64,
        # txnid u64
        base = off + _PAGE_HDR
        magic, version = struct.unpack_from("<II", self._buf, base)
        if magic != _MDB_MAGIC:
            return None
        # skip magic+version (8) + mm_address (8) + mm_mapsize (8), then
        # the FREE_DBI MDB_db (48) → the MAIN_DBI MDB_db
        main_db = base + 24 + 48
        (_pad, _dflags, _depth, _branch, _leaf, _ovf, entries,
         root) = struct.unpack_from("<IHHQQQQQ", self._buf, main_db)
        txnid = struct.unpack_from("<Q", self._buf,
                                   main_db + 48 + 8)[0]
        return {"txnid": txnid, "main_root": root, "entries": entries}

    def _page(self, pgno: int) -> int:
        off = pgno * self.psize
        if off + self.psize > len(self._buf):
            raise ValueError(f"page {pgno} beyond EOF")
        return off

    def _iter_page(self, pgno: int):
        off = self._page(pgno)
        flags, lower = struct.unpack_from("<HH", self._buf, off + 10)
        n_keys = (lower - _PAGE_HDR) // 2
        ptrs = struct.unpack_from(f"<{n_keys}H", self._buf,
                                  off + _PAGE_HDR)
        if flags & _P_LEAF:
            for p in ptrs:
                yield from self._leaf_node(off + p)
        elif flags & _P_BRANCH:
            for p in ptrs:
                lo, hi, fl, ksize = struct.unpack_from(
                    "<HHHH", self._buf, off + p)
                # branch nodes overload (lo, hi, flags) as a 48-bit
                # child pgno (mdb.c NODEPGNO)
                child = lo | (hi << 16) | (fl << 32)
                yield from self._iter_page(child)
        else:
            raise ValueError(f"page {pgno}: unexpected flags {flags:#x}")

    def _leaf_node(self, noff: int):
        lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._buf,
                                                   noff)
        dsize = lo | (hi << 16)
        key = self._buf[noff + _NODE_HDR:noff + _NODE_HDR + ksize]
        dstart = noff + _NODE_HDR + ksize
        if nflags & _F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._buf, dstart)[0]
            ooff = self._page(ovpg)
            oflags = struct.unpack_from("<H", self._buf, ooff + 10)[0]
            if not oflags & _P_OVERFLOW:
                raise ValueError(f"page {ovpg}: expected overflow page")
            # a multi-page value can run past EOF on a truncated file;
            # an mmap slice would silently shorten it and surface later
            # as a confusing reshape error — diagnose it here instead
            if ooff + _PAGE_HDR + dsize > len(self._buf):
                raise ValueError(
                    f"page {ovpg}: overflow value of {dsize} bytes for "
                    f"key {bytes(key)!r} runs past EOF — truncated or "
                    "corrupt LMDB")
            data = self._buf[ooff + _PAGE_HDR:ooff + _PAGE_HDR + dsize]
        else:
            data = self._buf[dstart:dstart + dsize]
        yield bytes(key), bytes(data)

    def __iter__(self):
        yield from self._iter_page(self._root)


# -- Caffe Datum (protobuf wire format, hand-decoded) ----------------------
def parse_datum(blob: bytes) -> dict:
    """Decode the Caffe ``Datum`` message the reference's LMDB pipeline
    stored per key: channels(1) height(2) width(3) data(4, bytes)
    label(5) float_data(6, repeated float) encoded(7, bool)."""
    out = {"channels": 0, "height": 0, "width": 0, "data": b"",
           "label": 0, "float_data": [], "encoded": False}
    names = {1: "channels", 2: "height", 3: "width", 5: "label"}
    i, n = 0, len(blob)

    def varint():
        nonlocal i
        v, shift = 0, 0
        while True:
            b = blob[i]
            i += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    while i < n:
        tag = varint()
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            v = varint()
            if field in names:
                out[names[field]] = v
            elif field == 7:
                out["encoded"] = bool(v)
        elif wire == 2:                     # length-delimited
            ln = varint()
            chunk = blob[i:i + ln]
            i += ln
            if field == 4:
                out["data"] = chunk
            elif field == 6:                # packed repeated float
                out["float_data"].extend(
                    struct.unpack(f"<{ln // 4}f", chunk))
        elif wire == 5:                     # 32-bit (unpacked float_data)
            v = struct.unpack_from("<f", blob, i)[0]
            i += 4
            if field == 6:
                out["float_data"].append(v)
        elif wire == 1:
            i += 8
        else:
            raise ValueError(f"Datum: unsupported wire type {wire}")
    return out


def _resize_float(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an HWC float32 array with NO dtype round-trip
    — float_data Datums hold arbitrary ranges (mean-subtracted etc.)
    that a uint8 detour would silently wrap."""
    from PIL import Image
    h, w = hw
    chans = [np.asarray(Image.fromarray(img[:, :, c], mode="F")
                        .resize((w, h), Image.BILINEAR), np.float32)
             for c in range(img.shape[2])]
    return np.stack(chans, axis=2)


def datum_to_arrays(d: dict, decode_encoded: bool = True,
                    size: tuple[int, int] | None = None,
                    channels: str | None = None
                    ) -> tuple[np.ndarray, int]:
    """Datum → (HWC float32 image, label).  Raw ``data`` bytes are CHW
    uint8 (the Caffe convention) → transposed HWC, scaled to [0, 1];
    ``float_data`` is already float CHW.  ``encoded`` Datum values
    (the reference's flagship ImageNet LMDBs store JPEG/PNG bytes) are
    decoded with PIL — the same backend ``loader/image.py`` already
    trusts; pass ``decode_encoded=False`` to refuse them instead.
    ``size=(H, W)`` resizes (bilinear) — on the still-open PIL image
    for encoded values, float-safe for raw/float_data ones.
    ``channels`` ("gray"/"rgb") forces the channel count — mixed
    gray/color LMDBs need one or the other; raw values convert with
    the same ITU-R 601 luma PIL's "L" mode uses, so mixed raw/encoded
    datasets stay consistent."""
    if channels not in (None, "gray", "rgb"):
        raise ValueError(f"channels={channels!r}: use 'gray' or 'rgb'")
    if d["encoded"]:
        if not decode_encoded:
            raise NotImplementedError(
                "encoded (JPEG) Datum values refused by "
                "decode_encoded=False; re-export the dataset unencoded "
                "or drop the flag")
        from PIL import Image
        with Image.open(io.BytesIO(d["data"])) as im:
            # Caffe's convert_imageset -encoded leaves channels unset
            # (0) — fall back to the image's own mode then, unless the
            # caller forces a channel count
            if channels == "gray" or (channels is None and (
                    d["channels"] == 1
                    or (d["channels"] == 0
                        and im.mode in ("1", "L", "I", "I;16", "F")))):
                im = im.convert("L")
            else:
                im = im.convert("RGB")
            if size is not None and im.size != (size[1], size[0]):
                im = im.resize((size[1], size[0]), Image.BILINEAR)
            arr = np.asarray(im, np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr, int(d["label"])
    c, h, w = d["channels"], d["height"], d["width"]
    if d["data"]:
        arr = np.frombuffer(d["data"], np.uint8).astype(np.float32)
        arr = arr.reshape(c, h, w).transpose(1, 2, 0) / 255.0
    else:
        arr = np.asarray(d["float_data"], np.float32
                         ).reshape(c, h, w).transpose(1, 2, 0)
    if channels == "gray" and arr.shape[2] == 3:
        arr = (arr @ np.asarray([0.299, 0.587, 0.114], np.float32)
               )[:, :, None]
    elif channels == "rgb" and arr.shape[2] == 1:
        arr = np.repeat(arr, 3, axis=2)
    if size is not None and arr.shape[:2] != tuple(size):
        arr = _resize_float(arr, size)
    return arr, int(d["label"])


def import_lmdb(path: str, out_path: str,
                shard_size: int | None = None,
                size: tuple[int, int] | None = None,
                decode_encoded: bool = True,
                channels: str | None = None) -> list[str]:
    """Convert a Caffe-style LMDB dataset into ``.znr`` shard(s).

    ``size=(H, W)`` resizes every image (PIL bilinear) — required when
    an encoded LMDB stores variable-sized JPEGs, since ``.znr`` shards
    hold one static sample shape.  ``channels`` ("gray"/"rgb") forces
    the decoded channel count for mixed gray/color encoded LMDBs."""
    reader = LMDBReader(path)
    writer = None
    paths: list[str] = []
    count = 0
    shard_idx = 0

    def shard_name():
        if shard_size is None:
            return out_path
        base, ext = os.path.splitext(out_path)
        return f"{base}-{shard_idx:05d}{ext}"

    ds_shape = None                        # one geometry across ALL shards
    try:
        for key, blob in reader:
            img, label = datum_to_arrays(parse_datum(blob),
                                         decode_encoded=decode_encoded,
                                         size=size, channels=channels)
            if ds_shape is None:
                ds_shape = img.shape
            elif img.shape != ds_shape:
                hints = []
                if img.shape[:2] != ds_shape[:2]:
                    hints.append("pass size=(H, W) to resize")
                if img.shape[2:] != ds_shape[2:]:
                    hints.append("pass channels='gray' or 'rgb' to "
                                 "force one channel count")
                raise ValueError(
                    f"{path}: record {key!r} has shape {img.shape} but "
                    f"the dataset opened at {ds_shape}; "
                    f"{' and '.join(hints)}")
            if writer is None:
                writer = RecordWriter(shard_name(), ds_shape,
                                      np.float32, (), np.int32)
                paths.append(writer.path)
            writer.write(img, label)
            count += 1
            if shard_size is not None and writer.n >= shard_size:
                writer.close()
                writer = None
                shard_idx += 1
    except BaseException:
        # don't leave partial/placeholder-header shards for a later
        # glob to feed into RecordLoader (close may itself fail — e.g.
        # the full disk that aborted the import — but the unlinks must
        # still run)
        if writer is not None:
            try:
                writer.close()
            except OSError:
                pass
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass
        raise
    if writer is not None:
        writer.close()
    if count == 0:
        raise ValueError(f"{path}: LMDB contains no records")
    return paths


# -- pickled numpy datasets ------------------------------------------------
class _RestrictedUnpickler(pickle.Unpickler):
    """Admit numpy array reconstruction only — a dataset pickle must not
    execute arbitrary code on import."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"dataset pickle references {module}.{name}; only numpy "
            f"arrays are allowed — convert the file upstream")


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def import_pickle(path: str, out_path: str,
                  shard_size: int | None = None) -> list[str]:
    """Convert a pickled numpy dataset into ``.znr`` shard(s).

    Accepted layouts (what the reference's loaders pickled):
    ``(data, labels)`` tuples/lists, or dicts with data under one of
    ``data``/``x``/``images`` and labels under ``labels``/``y``
    (missing labels become zeros)."""
    from .records import write_records
    obj = _load_pickle(path)
    if isinstance(obj, (tuple, list)) and len(obj) >= 2:
        data, labels = np.asarray(obj[0]), np.asarray(obj[1])
    elif isinstance(obj, dict):
        data = None
        for k in ("data", "x", "images"):
            if k in obj:
                data = np.asarray(obj[k])
                break
        if data is None:
            raise ValueError(f"{path}: no data key in "
                             f"{sorted(obj)}")
        labels = None
        for k in ("labels", "y"):
            if k in obj:
                labels = np.asarray(obj[k])
                break
        if labels is None:
            labels = np.zeros(len(data), np.int32)
    elif isinstance(obj, np.ndarray):
        data, labels = obj, np.zeros(len(obj), np.int32)
    else:
        raise ValueError(f"{path}: unsupported pickle layout "
                         f"{type(obj).__name__}")
    if len(data) != len(labels):
        raise ValueError(f"{path}: {len(data)} rows vs {len(labels)} "
                         f"labels")
    return write_records(out_path, np.ascontiguousarray(data),
                         np.ascontiguousarray(labels),
                         shard_size=shard_size)


def main(argv=None) -> int:
    """CLI: ``python -m znicz_tpu_torch.loader.importers {lmdb|pickle} SRC
    DST.znr [--shard-size N]`` — the one-shot migration entry point."""
    import argparse
    p = argparse.ArgumentParser(
        description="Convert reference on-disk datasets to .znr shards")
    p.add_argument("format", choices=("lmdb", "pickle"))
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--shard-size", type=int, default=None)
    p.add_argument("--size", type=int, nargs=2, metavar=("H", "W"),
                   default=None,
                   help="resize images (needed for variable-sized "
                        "encoded LMDBs)")
    p.add_argument("--no-decode", action="store_true",
                   help="refuse JPEG/PNG-encoded Datum values instead "
                        "of decoding them with PIL")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--gray", action="store_true",
                   help="force 1-channel decode of encoded values")
    g.add_argument("--rgb", action="store_true",
                   help="force 3-channel decode of encoded values")
    args = p.parse_args(argv)
    if args.format == "lmdb":
        channels = "gray" if args.gray else "rgb" if args.rgb else None
        paths = import_lmdb(args.src, args.dst,
                            shard_size=args.shard_size,
                            size=tuple(args.size) if args.size else None,
                            decode_encoded=not args.no_decode,
                            channels=channels)
    else:
        if args.size or args.no_decode or args.gray or args.rgb:
            p.error("--size/--no-decode/--gray/--rgb apply to "
                    "format=lmdb only")
        paths = import_pickle(args.src, args.dst,
                              shard_size=args.shard_size)
    for path in paths:
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
