"""Portable model export (.znn) + the native-engine binding (port of
``znicz_tpu/export.py``).

The boundary between training and serving is a flat binary (magic
``ZNN1``; per layer: kind, activation, 8-int geometry, raw float32
weight/bias blobs — ``native/znicz_infer.cpp`` holds the authoritative
format comment) written from a trained workflow.  The writer here emits
the same bytes as the JAX package's for the same weights, so a file
crosses between the two packages and the C++ engine.

The weights are read from the units as host float32 wherever they live:
after ``run_fused`` the trainer has written the trained weights back to
the units (``StandardWorkflow.run_fused``), and on the card ``.mem`` maps
them to the host.

The native engine (``native/znicz_infer.cpp`` with ``parallel.h``) is
built by :func:`build_native` with the Makefile's flags into the
package's ``build/`` directory, keyed on a digest of both sources, and
bound through ctypes; nothing is written into ``native/``."""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct

import numpy as np

from . import cuda_build, durability

NATIVE_DIR = cuda_build.PACKAGE_DIR.parent / "native"

KIND = {"fc": 0, "conv": 1, "max_pool": 2, "avg_pool": 3, "lrn": 4,
        "activation": 5, "dropout": 6, "softmax": 7, "deconv": 8,
        "depool": 9, "kohonen": 10}
ACT = {"linear": 0, "tanh": 1, "relu": 2, "strict_relu": 3, "sigmoid": 4}


KIND_NAMES = {v: k for k, v in KIND.items()}
ACT_NAMES = {v: k for k, v in ACT.items()}


@dataclasses.dataclass(frozen=True)
class ZnnLayer:
    """One parsed .znn layer row (the Python twin of the C++ loader's
    Layer struct; geometry ``p`` meanings per kind are documented in
    ``native/znicz_infer.cpp``'s format comment)."""

    kind: str                     # KIND key
    activation: str               # ACT key
    p: tuple                      # the 8-int geometry row
    w: np.ndarray | None          # reshaped per kind (see read_znn)
    b: np.ndarray | None


def _reshape_params(kind: str, p, w, b):
    """Give the raw blobs their per-kind geometry (and validate sizes
    like the C++ loader does — a corrupt row must fail at load, not as
    a shape error mid-forward)."""
    shapes = {"fc": (p[0], p[1]), "conv": (p[0], p[1], p[2], p[3]),
              "deconv": (p[0], p[1], p[2], p[3]), "lrn": (3,),
              "kohonen": (p[0], p[1])}
    want = shapes.get(kind)
    if want is None:                     # parameter-less kinds
        return w, b
    if w is None or w.size != int(np.prod(want)):
        raise IOError(f"{kind} layer carries "
                      f"{0 if w is None else w.size} weights, geometry "
                      f"says {want}")
    n_bias = {"fc": p[1], "conv": p[3], "deconv": p[2]}.get(kind)
    if b is not None and b.size != n_bias:
        raise IOError(f"{kind} layer carries {b.size} bias values, "
                      f"geometry says {n_bias}")
    return w.reshape(want), b


def read_znn(path: str) -> list[ZnnLayer]:
    """Parse a .znn container back into layer rows — the exact inverse
    of ``export_workflow``'s writer, used by the serving engine
    (``znicz_tpu_torch.serving``) so every engine consumes one format
    with one authoritative layout comment (``native/znicz_infer.cpp``)."""
    with open(path, "rb") as fh:
        blob = fh.read()
    if blob[:4] != b"ZNN1":
        raise IOError(f"{path!r} is not a .znn file (bad magic)")
    if len(blob) < 8:
        raise IOError(f"{path!r}: header truncated")
    (n_layers,) = struct.unpack_from("<I", blob, 4)
    off, layers = 8, []
    for li in range(n_layers):
        if off + 40 > len(blob):
            raise IOError(f"{path!r}: layer {li} header truncated")
        kind_id, act_id, *p = struct.unpack_from("<II8i", blob, off)
        off += 40
        if kind_id not in KIND_NAMES or act_id not in ACT_NAMES:
            raise IOError(f"{path!r}: layer {li} has unknown "
                          f"kind/activation ({kind_id}, {act_id})")
        blobs = []
        for which in ("weights", "bias"):
            if off + 8 > len(blob):
                raise IOError(f"{path!r}: layer {li} {which} size "
                              f"truncated")
            (size,) = struct.unpack_from("<Q", blob, off)
            off += 8
            if size * 4 > len(blob) - off:   # hostile size: no bad_alloc
                raise IOError(f"{path!r}: layer {li} {which} blob "
                              f"overruns the file")
            blobs.append(np.frombuffer(blob, np.float32, int(size),
                                       off).copy() if size else None)
            off += int(size) * 4
        kind = KIND_NAMES[kind_id]
        if kind == "depool" and not (
                0 <= p[2] < li and layers[p[2]].kind == "max_pool"):
            # a dangling tie must fail HERE, not as a KeyError inside
            # the first forward (same standard as the blob checks; the
            # C++ loader enforces the identical rule)
            raise IOError(f"{path!r}: layer {li} depool ties to "
                          f"{p[2]}, which is not an earlier max_pool")
        w, b = _reshape_params(kind, p, *blobs)
        layers.append(ZnnLayer(kind, ACT_NAMES[act_id], tuple(p), w, b))
    return layers


def _write_header(fh, n_layers: int) -> None:
    """The one place the .znn container header is written — every
    export branch goes through it (and _pack_layer for rows)."""
    fh.write(b"ZNN1")
    fh.write(struct.pack("<I", n_layers))


def _pack_layer(fh, kind: int, act: int, p, w=None, b=None) -> None:
    p = (list(p) + [0] * 8)[:8]
    fh.write(struct.pack("<II8i", kind, act, *p))
    for blob in (w, b):
        if blob is None:
            fh.write(struct.pack("<Q", 0))
        else:
            arr = np.ascontiguousarray(blob, np.float32)
            fh.write(struct.pack("<Q", arr.size))
            fh.write(arr.tobytes())


def _commit_znn(path: str) -> str:
    """Atomic publish of a finished ``.znn``: invalidate any old
    manifest, rename the temp blob into place, then write the new
    sha256 manifest (the invalidate→blob→manifest protocol pinned in
    ``durability`` — a crash can leave a manifest-less blob,
    never a live manifest over foreign bytes) and give the
    ``artifact.bitflip`` chaos site its shot at the committed bytes."""
    durability.invalidate_manifest(path)
    os.replace(path + ".tmp", path)
    durability.write_manifest(path, kind="znn")
    durability.chaos_bitflip(path)
    return path


def export_workflow(workflow, path: str) -> str:
    """Serialize a trained StandardWorkflow's forward chain to .znn.

    Covers the inference-relevant unit zoo — fc/conv/pool/LRN/activation/
    dropout/softmax plus the decoder path (Deconv/Depooling, so trained
    autoencoders run natively) and trained-SOM serving (a
    KohonenForward head exports as negated squared distances).

    Writes are crash-safe: the container lands at ``path`` by a single
    rename only once fully written, with a sha256 manifest sidecar
    (``path.manifest.json``) committed right after — serving's
    verify-on-load refuses a truncated or bit-flipped artifact instead
    of crashing mid-forward (docs/durability.md)."""
    from .nn.all2all import All2All, All2AllSoftmax
    from .nn.kohonen import KohonenForward

    som = getattr(workflow, "forward", None)
    if not hasattr(workflow, "forwards") and isinstance(som,
                                                        KohonenForward):
        # SOM workflows have a single winner-take-all forward, not a
        # layer chain
        with open(path + ".tmp", "wb") as fh:
            _write_header(fh, 1)
            w = np.asarray(som.weights.mem, np.float32)
            _pack_layer(fh, KIND["kohonen"], 0, list(w.shape), w)
        return _commit_znn(path)
    from .nn.conv import Conv
    from .nn.deconv import Deconv
    from .nn.depooling import Depooling
    from .nn.dropout import DropoutForward
    from .nn.normalization import LRNormalizerForward
    from .nn import activation as act_units
    from .nn import pooling as pool_units

    with open(path + ".tmp", "wb") as fh:
        _write_header(fh, _count_layers(workflow))
        export_idx = {}   # forward unit -> its EXPORT-stream index
        n_out = 0
        for fwd in workflow.forwards:
            export_idx[id(fwd)] = n_out
            n_out += 1
            if isinstance(fwd, All2AllSoftmax):
                n_out += 1           # fused softmax head adds a layer
            if isinstance(fwd, Deconv):      # before Conv: subclass-ish
                w = np.asarray(fwd.weights.mem, np.float32)
                b = (np.asarray(fwd.bias.mem, np.float32)
                     if fwd.include_bias else None)
                kh, kw, cout, cin = w.shape   # (KH, KW, C_out, C_in)
                (sh, sw), (ph, pw) = fwd.sliding, fwd.padding
                _pack_layer(fh, KIND["deconv"],
                            ACT[fwd.ACTIVATION.name],
                            [kh, kw, cout, cin, sh, sw, ph, pw], w, b)
                continue
            if isinstance(fwd, Depooling):
                tie = export_idx[id(fwd.pool_unit)]
                (kh, kw) = fwd.ksize
                (sh, sw), (ph, pw) = fwd.sliding, fwd.padding
                _pack_layer(fh, KIND["depool"], 0,
                            [kh, kw, tie, 0, sh, sw, ph, pw])
                continue
            if isinstance(fwd, All2All):
                w = np.asarray(fwd.weights.mem, np.float32)
                b = (np.asarray(fwd.bias.mem, np.float32)
                     if fwd.include_bias else None)
                act = ("linear" if isinstance(fwd, All2AllSoftmax)
                       else fwd.ACTIVATION.name)
                _pack_layer(fh, KIND["fc"], ACT[act],
                            [w.shape[0], w.shape[1]], w, b)
                if isinstance(fwd, All2AllSoftmax):
                    _pack_layer(fh, KIND["softmax"], 0, [])
            elif isinstance(fwd, Conv):
                w = np.asarray(fwd.weights.mem, np.float32)
                b = (np.asarray(fwd.bias.mem, np.float32)
                     if fwd.include_bias else None)
                kh, kw, cin, cout = w.shape
                (sh, sw), (ph, pw) = fwd.sliding, fwd.padding
                _pack_layer(fh, KIND["conv"], ACT[fwd.ACTIVATION.name],
                            [kh, kw, cin, cout, sh, sw, ph, pw], w, b)
            elif isinstance(fwd, pool_units.Pooling):
                avg = isinstance(fwd, pool_units.AvgPooling)
                (kh, kw) = fwd.ksize
                (sh, sw), (ph, pw) = fwd.sliding, fwd.padding
                _pack_layer(fh, KIND["avg_pool" if avg else "max_pool"],
                            0, [kh, kw, 0, 0, sh, sw, ph, pw])
            elif isinstance(fwd, LRNormalizerForward):
                _pack_layer(fh, KIND["lrn"], 0, [fwd.n],
                            np.asarray([fwd.alpha, fwd.beta, fwd.k],
                                       np.float32))
            elif isinstance(fwd, DropoutForward):
                _pack_layer(fh, KIND["dropout"], 0, [])
            elif isinstance(fwd, act_units.ActivationForward):
                name = fwd.ACTIVATION.name
                if name not in ACT:
                    raise NotImplementedError(
                        f"native engine has no activation {name!r}")
                _pack_layer(fh, KIND["activation"], ACT[name], [])
            else:
                raise NotImplementedError(
                    f"export does not cover {type(fwd).__name__}")
    return _commit_znn(path)


def _count_layers(workflow) -> int:
    from .nn.all2all import All2AllSoftmax
    n = len(workflow.forwards)
    n += sum(1 for f in workflow.forwards
             if isinstance(f, All2AllSoftmax))   # fused softmax head
    return n


class NativeEngine:
    """ctypes wrapper over the native engine's library (built on first
    use)."""

    def __init__(self, lib_path: str | None = None):
        self.lib = ctypes.CDLL(lib_path or build_native())
        self.lib.zn_load.restype = ctypes.c_void_p
        self.lib.zn_load.argtypes = [ctypes.c_char_p]
        self.lib.zn_free.argtypes = [ctypes.c_void_p]
        self.lib.zn_n_layers.argtypes = [ctypes.c_void_p]
        self.lib.zn_infer.restype = ctypes.c_int64
        self.lib.zn_infer.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64]

    def load(self, path: str) -> "NativeModel":
        handle = self.lib.zn_load(path.encode())
        if not handle:
            raise IOError(f"native engine failed to load {path!r}")
        return NativeModel(self, handle)


class NativeModel:
    def __init__(self, engine: NativeEngine, handle):
        self.engine = engine
        self.handle = handle

    @property
    def n_layers(self) -> int:
        return self.engine.lib.zn_n_layers(self.handle)

    def infer(self, x: np.ndarray, out_features: int) -> np.ndarray:
        """x: (B, H, W, C) or (B, F) float32 → (B, out_features)."""
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim == 2:
            b, f = x.shape
            shape = (b, 1, 1, f)
        elif x.ndim == 4:
            shape = x.shape
        else:
            raise ValueError(f"expected 2-D or 4-D input, got {x.shape}")
        out = np.empty(shape[0] * out_features, np.float32)
        n = self.engine.lib.zn_infer(
            self.handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *[ctypes.c_int64(int(d)) for d in shape],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(out.size))
        if n < 0:
            raise RuntimeError("native inference failed")
        if n != out.size:
            raise RuntimeError(
                f"native engine produced {n} floats, expected {out.size} "
                "(wrong out_features?)")
        return out.reshape(shape[0], out_features)

    def __del__(self):
        try:
            self.engine.lib.zn_free(self.handle)
        except Exception:
            pass


def build_native(force: bool = False) -> str:
    """Compile ``native/znicz_infer.cpp`` (with ``parallel.h``) with the
    Makefile's flags into ``build/libznicz_infer-<digest>.so`` unless a
    library of these sources is built already (``force``: rebuild),
    under a lock file; returns its path.  A failing build raises
    ``cuda_build.BuildError``: serving has no other CPU engine, and a
    stale library must never be loaded after an edit."""
    return str(cuda_build.build_host(
        "libznicz_infer", NATIVE_DIR / "znicz_infer.cpp",
        (NATIVE_DIR / "parallel.h",), force=force))
