"""Cross-channel LRN fused into the max pool that follows it, forward and
backward (port of ``znicz_tpu/ops/lrn_pool.py``).

AlexNet's conv → LRN → max-pool 3/2 pairs are merged into one ``lrn_pool``
layer by the fused step (``parallel/fused.py`` ``_merge_lrn_pool``).  The
forward reads x and writes only the pooled output and the winner offsets;
the backward reads (pooled err, offsets, x) and writes dx.  Neither the
LRN output y nor its gradient reaches device memory.

The plain versions are the reference's composed golden path: LRN then
max (or max-abs) pooling forward; pool scatter, LRN backward with the
denominator recomputed, then the optional folded derivative of the
preceding layer's activation (``fold_act``, evaluated at its output y = x)
backward.  On a CUDA tensor ``lrn_maxpool``/``gd_lrn_maxpool`` launch the
hand-written kernels of ``csrc/lrn_pool.cu`` over x unsplit; on a CPU
tensor they run the plain versions.  A CUDA tensor never falls back.

``lrn_maxpool_split``/``gd_lrn_maxpool_split`` take x as the reference's
column-parity halves (``split_cols``: even and odd columns), which a conv
of the ``fused2`` routing emits directly (``ops/conv.py``
``conv2d_split``); with ``return_split`` the backward hands dx back as
halves too, for that conv's gradients.  The same kernels read (and write)
the halves in place, so nothing is ever interleaved on the card; the
plain versions interleave, compute and split again, as the reference's
XLA tier does.

x (and y) may be in any of the fused step's storage dtypes (float32,
bfloat16, float16); err and dx are float32.  Every form computes in
float32 from the stored x, rounds each LRN output to x's dtype before the
pooling compares it (so the winners are those of the split layers, LRN
stored then pooled) and takes the folded derivative at the stored x.  The kernels' launch (vector width, strips of
rows, tiles of columns, threads, shared bytes) is ``lrn_pool_plan``'s, in
Python so that the CPU tests hold it; the wrappers refuse, on either
device, a geometry whose one-column tile does not fit a block."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import (STORAGE_DTYPES, STORAGE_SUFFIX, activations, count_launch,
               form_counter)
from . import normalization as lrn_ops, pooling as pool_ops
from .geometry import norm2

#: Launches of the fused pair's kernels in this process, one counter a form
#: (``ops.form_counter``: x unsplit or as halves, and its storage dtype);
#: the CUDA branches of the wrappers add one per launch, nowhere else.
lrn_maxpool_launches = 0
lrn_maxpool_bf16_launches = 0
lrn_maxpool_f16_launches = 0
lrn_maxpool_split_launches = 0
lrn_maxpool_split_bf16_launches = 0
lrn_maxpool_split_f16_launches = 0
gd_lrn_maxpool_launches = 0
gd_lrn_maxpool_bf16_launches = 0
gd_lrn_maxpool_f16_launches = 0
gd_lrn_maxpool_split_launches = 0
gd_lrn_maxpool_split_bf16_launches = 0
gd_lrn_maxpool_split_f16_launches = 0


def fusable(ksize, stride, padding) -> bool:
    """Whether the merge fuses a pool of this geometry: the reference's
    gate (stride-W 2, padding 0), kept so that both packages merge the same
    pairs.  The kernels themselves take any stride with padding 0."""
    (sh, sw) = norm2(stride)
    (ph, pw) = norm2(padding)
    return sw == 2 and ph == 0 and pw == 0 and sh >= 1


def split_cols(x):
    """(x_even, x_odd): the column-parity halves along W of NHWC ``x``
    (views; ``.contiguous()`` them for the kernels)."""
    return x[:, :, 0::2, :], x[:, :, 1::2, :]


def interleave_cols(xe, xo, w: int):
    """Inverse of :func:`split_cols`: the W = ``w`` columns of the halves
    (the odd one padded where W is odd)."""
    b, h, we, c = xe.shape
    if xo.shape[2] < we:
        xo = torch.nn.functional.pad(xo, (0, 0, 0, we - xo.shape[2]))
    return torch.stack([xe, xo], dim=3).reshape(b, h, 2 * we, c)[:, :, :w]


# -- plain versions (the reference's composed golden path) -------------------
def plain_lrn_maxpool(x, n, alpha, beta, k, ksize, stride, padding=0,
                      use_abs=False):
    """→ (pooled, offsets): ``np_lrn_maxpool`` of the reference; a narrow
    x's LRN output rounded to its dtype before it is pooled."""
    y = lrn_ops.plain_lrn_y(x, n, alpha, beta, k)
    pool = (pool_ops.plain_maxabs_pooling if use_abs
            else pool_ops.plain_max_pooling)
    return pool(y, ksize, stride, padding)


def plain_gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k, ksize, stride,
                         padding=0, fold_act=None):
    """Pooled err → dx (float32): ``np_gd_lrn_maxpool`` of the reference,
    in float32 from the stored x (the folded derivative too)."""
    activations.fold_id(fold_act)          # refuse what cannot be folded
    err_y = pool_ops.plain_gd_max_pooling(errp, offsets, tuple(x.shape),
                                          ksize, stride, padding)
    dx = lrn_ops.plain_gd_lrn_x(err_y, x, n, alpha, beta, k)
    if fold_act is not None:
        dx = activations.BY_NAME[fold_act].bwd(dx, x.float())
    return dx


def plain_lrn_maxpool_split(xe, xo, n, alpha, beta, k, ksize, stride,
                            padding=0, use_abs=False):
    """The pair forward over the halves: interleaved, then
    :func:`plain_lrn_maxpool` (the reference's XLA tier)."""
    return plain_lrn_maxpool(interleave_cols(xe, xo, xe.shape[2]
                                             + xo.shape[2]), n, alpha, beta,
                             k, ksize, stride, padding, use_abs)


def plain_gd_lrn_maxpool_split(errp, offsets, xe, xo, n, alpha, beta, k,
                               ksize, stride, padding=0, fold_act=None,
                               return_split=False):
    """The pair backward over the halves: interleaved, then
    :func:`plain_gd_lrn_maxpool`, dx split again with ``return_split``."""
    dx = plain_gd_lrn_maxpool(
        errp, offsets, interleave_cols(xe, xo, xe.shape[2] + xo.shape[2]),
        n, alpha, beta, k, ksize, stride, padding, fold_act)
    return tuple(h.contiguous() for h in split_cols(dx)) if return_split \
        else dx


# -- kernels ----------------------------------------------------------------
_PLAN = [ctypes.c_int] * 9        # the fields of LrnPoolPlan, in order
_GEO = [ctypes.c_int] * 8 + [ctypes.c_double] * 3 + [ctypes.c_int]
#: the C entry points' ctypes signatures, the same for every storage type:
#: x (or xe, xo), y, offsets, B, H, W, C, kh, kw, sh, sw, alpha, beta, k,
#: use_abs, the plan, stream; backward err, offsets, x (or xe, xo), dx (or
#: dxe, dxo, dx_split), the geometry, act, the plan, stream
_ARGTYPES = {}
for _sfx in STORAGE_SUFFIX.values():
    _ARGTYPES.update({
        f"znicz_lrn_maxpool_{_sfx}": [ctypes.c_void_p] * 3 + _GEO + _PLAN
        + [ctypes.c_void_p],
        f"znicz_lrn_maxpool_split_{_sfx}": [ctypes.c_void_p] * 4 + _GEO
        + _PLAN + [ctypes.c_void_p],
        f"znicz_gd_lrn_maxpool_{_sfx}": [ctypes.c_void_p] * 4 + _GEO + _PLAN
        + [ctypes.c_void_p],
        f"znicz_gd_lrn_maxpool_split_{_sfx}": [ctypes.c_void_p] * 6
        + [ctypes.c_int] + _GEO + _PLAN + [ctypes.c_void_p]})


#: The card's limits that both LRN plans share: the most shared memory a
#: block may have (227 KB), a block's threads at most (a thread takes
#: ceil(vectors / MAX_THREADS) vectors of a tile row) and the H100's
#: multiprocessors, the plan's default.
MAX_TILE_BYTES = lrn_ops.MAX_TILE_BYTES
MAX_THREADS = lrn_ops.MAX_THREADS
H100_SMS = lrn_ops.H100_SMS
#: x rows a block has in flight past the one it computes (csrc/lrn_pool.cu
#: kAhead): the tile holds this many more.
ROWS_AHEAD = 2


class LrnPoolPlan(NamedTuple):
    """The launch of one kernel of the pair (``lrn_pool_plan``).  A block
    takes one image, a strip of ``rows`` rows (output rows forward, input
    rows backward) and a tile of ``cols`` columns of the same kind, and
    walks down the strip one row at a time; the grid is B · strips ·
    col_tiles blocks of ``threads`` threads with ``smem`` bytes of dynamic
    shared memory.  A thread takes ``vec`` consecutive channels of a pixel
    (4: 16-byte copies and vectors; 1 where C % 4 != 0 or a base is not
    16-byte aligned).  ``n`` is the LRN window min(n, 2C + 1): past that
    every slot beyond a channel's edge is another 0.0f, which adds nothing
    to a sum that already added one.  ``halo`` zero floats each side of a
    pixel's C channels in the x (and backward q) tiles stand for the
    window's clipped slots."""
    vec: int
    n: int
    halo: int
    rows: int
    strips: int
    cols: int
    col_tiles: int
    threads: int
    smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _smem_bytes(backward: bool, cols: int, c: int, halo: int, kh: int,
                kw: int, sh: int, sw: int, ow: int) -> int:
    """The tile of a block whose strip is ``cols`` columns wide, as the
    kernels lay it out (floats, 4 bytes each; P = C + 2·halo):

    forward: the x row in use and ``ROWS_AHEAD`` in flight, each
    wi = (cols-1)·sw + kw pixels of P, and a ring of kh + 1 LRN output
    rows of wi pixels of C (a window is pooled while the next row is
    computed);
    backward: those x rows and the q row (each cols pixels of P), the
    err·p row (cols pixels of C), and a ring of the pooled rows of err and
    of offsets that ``ROWS_AHEAD`` + 1 consecutive x rows need,
    (kh - 1 + ROWS_AHEAD) // sh + 1, each as wide as the windows over the
    tile's columns reach: min(OW, (cols + kw - 2) // sw + 1)."""
    p = c + 2 * halo
    x_rows = ROWS_AHEAD + 1
    if not backward:
        wi = (cols - 1) * sw + kw
        return 4 * (x_rows * wi * p + (kh + 1) * wi * c)
    ecols = min(ow, (cols + kw - 2) // sw + 1)
    ring = (kh - 1 + ROWS_AHEAD) // sh + 1
    return 4 * ((x_rows + 1) * cols * p + cols * c + 2 * ring * ecols * c)


def lrn_pool_plan(shape, ksize, stride, n: int, backward: bool = False,
                  aligned: bool = True, n_sm: int = H100_SMS) -> LrnPoolPlan:
    """The launch of ``lrn_maxpool`` (or, ``backward``, of
    ``gd_lrn_maxpool``) for NHWC ``shape`` and a padding-0 window, bases
    16-byte aligned or not, on a card of ``n_sm`` multiprocessors.

    Columns: the whole row where its tile fits ``MAX_TILE_BYTES``, else
    the widest tile that does (``cols`` 0 where not even one column
    fits: the wrappers refuse that).  Threads: the fewest vectors a
    thread per pass over a tile row within ``MAX_THREADS`` (forward, a
    pass computes an LRN row and pools an output row).  Strips: about
    ``n_sm`` blocks in all (one block an SM holds, the tile being
    large), each strip at least one row.  Of 123 plans timed at
    AlexNet's pairs on an H100 (1-3 column tiles, threads, 1-3 strips)
    none beat this one (PERF.md)."""
    b, h, w, c = (int(v) for v in shape)
    (kh, kw), (sh, sw) = norm2(ksize), norm2(stride)
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    vec = 4 if c % 4 == 0 and aligned else 1
    n = min(int(n), 2 * c + 1)
    lo = (n - 1) // 2
    halo = _ceil(max(lo, n - 1 - lo), vec) * vec
    rows_total, cols = (h, w) if backward else (oh, ow)
    geo = (c, halo, kh, kw, sh, sw, ow)
    if _smem_bytes(backward, cols, *geo) > MAX_TILE_BYTES:
        fits, over = 0, cols     # the tile grows with its columns
        while over - fits > 1:
            mid = (fits + over) // 2
            if _smem_bytes(backward, mid, *geo) <= MAX_TILE_BYTES:
                fits = mid
            else:
                over = mid
        cols = fits
    if cols == 0:
        return LrnPoolPlan(vec, n, halo, rows_total, 1, 0, 0, 0,
                           _smem_bytes(backward, 1, *geo))
    col_tiles = _ceil(w if backward else ow, cols)
    # a pass: the backward's x row; the forward's LRN row and pooled row
    pixels = cols if backward else (cols - 1) * sw + kw + cols
    vectors = pixels * c // vec
    per = _ceil(vectors, MAX_THREADS)
    threads = _ceil(_ceil(vectors, per), 32) * 32
    strips = min(rows_total, max(1, round(n_sm / (b * col_tiles))))
    rows = _ceil(rows_total, strips)
    return LrnPoolPlan(vec, n, halo, rows, _ceil(rows_total, rows), cols,
                       col_tiles, threads,
                       _smem_bytes(backward, cols, *geo))


def _plan(x, ksize, stride, n, backward: bool, *tensors) -> LrnPoolPlan:
    """The plan for a CUDA launch over x (a tensor, or its halves) and
    these tensors (all of them 16-byte aligned or the scalar form) on x's
    card."""
    xs = x if isinstance(x, tuple) else (x,)
    aligned = all(t.data_ptr() % 16 == 0 for t in (*xs, *tensors))
    return lrn_pool_plan(
        _shape(x), ksize, stride, n, backward, aligned,
        torch.cuda.get_device_properties(
            xs[0].device).multi_processor_count)


def _shape(x) -> tuple:
    """NHWC shape of x, or of the tensor whose halves x is."""
    if isinstance(x, tuple):
        b, h, we, c = x[0].shape
        return (b, h, we + x[1].shape[2], c)
    return tuple(x.shape)


def _launch(name: str, device, *args) -> None:
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("lrn_pool", name, _ARGTYPES[name]),
                      device, *args)


def _check_x(who, x) -> None:
    """Refuse an x (a tensor, or the halves (xe, xo)) that is not NHWC in
    a storage dtype and contiguous, or halves not of one dtype and device
    with widths ceil(W/2) and floor(W/2)."""
    xs = x if isinstance(x, tuple) else (x,)
    for name, t in zip(("xe", "xo") if len(xs) == 2 else ("x",), xs):
        pool_ops._check(who, name, t, STORAGE_DTYPES, xs[0].device)
    if len(xs) == 2:
        xe, xo = xs
        if xo.dtype != xe.dtype or xe.shape[:2] != xo.shape[:2] \
                or xe.shape[3] != xo.shape[3] \
                or xe.shape[2] - xo.shape[2] not in (0, 1):
            raise ValueError(f"{who}: halves {tuple(xe.shape)} {xe.dtype} "
                             f"and {tuple(xo.shape)} {xo.dtype} are not the "
                             f"even and odd columns of one tensor")


def _geometry(who, x, n, ksize, stride, padding):
    """((kh, kw), (sh, sw), (OH, OW)) of x (or its halves) after refusing
    what the kernels do not take; the CPU branch is held to the same
    contract."""
    _check_x(who, x)
    shape = _shape(x)
    if norm2(padding) != (0, 0):
        raise ValueError(f"{who}: the fused pair takes padding 0, got "
                         f"{padding}")
    if not 1 <= int(n) < 2 ** 31:
        raise ValueError(f"{who}: window n must be positive, got {n}")
    (kh, kw), (sh, sw), _, (oh, ow) = pool_ops._geometry(
        who, shape, ksize, stride, 0)
    if shape[-1] > lrn_ops.MAX_CHANNELS:
        raise ValueError(f"{who}: {shape[-1]} channels; the kernels take "
                         f"at most {lrn_ops.MAX_CHANNELS}")
    for backward in (False, True):
        if lrn_pool_plan(shape, (kh, kw), (sh, sw), n, backward).cols == 0:
            raise ValueError(f"{who}: one column of {shape[-1]} channels "
                             f"under a {kh}x{kw} window does not fit the "
                             f"kernels' shared-memory tile")
    return (kh, kw), (sh, sw), (oh, ow)


def _forward(who, x, n, alpha, beta, k, ksize, stride, padding, use_abs):
    """The forward over x unsplit or as halves (a tuple)."""
    split = isinstance(x, tuple)
    (kh, kw), (sh, sw), (oh, ow) = _geometry(who, x, n, ksize, stride,
                                             padding)
    xs = x if split else (x,)
    if xs[0].device.type == "cpu":
        plain = plain_lrn_maxpool_split if split else plain_lrn_maxpool
        return plain(*xs, n, alpha, beta, k, (kh, kw), (sh, sw), 0, use_abs)
    b, h, w, c = _shape(x)
    dtype = xs[0].dtype
    y = torch.empty((b, oh, ow, c), dtype=dtype, device=xs[0].device)
    off = torch.empty((b, oh, ow, c), dtype=torch.int32, device=y.device)
    plan = _plan(x, (kh, kw), (sh, sw), n, False, y, off)
    entry = f"znicz_lrn_maxpool{'_split' if split else ''}_" \
        f"{STORAGE_SUFFIX[dtype]}"
    _launch(entry, y.device, *(t.data_ptr() for t in xs), y.data_ptr(),
            off.data_ptr(), b, h, w, c, kh, kw, sh, sw, float(alpha),
            float(beta), float(k), int(use_abs), *plan)
    count_launch(__name__, form_counter("lrn_maxpool", dtype, split))
    return y, off


def lrn_maxpool(x, n, alpha, beta, k, ksize, stride, padding=0,
                use_abs=False):
    """(pooled, int32 offsets) of LRN then max (max-|·| with ``use_abs``)
    pooling over NHWC ``x`` (float32, bfloat16 or float16; the pooled
    output in x's dtype): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    return _forward("lrn_maxpool", x, n, alpha, beta, k, ksize, stride,
                    padding, use_abs)


def lrn_maxpool_split(xe, xo, n, alpha, beta, k, ksize, stride, padding=0,
                      use_abs=False):
    """:func:`lrn_maxpool` of the tensor whose column-parity halves are
    ``xe``/``xo`` (contiguous): the kernel reads the halves in place."""
    return _forward("lrn_maxpool_split", (xe, xo), n, alpha, beta, k, ksize,
                    stride, padding, use_abs)


def _backward(who, errp, offsets, x, n, alpha, beta, k, ksize, stride,
              padding, fold_act, return_split):
    split = isinstance(x, tuple)
    act = activations.fold_id(fold_act)
    (kh, kw), (sh, sw), (oh, ow) = _geometry(who, x, n, ksize, stride,
                                             padding)
    xs = x if split else (x,)
    b, h, w, c = _shape(x)
    dev = xs[0].device
    pool_ops._check(who, "err", errp, torch.float32, dev, (b, oh, ow, c))
    pool_ops._check(who, "offsets", offsets, torch.int32, dev,
                    (b, oh, ow, c))
    if dev.type == "cpu":
        if split:
            return plain_gd_lrn_maxpool_split(
                errp, offsets, *xs, n, alpha, beta, k, (kh, kw), (sh, sw),
                0, fold_act, return_split)
        return plain_gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k,
                                    (kh, kw), (sh, sw), 0, fold_act)
    if return_split:
        dxs = tuple(torch.empty(t.shape, dtype=torch.float32, device=dev)
                    for t in xs)
    else:
        dxs = (torch.empty((b, h, w, c), dtype=torch.float32, device=dev),)
    plan = _plan(x, (kh, kw), (sh, sw), n, True, errp, offsets, *dxs)
    dtype = xs[0].dtype
    geo = (b, h, w, c, kh, kw, sh, sw, float(alpha), float(beta), float(k),
           act)
    if split:
        _launch(f"znicz_gd_lrn_maxpool_split_{STORAGE_SUFFIX[dtype]}", dev,
                errp.data_ptr(), offsets.data_ptr(), xs[0].data_ptr(),
                xs[1].data_ptr(), dxs[0].data_ptr(),
                dxs[-1].data_ptr() if return_split else None,
                int(return_split), *geo, *plan)
    else:
        _launch(f"znicz_gd_lrn_maxpool_{STORAGE_SUFFIX[dtype]}", dev,
                errp.data_ptr(), offsets.data_ptr(), x.data_ptr(),
                dxs[0].data_ptr(), *geo, *plan)
    count_launch(__name__, form_counter("gd_lrn_maxpool", dtype, split))
    return dxs if return_split else dxs[0]


def gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k, ksize, stride,
                   padding=0, fold_act=None):
    """float32 dx of the fused pair from the pooled err, the winner offsets
    and the pair's input x (any storage dtype); ``fold_act`` also applies
    the derivative of the preceding layer's (y-only) activation at its
    output y = x."""
    return _backward("gd_lrn_maxpool", errp, offsets, x, n, alpha, beta, k,
                     ksize, stride, padding, fold_act, False)


def gd_lrn_maxpool_split(errp, offsets, xe, xo, n, alpha, beta, k, ksize,
                         stride, padding=0, fold_act=None,
                         return_split=False):
    """:func:`gd_lrn_maxpool` with x as its column-parity halves
    (contiguous); dx as halves (dxe, dxo) with ``return_split``, else
    unsplit.  The kernel reads and writes the halves in place."""
    return _backward("gd_lrn_maxpool_split", errp, offsets, (xe, xo), n,
                     alpha, beta, k, ksize, stride, padding, fold_act,
                     return_split)
