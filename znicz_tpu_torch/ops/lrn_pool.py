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
hand-written kernels of ``csrc/lrn_pool.cu``, which take x unsplit (the
reference's column-parity split ``split_cols`` exists because Mosaic has
no strided loads); on a CPU tensor they run the plain versions.  A CUDA
tensor never falls back."""

from __future__ import annotations

import ctypes

import torch

from . import activations, normalization as lrn_ops, pooling as pool_ops
from .geometry import norm2

#: Launches of the fused pair's kernels in this process (the CUDA branches
#: of the wrappers add one per launch, nowhere else).
lrn_maxpool_launches = 0
gd_lrn_maxpool_launches = 0


def fusable(ksize, stride, padding) -> bool:
    """Whether the merge fuses a pool of this geometry: the reference's
    gate (stride-W 2, padding 0), kept so that both packages merge the same
    pairs.  The kernels themselves take any stride with padding 0."""
    (sh, sw) = norm2(stride)
    (ph, pw) = norm2(padding)
    return sw == 2 and ph == 0 and pw == 0 and sh >= 1


# -- plain versions (the reference's composed golden path) -------------------
def plain_lrn_maxpool(x, n, alpha, beta, k, ksize, stride, padding=0,
                      use_abs=False):
    """→ (pooled, offsets): ``np_lrn_maxpool`` of the reference."""
    y = lrn_ops.plain_lrn_y(x, n, alpha, beta, k)
    pool = (pool_ops.plain_maxabs_pooling if use_abs
            else pool_ops.plain_max_pooling)
    return pool(y, ksize, stride, padding)


def plain_gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k, ksize, stride,
                         padding=0, fold_act=None):
    """Pooled err → dx: ``np_gd_lrn_maxpool`` of the reference."""
    activations.fold_id(fold_act)          # refuse what cannot be folded
    err_y = pool_ops.plain_gd_max_pooling(errp, offsets, tuple(x.shape),
                                          ksize, stride, padding)
    dx = lrn_ops.plain_gd_lrn_x(err_y, x, n, alpha, beta, k)
    if fold_act is not None:
        dx = activations.BY_NAME[fold_act].bwd(dx, x)
    return dx


# -- kernels ----------------------------------------------------------------
_ARGTYPES = {
    # x, y, offsets, B, H, W, C, kh, kw, sh, sw, n, alpha, beta, k,
    # use_abs, stream
    "znicz_lrn_maxpool_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p],
    # err, offsets, x, dx, B, H, W, C, kh, kw, sh, sw, n, alpha, beta, k,
    # act, stream
    "znicz_gd_lrn_maxpool_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
    + [ctypes.c_double] * 3 + [ctypes.c_int, ctypes.c_void_p],
}


#: The forward kernel tiles whole input rows of 32 channels in shared
#: memory, at most the 227 KB a block of an H100 may have.
TILE_ROW_BYTES_PER_COLUMN = 32 * 4
MAX_TILE_BYTES = 232448


def _launch(name: str, device, *args) -> None:
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("lrn_pool", name, _ARGTYPES[name]),
                      device, *args)


def _geometry(who, x, n, ksize, stride, padding):
    """((kh, kw), (sh, sw), (OH, OW)) after refusing what the kernels do
    not take; the CPU branch is held to the same contract."""
    pool_ops._check(who, "x", x, torch.float32)
    if norm2(padding) != (0, 0):
        raise ValueError(f"{who}: the fused pair takes padding 0, got "
                         f"{padding}")
    if not 1 <= int(n) < 2 ** 31:
        raise ValueError(f"{who}: window n must be positive, got {n}")
    (kh, kw), (sh, sw), _, (oh, ow) = pool_ops._geometry(
        who, x.shape, ksize, stride, 0)
    if x.shape[-1] > lrn_ops.MAX_CHANNELS:
        raise ValueError(f"{who}: {x.shape[-1]} channels; the kernels take "
                         f"at most {lrn_ops.MAX_CHANNELS}")
    if kh * x.shape[2] * TILE_ROW_BYTES_PER_COLUMN > MAX_TILE_BYTES:
        raise ValueError(f"{who}: a {kh}-row window over {x.shape[2]} "
                         f"columns does not fit the forward kernel's "
                         f"shared-memory tile")
    return (kh, kw), (sh, sw), (oh, ow)


def lrn_maxpool(x, n, alpha, beta, k, ksize, stride, padding=0,
                use_abs=False):
    """(pooled, int32 offsets) of LRN then max (max-|·| with ``use_abs``)
    pooling over NHWC float32 ``x``: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    global lrn_maxpool_launches
    who = "lrn_maxpool"
    (kh, kw), (sh, sw), (oh, ow) = _geometry(who, x, n, ksize, stride,
                                             padding)
    if x.device.type == "cpu":
        return plain_lrn_maxpool(x, n, alpha, beta, k, (kh, kw), (sh, sw), 0,
                                 use_abs)
    b, h, w, c = x.shape
    y = torch.empty((b, oh, ow, c), dtype=torch.float32, device=x.device)
    off = torch.empty((b, oh, ow, c), dtype=torch.int32, device=x.device)
    _launch("znicz_lrn_maxpool_f32", x.device, x.data_ptr(), y.data_ptr(),
            off.data_ptr(), b, h, w, c, kh, kw, sh, sw, int(n), float(alpha),
            float(beta), float(k), int(use_abs))
    lrn_maxpool_launches += 1
    return y, off


def gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k, ksize, stride,
                   padding=0, fold_act=None):
    """dx of the fused pair from the pooled err, the winner offsets and the
    pair's input x; ``fold_act`` also applies the derivative of the
    preceding layer's (y-only) activation at its output y = x."""
    global gd_lrn_maxpool_launches
    who = "gd_lrn_maxpool"
    act = activations.fold_id(fold_act)
    (kh, kw), (sh, sw), (oh, ow) = _geometry(who, x, n, ksize, stride,
                                             padding)
    b, h, w, c = x.shape
    pool_ops._check(who, "err", errp, torch.float32, x.device,
                    (b, oh, ow, c))
    pool_ops._check(who, "offsets", offsets, torch.int32, x.device,
                    (b, oh, ow, c))
    if x.device.type == "cpu":
        return plain_gd_lrn_maxpool(errp, offsets, x, n, alpha, beta, k,
                                    (kh, kw), (sh, sw), 0, fold_act)
    dx = torch.empty_like(x)
    _launch("znicz_gd_lrn_maxpool_f32", x.device, errp.data_ptr(),
            offsets.data_ptr(), x.data_ptr(), dx.data_ptr(), b, h, w, c, kh,
            kw, sh, sw, int(n), float(alpha), float(beta), float(k), act)
    gd_lrn_maxpool_launches += 1
    return dx
