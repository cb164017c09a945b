"""Pooling: max / max-abs / avg, with winner offsets for backprop (port of
``znicz_tpu/ops/pooling.py``).

Layout NHWC throughout.  Winner offsets are the reference's dense int32
window-slot index ``t = i·kw + j`` in ``[0, kh·kw)`` per output element
(not ``max_pool2d``'s flat plane positions).  Max pooling pads with −inf
(0 for max-abs), takes the taps in flat row-major order and keeps a tap
only when its score is strictly greater, so ties keep the first tap.

``max_pooling``/``maxabs_pooling`` and ``gd_max_pooling`` launch the
hand-written kernels of ``csrc/pooling.cu`` on a CUDA tensor and run the
plain versions (``plain_*``, transcriptions of the reference's XLA tier)
on a CPU tensor; a CUDA tensor never falls back to the plain version.
Average pooling is XLA in the reference, so it stays PyTorch on both
devices."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .geometry import norm2, out_size

#: Launches of the pool-select / pool-scatter kernels in this process (the
#: CUDA branches of the wrappers add one per launch, nowhere else).
pool_select_launches = 0
pool_scatter_launches = 0

def pool_out_shape(x_shape, ksize, stride=None, padding=0):
    """NHWC output shape of a pooling window over ``x_shape``."""
    (kh, kw), (ph, pw) = norm2(ksize), norm2(padding)
    (sh, sw) = norm2(stride if stride is not None else ksize)
    b, h, w, c = x_shape
    return (b, out_size(h, kh, sh, ph), out_size(w, kw, sw, pw), c)


def _taps(kh: int, kw: int):
    return [(t, t // kw, t % kw) for t in range(kh * kw)]


def _pad(x, ph, pw, value):
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (0, 0, pw, pw, ph, ph), value=value)


def _slices(xp, kh, kw, sh, sw, oh, ow):
    """Strided window slices, one per tap: each (B, OH, OW, C)."""
    return [xp[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :]
            for _, i, j in _taps(kh, kw)]


# -- plain versions (the reference's XLA tier) ------------------------------
def _max_pool(x, ksize, stride, padding, use_abs: bool):
    (kh, kw), (sh, sw), (ph, pw) = norm2(ksize), norm2(stride), \
        norm2(padding)
    _, h, w, _ = x.shape
    oh, ow = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    xpad = _pad(x, ph, pw, 0.0 if use_abs else float("-inf"))
    best = best_val = idx = None
    for t, sl in enumerate(_slices(xpad, kh, kw, sh, sw, oh, ow)):
        score = torch.abs(sl) if use_abs else sl
        if best is None:
            best, best_val = score, sl
            idx = torch.zeros(sl.shape, dtype=torch.int32, device=x.device)
        else:
            take = score > best
            best = torch.where(take, score, best)
            best_val = torch.where(take, sl, best_val)
            idx = torch.where(take, t, idx)
    return best_val.contiguous(), idx.contiguous()


def plain_max_pooling(x, ksize, stride=None, padding=0):
    """→ (y, offsets): ``_max_pool`` of the reference."""
    return _max_pool(x, ksize, stride or ksize, padding, False)


def plain_maxabs_pooling(x, ksize, stride=None, padding=0):
    """Winner is the element with max |value|; output keeps its sign."""
    return _max_pool(x, ksize, stride or ksize, padding, True)


def plain_gd_max_pooling(err, offsets, x_shape, ksize, stride=None,
                         padding=0):
    """Add err into a padded dx at each window's winner slot, tap by tap
    in order, then crop: the reference's ``xla_gd_max_pooling``."""
    (kh, kw), (sh, sw), (ph, pw) = norm2(ksize), \
        norm2(stride or ksize), norm2(padding)
    b, h, w, c = x_shape
    _, oh, ow, _ = err.shape
    dx = torch.zeros((b, h + 2 * ph, w + 2 * pw, c), dtype=torch.float32,
                     device=err.device)
    for t, i, j in _taps(kh, kw):
        dx[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :] += err * (offsets == t)
    return dx[:, ph:ph + h, pw:pw + w, :].contiguous()


def avg_pooling(x, ksize, stride=None, padding=0):
    """Mean over the window, zero padding counted in the full window area
    (the reference's ``_avg_pool``)."""
    (kh, kw), (sh, sw), (ph, pw) = norm2(ksize), \
        norm2(stride or ksize), norm2(padding)
    _, h, w, _ = x.shape
    oh, ow = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    acc = None
    for sl in _slices(_pad(x, ph, pw, 0.0), kh, kw, sh, sw, oh, ow):
        acc = sl if acc is None else acc + sl
    return acc * (1.0 / (kh * kw))


def gd_avg_pooling(err, x_shape, ksize, stride=None, padding=0):
    """The reference's ``xla_gd_avg_pooling``."""
    (kh, kw), (sh, sw), (ph, pw) = norm2(ksize), \
        norm2(stride or ksize), norm2(padding)
    b, h, w, c = x_shape
    _, oh, ow, _ = err.shape
    scaled = err * (1.0 / (kh * kw))
    dx = torch.zeros((b, h + 2 * ph, w + 2 * pw, c), dtype=torch.float32,
                     device=err.device)
    for _, i, j in _taps(kh, kw):
        dx[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :] += scaled
    return dx[:, ph:ph + h, pw:pw + w, :].contiguous()


# -- kernels ----------------------------------------------------------------
_ARGTYPES = {
    # x, y, offsets, B, H, W, C, kh, kw, sh, sw, ph, pw, use_abs, stream
    "znicz_pool_select_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
    # err, offsets, dx, B, H, W, C, OH, OW, kh, kw, sh, sw, ph, pw, stream
    "znicz_pool_scatter_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
    + [ctypes.c_void_p],
}


def _launch(name: str, device, *args) -> None:
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("pooling", name, _ARGTYPES[name]),
                      device, *args)


def _geometry(who, x_shape, ksize, stride, padding):
    """((kh, kw), (sh, sw), (ph, pw), (OH, OW)) after checking that the
    window fits the kernels' int arguments."""
    (kh, kw), (ph, pw) = norm2(ksize), norm2(padding)
    (sh, sw) = norm2(stride or ksize)
    if min(kh, kw, sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"{who}: bad window ksize={ksize} stride={stride} "
                         f"padding={padding}")
    _, oh, ow, _ = pool_out_shape(x_shape, (kh, kw), (sh, sw), (ph, pw))
    if oh < 1 or ow < 1:
        raise ValueError(f"{who}: window {ksize} with padding {padding} "
                         f"does not fit input {tuple(x_shape)}")
    b, h, w, c = x_shape
    if max(b * h * w * c, b * oh * ow * c) >= 2 ** 31:
        raise ValueError(f"{who}: {tuple(x_shape)} has 2^31 elements or "
                         f"more (the kernels index in int32)")
    return (kh, kw), (sh, sw), (ph, pw), (oh, ow)


def _check(who: str, name: str, t: torch.Tensor, dtype, device=None,
           shape=None) -> None:
    """Refuse what the kernels do not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{who}: {name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{who}: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or t.numel() == 0:
        raise ValueError(f"{who}: {name} must be a non-empty NHWC tensor, "
                         f"got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _select(who, x, ksize, stride, padding, use_abs: bool):
    global pool_select_launches
    _check(who, "x", x, torch.float32)
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = _geometry(
        who, x.shape, ksize, stride, padding)
    if x.device.type == "cpu":
        return _max_pool(x, (kh, kw), (sh, sw), (ph, pw), use_abs)
    b, h, w, c = x.shape
    y = torch.empty((b, oh, ow, c), dtype=torch.float32, device=x.device)
    off = torch.empty((b, oh, ow, c), dtype=torch.int32, device=x.device)
    _launch("znicz_pool_select_f32", x.device, x.data_ptr(), y.data_ptr(),
            off.data_ptr(), b, h, w, c, kh, kw, sh, sw, ph, pw, int(use_abs))
    pool_select_launches += 1
    return y, off


def max_pooling(x, ksize, stride=None, padding=0):
    """(y, offsets) of max pooling over NHWC float32 ``x``: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    return _select("max_pooling", x, ksize, stride, padding, False)


def maxabs_pooling(x, ksize, stride=None, padding=0):
    """(y, offsets) of max-|x| pooling; y keeps the winner's sign."""
    return _select("maxabs_pooling", x, ksize, stride, padding, True)


def gd_max_pooling(err, offsets, x_shape, ksize, stride=None, padding=0):
    """dx of max pooling: each window's err added at its winner slot.  On
    the card one kernel gathers, for every dx element, the windows that
    contain it in the reference's order; no atomics, no memset."""
    global pool_scatter_launches
    who = "gd_max_pooling"
    _check(who, "err", err, torch.float32)
    x_shape = tuple(int(s) for s in x_shape)
    (kh, kw), (sh, sw), (ph, pw), (oh, ow) = _geometry(
        who, x_shape, ksize, stride, padding)
    b, h, w, c = x_shape
    if tuple(err.shape) != (b, oh, ow, c):
        raise ValueError(f"{who}: err must be {(b, oh, ow, c)}, got "
                         f"{tuple(err.shape)}")
    _check(who, "offsets", offsets, torch.int32, err.device, err.shape)
    if err.device.type == "cpu":
        return plain_gd_max_pooling(err, offsets, x_shape, (kh, kw),
                                    (sh, sw), (ph, pw))
    dx = torch.empty(x_shape, dtype=torch.float32, device=err.device)
    _launch("znicz_pool_scatter_f32", err.device, err.data_ptr(),
            offsets.data_ptr(), dx.data_ptr(), b, h, w, c, oh, ow, kh, kw,
            sh, sw, ph, pw)
    pool_scatter_launches += 1
    return dx
