"""2-D convolution and its hand-split gradients on NHWC/HWIO tensors (port
of ``znicz_tpu/ops/conv.py``), in two tiers, chosen as the reference
chooses them: ``ZNICZ_TPU_CONV=pallas`` (read on every call, so one
command line routes both packages the same way) selects the
implicit-GEMM tier, anything else the default tier.

* Default tier (the reference's XLA tier): PyTorch's convolution, cuDNN
  on the card and the CPU convolution on the host.  x is a zero-copy NCHW
  view with channels_last strides and W an OIHW view, the layout cuDNN
  takes without a transpose.
* Implicit-GEMM tier (the reference's Pallas tier, ``pallas_conv2d*``):
  on CUDA tensors the hand-written kernels of ``csrc/conv_gemm.cu``
  (``conv_fwd``, ``conv_dgrad`` and ``conv_wgrad``, on the tensor cores
  in the 3xTF32 split, which keeps float32 accuracy; the weight gradient
  splits its depth and sums the splits in a fixed order), which gather
  patches while they load a tile, so the patch matrix never exists; on
  CPU tensors their plain versions (``plain_conv2d*_gemm``), which
  transcribe the reference's tier: patches by pad + unfold, err's interior
  dilation by strided assignment into zeros, the products as
  ``torch.matmul``.
  A CUDA tensor never reaches cuDNN on this tier, and a kernel that does
  not build or launch raises.

Activations stay NHWC and weights HWIO at every public function.
Operands are computed in float32 whatever their dtype (the reference's
``preferred_element_type=float32``); TF32 stays off for PyTorch's own
calls (``znicz_tpu_torch/__init__.py``).  ``tf32_rn`` and
``matmul_3xtf32`` model the tensor-core kernels' arithmetic for the
tests; no path calls them.  The ``np_*`` functions are the
reference's numpy goldens (explicit im2col/col2im), which the numpy
device runs.

Two more forms run on the default tier whichever tier is chosen (the
reference computes them in XLA, never in Pallas):

* ``ZNICZ_TPU_CONV1=s2d`` (``tuning.conv_s2d``) routes a tiny-C strided
  conv's forward and weight gradient (``s2d_applicable``: AlexNet's conv1)
  through space-to-depth, ``conv2d_s2d``/``conv2d_grad_weights_s2d``: the
  stride folds into the channel axis, a stride-1 conv over s²·C channels
  against a kernel with structurally zero taps.
* The column-parity convs of the ``fused2`` routing, ``conv2d_split`` and
  its gradients: the even and odd output columns of a stride-(sh, sw) conv
  are each a conv of stride (sh, 2·sw) whose input starts ``p·sw`` columns
  later (a negative pad is a crop), so a conv feeding the fused LRN→pool
  pair emits the pair's halves directly; the gradients sum the two halves'
  convs, even then odd, and never build the interleaved tensor."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import count_launch, tuning
from .geometry import norm2, out_size
from .matmul import (TC_WIDTHS, _tc_width, launch_split, plain_matmul_at_b,
                     tc_split_plan)

#: Launches of the implicit-GEMM kernels in this process; the CUDA branch
#: of each wrapper adds one per launch, nowhere else.
conv_fwd_launches = 0
conv_dgrad_launches = 0
conv_wgrad_launches = 0

#: x (or err), w, out, then B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
#: pw, the tensor-core tile choice (``TcConfig``: bn, vec_a, vec_b,
#: unit_stride) and the stream
_CONV_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 17
                  + [ctypes.c_void_p])
#: the weight gradient: x, err, dw, its workspace, the 13 ints of the
#: shape, its tile choice (``WgradPlan``: bn, vec_a, vec_b, splits, chunk)
#: and the stream
_WGRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 18
                   + [ctypes.c_void_p])
_INT32 = 2 ** 31
_MAX_GRID_Y = 65535


class TcConfig(NamedTuple):
    """The tensor-core kernels' launch choice: the C tile's width, the
    floats a copy of A and of B moves (4 or 1) and 1 where the input
    gradient's stride is 1 (its taps then need no exactness test)."""
    bn: int
    vec_a: int
    vec_b: int
    unit_stride: int


def _tc_config(kind: str, n: int, gathered: int, stride=1,
               aligned: bool = True) -> TcConfig:
    """The tile choice of ``conv_fwd`` (``kind="fwd"``: N = OC, gathered
    axis C) or ``conv_dgrad`` (``"dgrad"``: N = C, gathered axis OC): the
    width ``_tc_width(n)``; a copy moves 16 bytes (4 floats) where the
    axis it runs along is a multiple of 4 and the operands are 16-byte
    ``aligned``: A and the input gradient's w along the gathered axis, the
    forward's w along N."""
    bn = _tc_width(n)
    vec_a = 4 if aligned and gathered % 4 == 0 else 1
    if kind == "fwd":
        return TcConfig(bn, vec_a, 4 if aligned and n % 4 == 0 else 1, 0)
    if kind == "dgrad":
        return TcConfig(bn, vec_a, vec_a, int(norm2(stride) == (1, 1)))
    raise ValueError(f"_tc_config: kind {kind!r} is not 'fwd' or 'dgrad'")


class WgradPlan(NamedTuple):
    """``conv_wgrad``'s launch choice: the C tile's width (N = OC), the
    floats a copy moves along x's C and along err's OC (4 or 1), and the
    split of the depth, the B·OH·OW output pixels (splits, chunk)."""
    bn: int
    vec_a: int
    vec_b: int
    splits: int
    chunk: int


def wgrad_plan(c: int, oc: int, k_total: int, pixels: int,
               aligned: bool = True) -> WgradPlan:
    """The weight gradient's launch for x with C channels, OC outputs, the
    patch length ``k_total`` (KH·KW·C, C's rows) and ``pixels`` (the
    depth): width ``_tc_width(oc)``, 16-byte copies along an axis that is
    a multiple of 4 on ``aligned`` operands, and the depth split
    ``tc_split_plan``."""
    bn = _tc_width(oc)
    return WgradPlan(bn, 4 if aligned and c % 4 == 0 else 1,
                     4 if aligned and oc % 4 == 0 else 1,
                     *tc_split_plan(pixels, k_total, oc, bn))


def gemm_tier() -> bool:
    """Whether ``ZNICZ_TPU_CONV=pallas`` routes the conv family to the
    implicit-GEMM tier (``tuning.force_pallas_conv``); read on every
    call."""
    return tuning.force_pallas_conv()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv2d(x, w, stride=1, padding=0, out_dtype=None):
    """x (B,H,W,C), w (KH,KW,C,OC) → (B,OH,OW,OC), contiguous NHWC, in
    ``out_dtype`` or x's dtype."""
    x32, w32 = x.float(), w.float()
    if gemm_tier():
        y = conv2d_gemm(x32.contiguous(), w32.contiguous(), stride, padding)
    elif tuning.conv_s2d() and s2d_applicable(w.shape, stride, padding):
        y = conv2d_s2d(x32, w32, stride, padding)
    else:
        y = _nhwc(F.conv2d(_nchw(x32), _oihw(w32), stride=norm2(stride),
                           padding=norm2(padding)))
    return y.to(out_dtype or x.dtype)


def _backward(err, x, w, stride, padding, mask):
    return torch.ops.aten.convolution_backward(
        _nchw(err.float()), _nchw(x), _oihw(w), None, list(norm2(stride)),
        list(norm2(padding)), [1, 1], False, [0, 0], 1, mask)


def conv2d_grad_input(err, w, x_shape, stride=1, padding=0):
    """dx (B,H,W,C) float32 from err (B,OH,OW,OC) and w (KH,KW,C,OC)."""
    if gemm_tier():
        return conv2d_grad_input_gemm(err.float().contiguous(),
                                      w.float().contiguous(), x_shape,
                                      stride, padding)
    # convolution_backward reads only the shape and layout of its input
    # when the weight gradient is not asked for
    x = torch.empty(tuple(x_shape), dtype=torch.float32, device=err.device)
    dx = _backward(err, x, w.float(), stride, padding,
                   (True, False, False))[0]
    return _nhwc(dx)


def conv2d_grad_weights(x, err, w_shape, stride=1, padding=0):
    """dW (KH,KW,C,OC) float32 = Σ over batch and positions of x patches
    times err."""
    if gemm_tier():
        return conv2d_grad_weights_gemm(x.float().contiguous(),
                                        err.float().contiguous(), w_shape,
                                        stride, padding)
    if tuning.conv_s2d() and s2d_applicable(w_shape, stride, padding):
        return conv2d_grad_weights_s2d(x, err, w_shape, stride, padding)
    return _grad_weights(x, err, w_shape, stride, padding)


def _grad_weights(x, err, w_shape, stride, padding):
    """The default tier's weight gradient (cuDNN on the card)."""
    kh, kw, c, oc = w_shape
    w = torch.empty((kh, kw, c, oc), dtype=torch.float32, device=err.device)
    dw = _backward(err, x.float(), w, stride, padding,
                   (False, True, False))[1]
    return dw.permute(2, 3, 1, 0).contiguous()


# -- space-to-depth (ZNICZ_TPU_CONV1=s2d) ------------------------------------
def s2d_applicable(w_shape, stride, padding) -> bool:
    """Whether a conv takes the space-to-depth route: tiny C (at most 8)
    and a real stride, equal in both axes (the reference's test)."""
    (sh, sw) = norm2(stride)
    return sh == sw and sh >= 2 and int(w_shape[2]) <= 8


def _s2d_input(x, s: int, rows: int, cols: int):
    """(B, H, W, C) → (B, rows, cols, s²C) phase stack, zero-padded (or
    trimmed: trailing rows no window reaches) to rows·s × cols·s first."""
    b, h, w, c = x.shape
    hp, wp = rows * s, cols * s
    x = x[:, :min(h, hp), :min(w, wp)]
    if (hp, wp) != tuple(x.shape[1:3]):
        x = F.pad(x, (0, 0, 0, wp - x.shape[2], 0, hp - x.shape[1]))
    x = x.reshape(b, rows, s, cols, s, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, rows, cols, s * s * c)


def _s2d_kernel(w, s: int):
    """(KH, KW, C, F) → (⌈KH/s⌉, ⌈KW/s⌉, s²C, F); the taps past the true
    support are zeros."""
    kh, kw, c, f = w.shape
    khp, kwp = -(-kh // s), -(-kw // s)
    wz = w.new_zeros((khp * s, kwp * s, c, f))
    wz[:kh, :kw] = w
    wz = wz.reshape(khp, s, kwp, s, c, f).permute(0, 2, 1, 3, 4, 5)
    return wz.reshape(khp, kwp, s * s * c, f)


def _s2d_stack(x, w_shape, stride, padding):
    """(phase stack of the padded x, s, ⌈KH/s⌉, ⌈KW/s⌉)."""
    kh, kw = int(w_shape[0]), int(w_shape[1])
    (s, _), (ph, pw) = norm2(stride), norm2(padding)
    if (ph, pw) != (0, 0):
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    _, h, w_in, _ = x.shape
    oh, ow = out_size(h, kh, s, 0), out_size(w_in, kw, s, 0)
    khp, kwp = -(-kh // s), -(-kw // s)
    return _s2d_input(x, s, oh + khp - 1, ow + kwp - 1), s, khp, kwp


def conv2d_s2d(x, w, stride=1, padding=0, out_dtype=None):
    """``conv2d`` by space-to-depth (the reference's ``xla_conv2d_s2d``):
    the same function, another order of the sums (close, not bit-equal)."""
    xs, s, _, _ = _s2d_stack(x.float(), w.shape, stride, padding)
    y = _nhwc(F.conv2d(_nchw(xs), _oihw(_s2d_kernel(w.float(), s))))
    return y.to(out_dtype or x.dtype)


def conv2d_grad_weights_s2d(x, err, w_shape, stride=1, padding=0):
    """dW through the same phase algebra (the reference's
    ``xla_conv2d_grad_weights_s2d``): the gradient of the s²C kernel,
    rearranged to (KH, KW, C, F), the zero taps' gradients dropped."""
    kh, kw, c, f = (int(v) for v in w_shape)
    xs, s, khp, kwp = _s2d_stack(x.float(), w_shape, stride, padding)
    dwp = _grad_weights(xs, err, (khp, kwp, s * s * c, f), 1, 0)
    dwp = dwp.reshape(khp, kwp, s, s, c, f).permute(0, 2, 1, 3, 4, 5)
    return dwp.reshape(khp * s, kwp * s, c, f)[:kh, :kw].contiguous()


# -- the column-parity convs (the fused2 routing) ----------------------------
def _window(x, top: int, bottom: int, left: int, right: int):
    """NHWC ``x`` padded with zeros by each positive amount and cropped by
    each negative one (``F.conv2d`` takes no negative padding)."""
    h, w = x.shape[1], x.shape[2]
    x = x[:, max(0, -top):h - max(0, -bottom),
          max(0, -left):w - max(0, -right)]
    if max(top, bottom, left, right) > 0:
        x = F.pad(x, (0, 0, max(left, 0), max(right, 0), max(top, 0),
                      max(bottom, 0)))
    return x


def _unwindow(g, top: int, bottom: int, left: int, right: int):
    """The adjoint of ``_window``: the gradient of the windowed input
    brought back onto the input (its padding cropped, its crops zeros)."""
    h, w = g.shape[1], g.shape[2]
    g = g[:, max(0, top):h - max(0, bottom), max(0, left):w - max(0, right)]
    if min(top, bottom, left, right) < 0:
        g = F.pad(g, (0, 0, max(-left, 0), max(-right, 0), max(-top, 0),
                      max(-bottom, 0)))
    return g


def _half_pads(p: int, width: int, w_in: int, kw: int, sw: int, pw: int):
    """(left, right) padding of the input for parity half ``p`` of
    ``width`` output columns: the half is the conv of column stride 2·sw
    over x shifted by p·sw columns; either side may be negative (a crop;
    AlexNet's conv1 odd half: −4 and −4)."""
    left = pw - p * sw
    return left, (width - 1) * 2 * sw + kw - w_in - left


def conv2d_split(x, w, stride=1, padding=0, out_dtype=None):
    """(y_even, y_odd): the column-parity halves of ``conv2d`` (the
    reference's ``xla_conv2d_split``), each its own conv of stride
    (sh, 2·sw); a half of width 0 (an output one column wide) comes out
    empty."""
    kh, kw, _, oc = w.shape
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    b, h_in, w_in, _ = x.shape
    oh, ow = out_size(h_in, kh, sh, ph), out_size(w_in, kw, sw, pw)
    x32, w32 = x.float(), _oihw(w.float())
    halves = []
    for p, width in ((0, -(-ow // 2)), (1, ow // 2)):
        if width == 0:
            halves.append(x.new_zeros((b, oh, 0, oc),
                                      dtype=out_dtype or x.dtype))
            continue
        left, right = _half_pads(p, width, w_in, kw, sw, pw)
        xp = _window(x32, ph, ph, left, right)
        y = _nhwc(F.conv2d(_nchw(xp), w32, stride=(sh, 2 * sw)))
        halves.append(y.to(out_dtype or x.dtype))
    return halves[0], halves[1]


def conv2d_grad_weights_split(x, err_e, err_o, w_shape, stride=1,
                              padding=0):
    """dW float32 from the output error's parity halves (the reference's
    ``xla_conv2d_grad_weights_split``): the even half's gradient plus the
    odd half's."""
    kw = int(w_shape[1])
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    w_in = x.shape[2]
    x32 = x.float()
    dw = None
    for p, err in ((0, err_e), (1, err_o)):
        if err.shape[2] == 0:
            continue
        left, right = _half_pads(p, err.shape[2], w_in, kw, sw, pw)
        g = _grad_weights(_window(x32, ph, ph, left, right), err, w_shape,
                          (sh, 2 * sw), 0)
        dw = g if dw is None else dw + g
    return dw


def conv2d_grad_input_split(err_e, err_o, w, x_shape, stride=1, padding=0):
    """dx float32 from the output error's parity halves (the reference's
    ``xla_conv2d_grad_input_split``): each half's transposed conv on its
    windowed input, brought back onto x's columns, even plus odd."""
    kw = int(w.shape[1])
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    b, h, w_in, c = (int(v) for v in x_shape)
    w32 = w.float()
    dx = None
    for p, err in ((0, err_e), (1, err_o)):
        if err.shape[2] == 0:
            continue
        left, right = _half_pads(p, err.shape[2], w_in, kw, sw, pw)
        xp = torch.empty((b, h + 2 * ph, w_in + left + right, c),
                         dtype=torch.float32, device=err.device)
        g = _backward(err, xp, w32, (sh, 2 * sw), 0, (True, False, False))[0]
        g = _unwindow(_nhwc(g), ph, ph, left, right)
        dx = g if dx is None else dx + g
    return dx.contiguous()


# -- the implicit-GEMM tier: plain versions --------------------------------
def _patches(xp: torch.Tensor, ksize, stride) -> torch.Tensor:
    """(B·OH·OW, C·KH·KW) patch matrix of an already padded NCHW ``xp``,
    the reference's (C, KH, KW) feature order
    (``lax.conv_general_dilated_patches``)."""
    cols = F.unfold(xp, ksize, stride=stride)        # (B, C·KH·KW, L)
    return cols.transpose(1, 2).reshape(-1, cols.shape[1])


def plain_conv2d_gemm(x, w, stride=1, padding=0):
    """The reference's ``pallas_conv2d`` in PyTorch: patches of the
    zero-padded x times w reordered to (C, KH, KW, OC); float32."""
    kh, kw, c, oc = w.shape
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    b, h, wd, _ = x.shape
    cols = _patches(F.pad(_nchw(x), (pw, pw, ph, ph)), (kh, kw), (sh, sw))
    y = torch.matmul(cols, w.permute(2, 0, 1, 3).reshape(-1, oc))
    return y.reshape(b, out_size(h, kh, sh, ph), out_size(wd, kw, sw, pw), oc)


def plain_conv2d_grad_input_gemm(err, w, x_shape, stride=1, padding=0):
    """The reference's ``pallas_conv2d_grad_input`` in PyTorch: err dilated
    by the stride (strided assignment into zeros) and edge-padded (a
    negative pad crops), its stride-1 patches times the spatially flipped,
    IO-swapped kernel; float32."""
    kh, kw, c, oc = w.shape
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    b, h, wd, _ = x_shape
    _, oh, ow, _ = err.shape
    ed = err.new_zeros((b, (oh - 1) * sh + 1, (ow - 1) * sw + 1, oc))
    ed[:, ::sh, ::sw] = err
    lo_h, lo_w = kh - 1 - ph, kw - 1 - pw
    hi_h = h + ph - ((oh - 1) * sh + 1)
    hi_w = wd + pw - ((ow - 1) * sw + 1)
    cols = _patches(F.pad(_nchw(ed), (lo_w, hi_w, lo_h, hi_h)), (kh, kw),
                    (1, 1))
    w_flip = w.flip(0, 1).permute(0, 1, 3, 2)       # (KH, KW, OC, C)
    dx = torch.matmul(cols, w_flip.permute(2, 0, 1, 3).reshape(-1, c))
    return dx.reshape(b, h, wd, c)


def plain_conv2d_grad_weights_gemm(x, err, w_shape, stride=1, padding=0):
    """The reference's ``pallas_conv2d_grad_weights`` in PyTorch:
    patchesᵀ·err (``plain_matmul_at_b``), reordered from (C, KH, KW, OC)
    to HWIO; float32."""
    kh, kw, c, oc = w_shape
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    cols = _patches(F.pad(_nchw(x), (pw, pw, ph, ph)), (kh, kw), (sh, sw))
    dw = plain_matmul_at_b(cols, err.reshape(-1, oc))
    return dw.reshape(c, kh, kw, oc).permute(1, 2, 0, 3).contiguous()


# -- the tensor-core kernels' arithmetic, emulated (tests only) ------------
def tf32_rn(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 mantissa bits, ties away from zero (half the
    weight of the 13 dropped bits added to the magnitude's bit pattern,
    then those bits cleared); infinities and NaNs pass through."""
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, R) · b (R, N) in float32 as ``conv_fwd``/``conv_dgrad``
    multiply (``csrc/gemm_tc.cuh`` ``split_tf32``): each operand split as
    big = tf32_rn(v), small = tf32_rn(v − big), and the three products
    small·big + big·small + big·big summed in float32; small·small is
    dropped."""
    a_big, b_big = tf32_rn(a), tf32_rn(b)
    a_small, b_small = tf32_rn(a - a_big), tf32_rn(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


# -- the implicit-GEMM tier: wrappers ---------------------------------------
def _gemm_geometry(name: str, x_shape, w_shape, stride, padding,
                   err_shape=None, kind: str = "wgrad") -> tuple:
    """(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph, pw) of a conv, checked:
    matching channels, a non-empty window that fits, ``err_shape`` (if
    given) equal to the conv's output, and x, w and the output within the
    kernels' int32 indices and within the grid of ``kind``'s kernel
    ("fwd", "dgrad" or "wgrad"), whose y axis runs over N's tiles of
    width ``_tc_width(N)``."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        raise ValueError(f"{name}: x {tuple(x_shape)} and w "
                         f"{tuple(w_shape)} must be NHWC and HWIO")
    b, h, wd, c = (int(v) for v in x_shape)
    kh, kw, c_w, oc = (int(v) for v in w_shape)
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    if c != c_w:
        raise ValueError(f"{name}: x has {c} channels, w expects {c_w}")
    if min(kh, kw, sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"{name}: window {kh}x{kw}, stride {sh}x{sw}, "
                         f"padding {ph}x{pw}")
    oh, ow = out_size(h, kh, sh, ph), out_size(wd, kw, sw, pw)
    if oh < 1 or ow < 1:
        raise ValueError(f"{name}: a {kh}x{kw} window does not fit "
                         f"{h}x{wd} padded by {ph}x{pw}")
    if err_shape is not None and tuple(err_shape) != (b, oh, ow, oc):
        raise ValueError(f"{name}: err {tuple(err_shape)} is not the conv "
                         f"output {(b, oh, ow, oc)}")
    if max(b * h * wd * c, kh * kw * c * oc, b * oh * ow * oc) >= _INT32:
        raise ValueError(f"{name}: a tensor exceeds int32 indexing")
    n = c if kind == "dgrad" else oc
    tile = _tc_width(n)
    if -(-n // tile) > _MAX_GRID_Y:
        raise ValueError(f"{name}: {n} channels exceed the kernel's grid "
                         f"({_MAX_GRID_Y} tiles of {tile})")
    return b, h, wd, c, kh, kw, oc, oh, ow, sh, sw, ph, pw


def _check_gemm(name: str, *tensors: torch.Tensor) -> None:
    """Refuse what the kernels do not take (the CPU branch is held to the
    same contract): one device, contiguous float32."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"{name}: operands on "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: operands must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous NHWC/HWIO")


def _launch_conv(entry: str, kind: str, a, b, out, geo) -> None:
    """One of the tensor-core kernels (``kind`` "fwd" or "dgrad"):
    ``out`` (its rows, N = its channels) from operands ``a`` and ``b``,
    with the tile choice of ``_tc_config``."""
    from .. import cuda_build
    c, oc, stride = geo[3], geo[6], geo[9:11]
    n, gathered = (oc, c) if kind == "fwd" else (c, oc)
    cfg = _tc_config(kind, n, gathered, stride,
                     all(t.data_ptr() % 16 == 0 for t in (a, b)))
    cuda_build.launch(cuda_build.kernel("conv_gemm", entry, _CONV_ARGTYPES),
                      out.device, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), *geo, *cfg)


def conv2d_gemm(x, w, stride=1, padding=0):
    """The implicit-GEMM forward: (B,OH,OW,OC) float32 of contiguous
    float32 x (B,H,W,C) and w (KH,KW,C,OC); the ``conv_fwd`` kernel for
    CUDA tensors, ``plain_conv2d_gemm`` for CPU tensors."""
    geo = _gemm_geometry("conv2d_gemm", x.shape, w.shape, stride, padding,
                         kind="fwd")
    _check_gemm("conv2d_gemm", x, w)
    if x.device.type == "cpu":
        return plain_conv2d_gemm(x, w, stride, padding)
    b, _, _, _, _, _, oc, oh, ow = geo[:9]
    y = torch.empty((b, oh, ow, oc), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    _launch_conv("znicz_conv_fwd_f32", "fwd", x, w, y, geo)
    count_launch(__name__, "conv_fwd_launches")
    return y


def conv2d_grad_input_gemm(err, w, x_shape, stride=1, padding=0):
    """The implicit-GEMM input gradient (a transposed conv): dx (B,H,W,C)
    float32 of contiguous float32 err (B,OH,OW,OC) and w; the
    ``conv_dgrad`` kernel for CUDA tensors,
    ``plain_conv2d_grad_input_gemm`` for CPU tensors."""
    geo = _gemm_geometry("conv2d_grad_input_gemm", x_shape, w.shape, stride,
                         padding, err.shape, kind="dgrad")
    _check_gemm("conv2d_grad_input_gemm", err, w)
    if err.device.type == "cpu":
        return plain_conv2d_grad_input_gemm(err, w, x_shape, stride, padding)
    dx = torch.empty(tuple(geo[:4]), dtype=torch.float32, device=err.device)
    if dx.numel() == 0:
        return dx
    _launch_conv("znicz_conv_dgrad_f32", "dgrad", err, w, dx, geo)
    count_launch(__name__, "conv_dgrad_launches")
    return dx


def conv2d_grad_weights_gemm(x, err, w_shape, stride=1, padding=0):
    """The implicit-GEMM weight gradient: dW (KH,KW,C,OC) float32 of
    contiguous float32 x and err, summed over batch and positions in a
    fixed order; the ``conv_wgrad`` kernel for CUDA tensors,
    ``plain_conv2d_grad_weights_gemm`` for CPU tensors."""
    geo = _gemm_geometry("conv2d_grad_weights_gemm", x.shape, w_shape,
                         stride, padding, err.shape)
    _check_gemm("conv2d_grad_weights_gemm", x, err)
    if x.device.type == "cpu":
        return plain_conv2d_grad_weights_gemm(x, err, w_shape, stride,
                                              padding)
    b, _, _, c, kh, kw, oc, oh, ow = geo[:9]
    dw = torch.empty((kh, kw, c, oc), dtype=torch.float32, device=x.device)
    if dw.numel() == 0:
        return dw
    if err.numel() == 0:
        return dw.zero_()
    launch_wgrad(x, err, dw, geo, wgrad_plan(
        c, oc, kh * kw * c, b * oh * ow,
        x.data_ptr() % 16 == 0 and err.data_ptr() % 16 == 0))
    count_launch(__name__, "conv_wgrad_launches")
    return dw


def launch_wgrad(x, err, dw, geo, plan: WgradPlan) -> None:
    """``conv_wgrad`` into ``dw`` by ``plan`` (the workspace allocated here
    when it splits the depth), without counting a launch: the CUDA branch
    of ``conv2d_grad_weights_gemm``, and what a measurement that sets its
    own plan calls."""
    b, c, kh, kw, oc, oh, ow = (geo[i] for i in (0, 3, 4, 5, 6, 7, 8))
    launch_split("conv_gemm", "znicz_conv_wgrad_f32", _WGRAD_ARGTYPES, x,
                 err, dw, kh * kw * c, oc, (*geo, *plan[:3]), plan[3:])


# -- numpy goldens (the numpy device) ---------------------------------------
def np_im2col(x: np.ndarray, ksize, stride, padding) -> np.ndarray:
    """(B, OH, OW, KH·KW·C) patches of NHWC ``x``, zero padded."""
    b, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = ksize, stride, padding
    xp = np.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    oh, ow = out_size(h, kh, sh, ph), out_size(w, kw, sw, pw)
    st = xp.strides
    cols = np.lib.stride_tricks.as_strided(
        xp, (b, oh, ow, kh, kw, c),
        (st[0], st[1] * sh, st[2] * sw, st[1], st[2], st[3]))
    return np.ascontiguousarray(cols).reshape(b, oh, ow, kh * kw * c)


def np_conv2d(x: np.ndarray, w: np.ndarray, stride=1, padding=0
              ) -> np.ndarray:
    """x (B,H,W,C), w (KH,KW,C,OC) → (B,OH,OW,OC)."""
    kh, kw, c, oc = w.shape
    cols = np_im2col(x, (kh, kw), norm2(stride), norm2(padding))
    b, oh, ow, _ = cols.shape
    return (cols.reshape(-1, kh * kw * c) @ w.reshape(-1, oc)).reshape(
        b, oh, ow, oc)


def np_conv2d_grad_weights(x: np.ndarray, err: np.ndarray, w_shape,
                           stride=1, padding=0) -> np.ndarray:
    """dW = im2col(x)ᵀ · err."""
    kh, kw, c, oc = w_shape
    cols = np_im2col(x, (kh, kw), norm2(stride), norm2(padding))
    return (cols.reshape(-1, kh * kw * c).T @ err.reshape(-1, oc)).reshape(
        w_shape)


def np_conv2d_grad_input(err: np.ndarray, w: np.ndarray, x_shape,
                         stride=1, padding=0) -> np.ndarray:
    """col2im of err · Wᵀ onto the zero-padded input, then cropped."""
    kh, kw, c, oc = w.shape
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    b, h, w_in, _ = x_shape
    _, oh, ow, _ = err.shape
    cols = (err.reshape(-1, oc) @ w.reshape(-1, oc).T).reshape(
        b, oh, ow, kh, kw, c)
    dx = np.zeros((b, h + 2 * ph, w_in + 2 * pw, c), np.float32)
    for i in range(kh):
        for j in range(kw):
            dx[:, i:i + oh * sh:sh, j:j + ow * sw:sw, :] += cols[:, :, :, i,
                                                                 j, :]
    return dx[:, ph:ph + h, pw:pw + w_in, :]
