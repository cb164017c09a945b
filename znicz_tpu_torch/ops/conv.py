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
  (``conv_fwd``, ``conv_dgrad``, ``conv_wgrad``), which gather patches
  while they load a tile, so the patch matrix never exists; on CPU
  tensors their plain versions (``plain_conv2d*_gemm``), which transcribe
  the reference's tier: patches by pad + unfold, err's interior dilation
  by strided assignment into zeros, the products as ``torch.matmul``.
  A CUDA tensor never reaches cuDNN on this tier, and a kernel that does
  not build or launch raises.

Activations stay NHWC and weights HWIO at every public function.
Operands are computed in float32 whatever their dtype (the reference's
``preferred_element_type=float32``); TF32 stays off
(``znicz_tpu_torch/__init__.py``).  The ``np_*`` functions are the
reference's numpy goldens (explicit im2col/col2im), which the numpy
device runs.  The parity-split and space-to-depth forms are not ported
yet (ROADMAP.md queue 1 item 5b)."""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import norm2, out_size
from .matmul import launch_split, plain_matmul_at_b

#: Launches of the implicit-GEMM kernels in this process; the CUDA branch
#: of each wrapper adds one per launch, nowhere else.
conv_fwd_launches = 0
conv_dgrad_launches = 0
conv_wgrad_launches = 0

#: x (or err), w, out, then B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph,
#: pw, stream; the weight gradient adds its workspace after out and
#: (splits, chunk) before the stream
_CONV_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 13
                  + [ctypes.c_void_p])
_WGRAD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p])
_INT32 = 2 ** 31
_TILE = 64
_MAX_GRID_Y = 65535


def gemm_tier() -> bool:
    """Whether ``ZNICZ_TPU_CONV=pallas`` routes the conv family to the
    implicit-GEMM tier (the reference's ``tuning.force_pallas_conv()``);
    read on every call."""
    return os.environ.get("ZNICZ_TPU_CONV") == "pallas"


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
    kh, kw, c, oc = w_shape
    w = torch.empty((kh, kw, c, oc), dtype=torch.float32, device=err.device)
    dw = _backward(err, x.float(), w, stride, padding,
                   (False, True, False))[1]
    return dw.permute(2, 3, 1, 0).contiguous()


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


# -- the implicit-GEMM tier: wrappers ---------------------------------------
def _gemm_geometry(name: str, x_shape, w_shape, stride, padding,
                   err_shape=None) -> tuple:
    """(B, H, W, C, KH, KW, OC, OH, OW, sh, sw, ph, pw) of a conv, checked:
    matching channels, a non-empty window that fits, ``err_shape`` (if
    given) equal to the conv's output, and x, w and the output within the
    kernels' int32 indices and grid."""
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
    if -(-max(c, oc) // _TILE) > _MAX_GRID_Y:
        raise ValueError(f"{name}: {max(c, oc)} channels exceed the "
                         f"kernels' grid")
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


def _launch_conv(entry: str, a, b, out, geo) -> None:
    """One of the forward and input-gradient kernels: ``out`` (its rows,
    N = its channels) from operands ``a`` and ``b``."""
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("conv_gemm", entry, _CONV_ARGTYPES),
                      out.device, a.data_ptr(), b.data_ptr(),
                      out.data_ptr(), *geo)


def conv2d_gemm(x, w, stride=1, padding=0):
    """The implicit-GEMM forward: (B,OH,OW,OC) float32 of contiguous
    float32 x (B,H,W,C) and w (KH,KW,C,OC); the ``conv_fwd`` kernel for
    CUDA tensors, ``plain_conv2d_gemm`` for CPU tensors."""
    global conv_fwd_launches
    geo = _gemm_geometry("conv2d_gemm", x.shape, w.shape, stride, padding)
    _check_gemm("conv2d_gemm", x, w)
    if x.device.type == "cpu":
        return plain_conv2d_gemm(x, w, stride, padding)
    b, _, _, _, _, _, oc, oh, ow = geo[:9]
    y = torch.empty((b, oh, ow, oc), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    _launch_conv("znicz_conv_fwd_f32", x, w, y, geo)
    conv_fwd_launches += 1
    return y


def conv2d_grad_input_gemm(err, w, x_shape, stride=1, padding=0):
    """The implicit-GEMM input gradient (a transposed conv): dx (B,H,W,C)
    float32 of contiguous float32 err (B,OH,OW,OC) and w; the
    ``conv_dgrad`` kernel for CUDA tensors,
    ``plain_conv2d_grad_input_gemm`` for CPU tensors."""
    global conv_dgrad_launches
    geo = _gemm_geometry("conv2d_grad_input_gemm", x_shape, w.shape, stride,
                         padding, err.shape)
    _check_gemm("conv2d_grad_input_gemm", err, w)
    if err.device.type == "cpu":
        return plain_conv2d_grad_input_gemm(err, w, x_shape, stride, padding)
    dx = torch.empty(tuple(geo[:4]), dtype=torch.float32, device=err.device)
    if dx.numel() == 0:
        return dx
    _launch_conv("znicz_conv_dgrad_f32", err, w, dx, geo)
    conv_dgrad_launches += 1
    return dx


def conv2d_grad_weights_gemm(x, err, w_shape, stride=1, padding=0):
    """The implicit-GEMM weight gradient: dW (KH,KW,C,OC) float32 of
    contiguous float32 x and err, summed over batch and positions in a
    fixed order; the ``conv_wgrad`` kernel for CUDA tensors,
    ``plain_conv2d_grad_weights_gemm`` for CPU tensors."""
    global conv_wgrad_launches
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
    launch_split("conv_gemm", "znicz_conv_wgrad_f32", _WGRAD_ARGTYPES, x,
                 err, dw, kh * kw * c, oc, b * oh * ow, geo)
    conv_wgrad_launches += 1
    return dw


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
