"""Transposed convolution (deconv) on NHWC/HWIO tensors (port of
``znicz_tpu/ops/deconv.py``).

Deconv is the adjoint of conv, so each op is one conv op with roles
swapped, as in the reference:

* forward ``deconv2d(x, w)`` = the conv's input gradient;
* input gradient ``∂L/∂x`` = the conv forward;
* weight gradient ``∂L/∂w`` = the conv's weight gradient with the error
  in the input's role and the deconv input in the error's role.

Weights keep the paired conv's HWIO layout ``(KH, KW, C_out, C_in)``
(``C_in``, the deconv's input channels, is the conv's ``n_kernels``), so a
deconv tied to an encoder conv shares its weight tensor with no
transpose.  The output extent is the least one with no remainder,
``H = stride·(OH − 1) + K − 2·pad``.

Each op goes through ``ops/conv.py``, so it takes the conv's tier: cuDNN
on the card by default (TF32 off), as the reference's XLA default; with
``ZNICZ_TPU_CONV=pallas`` the implicit-GEMM kernels, as the reference's
``pallas_deconv2d*``: the forward runs ``conv_dgrad``, the input gradient
``conv_fwd`` and the weight gradient ``conv_wgrad`` (their plain versions
on CPU tensors).  No deconv kernel of its own is needed.  Dtypes follow
the reference's tiers: the forward returns ``out_dtype`` or x's dtype,
both gradients float32.  The ``np_*`` functions are the numpy goldens
the numpy device runs."""

from __future__ import annotations

import torch

from . import conv as conv_ops
from .geometry import norm2


def deconv_out_size(size: int, k: int, stride: int, pad: int) -> int:
    """The least input extent whose conv output is ``size``."""
    return stride * (size - 1) + k - 2 * pad


def deconv_out_shape(x_shape, w_shape, stride=1, padding=0
                     ) -> tuple[int, int, int, int]:
    """x (B, OH, OW, C_in), w (KH, KW, C_out, C_in) → (B, H, W, C_out)."""
    b, oh, ow, cin = x_shape
    kh, kw, cout, cin_w = w_shape
    if cin != cin_w:
        raise ValueError(f"deconv channel mismatch: input has {cin}, "
                         f"weights expect {cin_w}")
    (sh, sw), (ph, pw) = norm2(stride), norm2(padding)
    return (b, deconv_out_size(oh, kh, sh, ph),
            deconv_out_size(ow, kw, sw, pw), cout)


def deconv2d(x, w, stride=1, padding=0, out_dtype=None):
    """x (B,OH,OW,C_in), w (KH,KW,C_out,C_in) → (B,H,W,C_out) in
    ``out_dtype`` or x's dtype."""
    out_shape = deconv_out_shape(x.shape, w.shape, stride, padding)
    y = conv_ops.conv2d_grad_input(x, w, out_shape, stride, padding)
    return y.to(out_dtype or x.dtype)


def deconv2d_grad_input(err, w, stride=1, padding=0):
    """err (B,H,W,C_out) → (B,OH,OW,C_in) float32: the conv forward."""
    return conv_ops.conv2d(err, w, stride, padding, out_dtype=torch.float32)


def deconv2d_grad_weights(err, x, w_shape, stride=1, padding=0):
    """∂L/∂w (KH,KW,C_out,C_in), err in the conv input's role."""
    return conv_ops.conv2d_grad_weights(err, x, w_shape, stride, padding)


def np_deconv2d(x, w, stride=1, padding=0):
    out_shape = deconv_out_shape(x.shape, w.shape, stride, padding)
    return conv_ops.np_conv2d_grad_input(x, w, out_shape, stride, padding)


def np_deconv2d_grad_input(err, w, stride=1, padding=0):
    return conv_ops.np_conv2d(err, w, stride, padding)


def np_deconv2d_grad_weights(err, x, w_shape, stride=1, padding=0):
    return conv_ops.np_conv2d_grad_weights(err, x, w_shape, stride, padding)
