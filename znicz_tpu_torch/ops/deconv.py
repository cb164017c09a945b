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

The reference leaves these to XLA outside any Pallas kernel by default,
so the port leaves them to ``ops/conv.py``: cuDNN on the card, TF32 off.
The ``np_*`` functions are the numpy goldens the numpy device runs.  The
Pallas tier (``pallas_deconv2d*``) waits with the conv tiers (ROADMAP.md
queue 2)."""

from __future__ import annotations

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


def deconv2d(x, w, stride=1, padding=0):
    """x (B,OH,OW,C_in), w (KH,KW,C_out,C_in) → (B,H,W,C_out) float32."""
    out_shape = deconv_out_shape(x.shape, w.shape, stride, padding)
    return conv_ops.conv2d_grad_input(x, w, out_shape, stride, padding)


def deconv2d_grad_input(err, w, stride=1, padding=0):
    """err (B,H,W,C_out) → (B,OH,OW,C_in): the conv forward."""
    return conv_ops.conv2d(err, w, stride, padding, out_dtype=err.dtype)


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
