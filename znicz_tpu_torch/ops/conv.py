"""2-D convolution and its hand-split gradients on NHWC/HWIO tensors (port
of the default tier of ``znicz_tpu/ops/conv.py``).

The reference leaves its convs to XLA outside any Pallas kernel
(``conv2d``/``conv2d_grad_*`` dispatch to ``xla_*`` unless
``ZNICZ_TPU_CONV=pallas``), so the port leaves them to PyTorch: cuDNN on
the card, the CPU convolution on the host.  Activations stay NHWC and
weights HWIO at every public function; inside, x is a zero-copy NCHW view
with channels_last strides and W an OIHW view, which is the layout cuDNN
takes without a transpose.  Operands are computed in float32 whatever
their dtype (the reference's ``preferred_element_type=float32``); TF32
stays off (``znicz_tpu_torch/__init__.py``).  The Pallas implicit-GEMM
tiers, the parity-split and the space-to-depth forms are not ported yet
(ROADMAP.md queue 2 and queue 1 item 5)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import norm2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)


def conv2d(x, w, stride=1, padding=0, out_dtype=None):
    """x (B,H,W,C), w (KH,KW,C,OC) → (B,OH,OW,OC), contiguous NHWC."""
    y = F.conv2d(_nchw(x.float()), _oihw(w.float()), stride=norm2(stride),
                 padding=norm2(padding))
    return _nhwc(y).to(out_dtype or x.dtype)


def _backward(err, x, w, stride, padding, mask):
    return torch.ops.aten.convolution_backward(
        _nchw(err.float()), _nchw(x), _oihw(w), None, list(norm2(stride)),
        list(norm2(padding)), [1, 1], False, [0, 0], 1, mask)


def conv2d_grad_input(err, w, x_shape, stride=1, padding=0):
    """dx (B,H,W,C) float32 from err (B,OH,OW,OC) and w (KH,KW,C,OC)."""
    # convolution_backward reads only the shape and layout of its input
    # when the weight gradient is not asked for
    x = torch.empty(tuple(x_shape), dtype=torch.float32, device=err.device)
    dx = _backward(err, x, w.float(), stride, padding,
                   (True, False, False))[0]
    return _nhwc(dx)


def conv2d_grad_weights(x, err, w_shape, stride=1, padding=0):
    """dW (KH,KW,C,OC) float32 = Σ over batch and positions of x patches
    times err."""
    kh, kw, c, oc = w_shape
    w = torch.empty((kh, kw, c, oc), dtype=torch.float32, device=err.device)
    dw = _backward(err, x.float(), w, stride, padding,
                   (False, True, False))[1]
    return dw.permute(2, 3, 1, 0).contiguous()
