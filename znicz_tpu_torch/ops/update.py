"""Fused parameter update: SGD + momentum + L1/L2 decay (port of
``znicz_tpu/ops/update.py``).

The rule, in the reference's order of operations::

    reg  = weights_decay · ((1 − l1_vs_l2)·w + ½·l1_vs_l2·sign(w))
    vel' = gradient_moment · vel − learning_rate · (grad + reg)
    w'   = w + vel'

``sgd_update(w, grad, vel, hypers)`` is what the unit graph's
``GradientDescent`` calls for each weight and bias.  On CUDA tensors it
launches the hand-written kernel in ``csrc/update.cu`` (the port of
``pallas_sgd_update``); on CPU tensors it runs ``plain_sgd_update``.
``hypers`` = (lr, weights_decay, l1_vs_l2, momentum), rounded to float32
on the host as the reference's f32 hypers array holds them.  Both versions
round once per operation with no fused multiply-add, so they agree bit
for bit.  A CUDA tensor never falls back to the plain version."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: Launches of the update kernel in this process (the CUDA branch of
#: ``sgd_update`` adds one per launch, nowhere else).
sgd_update_launches = 0

#: w, g, v, w_out, v_out, n, lr, wd, l1, momentum, stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def np_sgd_update(w, grad, vel, lr, weights_decay=0.0, l1_vs_l2=0.0,
                  momentum=0.0):
    """The numpy golden (the reference's ``np_sgd_update``); returns
    (w', vel')."""
    reg = weights_decay * ((1.0 - l1_vs_l2) * w
                           + 0.5 * l1_vs_l2 * np.sign(w))
    g = grad + reg
    vel_new = momentum * vel - lr * g
    return (w + vel_new).astype(w.dtype), vel_new.astype(vel.dtype)


def f32_hypers(hypers) -> tuple[float, float, float, float]:
    """(lr, weights_decay, l1_vs_l2, momentum) rounded to float32, as
    Python floats (exactly representable in float32)."""
    lr, wd, l1, mom = (float(np.float32(h)) for h in hypers)
    return lr, wd, l1, mom


def plain_sgd_update(w: torch.Tensor, grad: torch.Tensor, vel: torch.Tensor,
                     hypers) -> tuple[torch.Tensor, torch.Tensor]:
    """(w', vel') with the reference kernel's float32 arithmetic: the
    hypers rounded to float32, ``1 − l1`` and ``½·l1`` formed in float32,
    then one rounded operation at a time.  ``sign(±0) = 0``."""
    lr, wd, l1, mom = f32_hypers(hypers)
    one_minus_l1 = float(np.float32(1.0) - np.float32(l1))
    half_l1 = float(np.float32(0.5) * np.float32(l1))
    reg = wd * (one_minus_l1 * w + half_l1 * torch.sign(w))
    vel_new = mom * vel - lr * (grad + reg)
    return w + vel_new, vel_new


def _check(w: torch.Tensor, grad: torch.Tensor, vel: torch.Tensor) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if w.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sgd_update: unsupported device {w.device}")
    for name, t in (("grad", grad), ("vel", vel)):
        if t.device != w.device:
            raise ValueError(f"sgd_update: {name} on {t.device}, w on "
                             f"{w.device}")
        if t.shape != w.shape:
            raise ValueError(f"sgd_update: {name} is {tuple(t.shape)}, w is "
                             f"{tuple(w.shape)}")
    for name, t in (("w", w), ("grad", grad), ("vel", vel)):
        if t.dtype != torch.float32:
            raise TypeError(f"sgd_update: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sgd_update: {name} must be contiguous")


def sgd_update(w: torch.Tensor, grad: torch.Tensor, vel: torch.Tensor,
               hypers) -> tuple[torch.Tensor, torch.Tensor]:
    """(w', vel') for contiguous float32 tensors of one shape and hypers
    (lr, weights_decay, l1_vs_l2, momentum): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Fresh outputs; the inputs
    are left as they were."""
    global sgd_update_launches
    _check(w, grad, vel)
    if w.device.type == "cpu":
        return plain_sgd_update(w, grad, vel, hypers)
    w_out = torch.empty_like(w)
    v_out = torch.empty_like(vel)
    if w.numel() == 0:
        return w_out, v_out
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("update", "znicz_sgd_update_f32", _ARGTYPES),
        w.device, w.data_ptr(), grad.data_ptr(), vel.data_ptr(),
        w_out.data_ptr(), v_out.data_ptr(), w.numel(), *f32_hypers(hypers))
    sgd_update_launches += 1
    return w_out, v_out
