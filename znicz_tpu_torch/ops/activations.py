"""Activation math: forward + derivative pairs on torch tensors (port of
``znicz_tpu/ops/activations.py``).

Derivative convention (the reference's gradient units): ``bwd`` receives
the upstream error plus whichever of (output, input) the formula needs,
and returns the error w.r.t. the activation input.

Veles-specific formulas, kept for behavioural parity:

* ``tanh`` is the scaled LeCun tanh ``1.7159·tanh(0.6666·x)`` whose
  derivative in terms of the *output* is ``1.14381894 − 0.388484177·y²``.
* ``relu`` is the *smooth* relu ``log(1+eˣ)`` (softplus); ``strict_relu``
  is the familiar ``max(0, x)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TANH_A = 1.7159
TANH_B = 0.6666
_TANH_D1 = TANH_A * TANH_B            # 1.14381894
_TANH_D2 = TANH_B / TANH_A            # 0.388484177 = d1 / a²


def _parity(x: torch.Tensor) -> torch.Tensor:
    """True at even positions of the last axis (SinCos's sin lanes)."""
    return torch.arange(x.shape[-1], device=x.device) % 2 == 0


class Activation:
    """Namespace-style activation definition (identity = ``linear``)."""

    name = "linear"
    needs_input = False    # bwd uses only output unless set

    @staticmethod
    def fwd(x):
        return x

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y


class Tanh(Activation):
    name = "tanh"

    @staticmethod
    def fwd(x):
        return TANH_A * torch.tanh(TANH_B * x)

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y * (_TANH_D1 - _TANH_D2 * y * y)


class Relu(Activation):
    """Smooth relu: y = log(1+eˣ); dy/dx = 1 − e^(−y) (= sigmoid(x))."""

    name = "relu"

    @staticmethod
    def fwd(x):
        # numerically stable softplus: max(x, 0) + log1p(exp(-|x|))
        return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y * (1.0 - torch.exp(-y))


class StrictRelu(Activation):
    name = "strict_relu"

    @staticmethod
    def fwd(x):
        return torch.clamp(x, min=0.0)

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y * (y > 0)


class Sigmoid(Activation):
    name = "sigmoid"

    @staticmethod
    def fwd(x):
        return 1.0 / (1.0 + torch.exp(-x))

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y * y * (1.0 - y)


class Log(Activation):
    """y = log(x + sqrt(x²+1)) (asinh); derivative needs the input."""

    name = "log"
    needs_input = True

    @staticmethod
    def fwd(x):
        return torch.log(x + torch.sqrt(x * x + 1.0))

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y / torch.sqrt(x * x + 1.0)


class SinCos(Activation):
    """Alternating sin/cos over the last axis (reference SinCos unit)."""

    name = "sincos"
    needs_input = True

    @staticmethod
    def fwd(x):
        return torch.where(_parity(x), torch.sin(x), torch.cos(x))

    @staticmethod
    def bwd(err_y, y, x=None):
        return err_y * torch.where(_parity(x), torch.cos(x), -torch.sin(x))


class Mul(Activation):
    """y = x·k (reference ActivationMul with constant factor)."""

    name = "mul"
    k = 1.0

    @staticmethod
    def fwd(x, k=1.0):
        return x * k

    @staticmethod
    def bwd(err_y, y, x=None, k=1.0):
        return err_y * k


class TanhLog(Activation):
    """Scaled tanh in the linear region, log growth outside (reference
    TanhLog hybrid): |x| ≤ t → 1.7159·tanh(0.6666·x);
    |x| > t → sign(x)·(A·log(|x|/t) + y_t), C¹-continuous at t."""

    name = "tanhlog"
    needs_input = True
    THRESHOLD = 1.5 / TANH_B   # switch where tanh saturates (~2.25)
    # value and slope of the scaled tanh at |x| = t (python floats)
    _Y_T = TANH_A * math.tanh(TANH_B * THRESHOLD)
    _S_T = _TANH_D1 * (1.0 - math.tanh(TANH_B * THRESHOLD) ** 2)

    @staticmethod
    def fwd(x):
        t = TanhLog.THRESHOLD
        yt = TANH_A * torch.tanh(TANH_B * x)
        a = TanhLog._S_T * t
        ylog = torch.sign(x) * (
            a * torch.log(torch.clamp(torch.abs(x), min=t) / t) + TanhLog._Y_T)
        return torch.where(torch.abs(x) <= t, yt, ylog)

    @staticmethod
    def bwd(err_y, y, x=None):
        t = TanhLog.THRESHOLD
        th = torch.tanh(TANH_B * x)
        d_tanh = _TANH_D1 * (1.0 - th * th)
        d_log = TanhLog._S_T * t / torch.clamp(torch.abs(x), min=t)
        return err_y * torch.where(torch.abs(x) <= t, d_tanh, d_log)


#: Registry keyed by reference-style activation name.
BY_NAME: dict[str, type[Activation]] = {
    cls.name: cls
    for cls in (Activation, Tanh, Relu, StrictRelu, Sigmoid, Log, SinCos,
                Mul, TanhLog)
}
BY_NAME["linear"] = Activation

#: The numpy golden (fwd(x), bwd(err_y, y)) of the activations the fc
#: units take, as the reference's ``fwd(x, np)``/``bwd(err_y, y, x, np)``;
#: the unit graph's numpy device runs them.
NUMPY = {
    "linear": (lambda x: x, lambda err_y, y: err_y),
    "tanh": (lambda x: TANH_A * np.tanh(TANH_B * x),
             lambda err_y, y: err_y * (_TANH_D1 - _TANH_D2 * y * y)),
    "relu": (lambda x: np.maximum(x, 0.0) + np.log1p(np.exp(-np.abs(x))),
             lambda err_y, y: err_y * (1.0 - np.exp(-y))),
    "strict_relu": (lambda x: np.maximum(x, 0.0),
                    lambda err_y, y: err_y * (y > 0)),
    "sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)),
                lambda err_y, y: err_y * y * (1.0 - y)),
}

#: Ids of the activations whose derivative needs only the output y, as the
#: fused LRN→max-pool backward kernel (``csrc/lrn_pool.cu``) takes them when
#: it folds in the preceding conv's derivative.  ``linear`` folds nothing,
#: and the input-needing activations cannot be folded.
FOLD_IDS = {"strict_relu": 1, "tanh": 2, "sigmoid": 3, "relu": 4, "mul": 5}


def fold_id(name: str | None) -> int:
    """The kernel's id of a foldable activation; 0 for none (``None``)."""
    if name is None:
        return 0
    if name not in FOLD_IDS:
        raise ValueError(f"activation {name!r} cannot be folded into a "
                         f"fused kernel; foldable: {sorted(FOLD_IDS)}")
    return FOLD_IDS[name]
