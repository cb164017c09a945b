"""Activation math: forward + derivative pairs on torch tensors (port of
``znicz_tpu/ops/activations.py``).

Derivative convention (the reference's gradient units): ``bwd`` receives
the upstream error plus whichever of (output, input) the formula needs,
and returns the error w.r.t. the activation input.

``act_fwd(name, x)`` and ``act_bwd(name, err_y, y, x=None)`` are what the
standalone activation units call (the reference's dispatching
``act_fwd``/``act_bwd``): on CUDA tensors they launch the hand-written
elementwise kernels of ``csrc/activation.cu`` (the port of
``pallas_act_fwd``/``pallas_act_bwd``), on CPU tensors they run the
``BY_NAME`` classes (``plain_act_fwd``/``plain_act_bwd``).  A CUDA tensor
never falls back.  The fc, conv and fused paths keep the activation as
plain torch math, as XLA fuses it there in the reference.

Veles-specific formulas, kept for behavioural parity:

* ``tanh`` is the scaled LeCun tanh ``1.7159·tanh(0.6666·x)`` whose
  derivative in terms of the *output* is ``1.14381894 − 0.388484177·y²``.
* ``relu`` is the *smooth* relu ``log(1+eˣ)`` (softplus); ``strict_relu``
  is the familiar ``max(0, x)``.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

#: Launches of the activation kernels in this process (the CUDA branches
#: of ``act_fwd`` / ``act_bwd`` add one per launch, nowhere else).
act_fwd_launches = 0
act_bwd_launches = 0

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

def _np_parity(x):
    return np.arange(x.shape[-1]) % 2 == 0


def _np_tanhlog_fwd(x):
    # float64 numpy constants, as the reference computes them (under numpy
    # 2's promotion the log branch then runs in float64, as there)
    t = TanhLog.THRESHOLD
    y_t = TANH_A * np.tanh(np.float64(TANH_B * t))
    a = _TANH_D1 * (1.0 - np.tanh(np.float64(TANH_B * t)) ** 2) * t
    ylog = np.sign(x) * (a * np.log(np.maximum(np.abs(x), t) / t) + y_t)
    return np.where(np.abs(x) <= t, TANH_A * np.tanh(TANH_B * x), ylog)


def _np_tanhlog_bwd(err_y, y, x=None):
    t = TanhLog.THRESHOLD
    th = np.tanh(TANH_B * x)
    s_t = _TANH_D1 * (1.0 - np.tanh(np.float64(TANH_B * t)) ** 2)
    d_log = s_t * t / np.maximum(np.abs(x), t)
    return err_y * np.where(np.abs(x) <= t, _TANH_D1 * (1.0 - th * th),
                            d_log)


#: The numpy golden (fwd(x), bwd(err_y, y, x=None)) of every activation, as
#: the reference's ``fwd(x, np)``/``bwd(err_y, y, x, np)``; the unit
#: graph's numpy device runs them.
NUMPY = {
    "linear": (lambda x: x, lambda err_y, y, x=None: err_y),
    "tanh": (lambda x: TANH_A * np.tanh(TANH_B * x),
             lambda err_y, y, x=None: err_y * (_TANH_D1 - _TANH_D2 * y * y)),
    "relu": (lambda x: np.maximum(x, 0.0) + np.log1p(np.exp(-np.abs(x))),
             lambda err_y, y, x=None: err_y * (1.0 - np.exp(-y))),
    "strict_relu": (lambda x: np.maximum(x, 0.0),
                    lambda err_y, y, x=None: err_y * (y > 0)),
    "sigmoid": (lambda x: 1.0 / (1.0 + np.exp(-x)),
                lambda err_y, y, x=None: err_y * y * (1.0 - y)),
    "log": (lambda x: np.log(x + np.sqrt(x * x + 1.0)),
            lambda err_y, y, x=None: err_y / np.sqrt(x * x + 1.0)),
    "sincos": (lambda x: np.where(_np_parity(x), np.sin(x), np.cos(x)),
               lambda err_y, y, x=None: err_y * np.where(
                   _np_parity(x), np.cos(x), -np.sin(x))),
    "mul": (lambda x: x * 1.0, lambda err_y, y, x=None: err_y * 1.0),
    "tanhlog": (_np_tanhlog_fwd, _np_tanhlog_bwd),
}

#: Ids of the activations whose derivative needs only the output y, as the
#: fused LRN→max-pool backward kernel (``csrc/lrn_pool.cu``) takes them when
#: it folds in the preceding conv's derivative.  ``linear`` folds nothing,
#: and the input-needing activations cannot be folded.
FOLD_IDS = {"strict_relu": 1, "tanh": 2, "sigmoid": 3, "relu": 4, "mul": 5}
#: Ids of every activation in the elementwise kernels (``csrc/act_math.cuh``
#: numbers them the same way).
ACT_IDS = {"linear": 0, **FOLD_IDS, "log": 6, "sincos": 7, "tanhlog": 8}


def fold_id(name: str | None) -> int:
    """The kernel's id of a foldable activation; 0 for none (``None``)."""
    if name is None:
        return 0
    if name not in FOLD_IDS:
        raise ValueError(f"activation {name!r} cannot be folded into a "
                         f"fused kernel; foldable: {sorted(FOLD_IDS)}")
    return FOLD_IDS[name]


# -- the standalone units' elementwise kernels --------------------------------
#: in, [err, y,] out, n, C (the last axis), the tanhlog constants t, 1/t,
#: a, y_t, stream
_FWD_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 4 + [ctypes.c_void_p])


def tanhlog_constants() -> tuple[float, float, float, float]:
    """(t, 1/t, a = s_t·t, y_t) as float32 values: the threshold and the
    constants the reference computes in float64 on the host, each rounded
    once to the float32 its arithmetic takes them in; 1/t is the float32
    reciprocal of float32 t, as PyTorch divides a CUDA tensor by a host
    scalar."""
    f = np.float32
    t = f(TanhLog.THRESHOLD)
    return (float(t), float(f(1.0) / t),
            float(f(TanhLog._S_T * TanhLog.THRESHOLD)), float(f(TanhLog._Y_T)))


def plain_act_fwd(name: str, x: torch.Tensor) -> torch.Tensor:
    """y = act(x) by the ``BY_NAME`` class: what the kernel is held
    against on the card."""
    return BY_NAME[name].fwd(x)


def plain_act_bwd(name: str, err_y: torch.Tensor, y: torch.Tensor,
                  x: torch.Tensor | None = None) -> torch.Tensor:
    return BY_NAME[name].bwd(err_y, y, x)


def _check(who: str, name: str, *tensors) -> None:
    """Refuse what the kernels do not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if name not in ACT_IDS:
        raise ValueError(f"{who}: unknown activation {name!r}; known: "
                         f"{sorted(ACT_IDS)}")
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {first.device}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{who}: tensors on {first.device} and "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: tensors must be float32, got {t.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"{who}: shapes {tuple(first.shape)} and "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: tensors must be contiguous")
    if first.dim() == 0:
        raise ValueError(f"{who}: a scalar has no last axis")
    if first.numel() >= 2 ** 31:
        raise ValueError(f"{who}: 2^31 elements or more (the kernel "
                         "indexes in int32)")


def act_fwd(name: str, x: torch.Tensor) -> torch.Tensor:
    """y = act(x) for a contiguous float32 tensor: the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    global act_fwd_launches
    _check("act_fwd", name, x)
    if x.device.type == "cpu":
        return plain_act_fwd(name, x)
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("activation", "znicz_act_fwd_f32", _FWD_ARGTYPES),
        x.device, x.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1],
        ACT_IDS[name], *tanhlog_constants())
    act_fwd_launches += 1
    return y


def act_bwd(name: str, err_y: torch.Tensor, y: torch.Tensor,
            x: torch.Tensor | None = None) -> torch.Tensor:
    """err_x from (err_y, y[, x]) for contiguous float32 tensors of one
    shape: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  ``log``, ``sincos`` and ``tanhlog`` need the forward input
    and raise without it."""
    global act_bwd_launches
    if BY_NAME.get(name, Activation).needs_input and x is None:
        raise ValueError(f"{name} backward needs the forward input")
    _check("act_bwd", name, err_y, y, *(() if x is None else (x,)))
    if err_y.device.type == "cpu":
        return plain_act_bwd(name, err_y, y, x)
    out = torch.empty_like(err_y)
    if err_y.numel() == 0:
        return out
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("activation", "znicz_act_bwd_f32", _BWD_ARGTYPES),
        err_y.device, err_y.data_ptr(), y.data_ptr(),
        None if x is None else x.data_ptr(), out.data_ptr(), err_y.numel(),
        err_y.shape[-1], ACT_IDS[name], *tanhlog_constants())
    act_bwd_launches += 1
    return out
