"""Local-response normalization across channels, forward + backward (port
of ``znicz_tpu/ops/normalization.py``; distinct from the package's
top-level ``normalization.py``, the dataset normalizers).

Math (cross-channel window of size n on the last axis, clipped):

    S_i = Σ_{j ∈ [i−(n−1)//2, i+n//2]} x_j²
    d_i = k + α·S_i
    y_i = x_i · d_i^{−β}
    dx_i = err_i·d_i^{−β} − 2αβ·x_i·Σ_{j ∈ win(i)} err_j·x_j·d_j^{−β−1}

The backward reuses the forward's window even for an even n: this is the
reference's formula, not the true adjoint.  β = 0.75 is computed as
1/(√d·√√d), other β with ``pow``.

``lrn_y`` and ``gd_lrn_x`` are the fused path's forms (the denominator is
recomputed in the backward, never cached); ``lrn`` → (y, d) and
``gd_lrn(err, x, d)`` are the unit graph's (``LRNormalizerForward`` caches
d for ``LRNormalizerBackward``).  On a CUDA tensor all four launch the
hand-written kernels of ``csrc/lrn.cu``; on a CPU tensor they run the
plain versions, transcriptions of the reference's XLA tier.  ``np_lrn``
and ``np_gd_lrn`` are the numpy goldens the numpy device runs."""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

#: Reference defaults (AlexNet LRN).
DEFAULTS = dict(n=5, alpha=1e-4, beta=0.75, k=2.0)

#: Launches of the LRN kernels in this process (the CUDA branches of the
#: wrappers add one per launch, nowhere else).
lrn_y_launches = 0
gd_lrn_x_launches = 0
lrn_launches = 0
gd_lrn_launches = 0


def _window_sum(a, n: int):
    """Sum over a centered channel window of size n (last axis), clipped:
    n shifted slices of a zero-padded copy, added in order."""
    half_lo = (n - 1) // 2
    half_hi = n // 2
    c = a.shape[-1]
    ap = F.pad(a, (half_lo, half_hi))
    acc = None
    for i in range(n):
        sl = ap[..., i:i + c]
        acc = sl if acc is None else acc + sl
    return acc


def _sqrt_rn(a):
    """Correctly rounded float32 square root: torch's CPU ``sqrt`` may be
    off by an ulp, the square root taken in float64 and rounded once is
    not (as numpy's, XLA's and the card's ``__fsqrt_rn``)."""
    return torch.sqrt(a.double()).to(a.dtype)


def _dpow_nbeta(d, beta):
    """d^(−β), with β = 0.75 as 1/(√d·√√d) (correctly rounded IEEE ops,
    the same in every tier); other β with pow."""
    if beta == 0.75:
        r = _sqrt_rn(d)
        return 1.0 / (r * _sqrt_rn(r))
    return d ** (-beta)


def _fwd(x, n, alpha, beta, k):
    s = _window_sum(x * x, n)
    d = k + alpha * s
    return x * _dpow_nbeta(d, beta), d


def _bwd(err, x, d, n, alpha, beta):
    p = _dpow_nbeta(d, beta)
    q = err * x * (p / d)
    return err * p - 2.0 * alpha * beta * x * _window_sum(q, n)


def plain_lrn_y(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN forward, y only: the reference's ``xla_lrn(...)[0]``."""
    return _fwd(x, n, alpha, beta, k)[0]


def plain_gd_lrn_x(err, x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward with the denominator recomputed from x: the
    reference's ``xla_gd_lrn_x``."""
    d = k + alpha * _window_sum(x * x, n)
    return _bwd(err, x, d, n, alpha, beta)


def plain_lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN forward → (y, d): the reference's ``xla_lrn``."""
    return _fwd(x, n, alpha, beta, k)


def plain_gd_lrn(err, x, d, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward from the forward's cached d: the reference's
    ``xla_gd_lrn`` (``k`` is unused, as there)."""
    return _bwd(err, x, d, n, alpha, beta)


# -- numpy goldens (the numpy device) ---------------------------------------
def _np_window_sum(a: np.ndarray, n: int) -> np.ndarray:
    c = a.shape[-1]
    ap = np.pad(a, [(0, 0)] * (a.ndim - 1) + [((n - 1) // 2, n // 2)])
    acc = ap[..., 0:c]
    for i in range(1, n):
        acc = acc + ap[..., i:i + c]
    return acc


def _np_dpow_nbeta(d: np.ndarray, beta) -> np.ndarray:
    if beta == 0.75:
        r = np.sqrt(d)
        return 1.0 / (r * np.sqrt(r))
    return d ** (-beta)


def np_lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """→ (y, d): the reference's ``np_lrn``."""
    d = k + alpha * _np_window_sum(x * x, n)
    return x * _np_dpow_nbeta(d, beta), d


def np_gd_lrn(err, x, d, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """The reference's ``np_gd_lrn``."""
    p = _np_dpow_nbeta(d, beta)
    q = err * x * (p / d)
    return err * p - 2.0 * alpha * beta * x * _np_window_sum(q, n)


# -- kernels ----------------------------------------------------------------
_ARGTYPES = {
    # x, y, rows, C, n, alpha, beta, k, stream
    "znicz_lrn_y_f32": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
    # err, x, dx, rows, C, n, alpha, beta, k, stream
    "znicz_gd_lrn_x_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
    # x, y, d, rows, C, n, alpha, beta, k, stream
    "znicz_lrn_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
    # err, x, d, dx, rows, C, n, alpha, beta, k, stream
    "znicz_gd_lrn_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
}
#: The backward kernel keeps a tile of whole rows in 48 KB of shared memory.
MAX_CHANNELS = 6144


def _launch(name: str, device, *args) -> None:
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("lrn", name, _ARGTYPES[name]),
                      device, *args)


def _check(who: str, n: int, *tensors) -> None:
    """Refuse what the kernels do not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {first.device}")
    if not 1 <= int(n) < 2 ** 31:
        raise ValueError(f"{who}: window n must be positive, got {n}")
    for t in tensors:
        if t.device != first.device:
            raise ValueError(f"{who}: tensors on {t.device} and "
                             f"{first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who}: tensors must be float32, got "
                            f"{t.dtype}")
        if t.shape != first.shape:
            raise ValueError(f"{who}: shapes {tuple(t.shape)} and "
                             f"{tuple(first.shape)} differ")
        if not t.is_contiguous():
            raise ValueError(f"{who}: tensors must be contiguous")
    if first.dim() == 0 or first.numel() == 0:
        raise ValueError(f"{who}: tensors must be non-empty with a channel "
                         f"axis, got {tuple(first.shape)}")
    if first.numel() >= 2 ** 31:
        raise ValueError(f"{who}: 2^31 elements or more (the kernels index "
                         f"in int32)")
    if first.shape[-1] > MAX_CHANNELS:
        raise ValueError(f"{who}: {first.shape[-1]} channels; the kernels "
                         f"take at most {MAX_CHANNELS}")


def lrn_y(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN forward emitting only y, over the last (channel) axis of a
    contiguous float32 tensor."""
    global lrn_y_launches
    _check("lrn_y", n, x)
    if x.device.type == "cpu":
        return plain_lrn_y(x, n, alpha, beta, k)
    c = x.shape[-1]
    y = torch.empty_like(x)
    _launch("znicz_lrn_y_f32", x.device, x.data_ptr(), y.data_ptr(),
            x.numel() // c, c, int(n), float(alpha), float(beta), float(k))
    lrn_y_launches += 1
    return y


def gd_lrn_x(err, x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward recomputing the denominator from x (no cached d)."""
    global gd_lrn_x_launches
    _check("gd_lrn_x", n, err, x)
    if x.device.type == "cpu":
        return plain_gd_lrn_x(err, x, n, alpha, beta, k)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    _launch("znicz_gd_lrn_x_f32", x.device, err.data_ptr(), x.data_ptr(),
            dx.data_ptr(), x.numel() // c, c, int(n), float(alpha),
            float(beta), float(k))
    gd_lrn_x_launches += 1
    return dx


def lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN forward → (y, d), d = k + α·(window sum of x²) cached for
    :func:`gd_lrn`, over the last axis of a contiguous float32 tensor."""
    global lrn_launches
    _check("lrn", n, x)
    if x.device.type == "cpu":
        return plain_lrn(x, n, alpha, beta, k)
    c = x.shape[-1]
    y = torch.empty_like(x)
    d = torch.empty_like(x)
    _launch("znicz_lrn_f32", x.device, x.data_ptr(), y.data_ptr(),
            d.data_ptr(), x.numel() // c, c, int(n), float(alpha),
            float(beta), float(k))
    lrn_launches += 1
    return y, d


def gd_lrn(err, x, d, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward from the forward's cached denominator ``d``."""
    global gd_lrn_launches
    _check("gd_lrn", n, err, x, d)
    if x.device.type == "cpu":
        return plain_gd_lrn(err, x, d, n, alpha, beta, k)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    _launch("znicz_gd_lrn_f32", x.device, err.data_ptr(), x.data_ptr(),
            d.data_ptr(), dx.data_ptr(), x.numel() // c, c, int(n),
            float(alpha), float(beta), float(k))
    gd_lrn_launches += 1
    return dx
