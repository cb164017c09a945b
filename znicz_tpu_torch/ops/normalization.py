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
and ``np_gd_lrn`` are the numpy goldens the numpy device runs.

The fused path's kernels take a block of pixels through a zero-haloed
shared tile, 16-byte vectors of 4 channels a thread where C % 4 == 0 and
every base is aligned (the C entry points decide the width); their launch
is ``lrn_plan``'s, in Python so that the CPU tests hold it."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import STORAGE_DTYPES, STORAGE_SUFFIX, count_launch, form_counter

#: Reference defaults (AlexNet LRN).
DEFAULTS = dict(n=5, alpha=1e-4, beta=0.75, k=2.0)

#: Launches of the LRN kernels in this process (the CUDA branches of the
#: wrappers add one per launch, nowhere else).
lrn_y_launches = 0
lrn_y_bf16_launches = 0
lrn_y_f16_launches = 0
gd_lrn_x_launches = 0
gd_lrn_x_bf16_launches = 0
gd_lrn_x_f16_launches = 0
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
    """LRN forward, y only: the reference's ``xla_lrn(...)[0]``; a narrow
    x (bfloat16, float16) in float32, y rounded once to x's dtype."""
    return _fwd(x.float(), n, alpha, beta, k)[0].to(x.dtype)


def plain_gd_lrn_x(err, x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward with the denominator recomputed from x: the
    reference's ``xla_gd_lrn_x``; a narrow x in float32."""
    x = x.float()
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
    # x, y, rows, C, n, alpha, beta, k, vec, direct, threads_x, pixels,
    # smem, stream
    **{f"znicz_lrn_y_{sfx}": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
       + [ctypes.c_double] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
       for sfx in STORAGE_SUFFIX.values()},
    # err, x, dx, rows, C, n, alpha, beta, k, vec, threads_x, pixels, smem,
    # stream (x in the entry point's storage type)
    **{f"znicz_gd_lrn_x_{sfx}": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
       + [ctypes.c_double] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
       for sfx in STORAGE_SUFFIX.values()},
    # x, y, d, rows, C, n, alpha, beta, k, stream
    "znicz_lrn_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
    # err, x, d, dx, rows, C, n, alpha, beta, k, stream
    "znicz_gd_lrn_f32": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_double] * 3 + [ctypes.c_void_p],
}
#: The cached backward keeps a tile of whole rows in 48 KB of shared
#: memory; the recompute pair's one-pixel tile at this width and the widest
#: window (n clipped to 2C + 1) takes 172 KB of the 227 KB.
MAX_CHANNELS = 6144
#: The most shared memory a block of an H100 may have (227 KB).
MAX_TILE_BYTES = 232448
#: A block's threads at most.
MAX_THREADS = 1024
#: The threads a block of the recompute pair aims at (pixels times the
#: threads of a pixel; the fewest that did not lose at CIFAR's shape on an
#: H100, ``python -m znicz_tpu_torch.lrn_probe``).
PLAN_THREADS = 128
#: Channels a thread takes at least in the scalar form (V = 1) of a tensor
#: that is not small: two beat one, four and eight at C = 30 and C = 32 on
#: an H100 (``lrn_probe``).
SCALAR_PER = 2
#: The H100's streaming multiprocessors, the plan's default.
H100_SMS = 132
#: Elements a multiprocessor of a small tensor (the plan's scalar form at
#: one channel a thread, the forward reading its window from global
#: memory): half the 2048 threads an SM holds, where the vector form drew
#: level at AlexNet's LRN width on an H100 (``lrn_probe``, 2 to 32 images).
SMALL_PER_SM = 1024


class LrnPlan(NamedTuple):
    """The launch of ``lrn_y`` (or, ``backward``, of ``gd_lrn_x``): a block
    of ``threads_x`` × ``pixels`` threads takes ``pixels`` consecutive
    pixels, a row of ``threads_x`` threads each, with ``smem`` bytes of
    dynamic shared memory; ``blocks`` blocks in all.  A thread takes
    ``vec`` consecutive channels as one vector (4: 16-byte loads and
    stores; 1 where C % 4 != 0 or a base is not 16-byte aligned), then
    every ``threads_x · vec`` channels.  ``n`` is the window min(n, 2C + 1):
    past that every slot beyond a channel's edge is another 0.0f, which
    adds nothing to a sum that already added one; ``kn`` the window the
    kernel instance fixes at compile time (5, in either form, or 0: read
    at run time).
    ``halo`` zero floats each side of a pixel's C channels in the tile
    rows stand for the window's clipped slots.  ``warp``: a warp holds
    whole pixels (n = 5, the vector form, a pixel's C / 4 threads dividing
    32, the block whole warps), so the kernels take the window's
    neighbours from the next threads by shuffles and use no tile; ``smem``
    is the tile's all the same.  ``direct``: the forward of a small tensor
    in the scalar form, one thread an element (blocks of threads_x ·
    pixels threads over the flat index) reading its window straight from
    global memory, no tile either."""
    vec: int
    n: int
    kn: int
    halo: int
    threads_x: int
    pixels: int
    blocks: int
    smem: int
    warp: bool
    direct: bool


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lrn_tile_bytes(c: int, halo: int, pixels: int, backward: bool) -> int:
    """Shared bytes of a block of ``pixels`` pixels (P = C + 2·halo floats
    a tile row): the x rows forward; backward also the q rows and the
    err·p rows (C floats each)."""
    p = c + 2 * halo
    return 4 * pixels * ((2 * p + c) if backward else p)


def lrn_plan(shape, n: int, backward: bool = False, aligned: bool = True,
             n_sm: int = H100_SMS) -> LrnPlan:
    """The launch of the recompute pair's kernels over a tensor of
    ``shape`` (channels last), bases 16-byte aligned or not, on a card of
    ``n_sm`` multiprocessors.  The vector form where C % 4 == 0, the bases
    are aligned and the tensor is not small (more than ``n_sm`` ·
    ``SMALL_PER_SM`` elements); a small one takes the scalar form at one
    channel a thread, whose threads each run one chain of rounded
    operations (the time of a launch that small is one thread's latency,
    not bytes), the forward reading its window straight from global memory
    (``direct``).  A pixel's vectors go to the fewest threads that take one
    vector each (``SCALAR_PER`` channels in the scalar form of a tensor
    that is not small), and at most ``MAX_THREADS``; the pixels a block
    fill ``PLAN_THREADS`` threads,
    fewer where the tile would pass ``MAX_TILE_BYTES`` (one pixel fits at
    every C up to ``MAX_CHANNELS``).  The C entry points take the width
    asked for only where C and the pointers allow it, and the form from C,
    n and the block; where they take V = 1 under a plan made for V = 4,
    the narrower halo needs fewer shared bytes than the plan gives."""
    c = int(shape[-1])
    rows = int(np.prod([int(v) for v in shape[:-1]], dtype=np.int64))
    small = rows * c <= n_sm * SMALL_PER_SM
    vec = 4 if c % 4 == 0 and aligned and not small else 1
    n = min(int(n), 2 * c + 1)
    halo = _ceil(n - 1 - (n - 1) // 2, vec) * vec
    kn = 5 if n == 5 else 0
    vectors = c // vec
    per = 1 if vec == 4 or small else SCALAR_PER
    threads_x = _ceil(vectors, max(per, _ceil(vectors, MAX_THREADS)))
    pixels = max(1, min(PLAN_THREADS // threads_x, MAX_THREADS // threads_x,
                        rows))
    while pixels > 1 and lrn_tile_bytes(c, halo, pixels,
                                        backward) > MAX_TILE_BYTES:
        pixels -= 1
    warp = (vec == 4 and kn == 5 and c == 4 * threads_x
            and 32 % threads_x == 0
            and threads_x * pixels % 32 == 0)
    return LrnPlan(vec, n, kn, halo, threads_x, pixels, _ceil(rows, pixels),
                   lrn_tile_bytes(c, halo, pixels, backward), warp,
                   small and not backward)


def _plan(shape, n, backward: bool, *tensors) -> LrnPlan:
    """The plan for a CUDA launch over these tensors (all of them 16-byte
    aligned or the scalar form) on their card."""
    return lrn_plan(
        shape, n, backward, all(t.data_ptr() % 16 == 0 for t in tensors),
        torch.cuda.get_device_properties(
            tensors[0].device).multi_processor_count)


def _launch(name: str, device, *args) -> None:
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel("lrn", name, _ARGTYPES[name]),
                      device, *args)


def _check(who: str, n: int, *tensors, narrow: int | None = -1) -> None:
    """Refuse what the kernels do not take; the CPU branch is held to the
    same contract so both devices accept the same inputs.  The tensors
    are float32 but ``tensors[narrow]`` (None: none), the recompute pair's
    stored x, which may be in any storage dtype (``ops.STORAGE_DTYPES``)."""
    first = tensors[0]
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {first.device}")
    if not 1 <= int(n) < 2 ** 31:
        raise ValueError(f"{who}: window n must be positive, got {n}")
    for i, t in enumerate(tensors):
        if t.device != first.device:
            raise ValueError(f"{who}: tensors on {t.device} and "
                             f"{first.device}")
        if t.dtype != torch.float32 and not (
                narrow is not None and i == narrow % len(tensors)
                and t.dtype in STORAGE_DTYPES):
            raise TypeError(f"{who}: tensors must be float32 (x a storage "
                            f"dtype), got {t.dtype}")
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
    contiguous tensor in a storage dtype (float32, bfloat16, float16; y in
    x's dtype, computed in float32 and rounded once)."""
    _check("lrn_y", n, x)
    if x.device.type == "cpu":
        return plain_lrn_y(x, n, alpha, beta, k)
    c = x.shape[-1]
    y = torch.empty_like(x)
    plan = _plan(x.shape, n, False, x, y)
    _launch(f"znicz_lrn_y_{STORAGE_SUFFIX[x.dtype]}", x.device,
            x.data_ptr(), y.data_ptr(), x.numel() // c, c, plan.n,
            float(alpha), float(beta), float(k), plan.vec, int(plan.direct),
            plan.threads_x, plan.pixels, plan.smem)
    count_launch(__name__, form_counter("lrn_y", x.dtype))
    return y


def gd_lrn_x(err, x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward recomputing the denominator from x (no cached d): dx
    float32 from float32 err and x in a storage dtype."""
    _check("gd_lrn_x", n, err, x)
    if x.device.type == "cpu":
        return plain_gd_lrn_x(err, x, n, alpha, beta, k)
    c = x.shape[-1]
    dx = torch.empty_like(err)
    plan = _plan(x.shape, n, True, err, x, dx)
    _launch(f"znicz_gd_lrn_x_{STORAGE_SUFFIX[x.dtype]}", x.device,
            err.data_ptr(), x.data_ptr(), dx.data_ptr(), x.numel() // c, c,
            plan.n, float(alpha), float(beta), float(k), plan.vec,
            plan.threads_x, plan.pixels, plan.smem)
    count_launch(__name__, form_counter("gd_lrn_x", x.dtype))
    return dx


def lrn(x, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN forward → (y, d), d = k + α·(window sum of x²) cached for
    :func:`gd_lrn`, over the last axis of a contiguous float32 tensor."""
    _check("lrn", n, x, narrow=None)
    if x.device.type == "cpu":
        return plain_lrn(x, n, alpha, beta, k)
    c = x.shape[-1]
    y = torch.empty_like(x)
    d = torch.empty_like(x)
    _launch("znicz_lrn_f32", x.device, x.data_ptr(), y.data_ptr(),
            d.data_ptr(), x.numel() // c, c, int(n), float(alpha),
            float(beta), float(k))
    count_launch(__name__, "lrn_launches")
    return y, d


def gd_lrn(err, x, d, n=5, alpha=1e-4, beta=0.75, k=2.0):
    """LRN backward from the forward's cached denominator ``d``."""
    _check("gd_lrn", n, err, x, d, narrow=None)
    if x.device.type == "cpu":
        return plain_gd_lrn(err, x, d, n, alpha, beta, k)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    _launch("znicz_gd_lrn_f32", x.device, err.data_ptr(), x.data_ptr(),
            d.data_ptr(), dx.data_ptr(), x.numel() // c, c, int(n),
            float(alpha), float(beta), float(k))
    count_launch(__name__, "gd_lrn_launches")
    return dx
