"""Matrix product of the unit graph's fc units (port of
``znicz_tpu/ops/matmul.py``).

``matmul(a, b)`` is the product ``All2All`` and ``GradientDescent`` call
(``x·W``, ``xᵀ·err_y``, ``err_y·Wᵀ``).  On CUDA tensors it launches the
hand-written tensor-core kernel in ``csrc/matmul.cu`` (the port of
``pallas_matmul``, on the tile loop ``csrc/gemm_tc.cuh``), which reads
each operand through its strides, so a transposed view costs no copy;
``matmul_plan`` picks its launch (each operand's layout in shared memory,
the copy widths, the tile width, the split of the depth).  On CPU tensors
it runs ``plain_matmul``.

``matmul_at_b(a, b)`` is ``aᵀ·b`` of row-major ``a (M, K)`` and
``b (M, N)`` over their shared rows, the weight-gradient shape (M huge,
the output small): on CUDA tensors the same tensor-core kernel (the port
of ``pallas_matmul_at_b``) on the views ``a.T`` (M-major: its m stride is
1) and ``b`` (N-major), so ``aᵀ`` is never made, with the depth M split
across the card and the splits summed in a fixed order
(``at_b_plan``); on CPU tensors ``plain_matmul_at_b``.

Both keep float32 accuracy: the kernel multiplies in the 3×TF32 split
(three TF32 products a multiply-add, within the same tolerance as
float32 sums in another order); the reference's bf16 operand cast is a
TPU-only device (``_mxu_cast``), and TF32 stays off for PyTorch's own
products (``znicz_tpu_torch/__init__.py``).  The fused step's fc products
stay ``torch.matmul``, as the JAX fused step leaves them to XLA.  A CUDA
tensor never falls back to the plain version or to a library product."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import count_launch

#: Launches of the matmul kernel in this process (the CUDA branch of
#: ``matmul`` adds one per launch, nowhere else).
matmul_launches = 0
#: Launches of the matmul kernel for aᵀ·b (its split products and their
#: sum count as one), added by the CUDA branch of ``matmul_at_b`` only.
matmul_at_b_launches = 0

#: a, b, c, workspace, M, N, K, A strides (m, k), B strides (k, n), the
#: launch choice (``MatmulPlan``: bn, a_mmajor, b_kmajor, vec_a, vec_b,
#: splits, chunk) and the stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_void_p])

_MAX_GRID_Y = 65535
_INT32 = 2 ** 31
#: the tensor-core loop (csrc/gemm_tc.cuh): rows of its C tile, the depth
#: of a stage, and its tile widths, widest first (8 is the narrowest MMA's)
TC_ROWS = 128
TC_STEP = 32
TC_WIDTHS = (128, 96, 32, 16, 8)
_MMA_N = 8
#: its blocks resident at once on an H100 (two on each of 132 SMs), and a
#: block's fixed cost in stages (the two stages its prologue loads before
#: the first product, and its store)
TC_SLOTS = 264
TC_BLOCK_STAGES = 2


def np_matmul(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The numpy golden (the reference's ``numpy_run``: ``numpy.dot``)."""
    return np.dot(x, w)


def plain_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b`` (TF32 off): the reference's ``xla_matmul`` on the
    CPU tier, and what the kernel is held against on the card."""
    return torch.matmul(a, b)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul: unsupported device {a.device}")
    if b.device != a.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul: operands must be float32, got {a.dtype} "
                        f"and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} do not multiply")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or m * n >= 2 ** 31:
        raise ValueError("matmul: shape exceeds int32")
    if _ceil(n, _tc_width(n)) > _MAX_GRID_Y:
        raise ValueError(f"matmul: {n} columns exceed the kernel's grid")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("matmul: negative strides are not taken")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _tc_width(n: int) -> int:
    """The widest of ``TC_WIDTHS`` whose tiles over N columns idle less
    than a quarter of their columns beyond N rounded up to the narrowest
    MMA's 8 (so 8 at N ≤ 1)."""
    n = max(n, 1)
    padded = -(-n // _MMA_N) * _MMA_N
    for bn in TC_WIDTHS:
        cols = -(-n // bn) * bn
        if 4 * (cols - padded) < cols:    # always true at 8
            return bn


@functools.lru_cache(maxsize=4096)
def tc_split_plan(depth: int, rows: int, cols: int, bn: int
                  ) -> tuple[int, int]:
    """(splits, chunk) of the tensor-core loop's depth for a (rows, cols)
    output in TC_ROWS × ``bn`` tiles.  No split where the tiles alone fill
    the card's ``TC_SLOTS``; else the split count whose grid takes the
    least time in stages of one resident block, its waves of
    ``TC_SLOTS`` blocks times a block's chunk plus ``TC_BLOCK_STAGES``,
    the fewest splits among equals.  Each chunk is whole stages of
    TC_STEP, none empty (one stage at depth 0).  Measured on an H100
    (``chip_smoke.py`` ``splits_ms``), the time follows the waves: a grid
    a little past a wave loses what one a little short of it keeps."""
    tiles = _ceil(rows, TC_ROWS) * _ceil(cols, bn)
    stages = max(_ceil(depth, TC_STEP), 1)

    def cost(splits: int) -> tuple[int, int]:
        chunk = _ceil(stages, splits)
        return (_ceil(tiles * _ceil(stages, chunk), TC_SLOTS)
                * (chunk + TC_BLOCK_STAGES), splits)
    splits = (1 if tiles >= TC_SLOTS
              else min(range(1, stages + 1), key=cost))
    chunk = _ceil(stages, splits)
    return _ceil(stages, chunk), chunk * TC_STEP


def launch_split(library: str, entry: str, argtypes: list, a, b, out,
                 rows: int, cols: int, dims: tuple,
                 plan: tuple[int, int]) -> None:
    """Launch a split-depth product of operands ``a`` and ``b`` into
    ``out``, a (rows, cols) matrix: ``entry(a, b, out, workspace, *dims,
    splits, chunk, stream)``, with (splits, chunk) from ``plan`` and the
    workspace (splits, rows, cols) allocated here when the depth is
    split."""
    splits, chunk = plan
    if splits * rows * cols >= _INT32:
        raise ValueError(f"{entry}: the split workspace exceeds int32")
    ws = (torch.empty((splits, rows, cols), dtype=torch.float32,
                      device=out.device) if splits > 1 else None)
    from .. import cuda_build
    cuda_build.launch(cuda_build.kernel(library, entry, argtypes), out.device,
                      a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      None if ws is None else ws.data_ptr(), *dims, splits,
                      chunk)


def plain_matmul_at_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 ``aᵀ·b`` (TF32 off): the reference's Pallas product as one
    PyTorch product, what the kernel is held against on the card."""
    return a.T @ b


def _check_at_b(a: torch.Tensor, b: torch.Tensor) -> None:
    """Refuse what the aᵀ·b kernel does not take (the CPU branch is held
    to the same contract)."""
    if a.device.type not in ("cpu", "cuda") or b.device != a.device:
        raise ValueError(f"matmul_at_b: operands on {a.device} and "
                         f"{b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"matmul_at_b: operands must be float32, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"matmul_at_b: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} share no rows")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul_at_b: operands must be row-major "
                         "(contiguous)")
    k, n = a.shape[1], b.shape[1]
    if max(a.numel(), b.numel(), k * n) >= _INT32:
        raise ValueError("matmul_at_b: shape exceeds int32")
    if _ceil(n, _tc_width(n)) > _MAX_GRID_Y:
        raise ValueError(f"matmul_at_b: {n} columns exceed the kernel's "
                         f"grid")


class MatmulPlan(NamedTuple):
    """``matmul``'s launch choice: the C tile's width; 1 where A is kept
    M-major in shared memory (its m stride is 1: a transposed view), 1
    where B is kept K-major (its k stride is 1); the floats a copy of A
    and of B moves (4 or 1); the split of the depth (splits, chunk)."""
    bn: int
    a_mmajor: int
    b_kmajor: int
    vec_a: int
    vec_b: int
    splits: int
    chunk: int


def _copy_width(inner_stride: int, inner_extent: int, outer_stride: int,
                aligned: bool) -> int:
    """4 floats a copy along an operand's inner axis where it has stride 1
    and an extent that is a multiple of 4, its other stride is a multiple
    of 4 and its base is 16-byte aligned; else 1."""
    return 4 if (inner_stride == 1 and inner_extent % 4 == 0
                 and outer_stride % 4 == 0 and aligned) else 1


def matmul_plan(a_shape, a_stride, b_shape, b_stride, a_aligned: bool = True,
                b_aligned: bool = True) -> MatmulPlan:
    """The launch of ``matmul`` for A (M, K) and B (K, N) with these
    strides (in elements) and bases 16-byte aligned or not: A M-major where
    its m stride is 1 and its k stride is not, else K-major; B K-major
    where its k stride is 1 and its n stride is not, else N-major; copy
    widths along each one's inner axis (``_copy_width``); the width
    ``_tc_width(N)``; the depth split ``tc_split_plan``."""
    (m, k), n = a_shape, b_shape[1]
    sam, sak = a_stride
    sbk, sbn = b_stride
    a_mmajor = int(sam == 1 and sak != 1)
    b_kmajor = int(sbk == 1 and sbn != 1)
    vec_a = (_copy_width(sam, m, sak, a_aligned) if a_mmajor
             else _copy_width(sak, k, sam, a_aligned))
    vec_b = (_copy_width(sbk, k, sbn, b_aligned) if b_kmajor
             else _copy_width(sbn, n, sbk, b_aligned))
    bn = _tc_width(n)
    return MatmulPlan(bn, a_mmajor, b_kmajor, vec_a, vec_b,
                      *tc_split_plan(k, m, n, bn))


def launch_matmul(a: torch.Tensor, b: torch.Tensor,
                  plan: MatmulPlan) -> torch.Tensor:
    """C = a·b on the card by ``plan`` (the workspace allocated here when
    it splits the depth), without counting a launch: ``matmul``'s CUDA
    branch, and what a measurement that sets its own plan calls."""
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    launch_split("matmul", "znicz_matmul_f32", _ARGTYPES, a, b, c, m, n,
                 (m, n, k, *a.stride(), *b.stride(), *plan[:5]), plan[5:])
    return c


def at_b_plan(m: int, k: int, n: int, aligned: bool = True) -> MatmulPlan:
    """The launch of ``matmul_at_b`` for row-major a (M, K) and b (M, N),
    their bases 16-byte aligned or not: ``matmul_plan`` of A = aᵀ, the
    (K, M) view with strides (1, K), and B = b with strides (N, 1), so the
    depth is M."""
    return matmul_plan((k, m), (1, k), (m, n), (n, 1), aligned, aligned)


def matmul_at_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, N) float32 ``aᵀ·b`` of row-major (M, K) and (M, N) float32
    matrices, without a transposed copy of ``a``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_at_b(a, b)
    if a.device.type == "cpu":
        return plain_matmul_at_b(a, b)
    m, k = a.shape
    n = b.shape[1]
    if k == 0 or n == 0:
        return torch.empty((k, n), dtype=torch.float32, device=a.device)
    # the strides the plan takes: a contiguous tensor's stride is free along
    # an axis of extent 0 or 1 (an empty array from numpy has (0, 0)), and
    # the kernel would refuse a 16-byte copy along one that is not 4k
    c = launch_matmul(a.as_strided((k, m), (1, k)),
                      b.as_strided((m, n), (n, 1)), at_b_plan(
        m, k, n, a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0))
    count_launch(__name__, "matmul_at_b_launches")
    return c


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 product of (M, K) and (K, N) float32 matrices, which
    may be strided views (a transpose included): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check(a, b)
    if a.device.type == "cpu":
        return plain_matmul(a, b)
    m, n = a.shape[0], b.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=torch.float32, device=a.device)
    c = launch_matmul(a, b, matmul_plan(
        a.shape, a.stride(), b.shape, b.stride(), a.data_ptr() % 16 == 0,
        b.data_ptr() % 16 == 0))
    count_launch(__name__, "matmul_launches")
    return c
