"""Matrix product of the unit graph's fc units (port of
``znicz_tpu/ops/matmul.py``).

``matmul(a, b)`` is the product ``All2All`` and ``GradientDescent`` call
(``x·W``, ``xᵀ·err_y``, ``err_y·Wᵀ``).  On CUDA tensors it launches the
hand-written tiled SGEMM in ``csrc/matmul.cu`` (the port of
``pallas_matmul``), which reads each operand through its strides, so a
transposed view costs no copy; on CPU tensors it runs
``plain_matmul``.

``matmul_at_b(a, b)`` is ``aᵀ·b`` of row-major ``a (M, K)`` and
``b (M, N)`` over their shared rows, the weight-gradient shape (M huge,
the output small): on CUDA tensors the split-M kernel of
``csrc/matmul_at_b.cu`` (the port of ``pallas_matmul_at_b``), which
never makes ``aᵀ`` and sums its splits in a fixed order; on CPU tensors
``plain_matmul_at_b``.  The implicit-GEMM conv tier's weight gradient
(``ops/conv.py``) runs the same kernel template with its patch operand
gathered from the image.

All compute in full float32: the reference's bf16 operand cast is a
TPU-only device (``_mxu_cast``), and TF32 is off
(``znicz_tpu_torch/__init__.py``).  The fused step's fc products stay
``torch.matmul``, as the JAX fused step leaves them to XLA.  A CUDA
tensor never falls back to the plain version."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: Launches of the matmul kernel in this process (the CUDA branch of
#: ``matmul`` adds one per launch, nowhere else).
matmul_launches = 0
#: Launches of the aᵀ·b kernel (its split products and their sum count as
#: one), added by the CUDA branch of ``matmul_at_b`` only.
matmul_at_b_launches = 0

#: a, b, c, M, N, K, A strides (m, k), B strides (k, n), stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])

#: a, b, out, workspace, M, K, N, splits, chunk, stream
_AT_B_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p])

#: the kernels' tile of C (blocks along M are matmul's grid y dimension)
_BM = 64
_MAX_GRID_Y = 65535
#: the split products' depth step (rows of the reduction a shared-memory
#: step takes), the blocks they aim for (two on each of an H100's 132 SMs)
#: and the least rows a split takes
_STEP = 16
_TARGET_BLOCKS = 264
_MIN_CHUNK = 256
_INT32 = 2 ** 31


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
    if -(-m // _BM) > _MAX_GRID_Y:
        raise ValueError(f"matmul: {m} rows exceed the kernel's grid")
    if min(a.stride() + b.stride()) < 0:
        raise ValueError("matmul: negative strides are not taken")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(depth: int, rows: int, cols: int) -> tuple[int, int]:
    """(splits, chunk) for a product of a (rows, cols) output summed over
    ``depth`` > 0: split the depth until the grid has at least
    ``_TARGET_BLOCKS`` blocks, or into chunks of ``_MIN_CHUNK`` rows if
    that comes first; each chunk a multiple of the kernel's 16-row step,
    none empty."""
    tiles = _ceil(rows, _BM) * _ceil(cols, _BM)
    splits = min(_ceil(_TARGET_BLOCKS, tiles), depth // _MIN_CHUNK)
    if splits <= 1:
        return 1, _ceil(depth, _STEP) * _STEP
    chunk = depth // splits // _STEP * _STEP      # rounded down: ≥ splits
    return _ceil(depth, chunk), chunk


def launch_split(library: str, entry: str, argtypes: list, a, b, out,
                 rows: int, cols: int, depth: int, dims: tuple) -> None:
    """Launch a split-depth product (``csrc/gemm_tile.cuh`` ``at_b_block``)
    of operands ``a`` and ``b`` into ``out``, a (rows, cols) matrix summed
    over ``depth``: ``entry(a, b, out, workspace, *dims, splits, chunk,
    stream)``, with the workspace (splits, rows, cols) allocated here when
    the depth is split."""
    splits, chunk = split_plan(depth, rows, cols)
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
    if _ceil(n, _BM) > _MAX_GRID_Y:
        raise ValueError(f"matmul_at_b: {n} columns exceed the kernel's "
                         f"grid")


def matmul_at_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(K, N) float32 ``aᵀ·b`` of row-major (M, K) and (M, N) float32
    matrices, without a transposed copy of ``a``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global matmul_at_b_launches
    _check_at_b(a, b)
    if a.device.type == "cpu":
        return plain_matmul_at_b(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((k, n), dtype=torch.float32, device=a.device)
    if k == 0 or n == 0:
        return out
    if m == 0:
        return out.zero_()
    launch_split("matmul_at_b", "znicz_matmul_at_b_f32", _AT_B_ARGTYPES, a,
                 b, out, k, n, m, (m, k, n))
    matmul_at_b_launches += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, N) float32 product of (M, K) and (K, N) float32 matrices, which
    may be strided views (a transpose included): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    global matmul_launches
    _check(a, b)
    if a.device.type == "cpu":
        return plain_matmul(a, b)
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return c
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("matmul", "znicz_matmul_f32", _ARGTYPES),
        a.device, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
        *a.stride(), *b.stride())
    matmul_launches += 1
    return c
