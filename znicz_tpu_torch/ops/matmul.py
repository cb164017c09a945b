"""Matrix product of the unit graph's fc units (port of
``znicz_tpu/ops/matmul.py``).

``matmul(a, b)`` is the product ``All2All`` and ``GradientDescent`` call
(``x·W``, ``xᵀ·err_y``, ``err_y·Wᵀ``).  On CUDA tensors it launches the
hand-written tiled SGEMM in ``csrc/matmul.cu`` (the port of
``pallas_matmul``), which reads each operand through its strides, so a
transposed view costs no copy; on CPU tensors it runs
``plain_matmul``.  Both compute in full float32: the reference's bf16
operand cast is a TPU-only device (``_mxu_cast``), and TF32 is off
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

#: a, b, c, M, N, K, A strides (m, k), B strides (k, n), stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])

#: the kernel's tile of C (blocks along M are the grid's y dimension)
_BM = 64
_MAX_GRID_Y = 65535


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
