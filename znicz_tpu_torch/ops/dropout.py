"""Inverted dropout keyed by the counter RNG (port of
``znicz_tpu/ops/dropout.py``).

The keep mask is a pure function of ``(stream seed, unit id, epoch,
counter)`` and the element's flat (NHWC) index: ``rngbits.fold`` makes the
key on the host, and element i is kept when
``(fmix32(i·C2 ^ key) ≫ 8) · 2⁻²⁴ ≥ float32(ratio)``; a kept element is
scaled by ``float32(1/(1−ratio))``.  The backward regenerates the same mask
from the same key, so ``dropout`` serves both directions (x forward, err
backward) and no mask is ever stored.

On a CUDA tensor ``dropout`` launches the hand-written kernel of
``csrc/dropout.cu``; on a CPU tensor it runs ``plain_dropout``, the mask
multiply of the reference's fused path.  A CUDA tensor never falls back.

``index=(base, width, row, col)`` draws a shard's mask as the whole
tensor's at the shard's elements (``rngbits.flat_index``): a data shard
of the global batch (``base`` = its first row's offset), a model shard of
the channels (``width`` of ``row`` channels, from ``col``), so a sharded
step drops what the reference's mesh step drops over the global batch.
None (the whole tensor) is the kernel's (0, n, n, 0).
x may be in any of the fused step's storage dtypes (the forward over a
stored activation): the product is formed in float32 and rounded once to
x's dtype."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import (STORAGE_DTYPES, STORAGE_SUFFIX, count_launch, form_counter,
               rngbits)

#: Launches of the dropout kernel in this process, one counter a storage
#: dtype (the CUDA branch of ``dropout`` adds one per launch, nowhere
#: else).
dropout_launches = 0
dropout_bf16_launches = 0
dropout_f16_launches = 0

#: x, out, n, key, ratio, scale, base, width, row, col, stream
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_uint32,
                                     ctypes.c_float, ctypes.c_float,
                                     ctypes.c_uint32, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p]


def _scale(ratio: float) -> np.float32:
    return np.float32(1.0 / (1.0 - ratio))


def mask_from_key(key: int, shape, ratio: float, device="cpu", index=None):
    """0 / float32(1/(1−ratio)) mask of ``shape`` for a folded key (a
    shard's at ``index``, see the module's docstring).  The
    ratio and the scale are rounded to float32 on the host first, so the
    compare and the product see the reference's float32 values whatever
    precision torch gives a Python scalar (and no host tensor is copied
    to the device, which a CUDA graph could not capture)."""
    n = int(np.prod(shape))
    u = rngbits.uniform01(key, n, device, index).reshape(tuple(shape))
    keep = u >= float(np.float32(ratio))
    return keep.to(torch.float32) * float(_scale(ratio))


def plain_make_mask(stream_seed: int, counters, shape, ratio: float,
                    device="cpu"):
    """The reference's ``make_mask``; ``counters`` = (unit_id, epoch,
    counter)."""
    return mask_from_key(rngbits.fold(stream_seed, *counters), shape, ratio,
                         device)


def plain_dropout(x: torch.Tensor, key: int, ratio: float, index=None
                  ) -> torch.Tensor:
    """x · mask, as the reference's fused forward and backward apply it
    (a narrow x in float32, the product rounded once to its dtype)."""
    return (x.float() * mask_from_key(key, x.shape, ratio, x.device,
                                      index)).to(x.dtype)


def index_args(index, n: int) -> tuple[int, int, int, int]:
    """The kernel's (base, width, row, col) for ``index`` (None: the
    whole tensor, (0, n, n, 0)), checked against the kernel's int32
    arithmetic."""
    if index is None:
        return 0, n, n, 0
    base, width, row, col = (int(v) for v in index)
    if not (0 < width <= row and 0 <= col <= row - width
            and n % width == 0 and row < 2 ** 31):
        raise ValueError(f"dropout: index {index} is no shard of rows for "
                         f"{n} elements")
    return base & rngbits.MASK32, width, row, col


def _check(x: torch.Tensor, ratio: float) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dropout: unsupported device {x.device}")
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"dropout: x must be one of {STORAGE_DTYPES}, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("dropout: x must be contiguous")
    if x.numel() >= 2 ** 31:
        raise ValueError("dropout: 2^31 elements or more (the kernel "
                         "indexes in int32)")
    if not 0.0 <= ratio < 1.0:
        raise ValueError(f"dropout: ratio must be in [0, 1), got {ratio}")


def dropout(x: torch.Tensor, key: int, ratio: float, index=None
            ) -> torch.Tensor:
    """x · mask(key) for a contiguous tensor in a storage dtype (out in
    its dtype): the CUDA kernel for a CUDA tensor, the plain version for a
    CPU tensor.  ``key`` is the host-folded u32 key (``rngbits.fold``);
    ``index`` places a shard's elements in the whole tensor."""
    ratio = float(ratio)
    _check(x, ratio)
    args = index_args(index, x.numel())
    if x.device.type == "cpu":
        return plain_dropout(x, key, ratio, index)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("dropout", f"znicz_dropout_"
                          f"{STORAGE_SUFFIX[x.dtype]}", _ARGTYPES),
        x.device, x.data_ptr(), out.data_ptr(), x.numel(),
        int(key) & rngbits.MASK32, float(np.float32(ratio)),
        float(_scale(ratio)), *args)
    count_launch(__name__, form_counter("dropout", x.dtype))
    return out
