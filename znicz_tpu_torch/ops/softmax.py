"""Row softmax + argmax, and the fused softmax + cross-entropy + error
head (port of ``znicz_tpu/ops/softmax.py``).

``softmax_ce_from_logits`` is the loss head of the fused train step.  On a
CUDA tensor it launches the hand-written kernel in
``csrc/softmax_ce.cu`` (the port of ``pallas_softmax_ce_from_logits``);
on a CPU tensor it runs ``plain_softmax_ce_from_logits``, the torch
transcription of the reference's XLA tier, which is also what the kernel
is held against on the card.

``softmax`` is the unit graph's ``All2AllSoftmax`` head: probabilities and
the argmax of each row, through ``csrc/softmax.cu`` on CUDA tensors (the
port of ``pallas_softmax``) and ``plain_softmax`` on CPU tensors.  The
numpy goldens ``np_softmax``/``np_softmax_ce`` serve the unit graph's
numpy device and its host-side evaluator.

A CUDA tensor never falls back to a plain version: the kernel launches or
the call raises."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

#: Launches of the row softmax kernel in this process (the CUDA branch of
#: ``softmax`` adds one per launch, nowhere else).
softmax_launches = 0

#: Launches of the softmax-CE kernel in this process (the CUDA branch of
#: ``softmax_ce_from_logits`` adds one per launch, nowhere else).
softmax_ce_launches = 0

#: x, labels, probs, loss, err, N, C, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
#: x, y, idx, N, C, stream
_SOFTMAX_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p])


# -- numpy goldens -------------------------------------------------------------
def np_softmax(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(row softmax, argmax) — the reference's ``np_softmax``."""
    m = x.max(axis=1, keepdims=True)
    e = np.exp(x - m)
    y = e / e.sum(axis=1, keepdims=True)
    return y, x.argmax(axis=1)


def np_softmax_ce(probs: np.ndarray, labels: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(per-row CE loss, error signal y − onehot) from softmax outputs —
    the reference's ``np_softmax_ce``, with which its evaluator scores
    All2AllSoftmax's probabilities."""
    n, c = probs.shape
    onehot = np.zeros_like(probs)
    onehot[np.arange(n), labels] = 1.0
    loss = -np.log(np.maximum(probs[np.arange(n), labels], 1e-30))
    return loss, probs - onehot


# -- row softmax + argmax --------------------------------------------------------
def plain_softmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(probabilities, int32 argmax) step by step as the reference's
    ``_softmax_kernel``: m = max x, e = exp(x − m), y = e / Σe, and the
    first index of the maximum of x."""
    m = torch.amax(x, dim=1, keepdim=True)
    e = torch.exp(x - m)
    y = e / torch.sum(e, dim=1, keepdim=True)
    return y, torch.argmax(x, dim=1).to(torch.int32)


def _check_rows(who: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{who}: input must be float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"{who}: input must be a non-empty (N, C) matrix, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: input must be contiguous")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"{who}: shape exceeds int32")


def softmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(probabilities, int32 argmax) of (N, C) contiguous float32 rows: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    global softmax_launches
    _check_rows("softmax", x)
    if x.device.type == "cpu":
        return plain_softmax(x)
    n, c = x.shape
    y = torch.empty_like(x)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("softmax", "znicz_row_softmax_f32",
                          _SOFTMAX_ARGTYPES),
        x.device, x.data_ptr(), y.data_ptr(), idx.data_ptr(), n, c)
    softmax_launches += 1
    return y, idx


# -- fused softmax + cross-entropy -------------------------------------------------


def plain_softmax_ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(probs, per-row loss, err = probs − onehot) — the reference's
    ``xla_softmax_ce_from_logits``.  A label outside [0, C) one-hots to an
    all-zero row (loss 0, err = probs), as ``jax.nn.one_hot`` does."""
    c = logits.shape[1]
    m = torch.amax(logits, dim=1, keepdim=True)
    sh = logits - m
    lse = torch.log(torch.sum(torch.exp(sh), dim=1, keepdim=True))
    logp = sh - lse
    y = torch.exp(logp)
    onehot = (torch.arange(c, device=logits.device)
              == labels.reshape(-1, 1)).to(logits.dtype)
    loss = -torch.sum(logp * onehot, dim=1)
    return y, loss, y - onehot


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    _check_rows("softmax_ce_from_logits", logits)
    n = logits.shape[0]
    if tuple(labels.shape) != (n,):
        raise ValueError(f"softmax_ce_from_logits: labels must be ({n},), "
                         f"got {tuple(labels.shape)}")
    if labels.device != logits.device:
        raise ValueError(f"softmax_ce_from_logits: labels on "
                         f"{labels.device}, logits on {logits.device}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.dtype == torch.bool:
        raise TypeError(f"softmax_ce_from_logits: labels must be integers, "
                        f"got {labels.dtype}")


def softmax_ce_from_logits(logits: torch.Tensor, labels: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(probs, per-row loss, err) from (N, C) contiguous float32 logits and
    (N,) integer labels: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global softmax_ce_launches
    _check(logits, labels)
    if logits.device.type == "cpu":
        return plain_softmax_ce_from_logits(logits, labels)
    n, c = logits.shape
    labels = labels.to(torch.int32).contiguous()
    probs = torch.empty_like(logits)
    err = torch.empty_like(logits)
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    from .. import cuda_build
    cuda_build.launch(
        cuda_build.kernel("softmax_ce", "znicz_softmax_ce_f32", _ARGTYPES),
        logits.device, logits.data_ptr(), labels.data_ptr(),
        probs.data_ptr(), loss.data_ptr(), err.data_ptr(), n, c)
    softmax_ce_launches += 1
    return probs, loss, err
