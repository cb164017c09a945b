"""Fused softmax + cross-entropy + error head (port of
``znicz_tpu/ops/softmax.py``).

``softmax_ce_from_logits`` is the loss head of the fused train step.  On a
CUDA tensor it launches the hand-written kernel in
``csrc/softmax_ce.cu`` (the port of ``pallas_softmax_ce_from_logits``);
on a CPU tensor it runs ``plain_softmax_ce_from_logits``, the torch
transcription of the reference's XLA tier, which is also what the kernel
is held against on the card.  A CUDA tensor never falls back to the plain
version: the kernel launches or the call raises."""

from __future__ import annotations

import ctypes

import torch

#: Launches of the softmax-CE kernel in this process (the CUDA branch of
#: ``softmax_ce_from_logits`` adds one per launch, nowhere else).
softmax_ce_launches = 0

_fn = None


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


def _kernel():
    """The C entry point of csrc/softmax_ce.cu, built at first use."""
    global _fn
    if _fn is None:
        from .. import cuda_build
        fn = cuda_build.load("softmax_ce").znicz_softmax_ce_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"softmax_ce_from_logits: unsupported device "
                         f"{logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"softmax_ce_from_logits: logits must be float32, "
                        f"got {logits.dtype}")
    if logits.dim() != 2 or logits.shape[0] == 0 or logits.shape[1] == 0:
        raise ValueError(f"softmax_ce_from_logits: logits must be a "
                         f"non-empty (N, C) matrix, got "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("softmax_ce_from_logits: logits must be "
                         "contiguous")
    n, c = logits.shape
    if n >= 2 ** 31 or c >= 2 ** 31:
        raise ValueError("softmax_ce_from_logits: shape exceeds int32")
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
    with torch.cuda.device(logits.device):
        status = _kernel()(logits.data_ptr(), labels.data_ptr(),
                           probs.data_ptr(), loss.data_ptr(),
                           err.data_ptr(), n, c,
                           torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"softmax_ce kernel launch failed: CUDA error "
                           f"{status}")
    softmax_ce_launches += 1
    return probs, loss, err
