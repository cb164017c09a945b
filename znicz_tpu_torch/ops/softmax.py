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

Both kernels launch under ``softmax_plan``: narrow rows (C ≤ 32) take G
lanes a row in small blocks, register rows (C ≤ ``REGISTER_LIMIT``) one
block a row holding the row in registers, wider rows one block a row in
three passes (``csrc/softmax_row.cuh``).

A CUDA tensor never falls back to a plain version: the kernel launches or
the call raises."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from . import count_launch

#: Launches of the row softmax kernel in this process (the CUDA branch of
#: ``softmax`` adds one per launch, nowhere else).
softmax_launches = 0

#: Launches of the softmax-CE kernel in this process (the CUDA branch of
#: ``softmax_ce_from_logits`` adds one per launch, nowhere else).
softmax_ce_launches = 0

#: N, C, then the plan: form, threads, lanes a row, vector width, vectors a
#: lane or thread
_PLAN_ARGTYPES = [ctypes.c_int] * 7
#: x, labels, probs, loss, err, N, C, plan, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + _PLAN_ARGTYPES + [ctypes.c_void_p]
#: x, y, idx, N, C, plan, stream
_SOFTMAX_ARGTYPES = ([ctypes.c_void_p] * 3 + _PLAN_ARGTYPES
                     + [ctypes.c_void_p])

#: the kernels' forms, in the order ``csrc/softmax_row.cuh`` numbers them
FORMS = ("narrow", "register", "streaming")
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132
#: the widest row of the narrow form (a row within a warp's lanes)
NARROW_MAX = 32
#: floats a lane of the narrow form holds, at least (a vector where V = 4):
#: 8 lanes a row at C = 10; 1, 2 or 4 lanes took 0.1–1.9 µs longer on an
#: H100, 16 or 32 the same within 0.1 µs (``softmax_probe``)
NARROW_LANE_FLOATS = 2
#: threads a block of the narrow form at most; halved, down to one warp,
#: while the launch has fewer blocks than the card has SMs
NARROW_THREADS = 256
#: the widest row of the register form; wider rows stream (at C = 4096 the
#: register form was 10–11% faster on an H100, ``softmax_probe``)
REGISTER_LIMIT = 4096
#: floats a thread of the register form holds, about: 128 threads at
#: C = 1000, the fastest of 64-256 at (1024, 1000) (``softmax_probe``)
REGISTER_THREAD_FLOATS = 8
#: threads a block of the register form, fewest and most
REGISTER_THREADS = (64, 256)
#: floats a thread of the register form holds at most (the instances
#: ``csrc/softmax_row.cuh`` compiles: ``kRegisterFloats``)
REGISTER_FLOATS = 16
#: threads a block of the streaming form
STREAM_THREADS = 512


class SoftmaxPlan(NamedTuple):
    """A launch of either softmax kernel: its form, threads a block, lanes
    a row (``group``; 0 where a block takes a row), vector width (4 floats
    or 1), vectors a lane or thread (``per``; 0 in the streaming form) and
    blocks."""
    form: str
    threads: int
    group: int
    vec: int
    per: int
    blocks: int


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def narrow_plan(n: int, c: int, vec: int, group: int,
                n_sm: int = H100_SMS) -> SoftmaxPlan:
    """The narrow form: ``group`` lanes a row, each holding the fewest
    vectors (a power of two) that cover the row; ``NARROW_THREADS`` threads
    a block, halved down to a warp while the blocks are fewer than the
    SMs."""
    per = _pow2_ceil(math.ceil(math.ceil(c / vec) / group))
    threads = NARROW_THREADS
    while threads > 32 and math.ceil(n * group / threads) < n_sm:
        threads //= 2
    return SoftmaxPlan("narrow", threads, group, vec, per,
                       math.ceil(n / (threads // group)))


def register_plan(n: int, c: int, vec: int, threads: int) -> SoftmaxPlan:
    """The register form: one block of ``threads`` a row, each thread
    holding the fewest vectors (a power of two) that cover the row."""
    per = _pow2_ceil(math.ceil(math.ceil(c / vec) / threads))
    return SoftmaxPlan("register", threads, 0, vec, per, n)


def streaming_plan(n: int, vec: int,
                   threads: int = STREAM_THREADS) -> SoftmaxPlan:
    """The streaming form: one block of ``threads`` a row, three passes."""
    return SoftmaxPlan("streaming", threads, 0, vec, 0, n)


def softmax_plan(n: int, c: int, aligned: bool = True,
                 n_sm: int = H100_SMS) -> SoftmaxPlan:
    """The launch of the softmax kernels over n rows of c floats whose
    bases are 16-byte aligned or not, on a card of ``n_sm`` SMs.  16-byte
    vectors where C % 4 == 0 and the bases are aligned (the C entry points
    refuse them elsewhere).  C ≤ ``NARROW_MAX``: the narrow form, about
    ``NARROW_LANE_FLOATS`` floats a lane (the group a power of two up to
    32); C ≤ ``REGISTER_LIMIT``: the register form, about
    ``REGISTER_THREAD_FLOATS`` floats a thread (a power of two within
    ``REGISTER_THREADS``); wider: the streaming form."""
    vec = 4 if c % 4 == 0 and aligned else 1
    if c <= NARROW_MAX:
        per_lane = max(1, NARROW_LANE_FLOATS // vec)
        group = min(32, _pow2_ceil(math.ceil(math.ceil(c / vec)
                                             / per_lane)))
        return narrow_plan(n, c, vec, group, n_sm)
    if c <= REGISTER_LIMIT:
        lo, hi = REGISTER_THREADS
        threads = min(hi, max(lo, _pow2_ceil(
            math.ceil(c / REGISTER_THREAD_FLOATS))))
        return register_plan(n, c, vec, threads)
    return streaming_plan(n, vec)


def plan_for(x: torch.Tensor) -> SoftmaxPlan:
    """The plan of a launch over the rows of CUDA tensor ``x`` on its card
    (the wrappers' outputs are fresh allocations, 16-byte aligned)."""
    n, c = x.shape
    return softmax_plan(
        n, c, x.data_ptr() % 16 == 0,
        torch.cuda.get_device_properties(x.device).multi_processor_count)


def plan_args(plan: SoftmaxPlan) -> tuple:
    """The plan as the C entry points take it."""
    return (FORMS.index(plan.form), plan.threads, plan.group, plan.vec,
            plan.per)


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
        x.device, x.data_ptr(), y.data_ptr(), idx.data_ptr(), n, c,
        *plan_args(plan_for(x)))
    count_launch(__name__, "softmax_launches")
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
        probs.data_ptr(), loss.data_ptr(), err.data_ptr(), n, c,
        *plan_args(plan_for(logits)))
    count_launch(__name__, "softmax_ce_launches")
    return probs, loss, err
