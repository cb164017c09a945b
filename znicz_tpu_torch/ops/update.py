"""Fused parameter update: SGD + momentum + L1/L2 decay (port of
``znicz_tpu/ops/update.py``).

The rule, in the reference's order of operations::

    reg  = weights_decay · ((1 − l1_vs_l2)·w + ½·l1_vs_l2·sign(w))
    vel' = gradient_moment · vel − (learning_rate · s) · (grad + reg)
    w'   = w + vel'

``s`` is the step's learning-rate scale (the fused path's LR schedule), a
one-element float32 tensor on the entry's device that the kernel reads
from device memory, so a CUDA graph that captured the update follows a
schedule; ``learning_rate · s`` is rounded to float32 first, as the
reference's ``lr * lr_scale * (g + reg)`` does.  An entry without one
takes s = 1, and is updated as it was before the scale existed.

``sgd_update_many(entries, inplace=False)`` updates a list of tensors,
each entry ``(w, grad, vel, constants)`` or ``(w, grad, vel, constants,
s)``: on CUDA tensors in one launch of the hand-written kernel in
``csrc/update.cu`` (the port of ``pallas_sgd_update``), on CPU tensors
through ``plain_sgd_update_many``.  With ``inplace`` w′ and vel′ are
written over w and vel (the fused step's parameters and velocities, as
the reference donates them); no tensor may then appear twice among a
call's inputs, since an entry's outputs are another's inputs there.
``constants`` = (lr, weights_decay, 1 − l1_vs_l2, ½·l1_vs_l2, momentum) as
float32 values, formed by the caller's convention: ``unit_constants`` for
the unit graph's GD units (the reference's f32 hypers array, ``1 − l1``
formed in float32), ``fused_constants`` for the fused step (each constant
formed from the Python hypers and rounded once, as torch rounds a Python
scalar).  Both versions round once per operation with no fused
multiply-add, so they agree bit for bit.  A CUDA tensor never falls back
to the plain version.  ``sgd_update(w, grad, vel, hypers)`` is the
one-entry form with the unit graph's constants."""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import count_launch

#: Launches of the update kernel in this process (the CUDA branch of
#: ``sgd_update_many`` adds one per launch, nowhere else).
sgd_update_launches = 0

#: ptrs (6 an entry), ns, consts (5 an entry), count, launched, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p]


def np_sgd_update(w, grad, vel, lr, weights_decay=0.0, l1_vs_l2=0.0,
                  momentum=0.0):
    """The numpy golden (the reference's ``np_sgd_update``); returns
    (w', vel')."""
    reg = weights_decay * ((1.0 - l1_vs_l2) * w
                           + 0.5 * l1_vs_l2 * np.sign(w))
    g = grad + reg
    vel_new = momentum * vel - lr * g
    return (w + vel_new).astype(w.dtype), vel_new.astype(vel.dtype)


def f32_hypers(hypers) -> tuple[float, float, float, float]:
    """(lr, weights_decay, l1_vs_l2, momentum) rounded to float32, as
    Python floats (exactly representable in float32)."""
    lr, wd, l1, mom = (float(np.float32(h)) for h in hypers)
    return lr, wd, l1, mom


def unit_constants(hypers) -> tuple[float, ...]:
    """The unit graph's constants: the hypers rounded to float32, then
    ``1 − l1`` and ``½·l1`` formed in float32, as the reference's kernel
    forms them from its f32 hypers array."""
    return _unit_constants(tuple(hypers))


def fused_constants(hypers) -> tuple[float, ...]:
    """The fused step's constants: ``1.0 − l1`` and ``0.5·l1`` formed from
    the Python hypers, then every constant rounded once to float32, as
    torch rounds a Python scalar operand of a float32 tensor."""
    return _fused_constants(tuple(hypers))


@functools.lru_cache(maxsize=256)
def _unit_constants(hypers: tuple) -> tuple[float, ...]:
    lr, wd, l1, mom = f32_hypers(hypers)
    return (lr, wd, float(np.float32(1.0) - np.float32(l1)),
            float(np.float32(0.5) * np.float32(l1)), mom)


@functools.lru_cache(maxsize=256)
def _fused_constants(hypers: tuple) -> tuple[float, ...]:
    lr, wd, l1, mom = (float(h) for h in hypers)
    return tuple(float(np.float32(c))
                 for c in (lr, wd, 1.0 - l1, 0.5 * l1, mom))


def _scale(entry):
    """The entry's scale tensor s, or None (s = 1)."""
    return entry[4] if len(entry) > 4 else None


def plain_sgd_update_many(entries, inplace: bool = False
                          ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(w', vel')] of each entry ``(w, grad, vel, constants[, s])`` with
    the reference kernel's float32 arithmetic, one rounded operation at a
    time; ``sign(±0) = 0``; ``lr · s`` rounded first.  With ``inplace``
    the results are written over w and vel, and those are returned."""
    out = []
    for e in entries:
        w, grad, vel, (lr, wd, one_minus_l1, half_l1, mom) = e[:4]
        s = _scale(e)
        if s is not None:
            lr = s.reshape(()) * lr
        reg = wd * (one_minus_l1 * w + half_l1 * torch.sign(w))
        vel_new = mom * vel - lr * (grad + reg)
        w_new = w + vel_new
        if inplace:
            vel.copy_(vel_new)
            w.copy_(w_new)
            w_new, vel_new = w, vel
        out.append((w_new, vel_new))
    return out


def plain_sgd_update(w: torch.Tensor, grad: torch.Tensor, vel: torch.Tensor,
                     hypers) -> tuple[torch.Tensor, torch.Tensor]:
    """(w', vel') of one tensor with the unit graph's constants."""
    return plain_sgd_update_many([(w, grad, vel, unit_constants(hypers))])[0]


def _check(entries) -> None:
    """Refuse what the kernel does not take; the CPU branch is held to the
    same contract so both devices accept the same inputs."""
    if not entries:
        return
    device = entries[0][0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"sgd_update: unsupported device {device}")
    for k, e in enumerate(entries):
        if len(e) not in (4, 5):
            raise ValueError(f"sgd_update: entry {k} has {len(e)} items, "
                             f"not (w, grad, vel, constants[, s])")
        w, grad, vel, consts = e[:4]
        if len(consts) != 5:
            raise ValueError(f"sgd_update: entry {k} has {len(consts)} "
                             f"constants, not 5")
        s = _scale(e)
        if s is not None and (s.device != device or s.numel() != 1
                              or s.dtype != torch.float32):
            raise ValueError(f"sgd_update: entry {k}'s scale must be one "
                             f"float32 on {device}")
        for name, t in (("w", w), ("grad", grad), ("vel", vel)):
            if t.device != device:
                raise ValueError(f"sgd_update: entry {k} {name} on "
                                 f"{t.device}, entry 0 w on {device}")
            if t.shape != w.shape:
                raise ValueError(f"sgd_update: entry {k} {name} is "
                                 f"{tuple(t.shape)}, w is {tuple(w.shape)}")
            if t.dtype != torch.float32:
                raise TypeError(f"sgd_update: entry {k} {name} must be "
                                f"float32, got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"sgd_update: entry {k} {name} must be "
                                 f"contiguous")
    seen: dict = {}
    for k, e in enumerate(entries):
        for name, t in zip(("w", "grad", "vel"), e[:3]):
            if t.numel() == 0:
                continue
            ptr = t.data_ptr()
            if ptr in seen:
                raise ValueError(f"sgd_update: entry {k} {name} is also "
                                 f"{seen[ptr]} of this call")
            seen[ptr] = f"entry {k} {name}"


def sgd_update_many(entries, inplace: bool = False
                    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(w', vel')] of each entry ``(w, grad, vel, constants[, s])``:
    contiguous float32 tensors of one shape an entry, all on one device,
    and no tensor twice among them.  CUDA tensors go through the kernel, in
    one launch for up to 48 entries; CPU tensors through the plain version.
    Outputs are fresh (on the card views into one buffer for every w' and
    one for every vel') and the inputs are left as they were, or with
    ``inplace`` w′ and vel′ are written over w and vel.  Every entry reads
    its inputs as given: an update that must read another entry's w' (a
    tied deconv's, in the fused step) belongs in a later call."""
    entries = list(entries)
    _check(entries)
    if not entries or entries[0][0].device.type == "cpu":
        return plain_sgd_update_many(entries, inplace)
    from .. import cuda_build
    outs = ([(w, v) for w, _, v, *_ in entries] if inplace
            else empty_outputs(entries))
    count_launch(__name__, "sgd_update_launches", launch_many(
        cuda_build.kernel("update", "znicz_sgd_update_many_f32", _ARGTYPES),
        entries, outs))
    return outs


def empty_outputs(entries) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """[(w', vel')] of each entry as views into two fresh buffers, each
    entry's starting on a 16-byte boundary."""
    offsets, total = [], 0
    for w, *_ in entries:
        offsets.append(total)
        total += -(-w.numel() // 4) * 4
    w_buf = torch.empty(total, dtype=torch.float32,
                        device=entries[0][0].device)
    v_buf = torch.empty_like(w_buf)
    return [(torch.as_strided(w_buf, w.shape, w.stride(), o),
             torch.as_strided(v_buf, w.shape, w.stride(), o))
            for (w, *_), o in zip(entries, offsets)]


def launch_many(fn, entries, outs) -> int:
    """Call the C entry point ``fn`` on checked CUDA ``entries`` into
    ``outs`` (each entry's (w', vel'): its own w and vel, or tensors apart
    from every input); returns the launches it made, counting none (the
    probe calls it with variants of the kernel)."""
    from .. import cuda_build
    ptrs = np.array([p for e, (wo, vo) in zip(entries, outs)
                     for p in (*(t.data_ptr() for t in (*e[:3], wo, vo)),
                               0 if _scale(e) is None
                               else _scale(e).data_ptr())], np.uint64)
    ns = np.array([e[0].numel() for e in entries], np.int64)
    consts = np.array([c for e in entries for c in e[3]], np.float32)
    launched = ctypes.c_int(0)
    cuda_build.launch(fn, entries[0][0].device, ptrs.ctypes.data,
                      ns.ctypes.data, consts.ctypes.data, len(entries),
                      ctypes.byref(launched))
    return launched.value


def sgd_update(w: torch.Tensor, grad: torch.Tensor, vel: torch.Tensor,
               hypers) -> tuple[torch.Tensor, torch.Tensor]:
    """(w', vel') of one tensor and hypers (lr, weights_decay, l1_vs_l2,
    momentum) with the unit graph's constants: ``sgd_update_many`` of one
    entry."""
    return sgd_update_many([(w, grad, vel, unit_constants(hypers))])[0]
