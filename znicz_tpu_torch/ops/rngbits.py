"""Counter-based uniform bits, bit-identical to the JAX package's (port of
``znicz_tpu/ops/rngbits.py``).

Randomness is a pure integer hash of ``(stream seed, counters..., element
index)``: the murmur3 finalizer (``fmix32``) over uint32 values.  Keys are
folded on the host with Python ints (``fold``), so a kernel receives its
key as an argument and the device never syncs for it; ``fold_t`` folds
counters that live in device tensors (a captured step's epoch and
counter, read from its plan row at each replay) into a key tensor, bit
for bit the host fold of the same values.  ``uniform01`` is
the plain torch version of the per-element hash; torch on the CPU has no
uint32 ``>>``, ``+`` or ``arange``, so it computes in int64 masked to 32
bits, splitting each 32×32-bit product so that no int64 overflows."""

from __future__ import annotations

import torch

MASK32 = 0xFFFF_FFFF
C1 = 0x85EB_CA6B
C2 = 0xC2B2_AE35
GOLDEN = 0x9E37_79B9


def mix(x: int) -> int:
    """murmur3 fmix32 of a Python int in [0, 2³²)."""
    x ^= x >> 16
    x = (x * C1) & MASK32
    x ^= x >> 13
    x = (x * C2) & MASK32
    return x ^ (x >> 16)


def fold(seed: int, *counters: int) -> int:
    """Fold integer counters into a u32 key: the reference's ``fold`` for
    host values.  The seed and each counter are taken mod 2³², as the
    reference's uint32 casts take them."""
    key = mix(int(seed) & MASK32)
    for c in counters:
        key = mix(((key ^ (int(c) & MASK32)) + GOLDEN) & MASK32)
    return key


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 x in [0, 2³²): the constant is split into
    16-bit halves so every partial product stays below 2⁴⁸."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, C1)
    x = x ^ (x >> 13)
    x = _mul32(x, C2)
    return x ^ (x >> 16)


def fold_t(seed: int, *counters) -> int | torch.Tensor:
    """``fold`` where counters may be integer tensors (any integer dtype,
    each taken mod 2³² as the reference's uint32 casts take it): the host
    folds the leading Python ints, the device the rest, in masked int64.
    Returns a Python int when every counter is one, else an int64 tensor
    of the counters' broadcast shape on their device."""
    key = mix(int(seed) & MASK32)
    for c in counters:
        if isinstance(c, torch.Tensor):
            c32 = c.to(torch.int64) & MASK32
            key = _mix_t(((c32 ^ key) + GOLDEN) & MASK32)
        elif isinstance(key, torch.Tensor):
            key = _mix_t(((key ^ (int(c) & MASK32)) + GOLDEN) & MASK32)
        else:
            key = mix(((key ^ (int(c) & MASK32)) + GOLDEN) & MASK32)
    return key


def uniform01(key, n: int, device="cpu") -> torch.Tensor:
    """n float32 values in [0, 1): fmix32(i·C2 ^ key) ≫ 8 / 2²⁴ for the
    flat index i; ``key`` a Python int or a one-element int64 tensor of
    ``fold_t`` (on ``device``)."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if not isinstance(key, torch.Tensor):
        key = int(key) & MASK32
    h = _mix_t(_mul32(idx, C2) ^ key)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniforms(seed: int, counters, shape, device="cpu") -> torch.Tensor:
    """``shape``-shaped uniforms at (seed, counters): ``uniform01`` of the
    folded key.  Counters may be device tensors (a captured step's epoch
    and counter), and then the draw is made on their device."""
    key = fold_t(seed, *counters)
    if isinstance(key, torch.Tensor):
        device = key.device
    n = 1
    for d in shape:
        n *= int(d)
    return uniform01(key, n, device).reshape(tuple(shape))
