"""Shared window geometry helpers for conv/pooling (a copy of
``znicz_tpu/ops/geometry.py``, which the port may not import)."""

from __future__ import annotations


def norm2(v) -> tuple[int, int]:
    """Normalize an int-or-pair to a (h, w) tuple."""
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def out_size(size: int, k: int, stride: int, pad: int) -> int:
    """Output extent of a k-window sliding by ``stride`` over ``size``
    with symmetric padding ``pad``."""
    return (size + 2 * pad - k) // stride + 1
