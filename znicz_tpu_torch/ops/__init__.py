"""Functional math on torch tensors (port of ``znicz_tpu/ops``): each op's
plain PyTorch version beside the wrapper of its hand-written kernel.

Each wrapper counts its kernel's launches in a module-level integer named
``<kernel>_launches``; ``launch_counts`` reads them all.  A CUDA graph
that captured wrapper calls takes back what the capture counted
(``set_launch_counts``) and adds it on every replay
(``parallel.capture``), so the counts stay the launches the card ran."""

from __future__ import annotations

import importlib

#: the op modules whose wrappers count their kernels' launches
COUNTING = ("activations", "conv", "dropout", "kohonen", "lrn_pool",
            "matmul", "normalization", "pooling", "softmax", "update")


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """{(module, counter): launches so far} of every kernel wrapper."""
    out = {}
    for name in COUNTING:
        mod = _module(name)
        for attr, value in vars(mod).items():
            if attr.endswith("_launches") and isinstance(value, int):
                out[(name, attr)] = value
    return out


def set_launch_counts(counts: dict) -> None:
    """Set each ``(module, counter)`` of ``counts`` to its value."""
    for (name, attr), value in counts.items():
        setattr(_module(name), attr, value)
