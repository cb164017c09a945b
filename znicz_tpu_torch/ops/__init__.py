"""Functional math on torch tensors (port of ``znicz_tpu/ops``): each op's
plain PyTorch version beside the wrapper of its hand-written kernel.

Each wrapper counts its kernel's launches in a module-level integer named
``<kernel>_launches`` through :func:`count_launch`, one counter a form
(:func:`form_counter`); ``launch_counts`` reads them all.  Counts are added under one lock, so wrappers called
from several threads (the serving batcher and its callers) keep them
exact.  A CUDA graph's capture counts into :func:`recording` instead of
the counters (a capture launches nothing), and every replay adds what it
recorded (``parallel.capture``), so the counts stay the launches the card
ran."""

from __future__ import annotations

import contextlib
import importlib
import sys
import threading

import torch

#: the op modules whose wrappers count their kernels' launches
COUNTING = ("activations", "conv", "dropout", "kohonen", "lrn_pool",
            "matmul", "normalization", "pooling", "softmax", "update")

#: the fused step's storage dtypes (``ModelSpec.storage_dtype``) → the
#: suffix of a kernel's C entry point in that type (``csrc/narrow.cuh``)
STORAGE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
                  torch.float16: "f16"}
STORAGE_DTYPES = tuple(STORAGE_SUFFIX)

_lock = threading.Lock()
_local = threading.local()


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def form_counter(kernel: str, dtype=torch.float32, split: bool = False
                 ) -> str:
    """The counter of one form of a kernel: ``<kernel>_launches`` for the
    float32 form over unsplit tensors, ``_split`` inserted for the form
    over column-parity halves and ``_bf16``/``_f16`` for a narrow storage
    type (e.g. ``lrn_maxpool_split_bf16_launches``)."""
    sfx = STORAGE_SUFFIX[dtype]
    return (f"{kernel}{'_split' if split else ''}"
            f"{'' if sfx == 'f32' else '_' + sfx}_launches")


def count_launch(module: str, attr: str, n: int = 1) -> None:
    """Add ``n`` launches to counter ``attr`` of the op module named
    ``module`` (a wrapper passes its ``__name__``), or, inside
    :func:`recording` on this thread, to that recording instead."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        key = (module.rsplit(".", 1)[-1], attr)
        rec[key] = rec.get(key, 0) + n
        return
    add_launches(sys.modules[module], attr, n)


def add_launches(mod, attr: str, n: int) -> None:
    """Add ``n`` to counter ``attr`` of module object ``mod``."""
    with _lock:
        setattr(mod, attr, getattr(mod, attr) + n)


@contextlib.contextmanager
def recording():
    """Launches this thread's wrappers count inside the block go to the
    yielded ``{(module, counter): n}`` and not to the counters."""
    prev = getattr(_local, "recording", None)
    rec: dict = {}
    _local.recording = rec
    try:
        yield rec
    finally:
        _local.recording = prev


def launch_counts() -> dict:
    """{(module, counter): launches so far} of every kernel wrapper."""
    out = {}
    with _lock:
        for name in COUNTING:
            mod = _module(name)
            for attr, value in vars(mod).items():
                if attr.endswith("_launches") and isinstance(value, int):
                    out[(name, attr)] = value
    return out
