"""Carries a model across from the JAX package.

``from_reference`` takes what ``znicz_tpu.parallel.fused.extract_model``
returns, in plain form — ``dataclasses.asdict`` of each ``LayerSpec`` and
numpy ``(w, b)`` pairs, conv weights in HWIO and ``(None, None)`` for the
parameter-less pool, LRN and dropout rows, plus the spec's ``unit_index``
— and returns the port's ``(ModelSpec, params, vels)`` on a device.
``to_numpy`` is its inverse for the parameters.  Nothing here imports
``znicz_tpu``: the caller hands over numpy arrays.

A spec exported under the reference's default ``fused2`` routing marks the
convs before each merged LRN→pool pair ``split_out`` and the pair
``emit_split``: there the convs emit column-parity halves and take split
gradients back, a layout device for Mosaic's lack of strided loads.  The
math is the same as without it (``fused1``), and the port's kernels read
x unsplit, so ``from_reference`` drops both keys."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.fused import LayerSpec, ModelSpec


#: config keys of the reference's parity-split routing (module docstring)
_SPLIT_KEYS = ("split_out", "emit_split")


def _config(pairs) -> tuple:
    """Sorted ``(key, value)`` pairs with list values (as JSON gives
    them) turned back into the reference's tuples, e.g. ``("ksize",
    (2, 2))``, and the parity-split keys dropped."""
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in pairs if k not in _SPLIT_KEYS)


def _layer(d: dict) -> LayerSpec:
    return LayerSpec(kind=d["kind"], activation=d["activation"],
                     include_bias=bool(d["include_bias"]),
                     hypers=tuple(d["hypers"]),
                     hypers_bias=tuple(d["hypers_bias"]),
                     config=_config(d.get("config", ())))


def _pairs(pairs, device) -> list:
    return [tuple(None if a is None else
                  torch.from_numpy(np.array(a, np.float32)).to(device)
                  for a in pair)
            for pair in pairs]


def from_reference(layers: list[dict], loss: str, params, vels, *, device,
                   unit_index=()) -> tuple[ModelSpec, list, list]:
    """(ModelSpec, params, vels) on ``device`` from the reference's plain
    ``extract_model`` output; ``params``/``vels`` are lists of numpy
    ``(w, b)`` pairs (``None`` where absent), ``unit_index`` the spec's
    write-back map.  Layer kinds the port does not run raise
    ``NotImplementedError``."""
    spec = ModelSpec(tuple(_layer(d) for d in layers), loss,
                     unit_index=tuple(unit_index))
    device = torch.device(device)
    return spec, _pairs(params, device), _pairs(vels, device)


def to_numpy(params) -> list:
    """List of ``(w, b)`` tensors → numpy pairs (``None`` kept)."""
    return [tuple(None if t is None else t.detach().cpu().numpy()
                  for t in pair)
            for pair in params]
