"""Carries a model across from the JAX package.

``from_reference`` takes what ``znicz_tpu.parallel.fused.extract_model``
returns, in plain form — ``dataclasses.asdict`` of each ``LayerSpec`` and
numpy ``(w, b)`` pairs — and returns the port's ``(ModelSpec, params,
vels)`` on a device.  ``to_numpy`` is its inverse for the parameters.
Nothing here imports ``znicz_tpu``: the caller hands over numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.fused import LayerSpec, ModelSpec


def _layer(d: dict) -> LayerSpec:
    return LayerSpec(kind=d["kind"], activation=d["activation"],
                     include_bias=bool(d["include_bias"]),
                     hypers=tuple(d["hypers"]),
                     hypers_bias=tuple(d["hypers_bias"]),
                     config=tuple(tuple(kv) for kv in d.get("config", ())))


def _pairs(pairs, device) -> list:
    return [tuple(None if a is None else
                  torch.from_numpy(np.array(a, np.float32)).to(device)
                  for a in pair)
            for pair in pairs]


def from_reference(layers: list[dict], loss: str, params, vels, *, device
                   ) -> tuple[ModelSpec, list, list]:
    """(ModelSpec, params, vels) on ``device`` from the reference's plain
    ``extract_model`` output; ``params``/``vels`` are lists of numpy
    ``(w, b)`` pairs (``None`` where absent).  Layer kinds the port does
    not run raise ``NotImplementedError``."""
    spec = ModelSpec(tuple(_layer(d) for d in layers), loss)
    device = torch.device(device)
    return spec, _pairs(params, device), _pairs(vels, device)


def to_numpy(params) -> list:
    """List of ``(w, b)`` tensors → numpy pairs (``None`` kept)."""
    return [tuple(None if t is None else t.detach().cpu().numpy()
                  for t in pair)
            for pair in params]
