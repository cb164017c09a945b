"""Carries a model across from the JAX package.

``from_reference`` takes what ``znicz_tpu.parallel.fused.extract_model``
returns, in plain form — ``dataclasses.asdict`` of each ``LayerSpec`` and
numpy ``(w, b)`` pairs, conv and deconv weights in HWIO and ``(None,
None)`` for the parameter-less pool, LRN, dropout and depooling rows, plus
the spec's ``unit_index`` — and returns the port's ``(ModelSpec, params,
vels)`` on a device.  A depooling row's ``tie`` (its max pool's row) and a
tied deconv's (its encoder conv's row, whose W it shares: its params are
``(None, None)``, its velocity its own) come across in the config as
they are.
``to_reference`` and ``to_numpy`` are its inverses (the whole plain form,
and the parameters alone).  Nothing here imports ``znicz_tpu``: the caller
hands over numpy arrays.

A spec exported under the reference's default ``fused2`` routing marks the
convs before each merged LRN→pool pair ``split_out`` and the pair
``emit_split``: there the convs emit column-parity halves and take split
gradients back.  Both keys come across as they are, and the port runs
them (``parallel/fused.py``), whatever its own default routing."""

from __future__ import annotations

import numpy as np
import torch

from .parallel.fused import LayerSpec, ModelSpec


def _config(pairs) -> tuple:
    """Sorted ``(key, value)`` pairs with list values (as JSON gives
    them) turned back into the reference's tuples, e.g. ``("ksize",
    (2, 2))``."""
    return tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in pairs)


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


def to_reference(spec: ModelSpec, params, vels) -> tuple:
    """The inverse of :func:`from_reference`: ``(layers, loss, params,
    vels, unit_index)`` in the reference's plain form — each ``LayerSpec``
    as a dict (its config pairs as they are, the routing keys
    ``act_folded``, ``fold_act``, ``split_out`` and ``emit_split``
    among them) and numpy ``(w, b)`` pairs."""
    layers = [{"kind": la.kind, "activation": la.activation,
               "include_bias": la.include_bias, "hypers": la.hypers,
               "hypers_bias": la.hypers_bias, "config": la.config}
              for la in spec.layers]
    return (layers, spec.loss, to_numpy(params), to_numpy(vels),
            spec.unit_index)
