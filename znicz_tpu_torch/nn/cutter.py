"""Slicing and joining units for branched nets (port of
``znicz_tpu/nn/cutter.py``).

``Cutter`` crops a spatial window out of NHWC activations and
``GDCutter`` zero-pads the error back; ``ChannelMerger`` concatenates
branch outputs on the channel axis and ``EltwiseSumMerger`` adds them,
their GD units splitting the error back per branch or handing it on
unchanged.  The mergers' branches are wired with ``link_inputs``.  Each
is a static slice, pad, concatenation or sum, which the reference leaves
to XLA: plain PyTorch here on both devices.  They run on the unit graph
only; the fused path refuses them, as the reference's does."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..memory import Vector
from .nn_units import Forward, GradientDescentBase


class Cutter(Forward):
    """output = input[:, top:h-bottom, left:w-right, :]."""

    MAPPING = ("cutter",)

    def __init__(self, workflow=None, name=None, padding=None, **kwargs):
        """``padding`` = (left, top, right, bottom) crop margins, the
        reference's 4-tuple convention."""
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        if padding is None:
            raise ValueError("padding=(left, top, right, bottom) required")
        self.padding = tuple(int(p) for p in padding)

    def output_shape_for(self, x_shape) -> tuple[int, ...]:
        b, h, w, c = x_shape
        le, to, ri, bo = self.padding
        return (b, h - to - bo, w - le - ri, c)

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if len(self.input.shape) != 4:
            raise ValueError(f"{self.name}: Cutter expects NHWC input")
        oshape = self.output_shape_for(self.input.shape)
        if oshape[1] <= 0 or oshape[2] <= 0:
            raise ValueError(f"{self.name}: crop {self.padding} leaves "
                             f"no pixels of {tuple(self.input.shape)}")
        if not self.output:
            self.output.mem = np.zeros(oshape, np.float32)
        self.init_vectors(self.output)

    def _slice(self, x):
        le, to, ri, bo = self.padding
        _, h, w, _ = self.input.shape
        return x[:, to:h - bo, le:w - ri, :]

    def numpy_run(self) -> None:
        self.output.mem = np.ascontiguousarray(self._slice(self.input.mem))

    def torch_run(self) -> None:
        self.output.devmem = self._slice(self.input.devmem).contiguous()


class GDCutter(GradientDescentBase):
    """Zero-pad err_output back to the input extent."""

    MAPPING = ("cutter",)

    def setup_from_forward(self, fwd) -> "GDCutter":
        super().setup_from_forward(fwd)
        self.padding = fwd.padding
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            le, to, ri, bo = self.padding
            err = self.err_output.mem.reshape(self.output.shape)
            self.err_input.mem = np.pad(
                err, ((0, 0), (to, bo), (le, ri), (0, 0)))

    def torch_run(self) -> None:
        if self.need_err_input:
            le, to, ri, bo = self.padding
            err = self.err_output.devmem.reshape(self.output.shape)
            self.err_input.devmem = F.pad(err, (0, 0, le, ri, to, bo))


class _Merger(Forward):
    """Branch outputs joined into one; ``link_inputs(unit_a, ...)`` wires
    them, and the unit's own ``input`` is the first branch's output (chain
    compatibility)."""

    def __init__(self, workflow=None, name=None, **kwargs):
        kwargs["include_bias"] = False
        super().__init__(workflow, name, **kwargs)
        self.branches: list = []

    def link_inputs(self, *units) -> "_Merger":
        self.branches = list(units)
        self.link_attrs(units[0], ("input", "output"))
        return self

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if not self.branches:
            raise ValueError(f"{self.name}: link_inputs(...) first")
        shape = self._output_shape([tuple(u.output.shape)
                                    for u in self.branches])
        if not self.output:
            self.output.mem = np.zeros(shape, np.float32)
        self.init_vectors(self.output)


class ChannelMerger(_Merger):
    """Concatenate branch outputs on the channel (minor) axis."""

    MAPPING = ("channel_merger",)

    def _output_shape(self, shapes) -> tuple[int, ...]:
        lead = shapes[0][:-1]
        if any(s[:-1] != lead for s in shapes):
            raise ValueError(f"{self.name}: branch shapes {shapes} differ "
                             "outside the channel axis")
        self.split_sizes = [s[-1] for s in shapes]
        return (*lead, sum(self.split_sizes))

    def numpy_run(self) -> None:
        self.output.mem = np.concatenate(
            [u.output.mem for u in self.branches], axis=-1)

    def torch_run(self) -> None:
        self.output.devmem = torch.cat(
            [u.output.devmem for u in self.branches], dim=-1)


class GDChannelMerger(GradientDescentBase):
    """Split err_output back into per-branch slices (``err_inputs[i]``;
    ``err_input`` is the first branch's)."""

    MAPPING = ("channel_merger",)

    def setup_from_forward(self, fwd) -> "GDChannelMerger":
        super().setup_from_forward(fwd)
        self.split_sizes = fwd.split_sizes
        self.include_bias = False
        self.err_inputs = [Vector() for _ in self.split_sizes]
        return self

    def numpy_run(self) -> None:
        err = self.err_output.mem.reshape(self.output.shape)
        bounds = np.cumsum(self.split_sizes)[:-1]
        for v, part in zip(self.err_inputs, np.split(err, bounds, axis=-1)):
            v.mem = np.ascontiguousarray(part)
        self.err_input.mem = self.err_inputs[0].mem

    def torch_run(self) -> None:
        err = self.err_output.devmem.reshape(self.output.shape)
        for v, part in zip(self.err_inputs,
                           torch.split(err, self.split_sizes, dim=-1)):
            v.devmem = part.contiguous()
        self.err_input.devmem = self.err_inputs[0].devmem


class EltwiseSumMerger(_Merger):
    """Elementwise sum of branch outputs (residual-style joins); the
    gradient hands err_output to every branch unchanged."""

    MAPPING = ("sum_merger",)

    def _output_shape(self, shapes) -> tuple[int, ...]:
        if len(set(shapes)) != 1:
            raise ValueError(f"{self.name}: branch shapes differ: "
                             f"{set(shapes)}")
        return shapes[0]

    def numpy_run(self) -> None:
        acc = self.branches[0].output.mem.copy()
        for u in self.branches[1:]:
            acc += u.output.mem
        self.output.mem = acc

    def torch_run(self) -> None:
        acc = self.branches[0].output.devmem
        for u in self.branches[1:]:
            acc = acc + u.output.devmem
        self.output.devmem = acc


class GDEltwiseSumMerger(GradientDescentBase):
    MAPPING = ("sum_merger",)

    def setup_from_forward(self, fwd) -> "GDEltwiseSumMerger":
        super().setup_from_forward(fwd)
        self.include_bias = False
        return self

    def numpy_run(self) -> None:
        if self.need_err_input:
            self.err_input.mem = self.err_output.mem.reshape(
                self.output.shape).copy()

    def torch_run(self) -> None:
        if self.need_err_input:
            self.err_input.devmem = self.err_output.devmem.reshape(
                self.output.shape)
