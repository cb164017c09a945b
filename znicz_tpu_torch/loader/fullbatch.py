"""FullBatchLoader: the entire dataset resident on the device (port of
``znicz_tpu/loader/fullbatch.py``).

``initialize`` normalizes the host data and moves it to the loader's
device once as ``original_data`` / ``original_labels`` tensors.  The fused
trainer gathers each minibatch there itself; the unit graph's
``fill_minibatch`` gathers the rows of one minibatch there with
``index_select`` into ``minibatch_data`` / ``minibatch_labels`` (and
``minibatch_targets`` for an MSE loader), padding a short last minibatch
to the full size with its last row (consumers mask by
``minibatch_size``).  On the numpy device the same gather is a numpy
fancy index on the host."""

from __future__ import annotations

import numpy as np
import torch

from ..memory import Vector, numpy_dtype
from ..normalization import create_normalizer
from .base import Loader


class FullBatchLoader(Loader):
    """Serves minibatches out of resident tensors.

    Subclasses set ``original_data`` (N, …) and ``original_labels`` (N,)
    as numpy arrays or tensors, plus ``class_lengths``, in
    ``load_data``; after ``initialize`` both are tensors on the device
    (the CPU for the numpy device)."""

    def __init__(self, workflow=None, name=None, normalization_type="none",
                 normalization_parameters=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.original_data: torch.Tensor | None = None
        self.original_labels: torch.Tensor | None = None
        self.normalization_type = normalization_type
        self.normalization_parameters = normalization_parameters or {}
        self.normalizer = None

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        self.original_data = self._normalize(
            self._to_device(self.original_data))
        self.original_labels = self._to_device(self.original_labels)
        # fixed-shape minibatch buffers, so downstream units size themselves
        self.minibatch_data.mem = np.zeros(
            (self.max_minibatch_size, *self.original_data.shape[1:]),
            numpy_dtype(self.original_data.dtype))
        self.minibatch_labels.mem = np.zeros(
            (self.max_minibatch_size,),
            numpy_dtype(self.original_labels.dtype))

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device.torch_device)

    def _normalize(self, data: torch.Tensor) -> torch.Tensor:
        """Fit the normalizer on the whole resident dataset once (kept on
        the loader for reuse) and apply it."""
        if self.normalizer is None:
            self.normalizer = create_normalizer(
                self.normalization_type, **self.normalization_parameters)
            self.normalizer.fit(data)
        return self.normalizer.apply(data)

    def _gather(self, vec, source: torch.Tensor, indices: np.ndarray
                ) -> None:
        """``vec`` ← rows ``indices`` of ``source``, the short tail padded
        with the last row (``edge``, as the reference pads)."""
        size = len(indices)
        full = np.concatenate([indices, np.full(
            self.max_minibatch_size - size, indices[-1], indices.dtype)])
        if self.device.is_torch:
            idx = torch.from_numpy(full).to(source.device)
            vec.devmem = source.index_select(0, idx)
        else:
            vec.mem = source.numpy()[full]

    def fill_minibatch(self, indices: np.ndarray, klass: int) -> None:
        self._gather(self.minibatch_data, self.original_data, indices)
        self._gather(self.minibatch_labels, self.original_labels, indices)

    # -- Distributable protocol (consumed by parallel.distributed.
    # distribute) ------------------------------------------------------------
    def _shard_vectors(self) -> tuple[str, ...]:
        """Names of the tensors split over the processes in a distributed
        run; everything else the loader owns is replicated."""
        return ("original_data", "original_labels")

    def generate_data_for_slave(self, slave=None):
        """This process's contiguous rows of every per-shard tensor, with
        the global row count."""
        from ..parallel import distributed
        sl = distributed.process_shard(self.total_samples)
        out = {}
        for name in self._shard_vectors():
            t = getattr(self, name, None)
            if t is not None:
                out[name] = (t[sl], self.total_samples)
        return out or None

    def apply_data_from_master(self, data) -> None:
        """Install the row shards (``distributed.RowShard``); a fused
        trainer under a mesh gathers the whole dataset from them."""
        for name, shard in data.items():
            setattr(self, name, shard)


class FullBatchLoaderMSE(FullBatchLoader):
    """Adds a regression target tensor and its ``minibatch_targets``
    (reference LoaderMSE contract), gathered like ``minibatch_data``."""

    def __init__(self, workflow=None, name=None, **kwargs):
        # by keyword: a sample loader mixed in after this class (the
        # autoencoder's MnistLoader) takes other positional parameters
        super().__init__(workflow=workflow, name=name, **kwargs)
        self.original_targets: torch.Tensor | None = None
        self.minibatch_targets = Vector()

    def initialize(self, device=None, **kwargs) -> None:
        super().initialize(device, **kwargs)
        if self.original_targets is None:
            # autoencoder-style: the target is the (normalized) input
            self.original_targets = self.original_data
        else:
            self.original_targets = self._to_device(self.original_targets)
        self.minibatch_targets.mem = np.zeros(
            (self.max_minibatch_size, *self.original_targets.shape[1:]),
            numpy_dtype(self.original_targets.dtype))
        self.minibatch_targets.initialize(self.device)

    def _shard_vectors(self) -> tuple[str, ...]:
        return super()._shard_vectors() + ("original_targets",)

    def fill_minibatch(self, indices: np.ndarray, klass: int) -> None:
        super().fill_minibatch(indices, klass)
        self._gather(self.minibatch_targets, self.original_targets, indices)
