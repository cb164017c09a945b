"""FullBatchLoader: the entire dataset resident on the device (port of
``znicz_tpu/loader/fullbatch.py``).

``initialize`` normalizes the host data and moves it to the loader's
device once; the fused trainer gathers each minibatch there with
``index_select``, so no host↔device traffic happens per step."""

from __future__ import annotations

import numpy as np
import torch

from ..normalization import create_normalizer
from .base import Loader


class FullBatchLoader(Loader):
    """Serves minibatches out of resident tensors.

    Subclasses set ``original_data`` (N, …) and ``original_labels`` (N,)
    as numpy arrays or tensors, plus ``class_lengths``, in
    ``load_data``; after ``initialize`` both are tensors on the device."""

    def __init__(self, name=None, normalization_type="none",
                 normalization_parameters=None, **kwargs):
        super().__init__(name, **kwargs)
        self.original_data: torch.Tensor | None = None
        self.original_labels: torch.Tensor | None = None
        self.normalization_type = normalization_type
        self.normalization_parameters = normalization_parameters or {}
        self.normalizer = None

    def initialize(self, device: torch.device) -> None:
        super().initialize(device)
        self.original_data = self._normalize(
            self._to_device(self.original_data))
        self.original_labels = self._to_device(self.original_labels)

    def _to_device(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(self.device)

    def _normalize(self, data: torch.Tensor) -> torch.Tensor:
        """Fit the normalizer on the whole resident dataset once (kept on
        the loader for reuse) and apply it."""
        if self.normalizer is None:
            self.normalizer = create_normalizer(
                self.normalization_type, **self.normalization_parameters)
            self.normalizer.fit(data)
        return self.normalizer.apply(data)


class FullBatchLoaderMSE(FullBatchLoader):
    """Adds a regression target tensor (reference LoaderMSE contract)."""

    def __init__(self, name=None, **kwargs):
        super().__init__(name, **kwargs)
        self.original_targets: torch.Tensor | None = None

    def initialize(self, device: torch.device) -> None:
        super().initialize(device)
        if self.original_targets is None:
            # autoencoder-style: the target is the (normalized) input
            self.original_targets = self.original_data
        else:
            self.original_targets = self._to_device(self.original_targets)
