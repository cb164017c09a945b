"""Dataset normalizers (port of ``znicz_tpu/normalization.py``).

Fit statistics once on the resident dataset, then transform any tensor
with the same state: ``none``, ``linear``, ``mean_disp``, ``external_mean``
and ``pointwise``, the reference's whole family.  Per-feature statistics
are fitted on the host in numpy (the reference's own reductions, so the
statistics are its bits), and every transform is the reference's float32
arithmetic one operation at a time, so the normalized data is
bit-identical on the CPU and on the card."""

from __future__ import annotations

import numpy as np
import torch


class NormalizerBase:
    """fit(data) once → apply(tensor) anywhere; state in plain attrs."""

    NAME: str = ""

    def fit(self, data: torch.Tensor) -> "NormalizerBase":
        return self

    def apply(self, data: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class NoneNormalizer(NormalizerBase):
    NAME = "none"

    def apply(self, data):
        return data.to(torch.float32)


class LinearNormalizer(NormalizerBase):
    """Scale to [-1, 1] from the fitted min/max (reference "linear")."""

    NAME = "linear"

    def __init__(self, interval=(-1.0, 1.0)):
        self.lo_out, self.hi_out = interval
        self.lo = self.hi = None

    def fit(self, data):
        self.lo = float(data.min())
        self.hi = float(data.max())
        return self

    def apply(self, data):
        # python-float operands round to float32 first, as numpy's do in
        # the reference, so each step is the same float32 operation
        scale = (self.hi_out - self.lo_out) / max(self.hi - self.lo, 1e-8)
        return (data.to(torch.float32) - self.lo) * scale + self.lo_out


def _host(data) -> np.ndarray:
    """float32 host copy of a tensor or array."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data, np.float32)


def _like(a: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        data.device)


class MeanDispersionNormalizer(NormalizerBase):
    """Per-feature zero mean and unit dispersion (reference
    "mean_disp")."""

    NAME = "mean_disp"

    def __init__(self):
        self.mean = self.disp = None

    def fit(self, data):
        host = _host(data)
        self.mean = host.mean(axis=0)
        self.disp = host.std(axis=0) + 1e-8
        return self

    def apply(self, data):
        data = data.to(torch.float32)
        return (data - _like(self.mean, data)) / _like(self.disp, data)


class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a supplied mean image (reference "external_mean": the
    ImageNet mean-pixel file of AlexNet)."""

    NAME = "external_mean"

    def __init__(self, mean_source=None):
        if mean_source is None:
            raise ValueError("mean_source (array or .npy path) required")
        self.mean = (np.load(mean_source) if isinstance(mean_source, str)
                     else np.asarray(mean_source)).astype(np.float32)

    def apply(self, data):
        data = data.to(torch.float32)
        return data - _like(self.mean, data)


class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear map fitted to [-1, 1] (reference "pointwise":
    each input coordinate rescaled independently)."""

    NAME = "pointwise"

    def __init__(self):
        self.lo = self.hi = None

    def fit(self, data):
        host = _host(data)
        self.lo = host.min(axis=0)
        self.hi = host.max(axis=0)
        return self

    def apply(self, data):
        data = data.to(torch.float32)
        scale = 2.0 / np.maximum(self.hi - self.lo, 1e-8)
        return (data - _like(self.lo, data)) * _like(scale, data) - 1.0


NORMALIZERS = {cls.NAME: cls for cls in
               (NoneNormalizer, LinearNormalizer, MeanDispersionNormalizer,
                ExternalMeanNormalizer, PointwiseNormalizer)}


def create_normalizer(name: str, **kwargs) -> NormalizerBase:
    try:
        cls = NORMALIZERS[name]
    except KeyError:
        raise ValueError(f"unknown normalizer {name!r}; known: "
                         f"{sorted(NORMALIZERS)}") from None
    return cls(**kwargs)
