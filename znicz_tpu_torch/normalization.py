"""Dataset normalizers (port of ``znicz_tpu/normalization.py``).

Fit statistics once on the resident dataset, then transform any tensor
with the same state.  The port carries ``none`` and ``linear``, the two
the fused MNIST path uses; the same float32 arithmetic as the reference
keeps the normalized data bit-identical.  The others are ROADMAP.md
queue 1 item 10 (``normalization.py``)."""

from __future__ import annotations

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


NORMALIZERS = {cls.NAME: cls for cls in (NoneNormalizer, LinearNormalizer)}


def create_normalizer(name: str, **kwargs) -> NormalizerBase:
    try:
        cls = NORMALIZERS[name]
    except KeyError:
        raise NotImplementedError(
            f"normalizer {name!r} is not ported yet (ROADMAP.md queue 1 "
            f"item 10); ported: {sorted(NORMALIZERS)}") from None
    return cls(**kwargs)
