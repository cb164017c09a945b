"""Execution of whole train steps (port of ``znicz_tpu/parallel``): the
fused step and ``FusedTrainer``.  Mesh/data-parallel execution is
ROADMAP.md queue 1 item 9."""

from .fused import FusedTrainer, LayerSpec, ModelSpec

__all__ = ["FusedTrainer", "LayerSpec", "ModelSpec"]
