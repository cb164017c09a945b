"""Execution of whole train steps (port of ``znicz_tpu/parallel``): the
fused step and ``FusedTrainer``, the (data, model) mesh over a
``torch.distributed`` process group, the multi-process bootstrap, device
checkpoints and the elastic runner."""

from .checkpoint import TrainerCheckpointer, restore_trainer, save_trainer
from .distributed import (CheckpointRecovery, RowShard, distribute,
                          global_mesh, initialize, process_shard,
                          shard_dataset)
from .fused import FusedTrainer, LayerSpec, ModelSpec, StepShard
from .mesh import (Mesh, mesh_shape_of, parse_mesh_arg, plan_tp_sharding,
                   resolve_mesh, shard_params)

__all__ = ["CheckpointRecovery", "ElasticRunner", "FusedTrainer",
           "LayerSpec", "Mesh", "ModelSpec", "RowShard", "StepShard",
           "TrainerCheckpointer", "distribute", "free_port", "global_mesh",
           "initialize", "mesh_shape_of", "parse_mesh_arg",
           "plan_tp_sharding", "process_shard", "resolve_mesh",
           "restore_trainer", "save_trainer", "shard_dataset",
           "shard_params"]


def __getattr__(name):
    # the elastic runner is also ``python -m znicz_tpu_torch.parallel.
    # elastic``: importing it with the package would run it twice there
    if name in ("ElasticRunner", "free_port"):
        from . import elastic
        return getattr(elastic, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
