"""Distributable protocol — per-unit hooks for distributed execution (port
of ``znicz_tpu/distributable.py``).

The reference's master–slave job protocol ``generate_data_for_slave →
apply_data_from_master → run → generate_data_for_master →
apply_data_from_slave`` survives as the sharding contract that
:func:`znicz_tpu_torch.parallel.distributed.distribute` consumes:

* ``generate_data_for_slave`` → ``{name: (local_rows, total)}`` — the
  per-shard arrays this unit owns on this process (loaders return their
  dataset shard; units with only replicated state return None);
* ``apply_data_from_master`` — install the
  :class:`~znicz_tpu_torch.parallel.distributed.RowShard`\\ s ``distribute``
  made of them.

The gradient fold (``generate_data_for_master`` /
``apply_data_from_slave``) is an all-reduce inside the fused step
(``parallel/fused.py``), so those hooks stay no-ops; ``drop_slave`` maps to
a restart from a checkpoint
(:class:`znicz_tpu_torch.parallel.elastic.ElasticRunner`)."""

from __future__ import annotations


class Distributable:
    """Per-unit distributed-state contract (reference IDistributable)."""

    #: Does this unit need cross-replica negotiation at setup time?
    negotiates_on_connect = False

    def generate_data_for_slave(self, slave=None):
        """Per-shard payload ``{name: (local_rows, total_rows)}`` of the
        arrays this unit owns that are split over the processes, or None
        when the unit carries only replicated state (loaders implement
        it: ``loader.fullbatch.FullBatchLoader``)."""
        return None

    def apply_data_from_master(self, data) -> None:
        """Install the row shards ``distribute`` made of every process's
        ``generate_data_for_slave`` payload."""

    def generate_data_for_master(self):
        """Slave→master payload (reference: gradients/stats); the fused
        step all-reduces the gradients itself."""
        return None

    def apply_data_from_slave(self, data, slave=None) -> None:
        """Master folds a slave's payload (reference: the gradient
        aggregation point); here the step's all-reduce over the data
        axis."""

    def drop_slave(self, slave=None) -> None:
        """Reference: master requeues a lost slave's job.  Here a lost
        process restarts the fleet from a checkpoint."""
