"""Closed-loop promotion: train → verify → bless → canary deploy →
SLO watch → automatic rollback.

The subsystem that closes the loop the reference workflow engine ran
in-process (PAPER.md: loaders, trainers, snapshotters, evaluators
wired into one self-driving workflow) at production scale: a
:class:`PromotionController` watches a candidate source (a trainer's
export directory, or a
:class:`~znicz_tpu_torch.parallel.checkpoint.TrainerCheckpointer` step tree),
durability-verifies each new candidate, commits it into a deploy
directory (atomic, manifest'd), swaps it into a live serving target
through the verified+canaried hot reload, then judges the new
generation against an :class:`SLOPolicy` over the live telemetry
histograms — rolling back to the previous generation on breach, and
failing fast after K consecutive failed promotions.  Every transition
is persisted to a :class:`PromotionLedger` that survives restarts.

A copy of the reference's ``promotion`` package over the port's
serving engine, durability, resilience and telemetry modules.  See
docs/promotion.md; sidecar CLI: ``python -m znicz_tpu_torch promote``.
The ``chaos --scenario promote`` drill comes with ``resilience/chaos.py``
and the fleet targets with ``fleet/`` (ROADMAP.md queue 1 items 10 and
11).
"""

from .controller import (CANARY_FAILED, EXPORT_FAILED, PROMOTED,
                         ROLLBACK_FAILED, ROLLED_BACK, VERIFY_FAILED,
                         CrashLoop, EngineTarget, HttpTarget,
                         PromotionController, ReloadBusy)
from .ledger import LedgerReplay, PromotionLedger
from .slo import (BurnRatePolicy, SLOPolicy, SLOSample, delta_quantile,
                  parse_prometheus, prometheus_sample, registry_sample)
from .sources import Candidate, CheckpointSource, DirectorySource

__all__ = [
    "CANARY_FAILED", "EXPORT_FAILED", "PROMOTED", "ROLLBACK_FAILED",
    "ROLLED_BACK", "VERIFY_FAILED", "BurnRatePolicy", "Candidate",
    "CheckpointSource", "CrashLoop", "DirectorySource", "EngineTarget",
    "HttpTarget", "LedgerReplay", "PromotionController",
    "PromotionLedger", "ReloadBusy", "SLOPolicy", "SLOSample",
    "delta_quantile", "parse_prometheus", "prometheus_sample",
    "registry_sample",
]
