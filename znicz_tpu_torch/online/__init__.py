"""Online/continual training: the live-data loop (docs/online.md).

serve --capture-dir ──▶ capture ring ──▶ replay tailer ──▶ bounded
rounds (fc fine-tune or Kohonen online) ──▶ blessed checkpoints +
candidate ``.znn``s ──▶ the stock promotion controller ──▶ canary →
SLO watch → fleet rollout.  Every stage reuses a prior subsystem:
the binary wire format frames the log, the promotion package's
sources/controller consume the output.  The fc fine-tune trains on the
port's ``FusedTrainer`` on the card; the Kohonen online mode keeps the
reference's numpy math (``ops/kohonen.py`` ``np_*``).
"""

from .capture import (CaptureLog, CaptureRecord, read_records,
                      segment_files)
from .replay import ReplayLoader, ReplayReader, records_to_arrays
from .som import OnlineSom, export_som_znn, read_som_znn
from .trainer import OnlineTrainer, export_fc_znn, spec_from_znn

__all__ = [
    "CaptureLog", "CaptureRecord", "read_records", "segment_files",
    "ReplayLoader", "ReplayReader", "records_to_arrays",
    "OnlineSom", "export_som_znn", "read_som_znn",
    "OnlineTrainer", "export_fc_znn", "spec_from_znn",
]
