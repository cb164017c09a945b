"""The ``Logger`` mixin every unit inherits and the structured metrics sink
(port of ``znicz_tpu/logger.py``): a named ``logging.Logger`` per instance
with ``debug``/``info``/``warning``/``error``, and ``MetricsWriter``, an
append-only JSONL stream of metric records."""

from __future__ import annotations

import json
import logging
import time


class Logger:
    """Mixin: named logger per instance (reference Logger mixin contract)."""

    @property
    def logger(self) -> logging.Logger:
        name = getattr(self, "name", None) or type(self).__name__
        return logging.getLogger(name)

    def debug(self, msg, *args):
        self.logger.debug(msg, *args)

    def info(self, msg, *args):
        self.logger.info(msg, *args)

    def warning(self, msg, *args):
        self.logger.warning(msg, *args)

    def error(self, msg, *args):
        self.logger.error(msg, *args)


class MetricsWriter:
    """Append-only JSONL metrics stream: every record stays in
    ``records``, and is appended to ``path`` (flushed per record) when one
    is given; without a path no file is made."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.records: list[dict] = []

    def write(self, **fields) -> dict:
        rec = {"ts": time.time(), **fields}
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec, default=float) + "\n")
            self._fh.flush()
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
