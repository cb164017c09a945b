"""The ``Logger`` mixin every unit inherits (port of the mixin in
``znicz_tpu/logger.py``): a named ``logging.Logger`` per instance with
``debug``/``info``/``warning``/``error``.  The structured metrics sink
(``MetricsWriter``) waits for ROADMAP.md queue 1 item 10."""

from __future__ import annotations

import logging


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
