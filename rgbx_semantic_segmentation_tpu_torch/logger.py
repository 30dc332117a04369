"""ANSI-colored logger with env-controlled level (the port's own copy of
rgbx_semantic_segmentation_tpu/logger.py).

Parity target: reference `engine/logger.py:18-99` — root logger with colored
level tags, level from the ENGINE_LOGGING_LEVEL env var, optional file handler.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_DEFAULT_LEVEL = logging.getLevelName(
    os.getenv("ENGINE_LOGGING_LEVEL", "INFO").upper())

_COLORS = {
    logging.DEBUG: "\x1b[36m",    # cyan
    logging.INFO: "\x1b[32m",     # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",    # red
    logging.CRITICAL: "\x1b[35m",  # magenta
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    date = "%(asctime)s"

    def format(self, record):
        color = _COLORS.get(record.levelno, "")
        fmt = (f"{self.date} {color}{record.levelname[:3]}{_RESET} "
               f"[%(filename)s:%(lineno)d] %(message)s")
        if not sys.stdout.isatty():
            fmt = (f"{self.date} {record.levelname[:3]} "
                   f"[%(filename)s:%(lineno)d] %(message)s")
        self._style._fmt = fmt
        return super().format(record)


_logger: Optional[logging.Logger] = None


def get_logger(log_dir: Optional[str] = None,
               log_file: Optional[str] = None) -> logging.Logger:
    """Process-wide logger; adds a file handler on first call with log_file."""
    global _logger
    if _logger is None:
        logger = logging.getLogger("rgbx_torch")
        logger.setLevel(_DEFAULT_LEVEL)
        logger.propagate = False
        handler = logging.StreamHandler()
        handler.setFormatter(_ColorFormatter(datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        _logger = logger
    if log_file:
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log_file = os.path.join(log_dir, log_file)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s"))
        _logger.addHandler(fh)
    return _logger
