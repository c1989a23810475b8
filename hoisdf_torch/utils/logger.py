"""Coloured console + file logger (``hoisdf_tpu/utils/logger.py``)."""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {"WARNING": 33, "INFO": 32, "DEBUG": 35, "CRITICAL": 31, "ERROR": 31}


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stderr.isatty():
            return f"\x1b[{color}m{msg}\x1b[0m"
        return msg


def colorlogger(log_dir: str = ".", log_name: str = "logs.txt") -> logging.Logger:
    """A logger writing to ``log_dir/log_name`` and to stderr.  A logger of
    the same name from an earlier run in this process is rebound to this
    run's file."""
    logger = logging.getLogger(f"hoisdf_torch.{log_name}")
    os.makedirs(log_dir, exist_ok=True)
    target = os.path.abspath(os.path.join(log_dir, log_name))
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler) and h.baseFilename == target:
            return logger
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = "%(asctime)s %(levelname)s %(message)s"
    fh = logging.FileHandler(target)
    fh.setFormatter(logging.Formatter(fmt))
    ch = logging.StreamHandler()
    ch.setFormatter(_ColorFormatter(fmt))
    logger.addHandler(fh)
    logger.addHandler(ch)
    return logger
