"""Logging setup: rotating debug file + INFO console.

Mirrors the reference's root-logger configuration (reference:
streaming_decoder/utils.py:70-106 — DEBUG-level ``logs/debug.log``
rotating at 500 MB x 5 backups, plus an INFO console handler with the
same ``[time] [level] [file:line]`` format).

Copied from asr_streaming_tpu/utils/logs.py.
"""

from __future__ import annotations

import logging
import os
from logging import handlers

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(filename)s:%(lineno)d]: %(message)s"


def setup_logger(log_dir: str = "logs", use_console: bool = True,
                 max_bytes: int = 500 * 1024 ** 2,
                 backup_count: int = 5) -> logging.Logger:
    """Configure the root logger. Idempotent (re-runs replace handlers)."""
    logger = logging.getLogger()
    logger.setLevel(logging.DEBUG)
    for h in list(logger.handlers):
        logger.removeHandler(h)

    os.makedirs(log_dir, exist_ok=True)
    debug_handler = handlers.RotatingFileHandler(
        os.path.join(log_dir, "debug.log"),
        maxBytes=max_bytes, backupCount=backup_count)
    debug_handler.setLevel(logging.DEBUG)
    debug_handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(debug_handler)

    if use_console:
        console = logging.StreamHandler()
        console.setLevel(logging.INFO)
        console.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(console)
    return logger
