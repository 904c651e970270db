"""Singleton framework logger.

Counterpart of ``awebox_tpu/utils/logging.py``: one named logger shared by
every module, with a stream handler installed on first use.
``set_level('debug'|'info'|...)`` adjusts verbosity globally.
"""
from __future__ import annotations

import logging
import sys

_LOGGER_NAME = 'awebox_tpu_torch'
_initialized = False


def get_logger() -> logging.Logger:
    global _initialized
    logger = logging.getLogger(_LOGGER_NAME)
    if not _initialized:
        logger.setLevel(logging.INFO)
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter('[%(levelname)s] %(message)s'))
            logger.addHandler(handler)
        logger.propagate = False
        _initialized = True
    return logger


def set_level(level: str):
    get_logger().setLevel(getattr(logging, level.upper()))


awelogger = get_logger()
