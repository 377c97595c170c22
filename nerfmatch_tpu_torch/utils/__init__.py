"""See the package docstring of nerfmatch_tpu_torch."""

from __future__ import annotations

import logging

_LOG_FORMAT = "[%(asctime)s %(name)s %(levelname)s] %(message)s"


def get_logger(level: str = "INFO", name: str = "nerfmatch_tpu_torch"):
    """A named logger writing ``[time name level] message`` lines to stderr
    (one handler, however often it is asked for)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_LOG_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
    logger.setLevel(getattr(logging, level.upper()))
    logger.propagate = False
    return logger
