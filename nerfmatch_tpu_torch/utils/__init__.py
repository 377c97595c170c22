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


def resolve_device(device="cuda"):
    """The device an entry point runs on: the card unless the caller asks
    for the CPU (``device="cpu"``, ``--device cpu``).  Raises when CUDA is
    asked for and absent, instead of carrying on on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless asked "
            "for the CPU (device='cpu', or --device cpu on the CLIs)")
    return device
