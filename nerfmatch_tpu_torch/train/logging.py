"""Experiment logging to files (counterpart of
``nerfmatch_tpu/train/logging.py``): a JSONL scalar stream, text files and
png image panels under the run directory."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
from PIL import Image


class MetricsLogger:
    def __init__(self, log_dir, name: str = "metrics"):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{name}.jsonl"
        self._fh = open(self.path, "a")

    def log_scalars(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_text(self, tag: str, text: str):
        (self.log_dir / f"{tag.replace('/', '_')}.txt").write_text(str(text))

    def log_image(self, step: int, tag: str, img):
        """Save an (H, W, 3) float image panel in [0, 1] as png."""
        arr = (np.clip(np.asarray(img), 0, 1) * 255).astype("uint8")
        out = self.log_dir / "images" / f"{tag.replace('/', '_')}_{step}.png"
        out.parent.mkdir(exist_ok=True)
        Image.fromarray(arr).save(out)

    def close(self):
        self._fh.close()


class NullLogger:
    """A :class:`MetricsLogger` that writes nothing (the ranks but 0 of a
    data-parallel run)."""

    def log_scalars(self, *args, **kwargs):
        pass

    log_text = log_image = close = log_scalars
