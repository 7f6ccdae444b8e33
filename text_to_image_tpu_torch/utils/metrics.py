"""Metric writer and throughput meter (counterpart of
``text_to_image_tpu/utils/metrics.py``).

Metrics land as JSON lines (one dict per write, ``<log_dir>/<name>.jsonl``)
and, beside them, as TensorBoard event files through the pure-Python
encoder in ``utils/tensorboard.py``; each write also prints a ``[step N]``
line.  `hbm_stats` reads the card's allocator (`torch.cuda.memory_stats`).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from text_to_image_tpu_torch.utils.tensorboard import TBEventWriter


class MetricWriter:
    def __init__(self, log_dir: str, name: str = "train",
                 also_print: bool = True, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._print = also_print
        self._tb = TBEventWriter(log_dir) if tensorboard else None

    def write(self, step: int, metrics: Dict) -> None:
        rec = {"step": int(step)}
        for k, v in metrics.items():
            rec[k] = float(v) if isinstance(v, torch.Tensor) else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, rec["step"])
            self._tb.flush()
        if self._print:
            body = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                            for k, v in rec.items() if k != "step")
            print(f"[step {rec['step']}] {body}", flush=True)

    def write_image(self, step: int, tag: str, image: np.ndarray) -> None:
        """Log a uint8 [H, W, C] image summary (sample grids)."""
        if self._tb is not None:
            self._tb.add_image(tag, image, int(step))
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def hbm_stats(device=None) -> Dict[str, float]:
    """The card's allocated memory in GiB, now and at its peak (the JAX
    package's keys); empty off the card."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    gib = 1024**3
    return {"hbm_in_use_gib": round(stats["allocated_bytes.all.current"] / gib, 3),
            "hbm_peak_gib": round(stats["allocated_bytes.all.peak"] / gib, 3)}


class ThroughputMeter:
    """Images/s over a sliding window of recent ticks; the first tick
    (kernel builds, warm-up) only opens the window."""

    WINDOW = 200

    def __init__(self, images_per_step: int):
        self.images_per_step = images_per_step
        self._ticks: collections.deque = collections.deque(maxlen=self.WINDOW)

    def tick(self) -> Optional[float]:
        self._ticks.append(time.perf_counter())
        if len(self._ticks) < 2:
            return None
        dt = self._ticks[-1] - self._ticks[0]
        return self.images_per_step * (len(self._ticks) - 1) / dt if dt > 0 else None
