"""Host training loop (counterpart of ``text_to_image_tpu/train/trainer.py``,
the loop only): stacked [n_critic, B, …] batches from the dataset, one tick
per step, metrics read every ``summary_interval`` steps and after the last
one (each read is also the NaN guard) and printed as ``[step N] …`` lines
with ``images_per_sec``.

Checkpoints, sample grids, the real datasets and the device-resident data
tier are ROADMAP.md 'Modules to port' item 3.  A run that would need one
of them raises `NotImplementedError` before its first step; none is
skipped silently.  ``stackgan_stage2`` takes its frozen Stage-I generator
from the ``.npz`` that ``cfg.stage1_checkpoint`` names, or draws it from the
seed when that is empty; a checkpoint directory there raises as well.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional

import numpy as np
import torch

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.convert import load_stage1_generator
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_train_step)

ITEM_3 = "ROADMAP.md, 'Modules to port' item 3 (data, checkpoint, trainer)"


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


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        if cfg.data.device_resident in ("on", "sharded"):
            raise NotImplementedError(
                f"data.device_resident={cfg.data.device_resident!r}: the "
                f"device-resident data tier is not ported yet: {ITEM_3}")
        self.cfg = cfg
        self.dataset = get_dataset(cfg)
        self.steps_per_epoch = max(
            1, self.dataset.num_examples // cfg.train.batch_size)
        stage1 = (load_stage1_generator(cfg.stage1_checkpoint, device)
                  if cfg.model == "stackgan_stage2" else None)
        self.ts = init_train_state(cfg.seed, cfg, self.steps_per_epoch, device,
                                   stage1=stage1)
        self.step_fn = make_train_step(cfg, self.steps_per_epoch, device)
        self.meter = ThroughputMeter(cfg.train.batch_size * cfg.train.n_critic)
        self.history: list = []
        print("data path: host feed (synthetic dataset, stacked per tick)")

    def next_batch(self) -> Dict[str, np.ndarray]:
        """One tick's data: n_critic batches stacked to [K, B, …]."""
        cfg = self.cfg
        parts = [self.dataset.next_batch(cfg.train.batch_size,
                                         window=cfg.data.caption_window)
                 for _ in range(cfg.train.n_critic)]
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}

    def train(self, num_steps: Optional[int] = None) -> None:
        """Run to ``num_steps`` (absolute; default max_epoch epochs)."""
        cfg = self.cfg
        tcfg = cfg.train
        total = (num_steps if num_steps is not None
                 else tcfg.max_epoch * self.steps_per_epoch)
        start = self.ts.step
        for what, every in (("checkpoints", tcfg.snapshot_interval),
                            ("sample grids", tcfg.sample_interval)):
            if total // every > start // every:
                raise NotImplementedError(
                    f"steps {start}..{total} reach train."
                    f"{'snapshot' if what == 'checkpoints' else 'sample'}"
                    f"_interval={every}, but {what} are not ported yet: "
                    f"{ITEM_3}; raise the interval past the run's length")
        for i in range(start, total):
            self.ts, metrics = self.step_fn(self.ts, self.next_batch())
            ips = self.meter.tick()
            if (i + 1) % tcfg.summary_interval == 0 or i + 1 == total:
                self.summary(i + 1, metrics, ips)
        print(f"trained to step {total}; the weights are not saved: "
              f"checkpoints are not ported yet ({ITEM_3})")

    def summary(self, step: int, metrics: Dict[str, torch.Tensor],
                ips: Optional[float]) -> Dict[str, float]:
        """Read the metrics (one device→host copy), stop on a non-finite
        one, and print a ``[step N]`` line."""
        names = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
        host = dict(zip(names, vals))
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            raise FloatingPointError(
                f"non-finite metrics {bad} at step {step}: diverged "
                f"(consider a lower lr or another n_critic)")
        if ips is not None:
            host["images_per_sec"] = ips
        host["epoch"] = (step - 1) // self.steps_per_epoch
        self.history.append({"step": step, **host})
        body = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                        for k, v in host.items())
        print(f"[step {step}] {body}", flush=True)
        return host
