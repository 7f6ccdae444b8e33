"""A device trace of the training tick (counterpart of the JAX package's
``scripts/profile_step.py``): a Chrome-trace JSON of `--steps` ticks under
``--out`` (``utils/profiling.trace``: torch.profiler over the CPU and the
card), which TensorBoard's profiler plugin and Perfetto load, after the
steady-state ms a tick (``utils/profiling.time_step``).

    python -m text_to_image_tpu_torch.scripts.profile_step [--model gancls] \
        [--batch 64] [--image-size 64] [--steps 10] [--out /tmp/t2i_trace] \
        [--device cpu]

The tick runs on one batch of random uint8 images and embeddings kept on
the device (the config's widths, bf16; ``stackgan_stage2`` at 256 px over
a frozen Stage-I drawn from the seed).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from text_to_image_tpu_torch.config import Config, DataConfig, TrainConfig
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_train_step)
from text_to_image_tpu_torch.utils.profiling import time_step, trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default="gancls")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--out", default="/tmp/t2i_trace")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.model == "stackgan_stage2" and args.image_size == 64:
        args.image_size = 256
    cfg = Config(model=args.model,
                 train=TrainConfig(batch_size=args.batch,
                                   g_steps=1 if args.model != "gancls" else 2),
                 data=DataConfig(dataset_name="synthetic",
                                 image_size=args.image_size),
                 dtype="bfloat16")
    return profile(cfg, args.steps, args.out, args.device)


def profile(cfg: Config, steps: int, out: str, device="cuda") -> int:
    """Time `cfg`'s tick, then trace `steps` more under `out`."""
    ts = init_train_state(0, cfg, 100, device)
    step = make_train_step(cfg, 100, device)
    rng = np.random.default_rng(0)
    r, b, k = cfg.data.image_size, cfg.train.batch_size, cfg.train.n_critic
    batch = {
        "real": rng.integers(0, 255, (k, b, r, r, 3), dtype=np.uint8),
        "wrong": rng.integers(0, 255, (k, b, r, r, 3), dtype=np.uint8),
        "emb": rng.normal(size=(k, b, cfg.gan.embed_dim)).astype(np.float32),
    }
    batch = {name: torch.as_tensor(v).to(device) for name, v in batch.items()}

    timing = time_step(step, ts, batch, iters=5, warmup=2)
    print(f"pre-trace: {timing['ms_per_iter']:.2f} ms/step")

    with trace(out):
        for _ in range(steps):
            ts, m = step(ts, batch)
        float(m["g_loss"])           # the traced ticks done
    print(f"trace written to {out} (open with TensorBoard's profile tab or "
          f"Perfetto)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
