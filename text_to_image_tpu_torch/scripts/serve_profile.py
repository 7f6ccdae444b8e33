"""Per-stage attribution of the 256 px serving forward (counterpart of the
JAX package's ``scripts/serve_profile.py``).  The C-PGGAN generator at
stage k is the prefix of the stage-7 network (progressive growing), so
timing the forward at each stage and differencing attributes the cost to
each stage's layers (its toRGB swap included): no profiler needed.

    python -m text_to_image_tpu_torch.scripts.serve_profile [batch] \
        [--device cpu]

Stages 1–7 (4 → 256 px) of one state drawn from seed 0 at the shipped
widths, eval mode, bf16 weights cast once as the serving path casts them,
batch 32 by default; each stage's ms is the mean of 30 forwards between
two synchronises.  Prints the cumulative ms and the Δ of each stage and a
``SERVE RESULT {json}`` line.

The JAX script prints two columns, its ``use_pallas`` off and auto (the
TPU dispatch table between its Pallas kernels and XLA).  The port has one
column: ``use_pallas`` has no effect in the port (``config.py``), every
``upconv3x3_bias`` call of the forward runs the CUDA kernel on the card and
its plain version on the CPU, and there is no library dispatch to switch
to.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from text_to_image_tpu_torch.config import (CoeffConfig, Config, DataConfig,
                                            PgganConfig, TrainConfig)
from text_to_image_tpu_torch.models.registry import get_model
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.scripts import split_device
from text_to_image_tpu_torch.train.steps import init_train_state
from text_to_image_tpu_torch.utils import prng

STAGES = 7


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, iters=30) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters * 1e3


def base_config(batch: int = 32) -> Config:
    return Config(model="pggan",
                  train=TrainConfig(batch_size=batch, n_critic=2, g_steps=1,
                                    beta1=0.0,
                                    coeff=CoeffConfig(drift_epsilon=1e-3)),
                  data=DataConfig(dataset_name="synthetic", image_size=256),
                  pggan=PgganConfig(stage=STAGES, start_step=0),
                  dtype="bfloat16")


def stage_ms(base: Config, device="cuda", iters: int = 30) -> list:
    """ms of the eval-mode generator forward at each stage 1..7."""
    batch = base.train.batch_size
    ts = init_train_state(0, base, 100, device)
    policy = L.Policy.from_str(base.dtype)
    gp = L.cast_weights(ts.g_params, policy)
    z = torch.randn(batch, base.gan.z_dim, generator=prng.generator(1)
                    ).to(device)
    emb = torch.randn(batch, base.gan.embed_dim, generator=prng.generator(2)
                      ).to(device)
    eps = torch.randn(batch, base.gan.ca_dim, generator=prng.generator(3)
                      ).to(device)
    out = []
    for stage in range(1, STAGES + 1):
        cfg = base.replace(pggan=dataclasses.replace(base.pggan, stage=stage))
        bundle = get_model(cfg)

        @torch.inference_mode()
        def gen(_b=bundle):
            return _b.gen_apply(gp, ts.g_state, {}, z, emb, eps, False,
                                policy)[0]
        out.append(_time(gen, device, iters))
    return out


def main(batch: int = 32, device: str = "cuda", iters: int = 30) -> int:
    base = base_config(batch)
    name = (torch.cuda.get_device_name(torch.device(device))
            if torch.device(device).type == "cuda" else "cpu")
    print(f"device: {name} | B={batch} | per-stage serving forward "
          f"(cumulative prefix cost; Δ = this stage's layers incl its to_rgb "
          f"swap)")
    rows = stage_ms(base, device, iters)
    prev = 0.0
    for stage, ms in enumerate(rows, 1):
        print(f"  stage {stage} ({4 * 2 ** (stage - 1)}px): cum {ms:7.2f} ms "
              f"| Δ {ms - prev:7.2f} ms", flush=True)
        prev = ms
    print("\nstage Δ-attribution (ms):")
    print("stage  res  kernels")
    prev = 0.0
    for i, ms in enumerate(rows):
        print(f"{i + 1:>5} {4 * 2 ** i:>4}px {ms - prev:7.2f}")
        prev = ms
    print(f"total        {rows[-1]:7.2f}")
    print("SERVE RESULT " + json.dumps({
        "device": name, "batch": batch, "cum_ms": rows,
        "delta_ms": [b - a for a, b in zip([0.0] + rows[:-1], rows)]}),
        flush=True)
    return 0


def parse_argv(argv) -> dict:
    device, argv = split_device(argv)
    kw = {"device": device}
    if argv:
        kw["batch"] = int(argv[0])
    return kw


if __name__ == "__main__":
    sys.exit(main(**parse_argv(sys.argv[1:])))
