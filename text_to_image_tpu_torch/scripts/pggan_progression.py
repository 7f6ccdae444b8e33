"""The whole C-PGGAN progression to 256 px on the port (counterpart of the
JAX package's ``scripts/pggan_progression.py``).

Runs all seven stages (4 → 256 px) of ``configs/pggan_flowers_256.yml``'s
recipe (batch 32, n_critic 2, Adam(0, 0.9), the GP and the drift term,
α fading over the first half of each stage) on the class-structured
synthetic dataset through `train.trainer.train_progressive` (one Trainer a
stage, each restoring the checkpoint the stage before left), then restores
the final checkpoint into a full-depth state and reports the 256 px quality
(the synthetic IS, the fixed-z class-colour correlation r, the conditional
accuracy) and a sample grid, written to
``<root>/samples/pggan_<size>px_<dataset>_grid.png`` (the JAX script writes
it under the repository's ``assets/``).

    python -m text_to_image_tpu_torch.scripts.pggan_progression \
        [steps_per_stage] [image_size] [synthetic|natural|natural16] \
        [--ema[=0.999]] [--ema-rampup[=10]] [--resume] [--device cpu]

``--ema`` trains with a generator weight EMA and reports both the EMA and
the live params' eval of the same state; ``--ema-rampup`` ramps the decay
as min(decay, (1 + t)/(rampup + t)), t counted from each stage's fade end.
``--resume`` keeps the run directory: the progression re-enters at the
first stage the latest checkpoint does not cover.  Prints ``PGGAN256
RESULT {json}`` and ``PGGAN256 PASS`` (r > 0.9 and IS > 4) or ``PGGAN256
FAIL``; ``main`` returns 0 or 1.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

from text_to_image_tpu_torch.config import (CoeffConfig, Config, DataConfig,
                                            GanConfig, PgganConfig,
                                            TrainConfig)
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.eval import synthetic_quality as sq
from text_to_image_tpu_torch.eval.sampler import (live_generator,
                                                  make_generator_fn,
                                                  sample_grid)
from text_to_image_tpu_torch.models import pggan as PG
from text_to_image_tpu_torch.scripts import split_device
from text_to_image_tpu_torch.train.checkpoint import CheckpointManager
from text_to_image_tpu_torch.train.steps import init_train_state
from text_to_image_tpu_torch.train.trainer import run_dir, train_progressive
from text_to_image_tpu_torch.utils import prng
from text_to_image_tpu_torch.utils.images import save_images

ROOT = "runs/pggan256"


def _cfg(steps_per_stage: int, image_size: int, root: str,
         dataset: str = "synthetic", ema_decay: float = 0.0,
         ema_rampup: float = 0.0) -> Config:
    """``configs/pggan_flowers_256.yml``'s recipe on `dataset`."""
    return Config(
        model="pggan",
        gan=GanConfig(),
        train=TrainConfig(batch_size=32, n_critic=2, g_steps=1, beta1=0.0,
                          beta2=0.9, lr_decay_epoch=10**9,
                          summary_interval=100, sample_interval=10**9,
                          snapshot_interval=10**9, ema_decay=ema_decay,
                          ema_rampup=ema_rampup,
                          coeff=CoeffConfig(gp_lambda=10.0,
                                            drift_epsilon=1e-3)),
        data=DataConfig(dataset_name=dataset, image_size=image_size),
        pggan=PgganConfig(stage=0, steps_per_stage=steps_per_stage,
                          fade_fraction=0.5),
        dtype="bfloat16",
        checkpoint_dir=os.path.join(root, "ck"),
        sample_dir=os.path.join(root, "samples"),
        log_dir=os.path.join(root, "logs"),
    )


def main(steps_per_stage: int = 3000, image_size: int = 256,
         root: str = ROOT, resume: bool = False,
         dataset: str = "synthetic", ema_decay: float = 0.0,
         ema_rampup: float = 0.0, device: str = "cuda") -> int:
    if not resume:
        shutil.rmtree(root, ignore_errors=True)
    cfg = _cfg(steps_per_stage, image_size, root, dataset, ema_decay,
               ema_rampup)
    n = PG.num_stages(image_size)

    t0 = time.time()
    train_progressive(cfg, device=device)   # skips the stages a checkpoint covers
    dt = time.time() - t0
    print(f"[pggan] {n}-stage progression ({n * steps_per_stage} steps "
          f"total) in {dt:.1f}s", flush=True)

    # the final stage's eval: the last checkpoint in a full-depth state
    final = cfg.replace(pggan=dataclasses.replace(
        cfg.pggan, stage=n, start_step=(n - 1) * steps_per_stage))
    ds = get_dataset(final)
    ts = init_train_state(cfg.seed, final, 8, device)
    ts, restored = CheckpointManager(run_dir(cfg, cfg.checkpoint_dir)
                                     ).restore(ts)
    if restored is None:
        raise FileNotFoundError(
            f"no checkpoint under {run_dir(cfg, cfg.checkpoint_dir)}")
    print(f"[pggan] restored step {restored}", flush=True)

    gen = make_generator_fn(final, device=device)
    q = sq.evaluate(gen, ts, final, ds, num_classes=ds.num_classes,
                    device=device)
    print(f"[pggan {image_size}px] {q}", flush=True)
    if ema_decay > 0:
        q_live = sq.evaluate(gen, live_generator(ts), final, ds,
                             num_classes=ds.num_classes, device=device)
        print(f"[pggan {image_size}px] LIVE-params eval (EMA off): {q_live}",
              flush=True)
        print(f"[pggan] EMA(decay={ema_decay}, rampup={ema_rampup}) IS delta: "
              f"{q['is_mean'] - q_live['is_mean']:+.2f} "
              f"(EMA {q['is_mean']:.2f} vs live {q_live['is_mean']:.2f})",
              flush=True)

    grid = sample_grid(gen, ts, final,
                       ds.test_embeddings(32).astype("float32"),
                       generator=prng.generator(7))
    path = save_images(grid, os.path.join(
        cfg.sample_dir, f"pggan_{image_size}px_{dataset}_grid.png"))
    print(f"[pggan] grid: {path}", flush=True)

    print("PGGAN256 RESULT " + json.dumps(dict(q, train_s=round(dt, 1))),
          flush=True)
    ok = q["r"] > 0.9 and q["is_mean"] > 4.0
    print("PGGAN256 PASS" if ok else "PGGAN256 FAIL", flush=True)
    return 0 if ok else 1


def parse_argv(argv) -> dict:
    """`main`'s keyword arguments from the command line."""
    device, argv = split_device(argv)
    kw = {"device": device}
    pos = []
    for a in argv:
        if a == "--resume":
            kw["resume"] = True
        elif a.startswith("--ema-rampup"):
            kw["ema_rampup"] = float(a.split("=", 1)[1]) if "=" in a else 10.0
        elif a.startswith("--ema"):
            kw["ema_decay"] = float(a.split("=", 1)[1]) if "=" in a else 0.999
        else:
            pos.append(a)
    for name, conv, v in zip(("steps_per_stage", "image_size", "dataset"),
                             (int, int, str), pos):
        kw[name] = conv(v)
    return kw


if __name__ == "__main__":
    sys.exit(main(**parse_argv(sys.argv[1:])))
