"""Stage-II training-dynamics A/B (counterpart of the JAX package's
``scripts/stage2_dynamics.py``).

On natural pixels a long chained run once left Stage-II below Stage-I with
its discriminator saturated for thousands of steps (d_loss ~1e-4..1e-6):
D too strong at 256 px on textures.  This harness A/Bs the candidate fixes
at one budget from one shared Stage-I checkpoint, and reports both the
quality (IS, cond_acc, r at 256 px) and the saturation itself (the median
d_loss and the share of logged steps with d_loss < 1e-3 over the last half
of training, `_saturation`):

  base    the shipped recipe (the control)
  smooth  one-sided label smoothing: d_real target 0.9
          (train.coeff.real_label_smooth)
  g2      g_steps=2 (two G updates per D update)
  dlr     discriminator_lr halved to 1e-4
  dthin   df_dim 64 -> 32 (a half-width D at 256 px)
  smooth+g2, or any '+'-joined combination

    python -m text_to_image_tpu_torch.scripts.stage2_dynamics \
        [stage1_steps] [stage2_steps] [variant[,variant...]] \
        [--dataset=natural] [--keep-stage1] [--device cpu]

The Stage-I checkpoint is trained once into ``runs/s2ab/ck`` and reused by
every variant (and by later invocations with ``--keep-stage1``).  The
recipe, datasets, training and quality eval are `chained_stackgan`'s.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time

import numpy as np

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.scripts import split_device
from text_to_image_tpu_torch.scripts.chained_stackgan import (_cfg, _dataset,
                                                              _quality,
                                                              _train)

ROOT = "runs/s2ab"


def _variant_cfg(cfg: Config, variant: str) -> Config:
    for part in variant.split("+"):
        if part == "base":
            continue
        elif part == "smooth":
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, coeff=dataclasses.replace(
                    cfg.train.coeff, real_label_smooth=0.9)))
        elif part == "g2":
            cfg = cfg.replace(train=dataclasses.replace(cfg.train, g_steps=2))
        elif part == "dlr":
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, discriminator_lr=1e-4))
        elif part == "dthin":
            cfg = cfg.replace(gan=dataclasses.replace(cfg.gan, df_dim=32))
        else:
            raise SystemExit(f"unknown variant part {part!r}")
    return cfg


def _saturation(log_dir: str, model: str, dataset: str) -> dict:
    """The run's ``train.jsonl`` (``utils/metrics.py``): d_loss statistics
    over the last half of its records."""
    path = os.path.join(log_dir, model, dataset, "train.jsonl")
    d = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "d_loss" in rec:
                d.append(rec["d_loss"])
    tail = np.asarray(d[len(d) // 2:], np.float64)
    return {"d_loss_median_tail": float(np.median(tail)),
            "d_sat_frac_tail": float((tail < 1e-3).mean()),
            "d_loss_last": float(tail[-1])}


def main(stage1_steps: int = 3000, stage2_steps: int = 5000,
         variants=("base", "smooth", "g2", "dlr"), dataset: str = "natural",
         keep_stage1: bool = False, root: str = ROOT,
         device: str = "cuda") -> int:
    s1_ck = os.path.join(root, "ck", "stackgan_stage1", dataset)
    if not (keep_stage1 and os.path.isdir(s1_ck)):
        shutil.rmtree(root, ignore_errors=True)
        cfg1 = _cfg("stackgan_stage1", 64, root, dataset)
        ds64 = _dataset(64, dataset)
        t1 = _train(cfg1, ds64, stage1_steps, device=device)
        q1 = _quality(t1, cfg1, ds64, device)
        print(f"[stage1] {q1}", flush=True)
        with open(os.path.join(root, "stage1.json"), "w") as f:
            json.dump(q1, f)
        t1.close()
    else:
        print(f"[stage1] reusing checkpoint under {s1_ck}", flush=True)

    ds256 = _dataset(256, dataset)
    rows = {}
    for variant in variants:
        vroot = os.path.join(root, f"v_{variant.replace('+', '_')}")
        shutil.rmtree(vroot, ignore_errors=True)
        cfg2 = _variant_cfg(_cfg("stackgan_stage2", 256, vroot, dataset),
                            variant)
        # every variant refines the same frozen Stage-I
        cfg2 = cfg2.replace(stage1_checkpoint=s1_ck)
        print(f"=== variant {variant}: {stage2_steps} steps ===", flush=True)
        t0 = time.time()
        t2 = _train(cfg2, ds256, stage2_steps, device=device)
        q = _quality(t2, cfg2, ds256, device)
        q.update(_saturation(cfg2.log_dir, "stackgan_stage2", dataset))
        q["wall_s"] = round(time.time() - t0, 1)
        t2.save_samples(stage2_steps)
        t2.close()
        rows[variant] = q
        print(f"[{variant}] {q}", flush=True)

    print("\n=== Stage-II dynamics A/B ({} steps, {}) ===".format(
        stage2_steps, dataset), flush=True)
    hdr = ("variant", "IS", "cond_acc", "r", "d_med_tail", "d_sat%")
    print("{:<12} {:>6} {:>8} {:>6} {:>11} {:>7}".format(*hdr))
    for v, q in rows.items():
        print("{:<12} {:>6.2f} {:>8.3f} {:>6.3f} {:>11.2e} {:>7.1%}".format(
            v, q["is_mean"], q["cond_acc"], q["r"],
            q["d_loss_median_tail"], q["d_sat_frac_tail"]))
    print("S2AB RESULT " + json.dumps(rows), flush=True)
    return 0


def parse_argv(argv) -> dict:
    """`main`'s keyword arguments from the command line."""
    device, argv = split_device(argv)
    args = [a for a in argv if not a.startswith("--")]
    flags = [a for a in argv if a.startswith("--")]
    kw = {"device": device, "keep_stage1": "--keep-stage1" in flags}
    for f in flags:
        if f.startswith("--dataset"):
            kw["dataset"] = f.split("=", 1)[1]
    if len(args) > 0:
        kw["stage1_steps"] = int(args[0])
    if len(args) > 1:
        kw["stage2_steps"] = int(args[1])
    if len(args) > 2:
        kw["variants"] = args[2].split(",")
    return kw


if __name__ == "__main__":
    sys.exit(main(**parse_argv(sys.argv[1:])))
