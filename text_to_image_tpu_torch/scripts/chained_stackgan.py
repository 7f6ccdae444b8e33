"""The reference's flagship user journey on the port (counterpart of the
JAX package's ``scripts/chained_stackgan.py``): train StackGAN Stage-I at
64 px, freeze its generator into Stage-II through ``stage1_checkpoint``
(the Stage-I run directory; its EMA weights where it kept them), train
Stage-II at 256 px, and report 256 px quality (the synthetic IS with a
dataset-finetuned classifier, the fixed-z class-colour correlation r, the
conditional accuracy) and sample grids.

Runs on the class-structured synthetic dataset (nothing is downloaded);
both stages share its classes and embeddings, so Stage-II refines what
Stage-I conditioned on.  A third argument selects ``natural`` /
``natural16`` (``data/natural.py``: crops of the photographs bundled with
installed packages, 76 px sources for Stage-I and 304 px for Stage-II).

    python -m text_to_image_tpu_torch.scripts.chained_stackgan \
        [stage1_steps] [stage2_steps] [synthetic|natural|natural16] \
        [--ema[=0.999]] [--resume] [--s2-g2] [--traj[=1000]] [--device cpu]

``--resume`` keeps the run directory and continues both stages from their
latest checkpoints (a snapshot every 1000 steps).  ``--ema`` trains both
stages with a generator weight EMA (``train.ema_decay``): the evals and
grids sample the EMA params, Stage-II freezes the EMA Stage-I, and each
stage also reports the live params' IS and r (``live_is_mean``,
``live_r``) from the same state.  ``--s2-g2`` gives Stage-II two G updates
a tick.  ``--traj=N`` evaluates Stage-II every N steps with one shared
classifier (`_traj_hook`), keeps the best-IS state in a checkpoint of its
own and writes ``best.json`` beside it.

Three departures from the JAX script, each a repair:

* a run whose every trajectory eval has a NaN IS still prints ``CHAINED
  RESULT`` (without ``stage2_best``) and its verdict, where the JAX script
  ends in a ``KeyError``;
* the final result taken from the trajectory's last eval drops the
  ``resumed_seed`` mark along with ``step``, and with ``--ema`` still runs
  the live-params A/B;
* a trajectory eval at or before the best record's step (a step replayed
  after ``--resume``, already evaluated before the interruption) never
  replaces the best record or saves its checkpoint again, so ``best.json``
  always describes the checkpoint beside it.

Prints ``CHAINED RESULT {json}`` and ``CHAINED PASS`` (r > 0.9 and IS > 4
for the best Stage-II eval, else the final one) or ``CHAINED FAIL``;
``main`` returns 0 or 1.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

from text_to_image_tpu_torch.config import (Config, DataConfig, GanConfig,
                                            TrainConfig)
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.eval import synthetic_quality as sq
from text_to_image_tpu_torch.eval.sampler import (live_generator,
                                                  make_generator_fn)
from text_to_image_tpu_torch.scripts import split_device
from text_to_image_tpu_torch.train.checkpoint import CheckpointManager
from text_to_image_tpu_torch.train.trainer import Trainer

ROOT = "runs/chained"
N_CLASSES = 8


def _cfg(model: str, image_size: int, root: str,
         dataset: str = "synthetic", ema_decay: float = 0.0,
         g_steps: int = 1) -> Config:
    """The JAX script's recipe: flagship widths (gf 128, df 64, z 100,
    embed 1024), batch 64, bf16, a constant LR (the staircase decay counts
    epochs, and the synthetic split's are tiny), g_steps 1 (the StackGAN
    schedule), a snapshot every 1000 steps."""
    return Config(
        model=model,
        gan=GanConfig(),
        train=TrainConfig(batch_size=64, g_steps=g_steps,
                          lr_decay_epoch=10**6,
                          summary_interval=50, sample_interval=10**9,
                          snapshot_interval=1000, ema_decay=ema_decay),
        data=DataConfig(dataset_name=dataset, image_size=image_size),
        dtype="bfloat16",
        checkpoint_dir=os.path.join(root, "ck"),
        sample_dir=os.path.join(root, "samples"),
        log_dir=os.path.join(root, "logs"),
        stage1_checkpoint=(os.path.join(root, "ck", "stackgan_stage1",
                                        dataset)
                           if model == "stackgan_stage2" else ""),
    )


def _dataset(image_size: int, dataset: str = "synthetic"):
    if dataset.startswith("natural"):
        from text_to_image_tpu_torch.data.natural import (ANCHORS, ANCHORS16,
                                                          NaturalPhotoDataset)
        return NaturalPhotoDataset(examples_per_class=64,
                                   image_size=image_size,
                                   embed_dim=1024, seed=0,
                                   anchors=(ANCHORS16 if dataset == "natural16"
                                            else ANCHORS))
    return SyntheticDataset(num_examples=512, image_size=image_size,
                            embed_dim=1024, num_classes=N_CLASSES, seed=0)


def _num_classes(ds) -> int:
    return getattr(ds, "num_classes", N_CLASSES)


def _traj_hook(cfg: Config, ds, points: list, state: dict, device="cuda"):
    """Trainer ``eval_fn``: the quality eval every ``eval_interval`` steps.

    GAN quality is not monotone in steps, so a long run needs the curve
    and the best state: on a new best IS the hook writes the sample grid
    and snapshots the whole TrainState into ``state["ckpt"]`` (a
    ``max_to_keep=1`` manager, which the rolling training manager cannot
    evict), with ``best.json`` beside it so that ``--resume`` seeds the
    record.  A step at or before the best record's step is a replay after
    ``--resume`` (that step was evaluated before the interruption): its
    point is kept, the record and its checkpoint are not touched.  One
    classifier serves every eval of the run (one cache for this dataset
    and class count)."""
    gen = make_generator_fn(cfg, device=device)
    clf_cache = {}

    def hook(trainer, step):
        q = sq.evaluate(gen, trainer.ts, cfg, ds, _num_classes(ds),
                        clf_cache=clf_cache, device=device)
        q = dict(q, step=step)
        points.append(q)
        print(f"[{cfg.model}] TRAJ {json.dumps(q)}", flush=True)
        best = state.get("best", {})
        if step <= best.get("step", -1):
            return
        if q["is_mean"] > best.get("is_mean", -1.0):
            state["best"] = q
            trainer.save_samples(step)
            if state.get("ckpt") is not None:
                state["ckpt"].save(step, trainer.ts)
                with open(os.path.join(state["ckpt"].directory,
                                       "best.json"), "w") as f:
                    json.dump(q, f)

    return hook


def _train(cfg: Config, ds, steps: int, resume: bool = False,
           eval_fn=None, eval_interval: int = 0, device="cuda") -> Trainer:
    t0 = time.time()
    t = Trainer(cfg, dataset=ds, device=device, restore=resume)
    print(f"[{cfg.model}] trainer ready in {time.time() - t0:.1f}s",
          flush=True)
    start = t.ts.step
    t0 = time.time()
    t.train(num_steps=steps, eval_fn=eval_fn, eval_interval=eval_interval)
    dt = max(time.time() - t0, 1e-9)
    ran = max(steps - start, 0)
    print(f"[{cfg.model}] {ran} steps (from {start}) in {dt:.1f}s "
          f"({ran / dt:.2f} steps/s, "
          f"{ran * cfg.train.batch_size / dt:.1f} img/s)", flush=True)
    return t


def _live_ab(q: dict, ts, cfg: Config, ds, device="cuda") -> dict:
    """With the generator EMA on, `q` (the EMA params' eval) with the live
    params' IS and r of the same state beside it."""
    if cfg.train.ema_decay <= 0:
        return q
    q_live = sq.evaluate(make_generator_fn(cfg, device=device),
                         live_generator(ts),
                         cfg, ds, _num_classes(ds), device=device)
    print(f"[{cfg.model}] LIVE-params eval (EMA off): {q_live}; "
          f"EMA(decay={cfg.train.ema_decay}) IS delta "
          f"{q['is_mean'] - q_live['is_mean']:+.2f}", flush=True)
    return dict(q, live_is_mean=q_live["is_mean"], live_r=q_live["r"])


def _quality(t: Trainer, cfg: Config, ds, device="cuda") -> dict:
    q = sq.evaluate(make_generator_fn(cfg, device=device), t.ts, cfg, ds,
                    _num_classes(ds), device=device)
    return _live_ab(q, t.ts, cfg, ds, device)


def main(stage1_steps: int = 3000, stage2_steps: int = 3000,
         root: str = ROOT, dataset: str = "synthetic",
         ema_decay: float = 0.0, resume: bool = False,
         stage2_g_steps: int = 1, traj_interval: int = 0,
         device: str = "cuda") -> int:
    if not resume:
        shutil.rmtree(root, ignore_errors=True)
    results = {}

    # Stage-I, 64 px
    cfg1 = _cfg("stackgan_stage1", 64, root, dataset, ema_decay)
    ds64 = _dataset(64, dataset)
    t1 = _train(cfg1, ds64, stage1_steps, resume, device=device)
    results["stage1"] = _quality(t1, cfg1, ds64, device)
    print(f"[stage1] {results['stage1']}", flush=True)
    t1.save_samples(stage1_steps)
    t1.close()

    # Stage-II, 256 px, over the frozen Stage-I of that run directory
    cfg2 = _cfg("stackgan_stage2", 256, root, dataset, ema_decay,
                g_steps=stage2_g_steps)
    ds256 = _dataset(256, dataset)
    eval_fn, points, tstate = None, [], {}
    if traj_interval > 0:
        tstate["ckpt"] = CheckpointManager(
            os.path.join(root, "ck", "stackgan_stage2", dataset + "_best"),
            max_to_keep=1)
        best_json = os.path.join(tstate["ckpt"].directory, "best.json")
        if resume and os.path.exists(best_json):
            with open(best_json) as f:
                tstate["best"] = json.load(f)
            points.append(dict(tstate["best"], resumed_seed=True))
            print(f"[stage2] resume: seeded best from {best_json}: "
                  f"{tstate['best']}", flush=True)
        eval_fn = _traj_hook(cfg2, ds256, points, tstate, device)
    t2 = _train(cfg2, ds256, stage2_steps, resume, eval_fn=eval_fn,
                eval_interval=traj_interval, device=device)
    if points and points[-1].get("step") == stage2_steps:
        # the trajectory evaluated the final step with the run's classifier
        q = {k: v for k, v in points[-1].items()
             if k not in ("step", "resumed_seed")}
        results["stage2"] = _live_ab(q, t2.ts, cfg2, ds256, device)
    else:
        results["stage2"] = _quality(t2, cfg2, ds256, device)
    print(f"[stage2] {results['stage2']}", flush=True)
    grid = t2.save_samples(stage2_steps)
    print(f"[stage2] grid: {grid}", flush=True)
    t2.close()
    if points:
        results["stage2_traj"] = points
        tstate["ckpt"].close()
        best = tstate.get("best")
        if best is not None:
            results["stage2_best"] = best
            print(f"[stage2] BEST over trajectory: {best} "
                  f"(final: {results['stage2']})", flush=True)
        else:
            print("[stage2] no trajectory eval had a finite IS: no best "
                  "record", flush=True)

    print("CHAINED RESULT " + json.dumps(results), flush=True)
    s2 = results.get("stage2_best", results["stage2"])
    ok = s2["r"] > 0.9 and s2["is_mean"] > 4.0
    print("CHAINED PASS" if ok else "CHAINED FAIL", flush=True)
    return 0 if ok else 1


def parse_argv(argv) -> dict:
    """`main`'s keyword arguments from the command line."""
    device, argv = split_device(argv)
    kw = {"device": device}
    pos = []
    for a in argv:
        if a.startswith("--ema"):
            kw["ema_decay"] = float(a.split("=", 1)[1]) if "=" in a else 0.999
        elif a.startswith("--traj"):
            kw["traj_interval"] = int(a.split("=", 1)[1]) if "=" in a else 1000
        elif a == "--resume":
            kw["resume"] = True
        elif a == "--s2-g2":
            kw["stage2_g_steps"] = 2
        else:
            pos.append(a)
    for name, conv, v in zip(("stage1_steps", "stage2_steps", "dataset"),
                             (int, int, str), pos):
        kw[name] = conv(v)
    return kw


if __name__ == "__main__":
    sys.exit(main(**parse_argv(sys.argv[1:])))
