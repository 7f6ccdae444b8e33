"""Conditioning and convergence check of the port (counterpart of the JAX
package's ``scripts/convergence_check.py``).

Trains GAN-CLS (or GAN-INT, WGAN-CLS, the last C-PGGAN stage) on the
class-structured synthetic dataset for a few thousand steps on the
device-resident tier (``train/steps.make_resident_step`` over the split
staged by ``data/device.stage``), then checks the invariants the
matching-aware design must produce:

1. the discriminator separates matched from mismatched (image, text) pairs
   by a wide logit margin;
2. with a fixed z, sweeping the class embedding sweeps the generated mean
   colour in lockstep with the real class colours (r);
3. the synthetic Inception score with a dataset-finetuned classifier and
   the conditional accuracy (``eval/synthetic_quality.evaluate``).

The JAX package recorded, on a TPU: GAN-CLS after 3000 steps a margin of
about 5.1 (−0.6 against −5.7) and r = 0.999, IS 7.70 ± 0.10 of 8 after 4000;
WGAN-CLS r = 0.988 after 1500 steps.

    python -m text_to_image_tpu_torch.scripts.convergence_check [steps] \
        [gancls|gancls_int|pggan|wgancls] [synthetic|natural|natural16] \
        [grid.png] [--iv3] [--device cpu]

``--iv3`` also scores the generator with the full InceptionV3 finetuned on
the same real images (``evaluate_iv3``).  ``grid.png`` is a class-major
grid, one class a row.  PASS: margin > 1, (r > 0.9 or cond_acc > 0.5) and
IS > 4; prints ``CONVERGENCE PASS`` or ``CONVERGENCE FAIL`` and
``CONVERGENCE RESULT {json}``; ``main`` returns 0 or 1.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from text_to_image_tpu_torch.config import (CoeffConfig, Config, DataConfig,
                                            TrainConfig)
from text_to_image_tpu_torch.data import device as DD
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.eval import synthetic_quality as sq
from text_to_image_tpu_torch.eval.sampler import (eval_g_params,
                                                  make_generator_fn)
from text_to_image_tpu_torch.models import pggan as PG
from text_to_image_tpu_torch.models.registry import get_model
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.scripts import split_device
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_resident_step)
from text_to_image_tpu_torch.utils import prng
from text_to_image_tpu_torch.utils.images import save_images

STEPS_PER_EPOCH = 8


def _config(model: str, dataset: str = "synthetic") -> Config:
    if model == "wgancls":
        # the ε·E[D²] score anchor on natural data only: there the
        # unanchored critic scale ran away; the synthetic task converges
        # without it (the paper recipe)
        coeff = (CoeffConfig(drift_epsilon=1e-3)
                 if dataset.startswith("natural") else CoeffConfig())
        train = TrainConfig(batch_size=64, n_critic=5, g_steps=1,
                            generator_lr=1e-4, discriminator_lr=1e-4,
                            beta1=0.0, beta2=0.9, coeff=coeff)
    elif model == "pggan":
        # WGAN-GP with more critic steps and a lower lr than Karras', the
        # drift term anchoring the score scale; the last stage at α = 1
        train = TrainConfig(batch_size=64, n_critic=2, g_steps=1,
                            generator_lr=2e-4, discriminator_lr=2e-4,
                            beta1=0.0, beta2=0.9,
                            coeff=CoeffConfig(drift_epsilon=1e-3))
    elif model == "gancls_int":
        # GAN-INT: the interpolated-caption term fools D only
        train = TrainConfig(batch_size=64, g_steps=2,
                            use_interpolation=True)
        model = "gancls"
    else:
        train = TrainConfig(batch_size=64, g_steps=2)
    cfg = Config(model=model, train=train,
                 data=DataConfig(dataset_name="synthetic", image_size=64),
                 dtype="bfloat16")
    if model == "pggan":
        cfg = cfg.replace(pggan=dataclasses.replace(
            cfg.pggan, stage=PG.num_stages(64), fade_fraction=0.0,
            start_step=0))
    return cfg


def _dataset(dataset: str = "synthetic"):
    if dataset.startswith("natural"):
        from text_to_image_tpu_torch.data.natural import (ANCHORS, ANCHORS16,
                                                          NaturalPhotoDataset)
        return NaturalPhotoDataset(
            examples_per_class=64, image_size=64, embed_dim=1024, seed=0,
            anchors=(ANCHORS16 if dataset == "natural16" else ANCHORS))
    return SyntheticDataset(num_examples=512, image_size=64,
                            embed_dim=1024, num_classes=8, seed=0)


def class_grid(gen, ts, cfg: Config, ds, n_cls: int, per_class: int = 8
               ) -> np.ndarray:
    """One row a class: `per_class` images of z from key 7 (ε from key 8),
    each row conditioned on its class's first example's first caption."""
    n = per_class * n_cls
    z = torch.randn(n, cfg.gan.z_dim, generator=prng.generator(7))
    shape = gen.eps_shape(n)
    eps = (None if shape is None
           else torch.randn(*shape, generator=prng.generator(8)))
    embs_c = np.stack([ds.embeddings[np.where(ds.class_ids == c)[0][0], 0]
                       for c in range(n_cls)])
    embs = np.repeat(embs_c, per_class, axis=0)
    return gen(eval_g_params(ts), ts.g_state, ts.aux, z, embs, eps
               ).cpu().numpy()


def margin_of(ts, cfg: Config, ds, device="cuda") -> float:
    """D's mean logit on 64 matched (image, text) pairs minus its mean on
    the same images with the texts rolled by 13 (train-mode BN; the new
    D state is thrown away)."""
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    b = ds.next_batch(64)
    real = torch.as_tensor(b["real"].astype(np.float32) / 127.5 - 1.0,
                           device=device)
    emb = torch.as_tensor(b["emb"], device=device)
    with torch.no_grad():
        def da(x, e):
            return bundle.disc_apply(ts.d_params, ts.d_state, ts.aux, x, e,
                                     True, policy)[0].float()
        return float(da(real, emb).mean()
                     - da(real, torch.roll(emb, 13, dims=0)).mean())


def main(steps: int = 3000, model: str = "gancls",
         dataset: str = "synthetic", grid_path: str = "",
         with_iv3: bool = False, device: str = "cuda") -> int:
    cfg = _config(model, dataset)
    ds = _dataset(dataset)
    n_cls = ds.num_classes
    ts = init_train_state(0, cfg, STEPS_PER_EPOCH, device)
    step = make_resident_step(cfg, STEPS_PER_EPOCH, device)
    data = DD.stage(ds, device)

    print("first step...", flush=True)
    t0 = time.time()
    for i in range(steps):
        ts, m = step(ts, data)
        if i == 0:
            print(f"first step done in {time.time() - t0:.1f}s", flush=True)
        if (i + 1) % 500 == 0:
            print(f"step {i + 1}: d={float(m['d_loss']):.2f} "
                  f"g={float(m['g_loss']):.2f} "
                  f"({(i + 1) / (time.time() - t0):.1f} steps/s)", flush=True)
    if steps:
        float(m["d_loss"])                   # the last tick done
    dt = time.time() - t0
    print(f"trained {steps} steps in {dt:.1f}s "
          f"({steps * cfg.train.batch_size / max(dt, 1e-9):.1f} img/s)",
          flush=True)

    margin = margin_of(ts, cfg, ds, device)
    print("training done; evaluating (classifier finetune + IS)...",
          flush=True)
    gen = make_generator_fn(cfg, device=device)
    q = sq.evaluate(gen, ts, cfg, ds, num_classes=n_cls, num_images=1280,
                    device=device)
    if with_iv3:
        print("scoring with full InceptionV3 (finetune + IS)...", flush=True)
        q_iv3 = sq.evaluate_iv3(gen, ts, cfg, ds, num_classes=n_cls,
                                num_images=1280, device=device)
        q.update(q_iv3)
        print(f"IV3 (from-scratch finetune, acc={q_iv3['iv3_clf_acc']:.2f}): "
              f"IS {q_iv3['iv3_is_mean']:.2f} ± {q_iv3['iv3_is_std']:.2f}, "
              f"cond_acc {q_iv3['iv3_cond_acc']:.3f} "
              f"(SimpleCNN: IS {q['is_mean']:.2f}, "
              f"cond_acc {q['cond_acc']:.3f})", flush=True)

    if grid_path:
        save_images(class_grid(gen, ts, cfg, ds, n_cls), grid_path, (n_cls, 8))
        print(f"sample grid (one class per row): {grid_path}")

    print(f"D matched-vs-mismatched margin: {margin:.2f} (want > 1)")
    print(f"fixed-z class-color correlation: r={q['r']:.3f} (want > 0.9)")
    print(f"conditional accuracy (generated classified as conditioning "
          f"class): {q['cond_acc']:.3f} (chance {1 / n_cls:.3f})")
    print(f"classifier acc={q['clf_acc']:.2f}; "
          f"IS: {q['is_mean']:.2f} ± {q['is_std']:.2f} "
          f"(max {n_cls}, want > 4)")
    # the colour r assumes a class's mean colour is its signature; where it
    # is not (natural16), the classifier's conditional accuracy gates
    conditioned = q["r"] > 0.9 or q["cond_acc"] > 0.5
    ok = margin > 1.0 and conditioned and q["is_mean"] > 4.0
    print("CONVERGENCE RESULT " + json.dumps(
        dict(q, margin=round(margin, 3), steps=steps, train_s=round(dt, 1))),
        flush=True)
    print("CONVERGENCE PASS" if ok else "CONVERGENCE FAIL", flush=True)
    return 0 if ok else 1


def parse_argv(argv) -> dict:
    """`main`'s keyword arguments from the command line."""
    device, argv = split_device(argv)
    kw = {"device": device, "with_iv3": "--iv3" in argv}
    pos = [a for a in argv if a != "--iv3"]
    for name, conv, v in zip(("steps", "model", "dataset", "grid_path"),
                             (int, str, str, str), pos):
        kw[name] = conv(v)
    return kw


if __name__ == "__main__":
    sys.exit(main(**parse_argv(sys.argv[1:])))
