"""Entry point of the port (counterpart of the root ``main.py``):

    python -m text_to_image_tpu_torch.main --cfg configs/gancls_flowers.yml \
        [--train [--steps N]] [--weights g.npz] \
        [--eval-is [--is-images N]] \
        [--set data.data_dir=... ...] [--device cuda]

``--train`` runs the training loop (``train/trainer.py``) to step N (for
``model: pggan`` with ``pggan.stage: 0`` the whole progression,
`train.trainer.train_progressive`, N spread over the stages): on a
directory that holds checkpoints (``<checkpoint_dir>/<model>/<dataset>``)
it continues from the latest one; it writes checkpoints, sample grids
(``<sample_dir>/…``) and metrics (``<log_dir>/…/train.jsonl`` and
TensorBoard events).  Without ``--train`` it writes the fixed-z eval grid
and the latent- and text-interpolation grids under
``<sample_dir>/<model>/<dataset>/``, from the generator of ``--weights``
(an ``.npz`` of `convert.save_npz`, for example from the JAX package), else
of the latest checkpoint, else one initialised from ``cfg.seed`` (the root
``main.py`` refuses that last case: "train first"; the port samples it, so
that the serving path runs without a training run).  It prints which.
``--eval-is`` then computes the Inception score of ``--is-images`` images
(``eval/inception.py``) from the live generator params (the grids take the
EMA where there is one; the root ``main.py`` does the same): classified by
the converted InceptionV3 of ``inception_checkpoint``, else of
``<data_dir>/inception.npz`` when that file exists, else by the SimpleCNN
finetuned for 300 steps on the train split's images as they are stored.
``stackgan_stage2`` takes its frozen Stage-I generator from the Stage-I
run directory or ``.npz`` that ``stage1_checkpoint`` names
(`train.trainer.stage1_source`), and draws one from ``cfg.seed`` when that
is empty (``--set stage1_checkpoint=``).  The datasets are read from
``data.data_dir`` (StackGAN-format pickles, ``data/preprocess.py``);
nothing is downloaded.  Everything runs on the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import ast
import os

from text_to_image_tpu_torch.config import Config, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="text-to-image GAN training and sampling on PyTorch + "
                    "CUDA")
    p.add_argument("--cfg", required=True, help="YAML config path")
    p.add_argument("--weights", default=None,
                   help="generator .npz (convert.save_npz); default: the "
                        "latest checkpoint, else initialise from cfg.seed")
    p.add_argument("--train", action="store_true",
                   help="train (else: sample the three grids)")
    p.add_argument("--steps", type=int, default=None,
                   help="train to this step (default: max_epoch epochs)")
    p.add_argument("--eval-is", action="store_true",
                   help="also compute the Inception score (finetunes the "
                        "eval classifier on the dataset without a converted "
                        "one, reference protocol)")
    p.add_argument("--is-images", type=int, default=3000,
                   help="generated images for the IS estimate (ref: ~30k)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--set", nargs="*", default=[],
                   metavar="KEY=VALUE", help="config overrides")
    return p.parse_args(argv)


def parse_overrides(pairs):
    """KEY=VALUE strings → typed overrides (YAML-style bools, Python
    literals, bare strings)."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        low = v.strip().lower()
        if low in ("true", "false"):
            v = low == "true"
        else:
            try:
                v = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                pass
        overrides[k] = v
    return overrides


def evaluate(cfg: Config, weights: str | None = None, device="cuda",
             eval_is: bool = False, is_images: int = 3000):
    """Write the three grids; returns the output directory, and with
    `eval_is` the pair (directory, (IS mean, IS std))."""
    import numpy as np

    from text_to_image_tpu_torch import convert
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval.sampler import (
        GeneratorState, latent_interpolation_grid, make_generator_fn,
        sample_grid, text_interpolation_grid)
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.checkpoint import CheckpointManager
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     stage1_aux)
    from text_to_image_tpu_torch.train.trainer import run_dir, stage1_source
    from text_to_image_tpu_torch.utils import prng
    from text_to_image_tpu_torch.utils.images import save_images

    dataset = get_dataset(cfg, split="test")
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    mgr = CheckpointManager(run_dir(cfg, cfg.checkpoint_dir))
    step = None if weights else mgr.latest_step()
    if weights:
        g_params, g_state = convert.load_npz(weights, device)
        print(f"sampling from {weights}")
    elif step is not None:
        ts, _ = mgr.restore(init_train_state(cfg.seed, cfg, device=device),
                            step)
        g_params, g_state, aux = ts.g_params, ts.g_state, dict(ts.aux)
        print(f"sampling from the step-{step} checkpoint under "
              f"{mgr.directory}")
    else:
        g_params, g_state = bundle.init(cfg.seed, device)[:2]
        print(f"sampling from a generator initialised from seed {cfg.seed}")
    if step is None:
        aux = {}
        if bundle.needs_stage1:
            source = stage1_source(cfg)
            aux = stage1_aux(cfg, cfg.seed, device,
                             convert.load_stage1_generator(source, device))
            print("frozen Stage-I generator: "
                  + (source or f"initialised from seed {cfg.seed}"))
    ts = GeneratorState(
        L.cast_weights(g_params, policy), g_state,
        {k: L.cast_weights(v, policy) if k.endswith("params") else v
         for k, v in aux.items()})

    gen = make_generator_fn(cfg, device=device)
    out = run_dir(cfg, cfg.sample_dir)
    emb = np.asarray(dataset.test_embeddings(64), np.float32)
    g = prng.generator(prng.fold_in(cfg.seed, 1))

    save_images(sample_grid(gen, ts, cfg, emb, generator=g),
                os.path.join(out, "eval_grid.png"))
    rows = max(1, min(8, len(emb) // 2))   # robust to tiny test splits
    imgs, grid = latent_interpolation_grid(gen, ts, cfg, emb[:rows], 8,
                                           generator=g)
    save_images(imgs, os.path.join(out, "z_interp.png"), grid)
    imgs, grid = text_interpolation_grid(gen, ts, cfg, emb[:rows],
                                         emb[rows:2 * rows], 8, generator=g)
    save_images(imgs, os.path.join(out, "t_interp.png"), grid)
    print(f"wrote grids under {out}")
    if not eval_is:
        return out
    return out, eval_inception_score(cfg, gen, ts, dataset, is_images, device)


def eval_inception_score(cfg: Config, gen, ts, dataset, is_images: int,
                         device="cuda"):
    """The reference IS protocol over the live ``ts.g_params``: returns
    (mean, std) and prints it."""
    import numpy as np

    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval.classifier import (make_classifier_fn,
                                                         train_classifier)
    from text_to_image_tpu_torch.eval.inception import (
        compute_inception_score, load_classifier)

    inception_npz = cfg.inception_checkpoint or os.path.join(
        cfg.data.data_dir, "inception.npz")
    if os.path.exists(inception_npz):
        print(f"using converted classifier checkpoint {inception_npz}")
        classifier = load_classifier(inception_npz, device)
    else:
        train_ds = get_dataset(cfg, split="train")
        num_classes = int(train_ds.class_ids.max()) + 1
        print(f"finetuning eval classifier ({num_classes} classes)…")
        clf_params, acc = train_classifier(train_ds.images,
                                           train_ds.class_ids, num_classes,
                                           steps=300, device=device)
        print(f"classifier train accuracy {acc:.3f}")
        classifier = make_classifier_fn(clf_params)

    def gen_batch(z, e, eps):
        return gen(ts.g_params, ts.g_state, ts.aux, z, e, eps)

    mean, std = compute_inception_score(
        gen_batch, classifier,
        np.asarray(dataset.test_embeddings(), np.float32),
        num_images=is_images, batch_size=min(64, is_images),
        z_dim=cfg.gan.z_dim, seed=cfg.seed, eps_shape=gen.eps_shape)
    print(f"Inception score: {mean:.3f} ± {std:.3f} "
          f"({is_images} images, 10 splits)")
    return mean, std


def train(cfg: Config, steps: int | None = None, device="cuda"):
    """Run the training loop to `steps` (continuing from the latest
    checkpoint); returns the closed trainer, or for the C-PGGAN
    progression (``pggan.stage`` 0) the list of its stages' trainers."""
    from text_to_image_tpu_torch.train.trainer import (Trainer,
                                                       train_progressive)

    if cfg.model == "pggan" and cfg.pggan.stage == 0:
        return train_progressive(cfg, total_steps=steps, device=device)
    trainer = Trainer(cfg, device=device)
    try:
        trainer.train(num_steps=steps)
    finally:
        trainer.close()
    return trainer


def main(argv=None):
    """Returns what `train` returns (``--train``) or what `evaluate`
    returns."""
    args = parse_args(argv)
    cfg = load_config(args.cfg, parse_overrides(args.set) or None)
    if args.train:
        return train(cfg, args.steps, device=args.device)
    return evaluate(cfg, weights=args.weights, device=args.device,
                    eval_is=args.eval_is, is_images=args.is_images)


if __name__ == "__main__":
    main()
