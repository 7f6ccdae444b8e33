"""Sampling entry point of the port (counterpart of the root ``main.py``'s
``evaluate``):

    python -m text_to_image_tpu_torch.main --cfg configs/gancls_flowers.yml \
        [--weights g.npz] [--set dataset_name=synthetic ...] [--device cuda]

writes the fixed-z eval grid and the latent- and text-interpolation grids
under ``<sample_dir>/<model>/<dataset>/``.  ``--weights`` serves a generator
saved with `convert.save_npz` (for example from the JAX package); without
it the generator is initialised from ``cfg.seed``.  Training is not ported
yet: ``--train`` raises `NotImplementedError`.
"""

from __future__ import annotations

import argparse
import ast
import os

from text_to_image_tpu_torch.config import Config, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="text-to-image GAN sampling on PyTorch + CUDA")
    p.add_argument("--cfg", required=True, help="YAML config path")
    p.add_argument("--weights", default=None,
                   help="generator .npz (convert.save_npz); default: "
                        "initialise from cfg.seed")
    p.add_argument("--train", action="store_true",
                   help="train (not ported yet)")
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


def evaluate(cfg: Config, weights: str | None = None, device="cuda") -> str:
    """Write the three grids; returns the output directory."""
    import numpy as np

    from text_to_image_tpu_torch import convert
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval.sampler import (
        GeneratorState, latent_interpolation_grid, make_generator_fn,
        sample_grid, text_interpolation_grid)
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.utils import prng
    from text_to_image_tpu_torch.utils.images import save_images

    dataset = get_dataset(cfg, split="test")
    if weights:
        g_params, g_state = convert.load_npz(weights, device)
        print(f"sampling from {weights}")
    else:
        g_params, g_state = get_model(cfg).init(cfg.seed, device)
        print(f"sampling from a generator initialised from seed {cfg.seed}")
    ts = GeneratorState(L.cast_weights(g_params, L.Policy.from_str(cfg.dtype)),
                        g_state)

    gen = make_generator_fn(cfg, device=device)
    out = os.path.join(cfg.sample_dir, cfg.model, cfg.data.dataset_name)
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
    return out


def main(argv=None):
    args = parse_args(argv)
    if args.train:
        raise NotImplementedError(
            "training is not ported yet: ROADMAP.md, 'Modules to port' "
            "items 2-3")
    cfg = load_config(args.cfg, parse_overrides(args.set) or None)
    evaluate(cfg, weights=args.weights, device=args.device)


if __name__ == "__main__":
    main()
