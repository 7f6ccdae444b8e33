"""Model registry (counterpart of ``text_to_image_tpu/models/registry.py``):
maps the config's ``model`` name onto a `ModelBundle`.

``gancls``, ``stackgan_stage1`` and ``stackgan_stage2`` are ported.
``wgancls`` and ``pggan`` raise `NotImplementedError` naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models import gancls, stackgan
from text_to_image_tpu_torch.utils import prng

MODEL_NAMES = ("gancls", "wgancls", "stackgan_stage1", "stackgan_stage2",
               "pggan")

_NOT_PORTED = {
    "wgancls": "ROADMAP.md, 'Modules to port' item 5 (WGAN-CLS)",
    "pggan": "ROADMAP.md, 'Modules to port' item 7 (C-PGGAN)",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """The JAX bundle's surface for one model:

    * ``init(key, device="cuda")`` → (g_params, g_state, d_params,
      d_state), f32 tensors drawn on the CPU from `key` and moved to
      `device`;
    * ``gen_apply(gp, gs, aux, z, emb, eps, train, policy)`` → (img, new_gs,
      gen_aux).  `aux` is the train state's dict (Stage-II reads its frozen
      Stage-I generator, ``stage1_g_params`` / ``stage1_g_state``, from
      it).  `eps` stands where the JAX bundle takes a key: the
      conditioning-augmentation noise, of shape ``eps_shape(batch)`` — None
      for GAN-CLS, [B, ca_dim] for Stage-I, [2, B, ca_dim] for Stage-II
      (row 0 for the frozen Stage-I's CA, row 1 for its own).  `gen_aux`
      holds ``mu``, ``logvar`` and ``c`` when the model has CA, else
      nothing;
    * ``gen_apply_inference(gp, gs, z, emb, policy)`` → img with eval-mode
      BN folded into the kernels (GAN-CLS only, as in the JAX package);
    * ``disc_apply(dp, ds, aux, x, emb, train, policy)`` → (logits[B],
      new_ds);
    * ``disc_streams(dp, ds, aux, xs, embs, train, policy)`` → (logits[S,B],
      new_ds), per-stream BN statistics;
    * ``is_wgan`` (critic + GP loss), ``has_ca`` (KL term in the G loss),
      ``needs_stage1`` (the train state carries a frozen Stage-I generator).
    """

    name: str
    resolution: int
    init: Callable
    gen_apply: Callable
    disc_apply: Callable
    disc_streams: Callable
    gen_apply_inference: Optional[Callable] = None
    eps_shape: Callable = lambda batch: None
    is_wgan: bool = False
    has_ca: bool = False
    needs_stage1: bool = False


def tree_to(tree: Dict, device) -> Dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _bundle(name: str, res: int, d_gan, g_init: Callable, gen_apply: Callable,
            **flags) -> ModelBundle:
    """A bundle around a generator with the matching-aware batch-norm
    discriminator at `res` px, which every ported model shares."""
    def init(key, device="cuda"):
        g = g_init(prng.fold_in(key, 0))
        d = gancls.discriminator_init(prng.fold_in(key, 1), d_gan, res)
        return tuple(tree_to(t, device) for t in (*g, *d))

    def disc_apply(dp, ds, aux, x, emb, train, policy):
        return gancls.discriminator_apply(dp, ds, x, emb, train, policy, res)

    def disc_streams(dp, ds, aux, xs, embs, train, policy):
        return gancls.discriminator_apply_streams(dp, ds, xs, embs, train,
                                                  policy, res)

    return ModelBundle(name, res, init, gen_apply, disc_apply, disc_streams,
                       **flags)


def get_model(cfg: Config) -> ModelBundle:
    name = cfg.model
    res = cfg.data.image_size
    gan = cfg.gan

    if name == "gancls":
        def gen_apply(gp, gs, aux, z, emb, eps, train, policy):
            img, new_gs = gancls.generator_apply(gp, gs, z, emb, train,
                                                 policy, res)
            return img, new_gs, {}

        def gen_apply_inference(gp, gs, z, emb, policy):
            return gancls.generator_apply_inference(gp, gs, z, emb, policy,
                                                    res)

        return _bundle(name, res, gan,
                       lambda k: gancls.generator_init(k, gan, res),
                       gen_apply, gen_apply_inference=gen_apply_inference)

    if name in ("stackgan_stage1", "stackgan_stage2"):
        # StackGAN's D compresses the raw text to ca_dim before the join
        d_gan = dataclasses.replace(gan, compressed_embed_dim=gan.ca_dim)

    if name == "stackgan_stage1":
        def gen_apply(gp, gs, aux, z, emb, eps, train, policy):
            return stackgan.stage1_generator_apply(gp, gs, z, emb, eps, train,
                                                   policy, res)

        return _bundle(name, res, d_gan,
                       lambda k: stackgan.stage1_generator_init(k, gan, res),
                       gen_apply, eps_shape=lambda b: (b, gan.ca_dim),
                       has_ca=True)

    if name == "stackgan_stage2":
        lr_res = res // 4

        def gen_apply(gp, gs, aux, z, emb, eps, train, policy):
            """The frozen Stage-I generator draws the low-resolution image,
            Stage-II refines it.  Stage-I always runs with batch statistics
            (the sampling convention), without gradient, and its new BN
            state is thrown away."""
            with torch.no_grad():
                lr_img, _, _ = stackgan.stage1_generator_apply(
                    aux["stage1_g_params"], aux["stage1_g_state"], z, emb,
                    eps[0], True, policy, lr_res)
            if cfg.remat and torch.is_grad_enabled():
                # recompute the Stage-II activations in the backward pass
                return checkpoint(stackgan.stage2_generator_apply, gp, gs,
                                  lr_img, emb, eps[1], train, policy,
                                  use_reentrant=False)
            return stackgan.stage2_generator_apply(gp, gs, lr_img, emb,
                                                   eps[1], train, policy)

        return _bundle(
            name, res, d_gan,
            lambda k: stackgan.stage2_generator_init(k, gan, lr_res),
            gen_apply, eps_shape=lambda b: (2, b, gan.ca_dim), has_ca=True,
            needs_stage1=True)

    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown model {name!r}; expected one of {MODEL_NAMES}")
