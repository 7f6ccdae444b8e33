"""Model registry (counterpart of ``text_to_image_tpu/models/registry.py``):
maps the config's ``model`` name onto a `ModelBundle`: ``gancls``,
``wgancls`` (the GAN-CLS generator with the layer-norm critic),
``stackgan_stage1``, ``stackgan_stage2`` and ``pggan`` (one stage of the
C-PGGAN progression, ``pggan.stage``; 0 = the last).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models import gancls, stackgan
from text_to_image_tpu_torch.models import pggan as PG
from text_to_image_tpu_torch.utils import prng

MODEL_NAMES = ("gancls", "wgancls", "stackgan_stage1", "stackgan_stage2",
               "pggan")


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
      for GAN-CLS and WGAN-CLS, [B, ca_dim] for Stage-I and C-PGGAN,
      [2, B, ca_dim] for Stage-II (row 0 for the frozen Stage-I's CA, row
      1 for its own); ``eps_batch_axis`` is the batch's axis in it (1 for
      Stage-II, else 0), along which a data-parallel rank keeps its rows.
      C-PGGAN reads its fade-in α from ``aux["alpha"]``
      (1 when absent: sampling).  `gen_aux`
      holds ``mu``, ``logvar`` and ``c`` when the model has CA, else
      nothing;
    * ``gen_apply_inference(gp, gs, z, emb, policy)`` → img with eval-mode
      BN folded into the kernels (GAN-CLS only, as in the JAX package);
    * ``disc_apply(dp, ds, aux, x, emb, train, policy)`` → (logits[B],
      new_ds);
    * ``disc_streams(dp, ds, aux, xs, embs, train, policy)`` → (logits[S,B],
      new_ds), per-stream BN statistics;
    * ``is_wgan`` (critic + GP loss), ``has_ca`` (KL term in the G loss),
      ``needs_stage1`` (the train state carries a frozen Stage-I generator);
    * hooks: ``step_aux(step)`` → a dict merged into ``aux`` for the tick
      of `step` (C-PGGAN's α); ``prep_images(x)`` on the f32 images before
      any cast (C-PGGAN downsamples to the stage's resolution);
      ``ema_anchor``, the step from which the fade-aware EMA ramp counts
      (C-PGGAN: the end of this stage's fade).
    """

    name: str
    resolution: int
    init: Callable
    gen_apply: Callable
    disc_apply: Callable
    disc_streams: Callable
    gen_apply_inference: Optional[Callable] = None
    eps_shape: Callable = lambda batch: None
    eps_batch_axis: int = 0
    is_wgan: bool = False
    has_ca: bool = False
    needs_stage1: bool = False
    step_aux: Optional[Callable] = None
    prep_images: Optional[Callable] = None
    ema_anchor: int = 0


def tree_to(tree: Dict, device) -> Dict:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _bundle(name: str, res: int, d_gan, g_init: Callable, gen_apply: Callable,
            norm: str = "batch", **flags) -> ModelBundle:
    """A bundle around a generator with the matching-aware discriminator of
    GAN-CLS at `res` px (batch norm; WGAN-CLS's critic with `norm`
    "layer")."""
    def init(key, device="cuda"):
        g = g_init(prng.fold_in(key, 0))
        d = gancls.discriminator_init(prng.fold_in(key, 1), d_gan, res, norm)
        return tuple(tree_to(t, device) for t in (*g, *d))

    def disc_apply(dp, ds, aux, x, emb, train, policy):
        return gancls.discriminator_apply(dp, ds, x, emb, train, policy, res,
                                          norm)

    def disc_streams(dp, ds, aux, xs, embs, train, policy):
        return gancls.discriminator_apply_streams(dp, ds, xs, embs, train,
                                                  policy, res, norm)

    return ModelBundle(name, res, init, gen_apply, disc_apply, disc_streams,
                       **flags)


def get_model(cfg: Config) -> ModelBundle:
    name = cfg.model
    res = cfg.data.image_size
    gan = cfg.gan

    if name in ("gancls", "wgancls"):
        def gen_apply(gp, gs, aux, z, emb, eps, train, policy):
            img, new_gs = gancls.generator_apply(gp, gs, z, emb, train,
                                                 policy, res)
            return img, new_gs, {}

        def gen_apply_inference(gp, gs, z, emb, policy):
            return gancls.generator_apply_inference(gp, gs, z, emb, policy,
                                                    res)

        return _bundle(name, res, gan,
                       lambda k: gancls.generator_init(k, gan, res),
                       gen_apply, gen_apply_inference=gen_apply_inference,
                       norm="batch" if name == "gancls" else "layer",
                       is_wgan=name == "wgancls")

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
            gen_apply, eps_shape=lambda b: (2, b, gan.ca_dim),
            eps_batch_axis=1, has_ca=True, needs_stage1=True)

    if name == "pggan":
        return _pggan(cfg)
    raise ValueError(f"unknown model {name!r}; expected one of {MODEL_NAMES}")


def _pggan(cfg: Config) -> ModelBundle:
    """One stage of the C-PGGAN progression: stage ``pggan.stage`` (0 = the
    last) at its resolution, α ramping from ``start_step`` (−1: (stage −
    1)·steps_per_stage) over ``fade_fraction`` of the stage."""
    res, gan, pcfg = cfg.data.image_size, cfg.gan, cfg.pggan
    n_total = PG.num_stages(res)
    stage = pcfg.stage if pcfg.stage > 0 else n_total
    if stage > n_total:
        raise ValueError(f"pggan.stage {stage} exceeds {n_total} stages for "
                         f"image_size {res}")
    sres = PG.stage_resolution(stage)
    fade = int(pcfg.steps_per_stage * pcfg.fade_fraction)
    start = (pcfg.start_step if pcfg.start_step >= 0
             else (stage - 1) * pcfg.steps_per_stage)

    def init(key, device="cuda"):
        g = PG.generator_init(prng.fold_in(key, 0), gan, res)    # full depth
        d = PG.discriminator_init(prng.fold_in(key, 1), gan, res)
        return tuple(tree_to(t, device) for t in (*g, *d))

    def step_aux(step):
        """α = clip((step − start)/fade, 0, 1) in f32, as the JAX bundle
        computes it; a 0-dim CPU tensor."""
        if stage == 1 or fade <= 0:
            return {"alpha": torch.tensor(1.0)}
        a = (torch.tensor(step, dtype=torch.float32) - float(start)) / fade
        return {"alpha": a.clamp(0.0, 1.0)}

    def gen_apply(gp, gs, aux, z, emb, eps, train, policy):
        img, ca = PG.generator_apply(gp, z, emb, eps, stage,
                                     aux.get("alpha", 1.0), gan, policy)
        return img, gs, ca

    def disc_apply(dp, ds, aux, x, emb, train, policy):
        return PG.discriminator_apply(dp, x, emb, stage,
                                      aux.get("alpha", 1.0), gan, policy), ds

    def disc_streams(dp, ds, aux, xs, embs, train, policy):
        return PG.discriminator_apply_streams(
            dp, xs, embs, stage, aux.get("alpha", 1.0), gan, policy), ds

    return ModelBundle(
        "pggan", sres, init, gen_apply, disc_apply, disc_streams,
        eps_shape=lambda b: (b, gan.ca_dim), is_wgan=True, has_ca=True,
        step_aux=step_aux, prep_images=lambda x: PG.downsample_to(x, sres),
        ema_anchor=start + fade if stage > 1 else 0)
