"""Model registry (counterpart of ``text_to_image_tpu/models/registry.py``):
maps the config's ``model`` name onto a `ModelBundle`.

Only ``gancls`` is ported so far.  Every other name the JAX package knows
raises `NotImplementedError` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models import gancls
from text_to_image_tpu_torch.utils import prng

MODEL_NAMES = ("gancls", "wgancls", "stackgan_stage1", "stackgan_stage2",
               "pggan")

_NOT_PORTED = {
    "wgancls": "ROADMAP.md, 'Modules to port' item 5 (WGAN-CLS)",
    "stackgan_stage1": "ROADMAP.md, 'Modules to port' item 6 (StackGAN)",
    "stackgan_stage2": "ROADMAP.md, 'Modules to port' item 6 (StackGAN)",
    "pggan": "ROADMAP.md, 'Modules to port' item 7 (C-PGGAN)",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """The JAX bundle's surface for one model:

    * ``init(key, device="cuda")`` → (g_params, g_state, d_params,
      d_state), f32 tensors drawn on the CPU from `key` and moved to
      `device`;
    * ``gen_apply(gp, gs, z, emb, train, policy)`` → (img, new_gs);
    * ``gen_apply_inference(gp, gs, z, emb, policy)`` → img (BN folded);
    * ``disc_apply(dp, ds, x, emb, train, policy)`` → (logits[B], new_ds);
    * ``disc_streams(dp, ds, xs, embs, train, policy)`` → (logits[S,B],
      new_ds), per-stream BN statistics;
    * ``is_wgan`` (critic + GP loss) and ``has_ca`` (KL term): both False
      for GAN-CLS.
    """

    name: str
    resolution: int
    init: Callable
    gen_apply: Callable
    gen_apply_inference: Callable
    disc_apply: Callable
    disc_streams: Callable
    is_wgan: bool = False
    has_ca: bool = False


def _to(tree: Dict, device) -> Dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def get_model(cfg: Config) -> ModelBundle:
    name = cfg.model
    res = cfg.data.image_size
    gan = cfg.gan

    if name == "gancls":
        def init(key, device="cuda"):
            g = gancls.generator_init(prng.fold_in(key, 0), gan, res)
            d = gancls.discriminator_init(prng.fold_in(key, 1), gan, res)
            return tuple(_to(t, device) for t in (*g, *d))

        def gen_apply(gp, gs, z, emb, train, policy):
            return gancls.generator_apply(gp, gs, z, emb, train, policy, res)

        def gen_apply_inference(gp, gs, z, emb, policy):
            return gancls.generator_apply_inference(gp, gs, z, emb, policy,
                                                    res)

        def disc_apply(dp, ds, x, emb, train, policy):
            return gancls.discriminator_apply(dp, ds, x, emb, train, policy,
                                              res)

        def disc_streams(dp, ds, xs, embs, train, policy):
            return gancls.discriminator_apply_streams(dp, ds, xs, embs, train,
                                                      policy, res)

        return ModelBundle(name, res, init, gen_apply, gen_apply_inference,
                           disc_apply, disc_streams)

    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown model {name!r}; expected one of {MODEL_NAMES}")
