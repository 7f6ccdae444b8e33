"""Batched inference: fixed-z sample grids, latent interpolation and
text-embedding interpolation sweeps (counterpart of
``text_to_image_tpu/eval/sampler.py``).

Generators sample in train mode (batch statistics), the DCGAN-lineage
convention the reference follows, and the new BN state is thrown away.  So
an image depends on the batch it is drawn in, and the grids keep the JAX
package's grouping: each interpolation grid is one batch of rows·n_steps.

`torch.Generator` and `jax.random` never agree, so each function takes its
z — and, for StackGAN, the conditioning-augmentation noise ε where the JAX
sampler takes a key — from the caller, or draws it from a given
`torch.Generator` (on the CPU, then moved to the device).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models.registry import get_model
from text_to_image_tpu_torch.ops import layers as L


@dataclasses.dataclass
class GeneratorState:
    """The generator fields of the JAX package's ``TrainState``:
    params, BN state and ``aux`` (which may hold ``ema_g_params`` and, for
    Stage-II, the frozen Stage-I generator)."""

    g_params: Dict
    g_state: Dict
    aux: Dict = dataclasses.field(default_factory=dict)


def make_generator_fn(cfg: Config, train_mode: bool = True,
                      device="cuda") -> Callable:
    """``gen(g_params, g_state, aux, z, emb, eps=None) ->
    images[B,r,r,3]`` (f32, on `device`).  z, emb and eps may be numpy
    arrays or tensors; eps is the bundle's conditioning-augmentation noise
    (``gen.eps_shape(B)``; None for a model without CA)."""
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)

    @torch.inference_mode()
    def gen(g_params, g_state, aux, z, emb, eps=None):
        z, emb, eps = (None if v is None else
                       torch.as_tensor(v, dtype=torch.float32, device=device)
                       for v in (z, emb, eps))
        img, _, _ = bundle.gen_apply(g_params, g_state, aux, z, emb, eps,
                                     train_mode, policy)
        return img.float()

    gen.eps_shape = bundle.eps_shape
    return gen


def eval_g_params(ts: GeneratorState) -> Dict:
    """Generator params for sampling: the EMA weight average when the state
    carries one, else the live params."""
    return ts.aux.get("ema_g_params", ts.g_params)


def live_generator(ts: GeneratorState) -> GeneratorState:
    """The generator of `ts` without its EMA average: what sampling draws
    from the live params (the EMA A/B of the training scripts)."""
    return GeneratorState(ts.g_params, ts.g_state,
                          {k: v for k, v in ts.aux.items()
                           if k != "ema_g_params"})


def _run(gen, ts: GeneratorState, z, emb, eps, generator) -> np.ndarray:
    """One batch; ε is drawn from `generator` when the model needs it and
    the caller gave none."""
    shape = gen.eps_shape(len(z))
    if eps is None and shape is not None:
        eps = torch.randn(*shape, generator=generator)
    return gen(eval_g_params(ts), ts.g_state, ts.aux, z, emb, eps).cpu().numpy()


def sample_grid(gen, ts: GeneratorState, cfg: Config, embeddings: np.ndarray,
                z=None, generator: Optional[torch.Generator] = None, eps=None
                ) -> np.ndarray:
    """One image per embedding with fresh z — the training-time sample grid."""
    if z is None:
        z = torch.randn(len(embeddings), cfg.gan.z_dim, generator=generator)
    return _run(gen, ts, z, embeddings, eps, generator)


def latent_interpolation_grid(gen, ts: GeneratorState, cfg: Config,
                              embeddings: np.ndarray, n_steps: int,
                              z1=None, z2=None,
                              generator: Optional[torch.Generator] = None,
                              eps=None
                              ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Rows: one caption each; columns: z₁→z₂ linear sweep.  z1, z2 are
    [rows, z_dim]; eps covers the whole batch of rows·n_steps."""
    rows, zd = len(embeddings), cfg.gan.z_dim
    z1 = torch.as_tensor(z1 if z1 is not None
                         else torch.randn(rows, zd, generator=generator))
    z2 = torch.as_tensor(z2 if z2 is not None
                         else torch.randn(rows, zd, generator=generator))
    alphas = torch.from_numpy(
        np.linspace(0.0, 1.0, n_steps, dtype=np.float32)).reshape(1, n_steps, 1)
    z = ((1 - alphas) * z1[:, None, :] + alphas * z2[:, None, :])
    emb = np.repeat(embeddings, n_steps, axis=0)
    imgs = _run(gen, ts, z.reshape(rows * n_steps, zd), emb, eps, generator)
    return imgs, (rows, n_steps)


def text_interpolation_grid(gen, ts: GeneratorState, cfg: Config,
                            emb_a: np.ndarray, emb_b: np.ndarray,
                            n_steps: int, z=None,
                            generator: Optional[torch.Generator] = None,
                            eps=None
                            ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Rows: fixed z each ([rows, z_dim]); columns: β sweep between two
    captions' embeddings (GAN-INT-style manifold walk, β ∈ [0,1]); eps
    covers the whole batch of rows·n_steps."""
    rows, zd = len(emb_a), cfg.gan.z_dim
    z = torch.as_tensor(z if z is not None
                        else torch.randn(rows, zd, generator=generator))
    z = z[:, None, :].expand(rows, n_steps, zd).reshape(-1, zd)
    betas = np.linspace(0.0, 1.0, n_steps, dtype=np.float32).reshape(1, n_steps, 1)
    emb = ((1 - betas) * emb_a[:, None, :] + betas * emb_b[:, None, :])
    imgs = _run(gen, ts, z, emb.reshape(rows * n_steps, -1), eps, generator)
    return imgs, (rows, n_steps)
