"""The GAN-CLS training tick (counterpart of
``text_to_image_tpu/train/steps.py``):

1. ``n_critic`` matching-aware D updates, each on its own data slice, over
   the real, fake and wrong streams (three streams in one D pass, each with
   its own BN statistics);
2. ``g_steps`` G updates on the last slice, all with one z;
3. Adam (β1 0.5, β2 0.9) with the staircase LR decay on each net;
4. the optional generator EMA with the fade-aware ramp.

The JAX package compiles the tick into one XLA program; here it runs
eagerly, and every convolution, join and BN epilogue on the card is a
hand-written kernel (``ops/kernels``).

Semantics kept from the JAX step: the D step's generator runs train-mode
BN without gradient and its new G state is thrown away; the G step's D
call is one stream in train mode and its new D state is thrown away; only
the G steps update the G state.  The noise of step ``s`` comes from keys
``fold_in(fold_in(seed, s), 0 | 1)``, drawn on the CPU and moved to the
device, so a tick gives the same numbers on every device; a caller may pass
its own z instead (``noise=``), as the tests do with the JAX step's draws.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.models import losses as LL
from text_to_image_tpu_torch.models.registry import get_model
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.train import optim
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.state import TrainState
from text_to_image_tpu_torch.utils import prng


def _leaf_params(tree: Dict) -> Dict:
    return {k: _leaf_params(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def _detached(tree: Dict) -> Dict:
    return {k: _detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


def _clone(tree: Dict) -> Dict:
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def init_train_state(key: int, cfg: Config, steps_per_epoch: int = 1000,
                     device="cuda") -> TrainState:
    """Both networks drawn from `key` (f32, on `device`), fresh Adam states
    with the G decay period ``lr_decay_epoch·steps_per_epoch·g_steps`` and
    the D period ``…·n_critic``, step 0, and ``aux['ema_g_params']`` (a copy
    of G) when ``train.ema_decay > 0``."""
    gp, gs, dp, ds = get_model(cfg).init(key, device)
    return make_train_state(cfg, steps_per_epoch, gp, gs, dp, ds)


def make_train_state(cfg: Config, steps_per_epoch: int, g_params: Dict,
                     g_state: Dict, d_params: Dict, d_state: Dict,
                     step: int = 0, aux: Optional[Dict] = None) -> TrainState:
    """A TrainState around given trees: the params become f32 leaf tensors
    that require grad, the optimizers are fresh."""
    tcfg = cfg.train
    gp, dp = _leaf_params(g_params), _leaf_params(d_params)
    aux = dict(aux or {})
    if tcfg.ema_decay > 0 and "ema_g_params" not in aux:
        aux["ema_g_params"] = _clone(gp)
    return TrainState(
        g_params=gp, g_state=_clone(g_state), d_params=dp,
        d_state=_clone(d_state),
        g_opt=optim.generator_optimizer(gp, tcfg,
                                        steps_per_epoch * tcfg.g_steps),
        d_opt=optim.discriminator_optimizer(dp, tcfg,
                                            steps_per_epoch * tcfg.n_critic),
        step=step, aux=aux)


def draw_noise(cfg: Config, step: int, batch: int) -> Dict[str, torch.Tensor]:
    """The tick's z on the CPU: ``d`` [n_critic, B, z] (one per D update),
    ``g`` [B, z] (shared by the G updates) and, with GAN-INT, ``g2`` [B, z]
    for the interpolated-caption term."""
    key = prng.fold_in(cfg.seed, step)
    dkey, gkey = prng.fold_in(key, 0), prng.fold_in(key, 1)

    def normal(k):
        return torch.randn(batch, cfg.gan.z_dim, generator=prng.generator(k))

    noise = {"d": torch.stack([normal(prng.fold_in(dkey, k))
                               for k in range(cfg.train.n_critic)]),
             "g": normal(gkey)}
    if cfg.train.use_interpolation:
        noise["g2"] = normal(prng.fold_in(gkey, 1))
    return noise


def make_train_step(cfg: Config, steps_per_epoch: int = 1000, device="cuda"):
    """Returns ``step(ts, batch, noise=None) -> (ts, metrics)``.

    `batch` holds real/wrong [K,B,H,W,3] (uint8, or float in [-1, 1]) and
    emb [K,B,E] with K = n_critic, as numpy arrays or tensors; `noise` is
    `draw_noise`'s dict, drawn from (seed, step) when None.  `ts` is updated
    in place and returned; metrics are 0-dim device tensors."""
    bundle = get_model(cfg)
    if bundle.is_wgan or bundle.has_ca:
        raise NotImplementedError(
            "only the GAN-CLS tick is ported: ROADMAP.md, 'Modules to port' "
            "items 5-6")
    policy = L.Policy.from_str(cfg.dtype)
    tcfg = cfg.train
    co = tcfg.coeff

    def images(x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device, non_blocking=True)
        if x.dtype == torch.uint8:
            x = x.float() / 127.5 - 1.0
        return policy.cast(x)

    def d_step(ts: TrainState, real, wrong, emb, z) -> Dict:
        with torch.no_grad():
            fake, _ = bundle.gen_apply(ts.g_params, ts.g_state, z, emb, True,
                                       policy)
        xs = torch.stack([real, policy.cast(fake), wrong])
        logits, new_state = bundle.disc_streams(
            ts.d_params, ts.d_state, xs, emb.expand(3, *emb.shape), True,
            policy)
        ld = LL.gan_cls_d_loss(logits[0], logits[1], logits[2],
                               co.real_label_smooth)
        ts.d_opt.update(torch.autograd.grad(ld["d_loss"], ts.d_opt.leaves))
        ts.d_state = _detached(new_state)
        return ld

    def g_step(ts: TrainState, emb, z, z2) -> Dict:
        d_params = _detached(ts.d_params)
        fake, new_state = bundle.gen_apply(ts.g_params, ts.g_state, z, emb,
                                           True, policy)
        fake_logit, _ = bundle.disc_apply(d_params, ts.d_state, fake, emb,
                                          True, policy)
        interp_logit = None
        if tcfg.use_interpolation:
            emb_int = LL.interpolate_embeddings(emb, co.interp_beta)
            fake_int, _ = bundle.gen_apply(ts.g_params, ts.g_state, z2,
                                           emb_int, True, policy)
            interp_logit, _ = bundle.disc_apply(d_params, ts.d_state,
                                                fake_int, emb_int, True,
                                                policy)
        lg = LL.gan_cls_g_loss(fake_logit, interp_logit, co.interp_weight)
        ts.g_opt.update(torch.autograd.grad(lg["g_loss"], ts.g_opt.leaves))
        ts.g_state = _detached(new_state)
        return lg

    @torch.no_grad()
    def ema(ts: TrainState) -> None:
        decay = tcfg.ema_decay
        if tcfg.ema_rampup > 0:
            # fade-aware ramp from step 0 (the GAN-CLS anchor)
            t = float(max(ts.step, 0))
            decay = min(decay, (1.0 + t) / (tcfg.ema_rampup + t))
        ema_leaves = [e for _, e in flatten(ts.aux["ema_g_params"])]
        live = [p for _, p in flatten(ts.g_params)]
        torch._foreach_lerp_(ema_leaves, live, 1.0 - decay)

    def step(ts: TrainState, batch, noise: Optional[Dict] = None
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        embs = torch.as_tensor(batch["emb"]).to(device, non_blocking=True)
        if noise is None:
            noise = draw_noise(cfg, ts.step, embs.shape[1])
        zs = torch.as_tensor(noise["d"]).to(device, non_blocking=True)
        zg = torch.as_tensor(noise["g"]).to(device, non_blocking=True)
        for k in range(tcfg.n_critic):
            d_metrics = d_step(ts, images(batch["real"][k]),
                               images(batch["wrong"][k]), embs[k], zs[k])
        z2 = None
        if tcfg.use_interpolation:
            z2 = torch.as_tensor(noise["g2"]).to(device, non_blocking=True)
        for _ in range(tcfg.g_steps):
            g_metrics = g_step(ts, embs[-1], zg, z2)
        if tcfg.ema_decay > 0:
            ema(ts)
        ts.step += 1
        return ts, {k: v.detach() for k, v in {**d_metrics,
                                               **g_metrics}.items()}

    return step
