"""Plain reference of ``cpggan_flowers_256``: the text-conditioned
progressive GAN (Karras et al., arXiv:1710.10196; conditioned as in
crisbodnar/text-to-image) trained at one stage in its fade-in.

Generator: φ(text) → lrelu(linear) → t; conditioning augmentation
c = μ + e^{½logσ²}·ε from an equalized dense layer (gain 1); an equalized
dense stem over [z; t; c] to 4×4, lrelu and pixel norm; a 3×3 conv; then
per stage s ≤ S: nearest ×2 up, 3×3 conv, lrelu, pixel norm, twice; a 1×1
toRGB; during the fade the image is α·RGB_S + (1 − α)·up(RGB_{S−1}); tanh.
Critic: fromRGB 1×1 at S, per stage two 3×3 convs and a 2×2 average pool,
the first blended with the pooled image's fromRGB_{S−1} by α; the
minibatch stddev of each stream as one more channel; the text tiled and
joined by a 1×1 conv; a 3×3 conv, an equalized dense layer and the score.
Every equalized layer's weight is drawn N(0, 1) and scaled by
gain/√fan_in at use (gain √2, or 1 where noted); lrelu slope 0.2.

Training tick: ``n_critic`` critic updates, each on its own batch, on
E[D(fake)] − E[D(real)] + ½(E[D(wrong)] − E[D(real)]) + λ·GP
+ ε_drift(E[D(real)²] + E[D(wrong)²]), the GP at x̂ = fake + u(real − fake)
on one stream; then one generator update on −E[D(fake)] + w_kl·KL.  Adam
on each network.  α = clip((step − start)/fade, 0, 1), start =
(S − 1)·steps_per_stage, fade = fade_fraction·steps_per_stage.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from benchmark.reference import plain as P

GAIN = math.sqrt(2.0)


def num_stages(res: int) -> int:
    return int(math.log2(res // 4)) + 1


def stage_channels(s: int, gf: int) -> int:
    return max(16, min(4 * gf, 32 * gf // 2**s))


def _eq(shape) -> Dict:
    return {"w": (tuple(shape), "normal:1.0"), "b": ((shape[-1],), "zeros")}


def param_spec(c: Dict) -> Dict[str, Dict]:
    """Every leaf as (shape, init): the generator and the critic at full
    depth, every stage present from the start."""
    gan = c["gan"]
    gf, e, ce, ca, zd = (gan["gf_dim"], gan["embed_dim"],
                         gan["compressed_embed_dim"], gan["ca_dim"],
                         gan["z_dim"])
    n = num_stages(c["data"]["image_size"])
    c0 = stage_channels(1, gf)
    g = {"embed": {"w": ((e, ce), "normal:0.02"), "b": ((ce,), "zeros")},
         "ca": _eq((ce, 2 * ca)),
         "stem": _eq((zd + ce + ca, 16 * c0)),
         "stem_conv": _eq((3, 3, c0, c0)),
         "rgb1": _eq((1, 1, c0, 3))}
    cin = c0
    for s in range(2, n + 1):
        cout = stage_channels(s, gf)
        g[f"up{s}a"] = _eq((3, 3, cin, cout))
        g[f"up{s}b"] = _eq((3, 3, cout, cout))
        g[f"rgb{s}"] = _eq((1, 1, cout, 3))
        cin = cout
    d = {}
    for s in range(1, n + 1):
        cs = stage_channels(s, gf)
        d[f"from{s}"] = _eq((1, 1, 3, cs))
        if s >= 2:
            d[f"down{s}a"] = _eq((3, 3, cs, cs))
            d[f"down{s}b"] = _eq((3, 3, cs, stage_channels(s - 1, gf)))
    d["embed"] = {"w": ((e, ce), "normal:0.02"), "b": ((ce,), "zeros")}
    d["join"] = _eq((1, 1, c0 + 1 + ce, c0))
    d["conv4"] = _eq((3, 3, c0, c0))
    d["dense"] = _eq((16 * c0, c0))
    d["logit"] = _eq((c0, 1))
    return {"g": g, "g_state": {}, "d": d, "d_state": {}}


def _dense(x, p, prec, gain=GAIN):
    return P.linear(x, p["w"], p["b"], prec, gain / math.sqrt(p["w"].shape[0]))


def _conv(x, p, prec, gain=GAIN):
    k, _, cin, _ = p["w"].shape
    return P.conv(x, p["w"], p["b"], 1, prec,
                  scale=gain / math.sqrt(k * k * cin))


def _pixel_norm(x):
    return x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-8)


def generator(g: Dict, z, emb, eps, stage: int, alpha: float,
              prec: P.Precision):
    """(images NCHW in tanh range, μ, logσ²)."""
    t = P.lrelu(P.linear(emb, g["embed"]["w"], g["embed"]["b"], prec))
    mu, logvar = _dense(t, g["ca"], prec, 1.0).chunk(2, -1)
    c = mu + torch.exp(0.5 * logvar) * eps
    h = _dense(torch.cat([z, t, c], -1), g["stem"], prec)
    h = P.to_nchw(h.reshape(h.shape[0], 4, 4, -1))
    h = _pixel_norm(P.lrelu(h))
    h = _pixel_norm(P.lrelu(_conv(h, g["stem_conv"], prec)))
    prev = None
    for s in range(2, stage + 1):
        prev = _conv(h, g[f"rgb{s - 1}"], prec, 1.0)
        h = _pixel_norm(P.lrelu(_conv(P.upsample2(h), g[f"up{s}a"], prec)))
        h = _pixel_norm(P.lrelu(_conv(h, g[f"up{s}b"], prec)))
    img = _conv(h, g[f"rgb{stage}"], prec, 1.0)
    if prev is not None:
        img = alpha * img + (1 - alpha) * P.upsample2(prev)
    return torch.tanh(img), mu, logvar


def _mbstd(h, streams: int):
    hs = h.reshape(streams, -1, *h.shape[1:])
    std = torch.sqrt(hs.var(1, correction=0) + 1e-8).mean((1, 2, 3))
    feat = std[:, None, None, None, None].expand(streams, hs.shape[1], 1,
                                                 *h.shape[2:])
    return torch.cat([h, feat.reshape(h.shape[0], 1, *h.shape[2:])], 1)


def critic(d: Dict, x, emb, stage: int, alpha: float, streams: int,
           prec: P.Precision):
    """Scores [B] of NCHW images x; `streams` contiguous streams, each with
    its own minibatch stddev."""
    h = P.lrelu(_conv(x, d[f"from{stage}"], prec, 1.0))
    for s in range(stage, 1, -1):
        h = P.lrelu(_conv(h, d[f"down{s}a"], prec))
        h = P.avgpool2(P.lrelu(_conv(h, d[f"down{s}b"], prec)))
        if s == stage:
            skip = P.lrelu(_conv(P.avgpool2(x), d[f"from{s - 1}"], prec, 1.0))
            h = alpha * h + (1 - alpha) * skip
    h = _mbstd(h, streams)
    t = P.lrelu(P.linear(emb, d["embed"]["w"], d["embed"]["b"], prec))
    h = P.lrelu(_conv(P.tile_concat(h, t), d["join"], prec, 1.0))
    h = P.lrelu(_conv(h, d["conv4"], prec))
    h = P.lrelu(_dense(P.flatten_hwc(h), d["dense"], prec))
    return _dense(h, d["logit"], prec, 1.0).reshape(-1)


def alpha_at(c: Dict, step: int) -> float:
    pg = c["pggan"]
    stage = pg["stage"]
    fade = int(pg["steps_per_stage"] * pg["fade_fraction"])
    start = (pg["start_step"] if pg["start_step"] >= 0
             else (stage - 1) * pg["steps_per_stage"])
    if stage == 1 or fade <= 0:
        return 1.0
    return min(max((step - start) / fade, 0.0), 1.0)


def _tick(c: Dict, split: Dict, seed: int, step: int,
          fault: Optional[str]) -> Tuple[Dict, Dict, float]:
    """Tick `step`'s batch and noise (on the split's device) and α."""
    tc = c["train"]
    b, nc = tc["batch_size"], tc["n_critic"]
    batch = P.tick_batch(split, seed, step, nc, b, c["data"]["image_size"],
                         c["data"]["caption_window"], c["data"]["random_crop"],
                         c["data"]["random_flip"])
    noise = P.tick_noise(seed, step, nc, b, c["gan"]["z_dim"],
                         (b, c["gan"]["ca_dim"]), critic=True)
    noise = {k: v.to(split["images"].device) for k, v in noise.items()}
    if fault == "half_batch":
        batch = P.half_rows(batch)
        noise = {k: v.narrow(0 if k in ("g", "g_eps") else 1, 0, b // 2)
                 for k, v in noise.items()}
    return batch, noise, alpha_at(c, step)


def _g_loss(c: Dict, g: Dict, d: Dict, batch: Dict, noise: Dict,
            alpha: float, q: P.Precision) -> torch.Tensor:
    """The generator update's loss through the fixed critic `d`."""
    stage, emb = c["pggan"]["stage"], batch["emb"][-1]
    fake, mu, logvar = generator(g, noise["g"], emb, noise["g_eps"], stage,
                                 alpha, q)
    kl = P.ca_kl(mu, logvar)
    return (-critic(d, fake, emb, stage, alpha, 1, q).mean()
            + c["train"]["coeff"]["kl"] * kl)


def train(c: Dict, weights: Dict, split: Dict, seed: int, start_step: int,
          ticks: int, prec: str = "f32", fault: Optional[str] = None,
          steps_per_epoch: int = 1) -> Dict:
    """Run `ticks` ticks from `weights` on `split`'s device; returns each
    leaf's gradient as each Adam took it at its first update (``grad``),
    the critic's leaves as the generator's first update found them
    (``d_at_g``), and each leaf's change norm over all the ticks
    (``change``).  `fault` ``half_batch`` runs every tick on the first
    half of its rows."""
    tc, co = c["train"], c["train"]["coeff"]
    q = P.Precision(prec)
    stage, nc = c["pggan"]["stage"], tc["n_critic"]
    g, d = P.leaves(weights["g"]), P.leaves(weights["d"])
    start = {"g": {k: v.detach().clone() for k, v in P.flat(g)},
             "d": {k: v.detach().clone() for k, v in P.flat(d)}}
    decay = tc["lr_decay_epoch"] * steps_per_epoch
    g_opt = P.Adam(g, tc["generator_lr"], (tc["beta1"], tc["beta2"]),
                   decay * tc["g_steps"], tc["lr_decay_factor"])
    d_opt = P.Adam(d, tc["discriminator_lr"], (tc["beta1"], tc["beta2"]),
                   decay * nc, tc["lr_decay_factor"])
    out = {}
    for i in range(ticks):
        batch, noise, alpha = _tick(c, split, seed, start_step + i, fault)
        for k in range(nc):
            real = P.images(batch["real"][k])
            wrong = P.images(batch["wrong"][k])
            emb = batch["emb"][k]
            with torch.no_grad():
                fake, _, _ = generator(g, noise["d"][k], emb,
                                       noise["d_eps"][k], stage, alpha, q)
            scores = critic(d, torch.cat([real, fake, wrong]),
                            emb.repeat(3, 1), stage, alpha, 3, q)
            s_real, s_fake, s_wrong = scores.chunk(3)
            u = noise["gp_eps"][k]
            x_hat = (fake + u * (real - fake)).detach().requires_grad_(True)
            grad, = torch.autograd.grad(
                critic(d, x_hat, emb, stage, alpha, 1, q).sum(), x_hat,
                create_graph=True)
            norm = torch.sqrt((grad**2).sum((1, 2, 3)) + 1e-12)
            gp = ((norm - 1.0)**2).mean()
            d_loss = ((s_fake.mean() - s_real.mean())
                      + co["mismatch_alpha"] * (s_wrong.mean() - s_real.mean())
                      + co["gp_lambda"] * gp
                      + co["drift_epsilon"] * ((s_real**2).mean()
                                               + (s_wrong**2).mean()))
            d_opt.update(d_loss)
        d_fixed = {k: {n: t.detach() for n, t in v.items()}
                   for k, v in d.items()}
        if i == 0:
            out["d_at_g"] = {n: t.to("cpu", copy=True)
                             for n, t in P.flat(d_fixed)}
        for _ in range(tc["g_steps"]):
            g_opt.update(_g_loss(c, g, d_fixed, batch, noise, alpha, q))
    out["grad"] = {"g": g_opt.first, "d": d_opt.first}
    out["change"] = {"g": P.param_norms_from(g, start["g"]),
                     "d": P.param_norms_from(d, start["d"])}
    return out


def g_grad_at(c: Dict, weights: Dict, split: Dict, seed: int,
              start_step: int, d_at_g: Dict[str, torch.Tensor],
              prec: str = "f32") -> Dict[str, torch.Tensor]:
    """The generator's first gradient (tick `start_step`'s generator
    update, from `weights`' generator) taken through the critic whose
    leaves `d_at_g` gives by name: the gradient the first update of a
    side whose critic stood there should take."""
    dev = split["images"].device
    g = P.leaves(weights["g"])
    d = P.nest({n: t.to(dev).float() for n, t in d_at_g.items()})
    batch, noise, alpha = _tick(c, split, seed, start_step, None)
    loss = _g_loss(c, g, d, batch, noise, alpha, P.Precision(prec))
    names, params = zip(*P.flat(g))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: (torch.zeros_like(p) if gr is None else gr).detach().cpu()
            for n, p, gr in zip(names, params, grads)}
