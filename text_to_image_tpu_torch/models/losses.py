"""GAN-CLS and StackGAN losses (counterpart of
``text_to_image_tpu/models/losses.py``: the matching-aware CE family, Reed
et al. 2016, and the conditioning-augmentation KL, Zhang et al. 2017):

    d_loss = CE(D(real, t), 1) + ½·[CE(D(fake, t), 0) + CE(D(real, t̄), 0)]
    g_loss = CE(D(fake, t), 1)   (+ w·CE(D(G(z, t_int), t_int), 1), GAN-INT)
                                 (+ w_kl·KL(N(μ, σ) ‖ N(0, I)), StackGAN)

and the conditional Wasserstein family of WGAN-CLS and C-PGGAN (critic
scores, no sigmoid; Gulrajani et al. 2017 for the gradient penalty):

    d_loss = E[D(fake)] − E[D(real)] + α·(E[D(wrong)] − E[D(real)]) + λ·GP
             (+ ε_drift·(E[D(real)²] + E[D(wrong)²]))
    g_loss = −E[D(fake)]

Every reduction is a mean over the batch, in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from text_to_image_tpu_torch.parallel import collectives


def sigmoid_ce(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Stable sigmoid cross-entropy against a constant label, averaged:
    ``max(x, 0) − x·z + log1p(e^{−|x|})`` in f32 (TF1
    ``sigmoid_cross_entropy_with_logits``)."""
    x = logits.float()
    per = torch.clamp(x, min=0.0) - x * label + torch.log1p(torch.exp(-x.abs()))
    return per.mean()


def gan_cls_d_loss(real_logit: torch.Tensor, fake_logit: torch.Tensor,
                   wrong_logit: torch.Tensor, real_label: float = 1.0
                   ) -> Dict[str, torch.Tensor]:
    """`real_label` < 1 is one-sided label smoothing: only the real term's
    target softens; fake and wrong stay at 0."""
    d_real = sigmoid_ce(real_logit, real_label)
    d_fake = sigmoid_ce(fake_logit, 0.0)
    d_wrong = sigmoid_ce(wrong_logit, 0.0)
    return {"d_loss": d_real + 0.5 * (d_fake + d_wrong), "d_real": d_real,
            "d_fake": d_fake, "d_wrong": d_wrong}


def gan_cls_g_loss(fake_logit: torch.Tensor,
                   interp_logit: Optional[torch.Tensor] = None,
                   interp_weight: float = 0.5) -> Dict[str, torch.Tensor]:
    g = sigmoid_ce(fake_logit, 1.0)
    out = {"g_fake": g}
    if interp_logit is not None:
        g_int = sigmoid_ce(interp_logit, 1.0)
        out["g_interp"] = g_int
        g = g + interp_weight * g_int
    out["g_loss"] = g
    return out


def interpolate_embeddings(emb: torch.Tensor, beta: float = 0.5
                           ) -> torch.Tensor:
    """GAN-INT: β·t₁ + (1−β)·t₂, pairing each embedding with the previous
    one in the batch (a roll by one).

    In the data-parallel tick (`collectives.active`) emb is this rank's
    rows and the roll is over the global batch, as the JAX package's:
    rank d's first row pairs with rank d−1's last (the first rank's with
    the last rank's).  The embeddings are gathered, rolled, and this rank's
    rows kept; no gradient flows to them."""
    sync = collectives.active()
    if sync is None:
        return beta * emb + (1.0 - beta) * torch.roll(emb, shifts=1, dims=0)
    b = emb.shape[0]
    everyone = collectives.all_gather(emb.detach(), sync).flatten(0, 1)
    prev = torch.roll(everyone, shifts=1, dims=0)[sync.index * b:
                                                  (sync.index + 1) * b]
    return beta * emb + (1.0 - beta) * prev


def wgan_cls_d_loss(real_score: torch.Tensor, fake_score: torch.Tensor,
                    wrong_score: torch.Tensor, gp: torch.Tensor,
                    mismatch_alpha: float, gp_lambda: float,
                    drift_epsilon: float = 0.0) -> Dict[str, torch.Tensor]:
    """The matching-aware critic loss.  The drift term anchors the real
    **and** the wrong scores: the GP bounds the real↔fake direction but not
    the text direction, so the mismatch term alone would push D(x, t̄)
    towards −∞."""
    real, fake, wrong = (s.float() for s in (real_score, fake_score,
                                             wrong_score))
    e_real, e_fake, e_wrong = real.mean(), fake.mean(), wrong.mean()
    total = ((e_fake - e_real) + mismatch_alpha * (e_wrong - e_real)
             + gp_lambda * gp)
    if drift_epsilon:
        total = total + drift_epsilon * ((real**2).mean() + (wrong**2).mean())
    return {"d_loss": total, "w_dist": e_real - e_fake, "d_wrong": e_wrong,
            "gp": gp}


def wgan_cls_g_loss(fake_score: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"g_loss": -fake_score.float().mean()}


def gradient_penalty(critic_on_images: Callable[[torch.Tensor], torch.Tensor],
                     real: torch.Tensor, fake: torch.Tensor, eps: torch.Tensor
                     ) -> torch.Tensor:
    """WGAN-GP: mean of (‖∇x̂ Σ D(x̂)‖₂ − 1)² at x̂ = fake + ε·(real − fake),
    formed in f32 (ε [B,1,1,1]).  `critic_on_images` maps images to
    per-example scores with the text bound.  The inner gradient keeps its
    graph (``create_graph``), so differentiating the penalty reaches the
    critic's parameters through it."""
    x_hat = (fake.float() + eps.float() * (real.float() - fake.float()))
    x_hat = x_hat.detach().requires_grad_(True)
    score = critic_on_images(x_hat).float().sum()
    grads, = torch.autograd.grad(score, x_hat, create_graph=True)
    norms = torch.sqrt((grads.float()**2).sum((1, 2, 3)) + 1e-12)
    return ((norms - 1.0)**2).mean()


def ca_kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Closed-form KL(N(μ, e^logvar) ‖ N(0, I)), summed over the CA
    dimensions and averaged over the batch, in f32."""
    mu, logvar = mu.float(), logvar.float()
    per = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar), dim=-1)
    return per.mean()
