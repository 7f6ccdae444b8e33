"""GAN-CLS and StackGAN losses (counterpart of
``text_to_image_tpu/models/losses.py``: the matching-aware CE family, Reed
et al. 2016, and the conditioning-augmentation KL, Zhang et al. 2017):

    d_loss = CE(D(real, t), 1) + ½·[CE(D(fake, t), 0) + CE(D(real, t̄), 0)]
    g_loss = CE(D(fake, t), 1)   (+ w·CE(D(G(z, t_int), t_int), 1), GAN-INT)
                                 (+ w_kl·KL(N(μ, σ) ‖ N(0, I)), StackGAN)

Every reduction is a mean over the batch, in f32.  The WGAN-GP terms belong
to WGAN-CLS (ROADMAP.md, 'Modules to port' item 5).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


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
    one in the batch (a roll by one)."""
    return beta * emb + (1.0 - beta) * torch.roll(emb, shifts=1, dims=0)


def ca_kl_loss(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Closed-form KL(N(μ, e^logvar) ‖ N(0, I)), summed over the CA
    dimensions and averaged over the batch, in f32."""
    mu, logvar = mu.float(), logvar.float()
    per = -0.5 * torch.sum(1.0 + logvar - mu**2 - torch.exp(logvar), dim=-1)
    return per.mean()
