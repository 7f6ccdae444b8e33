"""StackGAN Stage-I and Stage-II generators (counterpart of
``text_to_image_tpu/models/stackgan.py``; Zhang et al. 2017,
arXiv:1612.03242):

* Conditioning Augmentation: ``h = lrelu(FC(φ(text)))`` split into (μ, logσ²),
  ``c = μ + σ⊙ε``; the KL(N(μ, σ) ‖ N(0, I)) term joins the generator loss.
* Stage-I G: concat(z, c) → FC → 4×4×(8·gf) → BN + ReLU → [nearest-up ×2 +
  conv3×3 + BN + ReLU] × log2(res/4) → conv3×3 → tanh.
* Stage-II G: the Stage-I image → conv3×3 + ReLU → [conv4×4 s2 + BN + ReLU]
  × 2 → concat(tile(c)) → conv3×3 + BN + ReLU → residual blocks → 4
  up-blocks → conv3×3 → tanh at 4× the Stage-I resolution.

The noise ε comes from the caller (the JAX package draws it from a key
inside `ca_apply`).  Each up-block is the `upconv3x3_bias` kernel (the 4×
upsampled map never exists) followed by a train-mode batch norm (the
`bn_stats` and `bn_act` kernels); every other BN, with or without its ReLU,
is one too.  The 3×3, 4×4 and FC layers are plain torch, as they are plain
lax in the JAX package.  On CUDA a 64 px Stage-I forward launches 4 upconv
and 5 BN calls, a 256 px Stage-II forward (without its Stage-I) 4 upconv and
7 + 2·``res_blocks`` BN calls, each one bn_stats + one bn_act.  The
discriminators are ``models/gancls.py``'s with the text compressed to
``ca_dim``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.ops.kernels.conv import upconv3x3_bias
from text_to_image_tpu_torch.utils import prng


# --- Conditioning Augmentation ------------------------------------------------

def ca_init(key: int, embed_dim: int, ca_dim: int) -> Dict:
    return {"fc": L.linear_init(key, embed_dim, 2 * ca_dim)}


def ca_apply(params: Dict, emb: torch.Tensor, eps: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """φ(text), ε[B, ca_dim] → (c, μ, logσ²) with c = μ + σ⊙ε.  The lrelu
    comes before the split, so μ and logσ² both pass through it; σ is taken
    in f32 and cast back."""
    h = L.lrelu(L.linear(params["fc"], emb))
    mu, logvar = h.chunk(2, dim=-1)
    sigma = torch.exp(0.5 * logvar.float()).to(mu.dtype)
    return mu + sigma * eps.to(mu.dtype), mu, logvar


# --- building blocks ------------------------------------------------------------

def _up_block_init(key: int, c_in: int, c_out: int) -> Tuple[Dict, Dict]:
    p = {"conv": L.conv2d_init(key, 3, c_in, c_out)}
    p["bn"], bn_s = L.batch_norm_init(c_out, prng.fold_in(key, 1))
    return p, {"bn": bn_s}


def _up_block(p: Dict, s: Dict, x: torch.Tensor, train: bool
              ) -> Tuple[torch.Tensor, Dict]:
    """nearest-up ×2 + conv3×3 + bias in one kernel, then BN + ReLU."""
    conv = p["conv"]
    x = upconv3x3_bias(x, conv["w"].to(x.dtype), conv["b"].float(), "none")
    x, bn_s = L.batch_norm_act(p["bn"], s["bn"], x, train)
    return x, {"bn": bn_s}


def _res_block_init(key: int, c: int) -> Tuple[Dict, Dict]:
    k1, k2 = prng.fold_in(key, 1), prng.fold_in(key, 2)
    p = {"conv1": L.conv2d_init(k1, 3, c, c), "conv2": L.conv2d_init(k2, 3, c, c)}
    p["bn1"], s1 = L.batch_norm_init(c, prng.fold_in(k1, 1))
    p["bn2"], s2 = L.batch_norm_init(c, prng.fold_in(k2, 1))
    return p, {"bn1": s1, "bn2": s2}


def _res_block(p: Dict, s: Dict, x: torch.Tensor, train: bool
               ) -> Tuple[torch.Tensor, Dict]:
    h = L.conv2d(p["conv1"], x, stride=1)
    h, s1 = L.batch_norm_act(p["bn1"], s["bn1"], h, train)
    h = L.conv2d(p["conv2"], h, stride=1)
    h, s2 = L.batch_norm(p["bn2"], s["bn2"], h, train)
    return torch.relu(x + h), {"bn1": s1, "bn2": s2}


def _n_up(resolution: int) -> int:
    n = int(math.log2(resolution // 4))
    if n < 1 or 4 * (2**n) != resolution:
        raise ValueError(f"resolution {resolution} must be 4·2^n, n ≥ 1")
    return n


# --- Stage-I generator -----------------------------------------------------------

def stage1_generator_init(key: int, gan: GanConfig, resolution: int = 64
                          ) -> Tuple[Dict, Dict]:
    """(params, state) as f32 CPU tensors, drawn from `key`."""
    n_up = _n_up(resolution)
    gf = gan.gf_dim
    ks = prng.split_tree(key, ("ca", "stem", "stem_bn", "ups", "out"))
    stem_c = gf * 8

    params: Dict = {"ca": ca_init(ks["ca"], gan.embed_dim, gan.ca_dim)}
    state: Dict = {}
    params["stem"] = L.linear_init(ks["stem"], gan.z_dim + gan.ca_dim,
                                   4 * 4 * stem_c)
    params["stem_bn"], state["stem_bn"] = L.batch_norm_init(stem_c,
                                                            ks["stem_bn"])
    c_in = stem_c
    for i in range(n_up):
        c_out = max(gf // 2, stem_c // (2 ** (i + 1)))
        params[f"up{i}"], state[f"up{i}"] = _up_block_init(
            prng.fold_in(ks["ups"], i), c_in, c_out)
        c_in = c_out
    params["out"] = L.conv2d_init(ks["out"], 3, c_in, 3)
    return params, state


def stage1_generator_apply(params: Dict, state: Dict, z: torch.Tensor,
                           emb: torch.Tensor, eps: torch.Tensor, train: bool,
                           policy: L.Policy = L.FP32, resolution: int = 64
                           ) -> Tuple[torch.Tensor, Dict, Dict]:
    """z[B,z_dim], emb[B,embed_dim], ε[B,ca_dim] → (images[B,res,res,3],
    new BN state, {mu, logvar, c} for the CA KL loss)."""
    n_up = _n_up(resolution)
    z, emb = policy.cast(z), policy.cast(emb)
    new_state: Dict = {}

    c, mu, logvar = ca_apply(params["ca"], emb, eps)
    h = L.linear(params["stem"], torch.cat([z, c], dim=-1))
    h = h.reshape(h.shape[0], 4, 4, -1)
    h, new_state["stem_bn"] = L.batch_norm_act(params["stem_bn"],
                                               state["stem_bn"], h, train)
    for i in range(n_up):
        h, new_state[f"up{i}"] = _up_block(params[f"up{i}"], state[f"up{i}"],
                                           h, train)
    img = L.conv2d(params["out"], h, stride=1, act="tanh")
    return img, new_state, {"mu": mu, "logvar": logvar, "c": c}


# --- Stage-II generator -----------------------------------------------------------

def stage2_generator_init(key: int, gan: GanConfig, lr_resolution: int = 64
                          ) -> Tuple[Dict, Dict]:
    """Refines lr_resolution → 4·lr_resolution (64 → 256)."""
    gf = gan.gf_dim
    ks = prng.split_tree(key, ("ca", "enc", "join", "res", "ups", "out"))
    params: Dict = {"ca": ca_init(ks["ca"], gan.embed_dim, gan.ca_dim)}
    state: Dict = {}

    # encoder: conv3x3 → [conv4x4 s2 + BN + ReLU] × 2  (res → res/4)
    params["enc0"] = L.conv2d_init(prng.fold_in(ks["enc"], 0), 3, 3, gf)
    c_in = gf
    for i in range(1, 3):
        c_out = gf * (2 ** i)
        ki = prng.fold_in(ks["enc"], i)
        params[f"enc{i}"] = L.conv2d_init(ki, 4, c_in, c_out)
        params[f"enc{i}_bn"], state[f"enc{i}_bn"] = L.batch_norm_init(
            c_out, prng.fold_in(ki, 1))
        c_in = c_out

    # join the tiled c, 3x3 back to 4·gf
    params["join"] = L.conv2d_init(ks["join"], 3, c_in + gan.ca_dim, c_in)
    params["join_bn"], state["join_bn"] = L.batch_norm_init(
        c_in, prng.fold_in(ks["join"], 1))

    for r in range(gan.res_blocks):
        params[f"res{r}"], state[f"res{r}"] = _res_block_init(
            prng.fold_in(ks["res"], r), c_in)

    # 4 up-blocks: res/4 → 4·res, halving the channels down to gf/2
    for i in range(4):
        c_out = max(gf // 2, c_in // 2)
        params[f"up{i}"], state[f"up{i}"] = _up_block_init(
            prng.fold_in(ks["ups"], i), c_in, c_out)
        c_in = c_out
    params["out"] = L.conv2d_init(ks["out"], 3, c_in, 3)
    return params, state


def stage2_generator_apply(params: Dict, state: Dict, lr_img: torch.Tensor,
                           emb: torch.Tensor, eps: torch.Tensor, train: bool,
                           policy: L.Policy = L.FP32
                           ) -> Tuple[torch.Tensor, Dict, Dict]:
    """lr_img[B,r,r,3] (the Stage-I output), emb, ε[B,ca_dim] →
    (images[B,4r,4r,3], new BN state, {mu, logvar, c})."""
    lr_img, emb = policy.cast(lr_img), policy.cast(emb)
    new_state: Dict = {}

    c, mu, logvar = ca_apply(params["ca"], emb, eps)

    h = L.conv2d(params["enc0"], lr_img, stride=1, act="relu")
    for i in range(1, 3):
        h = L.conv2d(params[f"enc{i}"], h, stride=2)
        h, new_state[f"enc{i}_bn"] = L.batch_norm_act(
            params[f"enc{i}_bn"], state[f"enc{i}_bn"], h, train)

    h = L.tile_and_concat(h, c)
    h = L.conv2d(params["join"], h, stride=1)
    h, new_state["join_bn"] = L.batch_norm_act(
        params["join_bn"], state["join_bn"], h, train)

    r = 0
    while f"res{r}" in params:
        h, new_state[f"res{r}"] = _res_block(params[f"res{r}"],
                                             state[f"res{r}"], h, train)
        r += 1
    for i in range(4):
        h, new_state[f"up{i}"] = _up_block(params[f"up{i}"], state[f"up{i}"],
                                           h, train)
    img = L.conv2d(params["out"], h, stride=1, act="tanh")
    return img, new_state, {"mu": mu, "logvar": logvar, "c": c}
