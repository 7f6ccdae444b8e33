"""GAN-CLS generator (counterpart of ``text_to_image_tpu/models/gancls.py``,
generator side; Reed et al. 2016, arXiv:1605.05396):

    t = lrelu(FC(φ(text)) → 128);  h = concat(z, t) → FC → 4×4×(8·gf) NHWC
    → [deconv5×5 s2 + BN + ReLU] × (n_up−1) → deconv5×5 s2 → tanh

Each up-block is the `deconv5x5_s2` kernel followed by the `bn_act` kernel
(train-mode statistics in plain torch).  `generator_apply_inference` folds
eval-mode BN into each deconv's per-channel scale/shift, so every up-block
is one kernel; its stem BN + ReLU also runs through `bn_act`.  On CUDA a
train-mode forward launches 4 deconv + 4 bn_act at 64 px, the folded
forward 4 deconv + 1 bn_act.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.ops.kernels.conv import deconv5x5_s2
from text_to_image_tpu_torch.utils import prng

BN_EPS = 1e-5


def _n_stages(resolution: int) -> int:
    n = int(math.log2(resolution // 4))
    if 4 * (2**n) != resolution:
        raise ValueError(f"resolution {resolution} must be 4·2^n")
    return n


def generator_init(key: int, gan: GanConfig, resolution: int = 64
                   ) -> Tuple[Dict, Dict]:
    """(params, state) as f32 CPU tensors, drawn from `key`; the same key
    gives the same weights on every device."""
    n_up = _n_stages(resolution)
    gf = gan.gf_dim
    ks = prng.split_tree(key, ("embed", "stem", "stem_bn", "ups", "out"))
    stem_c = gf * (2 ** (n_up - 1))

    params: Dict = {}
    state: Dict = {}
    params["embed"] = L.linear_init(ks["embed"], gan.embed_dim,
                                    gan.compressed_embed_dim)
    params["stem"] = L.linear_init(
        ks["stem"], gan.z_dim + gan.compressed_embed_dim, 4 * 4 * stem_c)
    params["stem_bn"], state["stem_bn"] = L.batch_norm_init(stem_c, ks["stem_bn"])

    c_in = stem_c
    for i in range(n_up - 1):
        c_out = gf * (2 ** (n_up - 2 - i))
        ki = prng.fold_in(ks["ups"], i)
        params[f"up{i}"] = L.conv2d_transpose_init(ki, 5, c_in, c_out)
        params[f"up{i}_bn"], state[f"up{i}_bn"] = L.batch_norm_init(
            c_out, prng.fold_in(ki, 1))
        c_in = c_out
    params["out"] = L.conv2d_transpose_init(ks["out"], 5, c_in, 3)
    return params, state


def _stem(params: Dict, z: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """concat(z, lrelu(FC(emb))) → FC → [B,4,4,C] (NHWC, as the JAX stem)."""
    t = L.lrelu(L.linear(params["embed"], emb))
    h = L.linear(params["stem"], torch.cat([z, t], dim=-1))
    return h.reshape(h.shape[0], 4, 4, h.shape[-1] // 16)


def generator_apply(params: Dict, state: Dict, z: torch.Tensor,
                    emb: torch.Tensor, train: bool, policy: L.Policy = L.FP32,
                    resolution: int = 64) -> Tuple[torch.Tensor, Dict]:
    """z[B,z_dim], emb[B,embed_dim] → (images[B,res,res,3] in tanh range,
    new BN state)."""
    n_up = _n_stages(resolution)
    h = _stem(params, policy.cast(z), policy.cast(emb))
    new_state: Dict = {}
    h, new_state["stem_bn"] = L.batch_norm_act(params["stem_bn"],
                                               state["stem_bn"], h, train)
    for i in range(n_up - 1):
        h = L.conv2d_transpose(params[f"up{i}"], h)
        h, new_state[f"up{i}_bn"] = L.batch_norm_act(
            params[f"up{i}_bn"], state[f"up{i}_bn"], h, train)
    img = L.conv2d_transpose(params["out"], h, act="tanh")
    return img, new_state


def generator_apply_inference(params: Dict, state: Dict, z: torch.Tensor,
                              emb: torch.Tensor, policy: L.Policy = L.FP32,
                              resolution: int = 64) -> torch.Tensor:
    """Serving-path generator: eval-mode BN (running statistics) folded into
    each deconv's per-channel scale a = γ·rsqrt(σ²+ε) and shift
    (b − μ)·a + β, so every up-block is one fused kernel.  Matches
    `generator_apply(train=False)` up to rounding."""
    n_up = _n_stages(resolution)
    h = _stem(params, policy.cast(z), policy.cast(emb))
    h, _ = L.batch_norm_act(params["stem_bn"], state["stem_bn"], h,
                            train=False)
    for i in range(n_up - 1):
        p, bn, s = params[f"up{i}"], params[f"up{i}_bn"], state[f"up{i}_bn"]
        a = (bn["scale"] * torch.rsqrt(s["var"] + BN_EPS)).float()
        shift = ((p["b"] - s["mean"]) * a + bn["bias"]).float()
        h = deconv5x5_s2(h, p["w"].to(h.dtype), a.contiguous(),
                         shift.contiguous(), "relu")
    out = params["out"]
    ones = torch.ones(3, dtype=torch.float32, device=h.device)
    return deconv5x5_s2(h, out["w"].to(h.dtype), ones, out["b"].float(),
                        "tanh")
