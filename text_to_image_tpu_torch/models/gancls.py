"""GAN-CLS generator and matching-aware discriminator (counterpart of
``text_to_image_tpu/models/gancls.py``; Reed et al. 2016, arXiv:1605.05396):

    G: t = lrelu(FC(φ(text)) → 128);  h = concat(z, t) → FC → 4×4×(8·gf)
       → [deconv5×5 s2 + BN + ReLU] × (n_up−1) → deconv5×5 s2 → tanh
    D: [conv5×5 s2 (+BN from layer 2) + lrelu] × n_down to 4×4×(8·df)
       → concat(tile(lrelu(FC(φ)))) → conv1×1 + BN + lrelu
       → conv4×4 VALID → scalar logit

Each G up-block is the `deconv5x5_s2` kernel followed by a train-mode batch
norm (`bn_stats` + `bn_act`; backward `bn_bwd_reduce` + `bn_bwd_apply`).
`generator_apply_inference` folds eval-mode BN into each deconv's
per-channel scale/shift, so every up-block is one kernel; its stem BN + ReLU
runs through `bn_act` alone.  On CUDA a train-mode forward launches 4 deconv
and, for its 4 BN calls, 4 bn_stats + 4 bn_act at 64 px; the folded forward
4 deconv + 1 bn_act.

Each D down-block is the `conv5x5_s2_act` kernel (bias, and on ``down0``
the lrelu, fused) followed by a batch norm; the text join is the
`conditioning_join` kernel.  The JAX package computes the same function
with ``L.conv2d`` + ``batch_norm_act`` and its lax join.  A 64 px D forward
launches 4 conv + 1 join and, for its 4 BN calls, 4 bn_stats + 4 bn_act
whatever its number of streams (each stream takes its own statistics
inside the kernels).

``norm="layer"`` is WGAN-CLS's critic: a per-example layer norm (plain
torch, ``L.layer_norm``) after every down-block from the second and after
the join, no D state.  Its convolutions and join stay on the same kernels
(4 conv + 1 join a forward): the gradient penalty differentiates the
critic twice, and the kernels' autograd Functions carry that second
derivative because their backwards are differentiable torch ops.  (The JAX
critic leaves its join to lax there, because a ``custom_vjp`` is not
differentiable twice.)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.ops.kernels.conv import deconv5x5_s2
from text_to_image_tpu_torch.ops.kernels.fused import conditioning_join
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


# --- discriminator ---------------------------------------------------------------

def discriminator_init(key: int, gan: GanConfig, resolution: int = 64,
                       norm: str = "batch") -> Tuple[Dict, Dict]:
    """(params, state) as f32 CPU tensors, drawn from `key`; `norm` is
    "batch" (GAN-CLS, StackGAN) or "layer" (the WGAN-CLS critic)."""
    _check_norm(norm)
    n_down = _n_stages(resolution)
    df = gan.df_dim
    ks = prng.split_tree(key, ("embed", "downs", "join", "logit"))

    params: Dict = {}
    state: Dict = {}
    c_in = 3
    for i in range(n_down):
        # growth capped at 8·df, as in the JAX package
        c_out = df * min(2 ** i, 8)
        ki = prng.fold_in(ks["downs"], i)
        params[f"down{i}"] = L.conv2d_init(ki, 5, c_in, c_out)
        if i > 0 and norm == "batch":  # no norm on the first conv
            params[f"down{i}_bn"], state[f"down{i}_bn"] = L.batch_norm_init(
                c_out, prng.fold_in(ki, 1))
        elif i > 0:
            params[f"down{i}_ln"] = L.layer_norm_init(c_out)
        c_in = c_out
    params["embed"] = L.linear_init(ks["embed"], gan.embed_dim,
                                    gan.compressed_embed_dim)
    params["join"] = L.conv2d_init(ks["join"], 1,
                                   c_in + gan.compressed_embed_dim, c_in)
    if norm == "batch":
        params["join_bn"], state["join_bn"] = L.batch_norm_init(
            c_in, prng.fold_in(ks["join"], 1))
    else:
        params["join_ln"] = L.layer_norm_init(c_in)
    params["logit"] = L.conv2d_init(ks["logit"], 4, c_in, 1)
    return params, state


def _text_join(join_params: Dict, h: torch.Tensor, t: torch.Tensor
               ) -> torch.Tensor:
    """conv1x1(concat(h, tile(t))) through the `conditioning_join` kernel:
    the 1×1 kernel split over the [image; text] channels, concat-free."""
    w = join_params["w"][0, 0].to(h.dtype)             # [Cx+E, Co], one cast
    cx = h.shape[-1]
    # row slices of a contiguous matrix are contiguous: no copies
    return conditioning_join(h, t.to(h.dtype), w[:cx], w[cx:],
                             join_params["b"].float(), "none")


def _check_norm(norm: str) -> None:
    if norm not in ("batch", "layer"):
        raise ValueError(f"norm {norm!r} not in ('batch', 'layer')")


def _norm_act(params: Dict, state: Dict, name: str, h: torch.Tensor,
              train: bool, norm: str, streams: int, new_state: Dict
              ) -> torch.Tensor:
    """lrelu(norm(h)): the batch-norm kernels (state under ``<name>_bn``)
    or the layer norm (``<name>_ln``, stateless) and an lrelu."""
    if norm == "batch":
        h, new_state[f"{name}_bn"] = L.batch_norm_act(
            params[f"{name}_bn"], state[f"{name}_bn"], h, train, act="lrelu",
            streams=streams)
        return h
    return L.lrelu(L.layer_norm(params[f"{name}_ln"], h))


def _discriminator(params: Dict, state: Dict, x: torch.Tensor,
                   emb: torch.Tensor, train: bool, policy: L.Policy,
                   resolution: int, streams: int, norm: str
                   ) -> Tuple[torch.Tensor, Dict]:
    """D over a batch of `streams` contiguous streams, each with its own
    batch statistics; convolutions and the join run once over all of it."""
    _check_norm(norm)
    n_down = _n_stages(resolution)
    h = policy.cast(x)
    new_state: Dict = {}
    for i in range(n_down):
        if i == 0:
            h = L.conv2d(params["down0"], h, act="lrelu")
            continue
        h = L.conv2d(params[f"down{i}"], h)
        h = _norm_act(params, state, f"down{i}", h, train, norm, streams,
                      new_state)
    t = L.lrelu(L.linear(params["embed"], policy.cast(emb)))
    h = _text_join(params["join"], h, t)
    h = _norm_act(params, state, "join", h, train, norm, streams, new_state)
    logit = L.conv2d(params["logit"], h, stride=1, padding="VALID")
    return logit.reshape(logit.shape[0]), new_state


def discriminator_apply(params: Dict, state: Dict, x: torch.Tensor,
                        emb: torch.Tensor, train: bool,
                        policy: L.Policy = L.FP32, resolution: int = 64,
                        norm: str = "batch") -> Tuple[torch.Tensor, Dict]:
    """x[B,res,res,3], emb[B,embed_dim] → (logits[B] before the sigmoid, or
    the critic's scores, new BN state; {} for the layer norm)."""
    return _discriminator(params, state, x, emb, train, policy, resolution, 1,
                          norm)


def discriminator_apply_streams(params: Dict, state: Dict, xs: torch.Tensor,
                                embs: torch.Tensor, train: bool,
                                policy: L.Policy = L.FP32,
                                resolution: int = 64, norm: str = "batch"
                                ) -> Tuple[torch.Tensor, Dict]:
    """D on S stacked streams xs[S,B,...], embs[S,B,E] in one pass of batch
    S·B: each stream keeps its own BN batch statistics (the JAX package
    ``vmap``s), and the new running state is the mean over streams of each
    stream's update.  Returns logits[S,B]."""
    s, b = xs.shape[:2]
    logits, new_state = _discriminator(
        params, state, xs.reshape(s * b, *xs.shape[2:]),
        embs.reshape(s * b, embs.shape[-1]), train, policy, resolution, s,
        norm)
    return logits.reshape(s, b), new_state
