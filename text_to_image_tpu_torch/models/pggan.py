"""Conditional progressive-growing GAN, C-PGGAN (counterpart of
``text_to_image_tpu/models/pggan.py``; Karras et al. 2018, arXiv:1710.10196,
text-conditioned as in arXiv:1805.00676).

Stage s trains at 4·2^(s−1) px; the parameter trees hold every stage from
init, and a stage's forward leaves the deeper layers untouched, so the
stages share one tree, one optimizer state and one checkpoint format.  The
fade-in α blends the new block with the upsampled (G) or downsampled (D)
path of the stage below.  Equalized learning rate (weights N(0, 1),
He-scaled at use), PixelNorm in G, minibatch stddev in D, average-pool down
and nearest up; text enters G as the compressed embedding and a
conditioning-augmentation sample beside z, and D at its 4×4 map as a tiled
concat and a 1×1 conv (the matching-aware critic of WGAN-CLS).

Each G up-block's first convolution is the `upconv3x3_bias` kernel with
its lrelu fused (the equalized-LR scale folded into the weights in f32),
then PixelNorm: one launch a block, ``stage − 1`` a forward.  Everything
else is plain torch, as the JAX package leaves it to lax: the 3×3 stride-1
convolutions (``F.conv2d``), the 1×1 toRGB / fromRGB and the critic's join
(matmuls), the pooling, ``conv4``, ``dense`` and ``logit``.  The critic is
stateless (no BN): the gradient penalty differentiates it twice.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.ops import initializers as init
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.ops.kernels.conv import upconv3x3_bias
from text_to_image_tpu_torch.parallel import collectives
from text_to_image_tpu_torch.utils import prng

GAIN = math.sqrt(2.0)


def stage_resolution(stage: int) -> int:
    """Stage s trains at 4·2^(s−1): stage 1 = 4 px, …, stage 7 = 256 px."""
    return 4 * 2 ** (stage - 1)


def num_stages(resolution: int) -> int:
    s = int(math.log2(resolution // 4)) + 1
    if stage_resolution(s) != resolution:
        raise ValueError(f"resolution {resolution} must be 4·2^n")
    return s


def stage_channels(stage: int, gan: GanConfig) -> int:
    """Feature width of a stage, capped at 4·gf and halving from 32 px:
    512, 512, 512, 256, 128, 64, 32 for gf 128."""
    return max(16, min(4 * gan.gf_dim, 32 * gan.gf_dim // 2 ** stage))


# --- equalized-LR primitives -----------------------------------------------------

def _eq_dense_init(key: int, in_dim: int, out_dim: int) -> L.Params:
    return {"w": init.normal(key, (in_dim, out_dim), 1.0),
            "b": init.zeros((out_dim,))}


def _eq_dense(p: L.Params, x: torch.Tensor, gain: float = GAIN
              ) -> torch.Tensor:
    scale = gain / math.sqrt(p["w"].shape[0])
    return x @ (p["w"] * scale).to(x.dtype) + p["b"].to(x.dtype)


def _eq_conv_init(key: int, k: int, cin: int, cout: int) -> L.Params:
    return {"w": init.normal(key, (k, k, cin, cout), 1.0),
            "b": init.zeros((cout,))}


def _eq_scale(w: torch.Tensor, gain: float = GAIN) -> float:
    k, _, cin, _ = w.shape
    return gain / math.sqrt(k * k * cin)


def _eq_conv(p: L.Params, x: torch.Tensor, gain: float = GAIN
             ) -> torch.Tensor:
    """Stride-1 SAME conv with the He scale applied to w in f32, then cast:
    a matmul for 1×1, ``F.conv2d`` for 3×3 (``L.conv2d``)."""
    w = (p["w"] * _eq_scale(p["w"], gain)).to(x.dtype)
    return L.conv2d({"w": w, "b": p["b"]}, x, stride=1)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    x32 = x.float()
    return (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
            ).to(x.dtype)


def _avgpool2(x: torch.Tensor) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum((2, 4)) / 4.0


def downsample_to(x: torch.Tensor, res: int) -> torch.Tensor:
    """Exact power-of-two average-pool downsample of NHWC images to res."""
    while x.shape[1] > res:
        x = _avgpool2(x)
    return x


def minibatch_stddev(x: torch.Tensor, streams: int = 1, eps: float = 1e-8
                     ) -> torch.Tensor:
    """Append each stream's mean feature stddev (over its own examples) as
    one constant channel.  x holds `streams` contiguous streams: the
    statistic is never taken across them.

    In the data-parallel tick (`collectives.active`) x is this rank's piece
    of each stream and the variance is the whole stream's, as the JAX
    package's under data parallelism: the ranks' per-feature means and
    variances are gathered (differentiably, so the gradient penalty's
    second derivative crosses the ranks too) and, the pieces being equal,
    var = mean of the variances + variance of the means."""
    x32 = x.float().reshape(streams, -1, *x.shape[1:])
    sync = collectives.active()
    if sync is None:
        var = x32.var(dim=1, correction=0)
    else:
        parts = collectives.all_gather(
            torch.stack(torch.var_mean(x32, dim=1, correction=0)), sync)
        means = parts[:, 1]
        var = parts[:, 0].mean(0) + means.var(0, correction=0)
    std = torch.sqrt(var + eps).mean((1, 2, 3))
    feat = std.to(x.dtype)[:, None, None, None, None].expand(
        streams, x32.shape[1], *x.shape[1:3], 1)
    return torch.cat([x, feat.reshape(*x.shape[:3], 1)], dim=-1)


def _alpha(alpha, like: torch.Tensor) -> torch.Tensor:
    """α as a scalar of `like`'s dtype (f32 first, as the JAX blend)."""
    return torch.as_tensor(alpha, dtype=torch.float32).to(like.dtype)


# --- generator -------------------------------------------------------------------

def generator_init(key: int, gan: GanConfig, resolution: int
                   ) -> Tuple[Dict, Dict]:
    """Full-depth (params, {}) as f32 CPU tensors drawn from `key`: every
    stage's blocks and toRGB exist from init."""
    n = num_stages(resolution)
    ks = prng.split_tree(key, ("embed", "ca", "stem", "blocks", "rgb"))
    params: Dict = {}
    params["embed"] = L.linear_init(ks["embed"], gan.embed_dim,
                                    gan.compressed_embed_dim)
    params["ca"] = _eq_dense_init(ks["ca"], gan.compressed_embed_dim,
                                  2 * gan.ca_dim)
    c0 = stage_channels(1, gan)
    params["stem"] = _eq_dense_init(
        ks["stem"], gan.z_dim + gan.compressed_embed_dim + gan.ca_dim,
        4 * 4 * c0)
    params["stem_conv"] = _eq_conv_init(prng.fold_in(ks["stem"], 1), 3, c0,
                                        c0)
    params["rgb1"] = _eq_conv_init(prng.fold_in(ks["rgb"], 1), 1, c0, 3)
    cin = c0
    for s in range(2, n + 1):
        kb = prng.fold_in(ks["blocks"], s)
        cout = stage_channels(s, gan)
        params[f"up{s}a"] = _eq_conv_init(kb, 3, cin, cout)
        params[f"up{s}b"] = _eq_conv_init(prng.fold_in(kb, 1), 3, cout, cout)
        params[f"rgb{s}"] = _eq_conv_init(prng.fold_in(ks["rgb"], s), 1,
                                          cout, 3)
        cin = cout
    return params, {}


def generator_apply(params: Dict, z: torch.Tensor, emb: torch.Tensor,
                    eps: torch.Tensor, stage: int, alpha, gan: GanConfig,
                    policy: L.Policy = L.FP32
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """z[B,z], emb[B,E], the CA noise eps[B,ca] (f32) and α → (images at
    stage_resolution(stage) in tanh range, {"mu", "logvar"} for the KL
    term)."""
    z, emb = policy.cast(z), policy.cast(emb)
    t = L.lrelu(L.linear(params["embed"], emb))
    mu, logvar = _eq_dense(params["ca"], t, gain=1.0).float().chunk(2, -1)
    c = policy.cast(mu + torch.exp(0.5 * logvar) * eps.float())

    h = _eq_dense(params["stem"], torch.cat([z, t, c], dim=-1))
    h = pixel_norm(L.lrelu(h.reshape(h.shape[0], 4, 4, -1)))
    h = pixel_norm(L.lrelu(_eq_conv(params["stem_conv"], h)))

    prev_rgb = None
    for s in range(2, stage + 1):
        prev_rgb = _eq_conv(params[f"rgb{s - 1}"], h, gain=1.0)
        pa = params[f"up{s}a"]
        w = (pa["w"] * _eq_scale(pa["w"])).to(h.dtype)
        h = pixel_norm(upconv3x3_bias(h, w, pa["b"].float(), "lrelu"))
        h = pixel_norm(L.lrelu(_eq_conv(params[f"up{s}b"], h)))

    img = _eq_conv(params[f"rgb{stage}"], h, gain=1.0)
    if prev_rgb is not None:
        a = _alpha(alpha, img)
        img = a * img + (1 - a) * L.upsample_nearest(prev_rgb)
    return torch.tanh(img.float()).to(img.dtype), {"mu": mu,
                                                   "logvar": logvar}


# --- critic ------------------------------------------------------------------------

def discriminator_init(key: int, gan: GanConfig, resolution: int
                       ) -> Tuple[Dict, Dict]:
    """Full-depth (params, {}) as f32 CPU tensors drawn from `key`."""
    n = num_stages(resolution)
    ks = prng.split_tree(key, ("from", "blocks", "embed", "join", "head"))
    params: Dict = {}
    for s in range(1, n + 1):
        cs = stage_channels(s, gan)
        params[f"from{s}"] = _eq_conv_init(prng.fold_in(ks["from"], s), 1, 3,
                                           cs)
        if s >= 2:
            kb = prng.fold_in(ks["blocks"], s)
            cprev = stage_channels(s - 1, gan)
            params[f"down{s}a"] = _eq_conv_init(kb, 3, cs, cs)
            params[f"down{s}b"] = _eq_conv_init(prng.fold_in(kb, 1), 3, cs,
                                                cprev)
    c0 = stage_channels(1, gan)
    params["embed"] = L.linear_init(ks["embed"], gan.embed_dim,
                                    gan.compressed_embed_dim)
    # the matching-aware join at the 4×4 map (+1: the minibatch-stddev channel)
    params["join"] = _eq_conv_init(ks["join"], 1,
                                   c0 + 1 + gan.compressed_embed_dim, c0)
    params["conv4"] = _eq_conv_init(prng.fold_in(ks["head"], 0), 3, c0, c0)
    params["dense"] = _eq_dense_init(prng.fold_in(ks["head"], 1),
                                     4 * 4 * c0, c0)
    params["logit"] = _eq_dense_init(prng.fold_in(ks["head"], 2), c0, 1)
    return params, {}


def _discriminator(params: Dict, x: torch.Tensor, emb: torch.Tensor,
                   stage: int, alpha, policy: L.Policy, streams: int
                   ) -> torch.Tensor:
    x, emb = policy.cast(x), policy.cast(emb)
    h = L.lrelu(_eq_conv(params[f"from{stage}"], x, gain=1.0))
    for s in range(stage, 1, -1):
        h = L.lrelu(_eq_conv(params[f"down{s}a"], h))
        h = _avgpool2(L.lrelu(_eq_conv(params[f"down{s}b"], h)))
        if s == stage:
            skip = L.lrelu(_eq_conv(params[f"from{s - 1}"], _avgpool2(x),
                                    gain=1.0))
            a = _alpha(alpha, h)
            h = a * h + (1 - a) * skip
    h = minibatch_stddev(h, streams)
    t = L.lrelu(L.linear(params["embed"], emb))
    h = L.lrelu(_eq_conv(params["join"], L.tile_and_concat(h, t), gain=1.0))
    h = L.lrelu(_eq_conv(params["conv4"], h))
    h = L.lrelu(_eq_dense(params["dense"], h.reshape(h.shape[0], -1)))
    return _eq_dense(params["logit"], h, gain=1.0).reshape(h.shape[0])


def discriminator_apply(params: Dict, x: torch.Tensor, emb: torch.Tensor,
                        stage: int, alpha, gan: GanConfig,
                        policy: L.Policy = L.FP32) -> torch.Tensor:
    """Critic scores [B] (no sigmoid) of x at stage_resolution(stage)."""
    return _discriminator(params, x, emb, stage, alpha, policy, 1)


def discriminator_apply_streams(params: Dict, xs: torch.Tensor,
                                embs: torch.Tensor, stage: int, alpha,
                                gan: GanConfig, policy: L.Policy = L.FP32
                                ) -> torch.Tensor:
    """Scores [S,B] of S stacked streams xs[S,B,…] in one pass of batch
    S·B; the minibatch stddev stays per stream, as S separate calls."""
    s, b = xs.shape[:2]
    out = _discriminator(params, xs.reshape(s * b, *xs.shape[2:]),
                         embs.reshape(s * b, embs.shape[-1]), stage, alpha,
                         policy, s)
    return out.reshape(s, b)
