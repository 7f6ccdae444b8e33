"""Functional layers of the GAN-CLS and StackGAN generators and the
discriminator (counterpart of ``text_to_image_tpu/ops/layers.py``).

Parameters are plain dicts of tensors in the JAX package's layouts: linear
``w`` is ``[in, out]``, conv weights are HWIO, activations NHWC.  Every
``*_init`` draws on the CPU from an integer key; callers move the tree to
the device.  The up-block transposed convolution, the down-block strided
convolution and the BN epilogue go through the hand-written kernels in
``ops/kernels`` (StackGAN's upsample + 3×3 up-block calls
`ops.kernels.conv.upconv3x3_bias` from ``models/stackgan.py``).  The
convolutions that the JAX package leaves to ``lax.conv_general_dilated``
outside any kernel (3×3 stride 1, 4×4 stride 2) go to ``F.conv2d``.

Mixed precision: parameters live in f32; a `Policy` casts inputs to the
compute dtype and each layer casts its weights to the input's dtype on each
call, as the JAX layers do.  Training keeps f32 master weights, so autograd
sees that cast and the optimizer updates the f32 leaves.  Serving casts the
weights once when they are loaded (`cast_weights`): the cast inside a layer
is then a no-op instead of a copy per call (``up0``'s weight alone is 52 MB
in f32).  BatchNorm statistics are always taken in f32, by the batch-norm
kernels of ``ops/kernels/fused.py``; the WGAN critic's layer norm is plain
torch in f32, as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.ops import initializers as init
from text_to_image_tpu_torch.ops.kernels.conv import (  # noqa: F401
    conv5x5_s2_act, deconv5x5_s2,
    upsample_nearest)  # re-exported: the JAX package's `L.upsample_nearest`
from text_to_image_tpu_torch.ops.kernels.fused import (
    apply_act, batch_norm_train, bn_act)
from text_to_image_tpu_torch.parallel import tensor

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: params float32, compute configurable."""

    compute_dtype: torch.dtype = torch.bfloat16

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    @staticmethod
    def from_str(name: str) -> "Policy":
        dtype = getattr(torch, name, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown compute dtype {name!r}")
        return Policy(compute_dtype=dtype)


FP32 = Policy(compute_dtype=torch.float32)


def cast_weights(params: Dict, policy: Policy) -> Dict:
    """Copy of a params tree with every weight ``w`` in the compute dtype
    (biases and BN parameters stay f32), so no layer casts per call."""
    return {k: (cast_weights(v, policy) if isinstance(v, dict)
                else policy.cast(v) if k == "w" else v)
            for k, v in params.items()}


# --- linear -----------------------------------------------------------------

def linear_init(key: int, in_dim: int, out_dim: int,
                stddev: float = init.DEFAULT_STDDEV) -> Params:
    return {"w": init.normal(key, (in_dim, out_dim), stddev),
            "b": init.zeros((out_dim,))}


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; column-parallel over the model group where `p`'s
    ``w`` is a column block and a `tensor.model_sync` is active (the
    multi-device dry run), else one matmul."""
    sync = tensor.active()
    if tensor.is_column_slice(p, sync):
        return tensor.column_parallel_linear(p, x, sync)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# --- conv2d -------------------------------------------------------------------

def conv2d_init(key: int, k: int, in_c: int, out_c: int,
                stddev: float = init.DEFAULT_STDDEV) -> Params:
    return {"w": init.normal(key, (k, k, in_c, out_c), stddev),
            "b": init.zeros((out_c,))}


def _same_pads(n: int, k: int, stride: int):
    """TF SAME over n pixels: (before, after); the odd pixel goes after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride: int = 2,
           padding: str = "SAME", act: str = "none") -> torch.Tensor:
    """``act(conv(x, w) + b)`` over NHWC x with HWIO w, TF SAME or VALID:

    * 5×5 stride 2 SAME (the D down-blocks): the `conv5x5_s2_act` kernel,
      bias and activation fused;
    * 1×1 stride 1 (the text join's plain version): one matmul;
    * k×k VALID over a k×k map (the logit): a ``[B, k·k·C] @ [k·k·C, Co]``
      matmul;
    * anything else (StackGAN's 3×3 stride 1 and 4×4 stride 2, which the
      JAX package computes outside any kernel too): ``F.conv2d`` over the
      SAME-padded input (4×4 stride 2 pads (1, 1) on an even map, (1, 2)
      on an odd one).
    """
    k = p["w"].shape[0]
    w = p["w"].to(x.dtype)
    if k == 5 and stride == 2 and padding == "SAME":
        return conv5x5_s2_act(x, w, p["b"].float(), act)
    if k == 1 and stride == 1:
        y = x @ w[0, 0] + p["b"].to(x.dtype)
    elif padding == "VALID" and tuple(x.shape[1:3]) == (k, k):
        y = (x.reshape(x.shape[0], -1) @ w.reshape(-1, w.shape[-1])
             + p["b"].to(x.dtype)).reshape(x.shape[0], 1, 1, -1)
    elif padding in ("SAME", "VALID"):
        xn = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            (pt, pb), (pl, pr) = (_same_pads(n, k, stride)
                                  for n in x.shape[1:3])
            xn = F.pad(xn, (pl, pr, pt, pb))
        y = F.conv2d(xn, w.permute(3, 2, 0, 1), p["b"].to(x.dtype),
                     stride=stride).permute(0, 2, 3, 1).contiguous()
    else:
        raise ValueError(f"padding {padding!r} not in SAME/VALID")
    return apply_act(y, act)


# --- conv2d_transpose (reference `deconv2d`) ---------------------------------

def conv2d_transpose_init(key: int, k: int, in_c: int, out_c: int,
                          stddev: float = init.DEFAULT_STDDEV) -> Params:
    return {"w": init.normal(key, (k, k, in_c, out_c), stddev),
            "b": init.zeros((out_c,))}


def conv2d_transpose(p: Params, x: torch.Tensor, act: str = "none"
                     ) -> torch.Tensor:
    """5×5 stride-2 SAME transposed conv (TF1 ``conv2d_transpose``
    semantics) with bias and activation fused: the `deconv5x5_s2` kernel
    with scale 1 and shift = bias."""
    w = p["w"].to(x.dtype)
    ones = torch.ones(w.shape[-1], dtype=torch.float32, device=x.device)
    return deconv5x5_s2(x, w, ones, p["b"].float(), act)


# --- batch norm ---------------------------------------------------------------

def batch_norm_init(c: int, key: int | None = None) -> Tuple[Params, Params]:
    """Returns (params, state).  Reference: momentum 0.9, eps 1e-5, scale
    init N(1.0, 0.02)."""
    scale = init.bn_scale(key, (c,)) if key is not None else torch.ones(c)
    params = {"scale": scale, "bias": init.zeros((c,))}
    state = {"mean": init.zeros((c,)), "var": torch.ones(c)}
    return params, state


def batch_norm(p: Params, state: Params, x: torch.Tensor, train: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Params]:
    """NHWC batch norm (no activation): `batch_norm_act` with act none."""
    return batch_norm_act(p, state, x, train, "none", momentum, eps)


def batch_norm_act(p: Params, state: Params, x: torch.Tensor, train: bool,
                   act: str = "relu", momentum: float = 0.9, eps: float = 1e-5,
                   streams: int = 1) -> Tuple[torch.Tensor, Params]:
    """`batch_norm` + activation as ``act(x·a + b)`` (a = γ·rsqrt(σ²+ε),
    b = β − μ·a).

    Train mode: `batch_norm_train`, f32 batch statistics with the biased
    variance and ``new = momentum·old + (1 − momentum)·batch``; two launches
    forward and two backward on the card.  ``streams`` > 1 splits the batch
    into that many contiguous streams, as the JAX package's ``vmap`` over
    stacked discriminator streams does: each takes its own batch statistics
    and the new running state is the mean over streams of each stream's
    update.  Eval mode: a and b from the running state, one `bn_act`
    launch."""
    if train:
        y, mean, var = batch_norm_train(x, p["scale"], p["bias"],
                                        state["mean"], state["var"], streams,
                                        act, momentum, eps)
        return y, {"mean": mean, "var": var}
    a = torch.rsqrt(state["var"] + eps) * p["scale"].float()
    b = p["bias"].float() - state["mean"] * a
    return bn_act(x, a.contiguous(), b.contiguous(), act), state


# --- layer norm (the WGAN-GP critic: no batch statistics under the GP) -----------

def layer_norm_init(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": init.zeros((c,))}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-example norm over (H, W, C) in f32 (biased variance), then the
    per-channel affine; returns x's dtype.  Each example is normalised on
    its own, so the gradient penalty's per-input gradient stays defined."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=(1, 2, 3), keepdim=True,
                               correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# --- activations ----------------------------------------------------------------

def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def tile_and_concat(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Replicate t[B,E] over x's H×W grid and concat on channels: the
    conditioning join's input as the reference builds it (the plain version
    of `conditioning_join`, which never builds it)."""
    b, h, w, _ = x.shape
    tiled = t[:, None, None, :].expand(b, h, w, t.shape[-1]).to(x.dtype)
    return torch.cat([x, tiled], dim=-1)

