"""Functional layers the generator needs (counterpart of
``text_to_image_tpu/ops/layers.py``).

Parameters are plain dicts of tensors in the JAX package's layouts: linear
``w`` is ``[in, out]``, conv weights are HWIO, activations NHWC.  Every
``*_init`` draws on the CPU from an integer key; callers move the tree to
the device.  The up-block transposed convolution and the BN epilogue go
through the hand-written kernels in ``ops/kernels``.

Mixed precision: parameters live in f32; a `Policy` casts inputs to the
compute dtype and each layer casts its weights to the input's dtype.  Cast
the weights once when they are loaded (`cast_weights`): the cast inside a
layer is then a no-op instead of a copy per call (``up0``'s weight alone is
52 MB in f32).  BatchNorm statistics are always taken in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from text_to_image_tpu_torch.ops import initializers as init
from text_to_image_tpu_torch.ops.kernels.conv import deconv5x5_s2
from text_to_image_tpu_torch.ops.kernels.fused import bn_act

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
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


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


def _stats(state: Params, x: torch.Tensor, train: bool, momentum: float
           ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """(mean, var, new_state): batch statistics in f32 with the biased
    variance and ``new = momentum·old + (1 − momentum)·batch`` in train mode,
    the running statistics otherwise."""
    if not train:
        return state["mean"], state["var"], state
    var, mean = torch.var_mean(x.float(), dim=(0, 1, 2), unbiased=False)
    new_state = {"mean": momentum * state["mean"] + (1.0 - momentum) * mean,
                 "var": momentum * state["var"] + (1.0 - momentum) * var}
    return mean, var, new_state


def batch_norm(p: Params, state: Params, x: torch.Tensor, train: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Params]:
    """NHWC batch norm, plain torch (no activation)."""
    mean, var, new_state = _stats(state, x, train, momentum)
    inv = torch.rsqrt(var + eps) * p["scale"].float()
    y = (x.float() - mean) * inv + p["bias"].float()
    return y.to(x.dtype), new_state


def batch_norm_act(p: Params, state: Params, x: torch.Tensor, train: bool,
                   act: str = "relu", momentum: float = 0.9, eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, Params]:
    """`batch_norm` + activation with the normalize-affine + activation
    epilogue folded to ``act(x·a + b)`` (a = γ·rsqrt(σ²+ε), b = β − μ·a) and
    run by the `bn_act` kernel; the statistics stay plain torch."""
    mean, var, new_state = _stats(state, x, train, momentum)
    a = torch.rsqrt(var + eps) * p["scale"].float()
    b = p["bias"].float() - mean * a
    return bn_act(x, a.contiguous(), b.contiguous(), act), new_state


# --- activations ----------------------------------------------------------------

def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)

