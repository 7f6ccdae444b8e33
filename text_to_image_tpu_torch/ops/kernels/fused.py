"""``bn_act``: the fused batch-norm epilogue ``act(x·a + b)``.

x is NHWC (any rows × C), a and b are per-channel f32 (BN folded as
a = γ·rsqrt(σ²+ε), b = β − μ·a).  Replaces
``text_to_image_tpu/ops/pallas/fused.py`` `bn_act` (Pallas body
`_bn_act_kernel` via `_bn_act_core`).

Bound on the H100: one read and one write of each element and no
tensor-core work, so it is bound by bytes (at B=64 bf16 the generator's four
calls move 4.2 + 8.4 + 16.8 + 33.6 MB, about 19 µs at 3.35 TB/s).  Design:
a Triton kernel over 2-D blocks (rows × up to 128 channels) with masked
loads and stores: a and b are read once per block, x once, y written once,
in f32 arithmetic.  It takes any row count and any C (the TPU's
``rows % 256`` and ``C % 128`` gates do not apply).  ``triton`` is imported
only when the kernel is first launched.
"""

from __future__ import annotations

import torch

ACT_CODES = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The JAX package's `_ACTS`: none, relu, lrelu (x >= 0, slope 0.2), tanh."""
    if act == "none":
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "lrelu":
        return torch.where(y >= 0, y, 0.2 * y)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")


def bn_act_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 act: str = "relu") -> torch.Tensor:
    """The plain PyTorch version: f32 affine + activation, cast back."""
    return apply_act(x.float() * a.float() + b.float(), act).to(x.dtype)


_KERNEL = None


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def bn_act_kernel(x_ptr, a_ptr, b_ptr, y_ptr, rows, C,
                          ACT: tl.constexpr, BLOCK_R: tl.constexpr,
                          BLOCK_C: tl.constexpr):
            r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
            c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = c < C
            a = tl.load(a_ptr + c, mask=cmask, other=0.0)
            b = tl.load(b_ptr + c, mask=cmask, other=0.0)
            mask = (r[:, None] < rows) & cmask[None, :]
            offs = r[:, None].to(tl.int64) * C + c[None, :]
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            y = x * a[None, :] + b[None, :]
            if ACT == 1:
                y = tl.maximum(y, 0.0)
            elif ACT == 2:
                y = tl.where(y >= 0, y, 0.2 * y)
            elif ACT == 3:
                y = 2.0 / (1.0 + tl.exp(-2.0 * y)) - 1.0
            tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

        _KERNEL = bn_act_kernel
    return _KERNEL


def _check(x, a, b, act):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bn_act takes bf16 or f32 x, got {x.dtype}")
    c = x.shape[-1]
    for name, v in (("a", a), ("b", b)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 [{c}], got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")


def bn_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           act: str = "relu") -> torch.Tensor:
    """``act(x·a + b)`` over channels-last x with per-channel f32 a, b:
    one read and one write of x.  CPU tensors take the plain version; CUDA
    tensors launch the Triton kernel or raise."""
    if x.device.type == "cpu":
        return bn_act_plain(x, a, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"bn_act runs on cuda or cpu, not {x.device}")
    _check(x, a, b, act)
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    block_c = min(128, 1 << (c - 1).bit_length())
    block_r = 4096 // block_c
    grid = ((rows + block_r - 1) // block_r, (c + block_c - 1) // block_c)
    _kernel()[grid](x, a, b, y, rows, c, ACT=ACT_CODES[act], BLOCK_R=block_r,
                    BLOCK_C=block_c, num_warps=4)
    bn_act.launches += 1
    return y


bn_act.launches = 0
