"""``deconv5x5_s2``: the generator's fused up-block transposed convolution.

``y = act(conv_transpose_5x5_s2_SAME(x, w) · scale + shift)`` over NHWC x and
HWIO w, with ``lax.conv_transpose`` semantics (no kernel flip).  Replaces
``text_to_image_tpu/ops/pallas/conv.py`` `deconv5x5_s2` (Pallas bodies
`_deconv_kernel_vpad` and its HBM-staged twin `_deconv_kernel`).

On CUDA the wrapper launches the hand-written kernel in
``csrc/deconv5x5_s2.cu`` (WMMA tensor cores for bf16, FMA for f32; its source
note gives the bound on the H100 and the design).  On the CPU it runs
`deconv5x5_s2_plain`, which is built from the same tap table as the TPU
kernel and is what the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.ops.kernels.fused import ACT_CODES, apply_act

# parity → [(padded slice start, kernel tap index)] with x padded (1, 2)
# per spatial dim (conv.py _DECONV_TAPS):
# O[2m] = X[m-1]·W1 + X[m]·W3; O[2m+1] = X[m-1]·W0 + X[m]·W2 + X[m+1]·W4
DECONV_TAPS = {0: ((0, 1), (1, 3)), 1: ((0, 0), (1, 2), (2, 4))}

_DTYPES = (torch.bfloat16, torch.float32)


def deconv5x5_s2_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version: four output-parity planes, each a sum of
    tap matmuls over the (1, 2)-padded input, accumulated in f32."""
    b, h, wd, _ = x.shape
    co = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 2, 1, 2))
    w32 = w.float()
    rows = []
    for py in (0, 1):
        cols = []
        for px in (0, 1):
            acc = torch.zeros(b, h, wd, co, device=x.device)
            for sh, kh in DECONV_TAPS[py]:
                for sw, kw in DECONV_TAPS[px]:
                    acc = acc + xp[:, sh:sh + h, sw:sw + wd, :] @ w32[kh, kw]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=3))          # [B,H,W,2(px),Co]
    y = torch.stack(rows, dim=2).reshape(b, 2 * h, 2 * wd, co)
    return apply_act(y * scale.float() + shift.float(), act).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.library("deconv5x5_s2")
    fn = lib.t2i_deconv5x5_s2
    # x, w, scale, shift, y; B, H, W, Cin, Co, act, bf16; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, w, scale, shift, act):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (5, 5, cin):
        raise ValueError(f"w must be [5,5,{cin},Co], got {tuple(w.shape)}")
    co = w.shape[-1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype in {_DTYPES}, got "
                        f"{x.dtype} and {w.dtype}")
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"{name} must be float32 [{co}], got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, t in (("x", x), ("w", w), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")
    if x.numel() * 4 * co // cin >= 2**31 or w.numel() >= 2**31:
        raise ValueError("tensor too large for the kernel's int32 extents")


def deconv5x5_s2(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Fused ``act(conv_transpose(x, w, s=2, SAME)·scale + shift)``.

    x [B,H,W,Cin] and w [5,5,Cin,Co] share a dtype (bf16 or f32); scale and
    shift are f32 [Co]: (1, bias) for the plain up-block, the folded BN
    (a, (b − μ)·a + β) for inference.  Any Co, including 3.  Returns
    [B,2H,2W,Co] in x's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return deconv5x5_s2_plain(x, w, scale, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"deconv5x5_s2 runs on cuda or cpu, not {x.device}")
    _check(x, w, scale, shift, act)
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    y = torch.empty(b, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    rc = _lib().t2i_deconv5x5_s2(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        y.data_ptr(), b, h, wd, cin, co, ACT_CODES[act],
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"deconv5x5_s2 kernel launch failed: CUDA error {rc}")
    deconv5x5_s2.launches += 1
    return y


deconv5x5_s2.launches = 0
