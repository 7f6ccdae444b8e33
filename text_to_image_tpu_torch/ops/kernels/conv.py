"""``deconv5x5_s2`` and ``conv5x5_s2_act``: the generator's up-block and the
discriminator's down-block convolutions (counterpart of
``text_to_image_tpu/ops/pallas/conv.py``).

``deconv5x5_s2``: ``y = act(conv_transpose_5x5_s2_SAME(x, w)·scale +
shift)`` over NHWC x and HWIO w, with ``lax.conv_transpose`` semantics (no
kernel flip).  Replaces `deconv5x5_s2` (Pallas bodies `_deconv_kernel_vpad`
and its HBM-staged twin `_deconv_kernel`).  CUDA kernel:
``csrc/deconv5x5_s2.cu``.

``conv5x5_s2_act``: ``y = act(conv_5x5_s2_SAME(x, w) + b)``, TF SAME
padding (an even map pads 1 before and 2 after).  Replaces
`conv5x5_s2_act` (Pallas bodies `_conv_kernel_vpad` and its HBM-staged twin
`_conv_kernel`).  CUDA kernel: ``csrc/conv5x5_s2.cu``.

On CUDA each wrapper launches its hand-written kernel (each source note
gives the bound on the H100 and the design).  On the CPU it runs the plain
version, which is built from the same taps as the kernel and is what the
kernel is held against.  Both are differentiable (`torch.autograd.Function`):
the backwards are the JAX package's (`_deconv_bwd`, `_conv_bwd`) — the
activation derivative from the saved output, then the conv's two adjoints,
which the JAX package leaves to XLA and the port to cuDNN / the CPU conv.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.ops.kernels.fused import (ACT_CODES,
                                                       act_grad_from_output,
                                                       apply_act, needs_grad)

# parity → [(padded slice start, kernel tap index)] with x padded (1, 2)
# per spatial dim (conv.py _DECONV_TAPS):
# O[2m] = X[m-1]·W1 + X[m]·W3; O[2m+1] = X[m-1]·W0 + X[m]·W2 + X[m+1]·W4
DECONV_TAPS = {0: ((0, 1), (1, 3)), 1: ((0, 0), (1, 2), (2, 4))}

_DTYPES = (torch.bfloat16, torch.float32)


def same_pads(n: int):
    """TF SAME for a 5-tap stride-2 conv over n pixels: (out, before,
    after).  Even n pads (1, 2), odd n (2, 2)."""
    out = (n + 1) // 2
    total = max((out - 1) * 2 + 5 - n, 0)
    return out, total // 2, total - total // 2


def _check_common(x, w, vecs, act):
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (5, 5, cin):
        raise ValueError(f"w must be [5,5,{cin},Co], got {tuple(w.shape)}")
    co = w.shape[-1]
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share a dtype in {_DTYPES}, got "
                        f"{x.dtype} and {w.dtype}")
    for name, v in vecs:
        if v.dtype != torch.float32 or tuple(v.shape) != (co,):
            raise ValueError(f"{name} must be float32 [{co}], got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, t in (("x", x), ("w", w), *vecs):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")
    if x.numel() * 4 * co // cin >= 2**31 or w.numel() >= 2**31:
        raise ValueError("tensor too large for the kernel's int32 extents")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


# ============================ deconv 5x5 s2 ==================================

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


def _deconv_lib() -> ctypes.CDLL:
    lib = _build.library("deconv5x5_s2")
    fn = lib.t2i_deconv5x5_s2
    # x, w, scale, shift, y; B, H, W, Cin, Co, act, bf16; stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(x, w, scale, shift, act):
    _check_common(x, w, (("scale", scale), ("shift", shift)), act)


def _deconv_forward(x, w, scale, shift, act):
    if x.device.type == "cpu":
        return deconv5x5_s2_plain(x, w, scale, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"deconv5x5_s2 runs on cuda or cpu, not {x.device}")
    _check(x, w, scale, shift, act)
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    y = torch.empty(b, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    rc = _deconv_lib().t2i_deconv5x5_s2(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        y.data_ptr(), b, h, wd, cin, co, ACT_CODES[act],
        int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"deconv5x5_s2 kernel launch failed: CUDA error {rc}")
    deconv5x5_s2.launches += 1
    return y


def _deconv_as_conv_weight(w):
    """The transposed conv is the adjoint of a stride-2 SAME conv over its
    output, whose OIHW weight is w flipped with in/out swapped:
    Wc[ci, co, kh, kw] = w[4−kh, 4−kw, ci, co]."""
    return w.flip(0, 1).permute(2, 3, 0, 1)


class _Deconv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, act):
        y = _deconv_forward(x, w, scale, shift, act)
        ctx.act = act
        ctx.save_for_backward(x, w, scale, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _deconv_bwd: the epilogue's derivative from the saved output, then
        # the two adjoints of the (linear) transposed conv
        x, w, scale, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        g32 = g.float() * act_grad_from_output(ctx.act, y)
        d = _nchw((g32 * scale).to(x.dtype))
        d_pad = F.pad(d, (1, 2, 1, 2))          # SAME pads of the 2H map
        wc = _deconv_as_conv_weight(w)
        dx = _nhwc(F.conv2d(d_pad, wc, stride=2)) if need[0] else None
        dw = None
        if need[1]:
            dwc = conv2d_weight(d_pad, wc.shape, _nchw(x), stride=2)
            dw = dwc.permute(2, 3, 0, 1).flip(0, 1)
        ds = None
        if need[2]:
            ones = torch.ones_like(scale)
            raw = _deconv_forward(x, w, ones, torch.zeros_like(scale), "none")
            ds = (g32 * raw.float()).sum((0, 1, 2))
        dt = g32.sum((0, 1, 2)) if need[3] else None
        return dx, dw, ds, dt, None


def deconv5x5_s2(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Fused ``act(conv_transpose(x, w, s=2, SAME)·scale + shift)``.

    x [B,H,W,Cin] and w [5,5,Cin,Co] share a dtype (bf16 or f32); scale and
    shift are f32 [Co]: (1, bias) for the plain up-block, the folded BN
    (a, (b − μ)·a + β) for inference.  Any Co, including 3.  Returns
    [B,2H,2W,Co] in x's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  Differentiable in every tensor
    argument."""
    if needs_grad(x, w, scale, shift):
        return _Deconv.apply(x, w, scale, shift, act)
    return _deconv_forward(x, w, scale, shift, act)


deconv5x5_s2.launches = 0


# ============================ conv 5x5 s2 + act ===============================

def conv5x5_s2_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         act: str = "lrelu") -> torch.Tensor:
    """The plain PyTorch version: 25 tap matmuls over the SAME-padded input,
    each reading every second pixel, accumulated in f32."""
    bsz, h, wd, _ = x.shape
    ho, pt, pb = same_pads(h)
    wo, pl, pr = same_pads(wd)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    w32 = w.float()
    acc = torch.zeros(bsz, ho, wo, w.shape[-1], device=x.device)
    for kh in range(5):
        for kw in range(5):
            tap = xp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2, :]
            acc = acc + tap @ w32[kh, kw]
    return apply_act(acc + b.float(), act).to(x.dtype)


def _conv_lib() -> ctypes.CDLL:
    lib = _build.library("conv5x5_s2")
    fn = lib.t2i_conv5x5_s2
    # x, w, b, y; B, H, W, Cin, Co, act, bf16; stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _conv_check(x, w, b, act):
    _check_common(x, w, (("b", b),), act)


def _conv_forward(x, w, b, act):
    if x.device.type == "cpu":
        return conv5x5_s2_act_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv5x5_s2_act runs on cuda or cpu, not {x.device}")
    _conv_check(x, w, b, act)
    bsz, h, wd, cin = x.shape
    co = w.shape[-1]
    y = torch.empty(bsz, same_pads(h)[0], same_pads(wd)[0], co, dtype=x.dtype,
                    device=x.device)
    rc = _conv_lib().t2i_conv5x5_s2(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd,
        cin, co, ACT_CODES[act], int(x.dtype == torch.bfloat16), _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv5x5_s2 kernel launch failed: CUDA error {rc}")
    conv5x5_s2_act.launches += 1
    return y


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, act):
        y = _conv_forward(x, w, b, act)
        ctx.act = act
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _conv_bwd: the VJP of act(conv(x, w) + b), the activation's
        # derivative taken from the saved output
        x, w, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        _, h, wd, _ = x.shape
        _, pt, pb = same_pads(h)
        _, pl, pr = same_pads(wd)
        ga = g.float() * act_grad_from_output(ctx.act, y)
        gc = _nchw(ga.to(x.dtype))
        w_oihw = w.permute(3, 2, 0, 1)
        dx = dw = None
        if need[0]:
            shape = (x.shape[0], x.shape[-1], h + pt + pb, wd + pl + pr)
            dxp = conv2d_input(shape, w_oihw, gc, stride=2)
            dx = _nhwc(dxp[:, :, pt:pt + h, pl:pl + wd])
        if need[1]:
            xp = F.pad(_nchw(x), (pl, pr, pt, pb))
            dw = conv2d_weight(xp, w_oihw.shape, gc, stride=2).permute(2, 3, 1, 0)
        db = ga.sum((0, 1, 2)) if need[2] else None
        return dx, dw, db, None


def conv5x5_s2_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   act: str = "lrelu") -> torch.Tensor:
    """Fused ``act(conv(x, w, s=2, SAME) + b)``: the discriminator
    down-block.

    x [B,H,W,Cin] and w [5,5,Cin,Co] share a dtype (bf16 or f32); b is f32
    [Co].  Any H, W (TF SAME: out = ceil(H/2)), any Cin and Co.  Returns
    [B,⌈H/2⌉,⌈W/2⌉,Co] in x's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise.  Differentiable in x, w, b."""
    if needs_grad(x, w, b):
        return _Conv.apply(x, w, b, act)
    return _conv_forward(x, w, b, act)


conv5x5_s2_act.launches = 0
