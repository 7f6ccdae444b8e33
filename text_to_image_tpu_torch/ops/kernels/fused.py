"""``bn_act`` and ``conditioning_join``: the fused epilogue and text-join
kernels (counterpart of ``text_to_image_tpu/ops/pallas/fused.py``).

``bn_act(x, a, b, act) = act(x·a + b)``: x is NHWC (any rows × C), a and b
are per-channel f32 (BN folded as a = γ·rsqrt(σ²+ε), b = β − μ·a).
Replaces `bn_act` (Pallas body `_bn_act_kernel` via `_bn_act_core`).
Bound on the H100: one read and one write of each element and no
tensor-core work, so it is bound by bytes (at B=64 bf16 the generator's four
calls move 4.2 + 8.4 + 16.8 + 33.6 MB, about 19 µs at 3.35 TB/s).  Design:
a Triton kernel over 2-D blocks (rows × up to 128 channels) with masked
loads and stores: a and b are read once per block, x once, y written once,
in f32 arithmetic.  It takes any row count and any C (the TPU's
``rows % 256`` and ``C % 128`` gates do not apply).  ``triton`` is imported
only when the kernel is first launched.

``conditioning_join(x, t, wx, wt, bias, act) = act(x·wx + t·wt + bias)``:
the discriminator's ``conv1x1(concat(x, tile(t)))`` without the concat.
Replaces `conditioning_join` (Pallas body `_join_kernel` via `_join_core`);
the CUDA kernel and its bound are in ``csrc/conditioning_join.cu``: one
launch that folds the text term into the GEMM's K, rows ``[x ; t]`` against
``[wx ; wt]`` (`join_path`: the convolution's wgmma main loop with two taps
for aligned bf16, a simple f32-FMA tile otherwise).

Both are differentiable (`torch.autograd.Function`).  Their backwards are
the JAX package's `_bn_act_bwd` and `_join_bwd` in plain torch: the
activation derivative is recovered from the saved output, so no
pre-activation tensor is kept.
"""

from __future__ import annotations

import ctypes

import torch

from text_to_image_tpu_torch.ops.kernels import _build

ACT_CODES = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}
_DTYPES = (torch.bfloat16, torch.float32)


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


def act_grad_from_output(act: str, y: torch.Tensor) -> torch.Tensor:
    """d act(p)/dp from y = act(p), in f32 (`_act_grad_from_output`): valid
    because every activation here is monotone with sign(y) = sign(p)."""
    y32 = y.float()
    if act == "none":
        return torch.ones_like(y32)
    if act == "relu":
        return (y32 > 0).float()
    if act == "lrelu":
        return torch.where(y32 >= 0, 1.0, 0.2)
    if act == "tanh":
        return 1.0 - y32 * y32
    raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")


def needs_grad(*ts: torch.Tensor) -> bool:
    """True when autograd must record this call."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# =============================== bn_act ======================================

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
    if x.dtype not in _DTYPES:
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


def _bn_act_forward(x, a, b, act):
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


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, act):
        y = _bn_act_forward(x, a, b, act)
        ctx.act = act
        ctx.save_for_backward(x, a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _bn_act_bwd: dx = g·act'·a, da = Σ g·act'·x, db = Σ g·act'
        x, a, y = ctx.saved_tensors
        ga = g.float() * act_grad_from_output(ctx.act, y)
        rows = tuple(range(x.dim() - 1))
        dx = (ga * a).to(x.dtype)
        da = (ga * x.float()).sum(rows) if ctx.needs_input_grad[1] else None
        db = ga.sum(rows) if ctx.needs_input_grad[2] else None
        return dx, da, db, None


def bn_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           act: str = "relu") -> torch.Tensor:
    """``act(x·a + b)`` over channels-last x with per-channel f32 a, b:
    one read and one write of x.  CPU tensors take the plain version; CUDA
    tensors launch the Triton kernel or raise.  Differentiable in x, a, b."""
    if needs_grad(x, a, b):
        return _BnAct.apply(x, a, b, act)
    return _bn_act_forward(x, a, b, act)


bn_act.launches = 0


# ========================== conditioning join ================================

def conditioning_join_plain(x: torch.Tensor, t: torch.Tensor,
                            wx: torch.Tensor, wt: torch.Tensor,
                            bias: torch.Tensor, act: str = "none"
                            ) -> torch.Tensor:
    """The plain PyTorch version: the image GEMM plus the per-example text
    row ``t·wt + bias``, in f32, cast back to x's dtype."""
    u = t.float() @ wt.float() + bias.float()                   # [B, Co]
    y = x.float() @ wx.float() + u[:, None, None, :]
    return apply_act(y, act).to(x.dtype)


def _join_lib() -> ctypes.CDLL:
    ptr, integer = ctypes.c_void_p, ctypes.c_int
    return _build.bind("conditioning_join", {
        # x, t, wx, wt, bias, y; B, HW, Cx, E, Co, act, bf16; stream
        "t2i_conditioning_join": [ptr] * 6 + [integer] * 7 + [ptr],
        # x, t, wx, wt, y; Cx, E, Co, bf16
        "t2i_conditioning_join_path": [ptr] * 5 + [integer] * 4})


# The kernel's code paths in the order of the C entry point's codes
# (csrc/conditioning_join.cu `Path`); both make one launch.
JOIN_PATHS = ("simple", "wgmma")


def join_path(cx: int, e: int, co: int, dtype: torch.dtype,
              aligned: bool = True) -> str:
    """The Python mirror of `join_path` in csrc/conditioning_join.cu."""
    ok = (dtype == torch.bfloat16 and aligned and cx > 0 and e > 0
          and cx % 64 == 0 and e % 64 == 0 and co % 64 == 0)
    return "wgmma" if ok else "simple"


def join_path_on_card(x, t, wx, wt, y) -> str:
    """The path the C entry point itself reports for these tensors."""
    return JOIN_PATHS[_join_lib().t2i_conditioning_join_path(
        x.data_ptr(), t.data_ptr(), wx.data_ptr(), wt.data_ptr(),
        y.data_ptr(), x.shape[-1], t.shape[-1], wx.shape[-1],
        int(x.dtype == torch.bfloat16))]


def _join_check(x, t, wx, wt, bias, act):
    if x.dim() != 4 or t.dim() != 2 or t.shape[0] != x.shape[0]:
        raise ValueError(f"x must be [B,H,W,Cx] and t [B,E], got "
                         f"{tuple(x.shape)} and {tuple(t.shape)}")
    cx, e = x.shape[-1], t.shape[-1]
    if wx.dim() != 2 or wx.shape[0] != cx:
        raise ValueError(f"wx must be [{cx},Co], got {tuple(wx.shape)}")
    co = wx.shape[1]
    if tuple(wt.shape) != (e, co):
        raise ValueError(f"wt must be [{e},{co}], got {tuple(wt.shape)}")
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (t, wx, wt)):
        raise TypeError(f"x, t, wx, wt must share a dtype in {_DTYPES}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be float32 [{co}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    for name, v in (("x", x), ("t", t), ("wx", wx), ("wt", wt),
                    ("bias", bias)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")
    if x.numel() // cx * max(cx, co) >= 2**31:
        raise ValueError("tensor too large for the kernel's int32 extents")


def _join_forward(x, t, wx, wt, bias, act):
    if x.device.type == "cpu":
        return conditioning_join_plain(x, t, wx, wt, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"conditioning_join runs on cuda or cpu, not {x.device}")
    _join_check(x, t, wx, wt, bias, act)
    b, h, w, cx = x.shape
    e, co = wt.shape
    y = torch.empty(b, h, w, co, dtype=x.dtype, device=x.device)
    rc = _join_lib().t2i_conditioning_join(
        x.data_ptr(), t.data_ptr(), wx.data_ptr(), wt.data_ptr(),
        bias.data_ptr(), y.data_ptr(), b, h * w, cx, e, co,
        ACT_CODES[act], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conditioning_join kernel launch failed: CUDA "
                           f"error {rc}")
    conditioning_join.launches += 1
    return y


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, wx, wt, bias, act):
        y = _join_forward(x, t, wx, wt, bias, act)
        ctx.act = act
        ctx.save_for_backward(x, t, wx, wt, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _join_bwd: the image GEMM's two adjoints, the text row's through
        # the spatial sum of the gradient
        x, t, wx, wt, y = ctx.saved_tensors
        ga = g.float() * act_grad_from_output(ctx.act, y)       # [B,H,W,Co]
        ga_c = ga.to(x.dtype)
        ga_sum = ga.sum((1, 2))                                  # [B, Co]
        need = ctx.needs_input_grad
        dx = ga_c @ wx.t() if need[0] else None
        dt = ga_sum.to(t.dtype) @ wt.t() if need[1] else None
        dwx = (x.reshape(-1, x.shape[-1]).t()
               @ ga_c.reshape(-1, ga_c.shape[-1])) if need[2] else None
        dwt = t.t() @ ga_sum.to(t.dtype) if need[3] else None
        db = ga.sum((0, 1, 2)) if need[4] else None
        return dx, dt, dwx, dwt, db, None


def conditioning_join(x: torch.Tensor, t: torch.Tensor, wx: torch.Tensor,
                      wt: torch.Tensor, bias: torch.Tensor, act: str = "none"
                      ) -> torch.Tensor:
    """Fused ``act(conv1x1(concat(x, tile(t))))`` = ``act(x·wx + t·wt +
    bias)``.

    x [B,H,W,Cx], t [B,E], wx [Cx,Co], wt [E,Co] share a dtype (bf16 or
    f32); bias is f32 [Co].  (wx; wt) is the split of the 1×1 conv kernel
    over the [image; text] channel axis.  Returns [B,H,W,Co] in x's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Differentiable in every tensor argument."""
    if needs_grad(x, t, wx, wt, bias):
        return _Join.apply(x, t, wx, wt, bias, act)
    return _join_forward(x, t, wx, wt, bias, act)


conditioning_join.launches = 0
