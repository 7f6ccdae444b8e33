"""``deconv5x5_s2``, ``conv5x5_s2_act`` and ``upconv3x3``: the generators'
up-blocks and the discriminator's down-block convolutions (counterpart of
``text_to_image_tpu/ops/pallas/conv.py``).

``deconv5x5_s2``: ``y = act(conv_transpose_5x5_s2_SAME(x, w)·scale +
shift)`` over NHWC x and HWIO w, with ``lax.conv_transpose`` semantics (no
kernel flip).  Replaces `deconv5x5_s2` (Pallas bodies `_deconv_kernel_vpad`
and its HBM-staged twin `_deconv_kernel`).  CUDA kernel:
``csrc/deconv5x5_s2.cu``, five code paths (`deconv_path` mirrors the rule):
``wgmma`` for bf16 with Cin and Co multiples of 64 (the three deep
generator layers: the four output parities as one grouped GEMM, whose tile
and per-parity split of K `deconv_plan` picks), ``thin`` for bf16 with Co ≤
4 and Cin a multiple of 16 (the RGB layer, the conv's first-layer dx: one
m64n16k16 GEMM of each pixel's 3×3 neighbourhood from one staged patch,
`thin_plan`), ``direct`` for Co ≤ 4 otherwise, ``pipelined`` / ``tile``
(mma.sync / f32 FMA) otherwise.

``conv5x5_s2_act``: ``y = act(conv_5x5_s2_SAME(x, w) + b)``, TF SAME
padding (an even map pads 1 before and 2 after).  Replaces
`conv5x5_s2_act` (Pallas bodies `_conv_kernel_vpad` and its HBM-staged twin
`_conv_kernel`).  CUDA kernel: ``csrc/conv5x5_s2.cu``, five code paths
chosen from shapes, types and alignment (`conv_path` mirrors the rule):
``wgmma`` for bf16 with Cin and Co multiples of 64 (every deep
discriminator call; `conv_plan` picks its tile and, for calls with few
output tiles, a split of K over whole taps that is reduced in a fixed
order), ``down0_mma`` for the RGB layer (bf16, Cin ≤ 4, Co = 64) on the
tensor cores, ``pipelined`` / ``tile`` (mma.sync / f32 FMA) for other
channel counts and f32, ``direct`` for Cin ≤ 4 otherwise.

``upconv3x3`` / ``upconv3x3_bias``: ``y = act(conv_3x3_SAME(
upsample2_nearest(x), w)·scale + shift)``, the StackGAN / PGGAN up-block,
as four output parities of 2×2 combined taps over x: the upsampled map never
exists.  Replaces `upconv3x3` / `upconv3x3_bias` (Pallas bodies
`_upconv_kernel` and, for maps over 32×32, `_upconv_halo_kernel`).  CUDA
kernel: ``csrc/upconv3x3.cu``; a CUDA tensor always goes through it, in
sampling and in training (the JAX package's per-shape dispatch tables are
TPU measurements and are not carried over).  Four code paths
(`upconv_path` mirrors the rule): ``wgmma`` for bf16 with Cin and Co
multiples of 64 (all eight StackGAN calls; `upconv_plan` picks the tile,
the split of K, or the resident kernel for K of at most 8 slices),
``co32`` for bf16 with Cin 64 and Co a multiple of 32 but not of 64 on maps
of 128-pixel row segments (C-PGGAN 256 px's 128²×64→32 call: the 16
products of a row of a segment from staged rows of x by shifted descriptor
starts, the weights resident, whole output rows by TMA), ``pipelined`` /
``tile`` otherwise.  The combined weights come from one
kernel launch (`combined_weights`).  Its backward is two hand-written
kernels of ``csrc/upconv3x3_bwd.cu`` over the same combined taps
(`upconv3x3_dx`: one GEMM over 16 taps of the cotangent, A by TMA from
its parity planes, on the 128² maps dxᵀ with the four taps of a plane
from one staged patch, elsewhere the parts of K summed in a cluster:
`dx_path` / `dx_plan`; `upconv3x3_dw`: 16 long-K products split over pixels and folded into the
3×3 taps in a fixed order, on chip at the 4² maps and Co 32, `dw_path` /
`dw_plan`), in place of the JAX package's `_parity_dx` / `_parity_dw`.

``conv5x5_s2_dw``: the weight gradient of the stride-2 5×5 conv, 25
long-K products over every output pixel split into parts that a
thread-block cluster sums on chip and writes into dw, in the conv's
layout or, for the transposed conv, in its own (``csrc/conv5x5_s2_bwd.cu``,
`conv_dw_path` / `conv_dw_plan`): the weight half of the JAX package's
`_conv_bwd` and, with its operands swapped, of `_deconv_bwd`.
``conv5x5_s2_dx``: the conv's input gradient, the other half of
`_conv_bwd` (same source; `conv_dx_path` / `conv_dx_plan`): four parity
GEMMs of 9, 6, 6 and 4 taps, A a TMA box of the cotangent a tap, w read
K-major as it lies (no flipped copy), the parts of K of a tile summed in a
cluster, dx written in place by parity (no crop), on the ring loop it
shares with upconv3x3_dx; at Cin 64 on the 128² maps every tap of a parity
from one staged patch.  It takes bf16 with Cin and Co multiples of 64; the
conv's other dx (the RGB layer's Cin 3, f32) is ``deconv5x5_s2`` of the
cotangent with w flipped and transposed (`conv_dx` picks by shape).
``deconv5x5_s2_dx``: the deconv's input gradient, the other half of
`_deconv_bwd` (same source; `deconv_dx_path` / `deconv_dx_plan`): for bf16
with Cin and Co multiples of 64 one GEMM of 25 taps on the same ring loop,
A a TMA box of the cotangent's parity plane a tap, w read K-major as it
lies (no flipped copy, no zero bias), the parts of K of a tile summed in a
cluster; for Co <= 4 (the RGB layer, the gradient penalty's critic first
layer) the thin-input conv of ``csrc/down0.cuh`` with the flip in the index
of its weight staging; f32 and ragged channels ``conv5x5_s2_act`` of the
cotangent with that weight (`deconv_dx` picks by shape).  A
weight-gradient plan that needs more parts than a cluster holds (or the
up-block's per-product blocks) takes a workspace, walked in chunks of Cin
so that it stays under CONV_WS_CAP at any Cin·Co (`wgrad_chunk`).

On CUDA each wrapper launches its hand-written kernel (each source note
gives the bound on the H100 and the design).  On the CPU it runs the plain
version, which is built from the same taps as the kernel and is what the
kernel is held against.  All are differentiable (`torch.autograd.Function`):
the backwards are the JAX package's (`_deconv_bwd`, `_conv_bwd`,
`_upconv_bwd`, `_upconv_bias_bwd`) — the activation derivative from the
saved output, then the conv's two adjoints, which the JAX package leaves to
XLA and the port computes on the kernels above, no library convolution
among them (tanh's up-block backward, on no training path, differentiates
the composed version again).  The conv's dx goes through the differentiable
conv5x5_s2_dx (whose own backward is the conv and conv5x5_s2_dw) or deconv,
and the deconv's through the differentiable deconv5x5_s2_dx (whose own
backward is the deconv and conv5x5_s2_dw) or the conv, so a gradient of a
gradient (the WGAN-CLS gradient penalty) runs on the same kernels.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.ops.kernels.fused import (ACT_CODES, acc,
                                                       act_grad_from_output,
                                                       apply_act, needs_grad)
from text_to_image_tpu_torch.utils import profiling

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


def _check_common(x, w, vecs, act, k=5, rows=None):
    """The checks every wrapper makes before it launches.  `rows` is the
    GEMM's row count where that is the kernel's only 32-bit extent (the conv
    and the upconv compute their tensor offsets in 64 bits; the 256 px D
    reads 192×256²×3 inputs); None holds the output to 2^31 elements."""
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC, got shape {tuple(x.shape)}")
    cin = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (k, k, cin):
        raise ValueError(f"w must be [{k},{k},{cin},Co], got {tuple(w.shape)}")
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
    extent = x.numel() * 4 * co // cin if rows is None else rows + 2**16
    if extent >= 2**31 or w.numel() >= 2**31:
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


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _deconv_lib() -> ctypes.CDLL:
    return _build.bind("deconv5x5_s2", {
        # x, w, scale, shift, y, ws; B, H, W, Cin, Co, act, bf16, tile,
        # parts of parities 0-3; stream
        "t2i_deconv5x5_s2": [_PTR] * 6 + [_INT] * 12 + [_PTR],
        # x, w, y; Cin, Co, bf16
        "t2i_deconv5x5_s2_path": [_PTR] * 3 + [_INT] * 3})


# The kernel's code paths in the order of the C entry point's codes
# (csrc/deconv5x5_s2.cu `Path`), chosen from shapes, types and alignment.
DECONV_PATHS = ("tile", "pipelined", "direct", "wgmma", "thin")
_DIRECT_MAX_CIN = 200 * 1024 // (25 * 16)     # its weights in shared memory


def deconv_path(cin: int, co: int, dtype: torch.dtype,
                aligned: bool = True) -> str:
    """The Python mirror of `deconv_path` in csrc/deconv5x5_s2.cu.
    `aligned`: x, w and y start on 16-byte boundaries.  Co <= 4 with Cin
    up to 512 (the RGB layer, the conv's first-layer dx): `thin` (wgmma)
    for bf16 with Cin a multiple of 16, else the `direct` FMA kernel."""
    bf16 = dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    if co <= 4 and cin <= _DIRECT_MAX_CIN:
        return "thin" if bf16 and aligned and cin % 16 == 0 else "direct"
    if bf16 and cin % 64 == 0 and co % 64 == 0 and aligned:
        return "wgmma"
    return ("pipelined" if bf16 and aligned and cin % vec == 0
            and co % vec == 0 else "tile")


def _check(x, w, scale, shift, act):
    _check_common(x, w, (("scale", scale), ("shift", shift)), act)


class ThinPlan(NamedTuple):
    """The thin path's tiling (csrc/deconv5x5_s2.cu `thin::plan`): TR
    image rows of TW pixels a tile, its patch rows of PW = TW + 2 pixels
    (a one-pixel halo), NB m64 blocks of GEMM rows (the patch's pixels
    from PW + 1 on), the K slice and the patches in flight (half of them
    each of the two warpgroups', which take alternate tiles)."""
    tw: int
    pw: int
    nb: int
    tr: int
    bk: int
    stages: int


_THIN_SMEM_CAP = 227 * 1024
_THIN_MAX_STAGES = 8


def thin_plan(h: int, w: int, cin: int, co: int) -> ThinPlan:
    """The Python mirror of `thin::plan`: of NB 8, 4 and 2 m64 blocks (TR
    the most rows whose patch NB·64 rows cover, at most H), the one that
    computes the fewest rows over the map (ties to the larger NB) whose
    weights, two warpgroups' staged outputs and a patch for each fit the
    SM."""
    bk = 64 if cin % 64 == 0 else 32 if cin % 32 == 0 else 16
    tw = min(w, 64)
    pw = tw + 2
    w_bytes = 9 * cin * 16 * 2
    best = None
    for nb in (8, 4, 2):
        tr = min((64 * nb + 2) // pw, h)
        if tr < 1:
            continue
        rows = -(-max((tr + 2) * pw, 2 * pw + 2 + 64 * nb) // 8) * 8
        patch = -(-rows * 2 * bk // 1024) * 1024
        # two warpgroups' staged outputs; a ring of stages each
        fixed = (1024 + -(-w_bytes // 1024) * 1024
                 + 2 * (2 * tr * 2 * tw * co * 2))
        stages = min((_THIN_SMEM_CAP - fixed) // patch,
                     _THIN_MAX_STAGES) // 2 * 2
        if stages < 2:
            continue
        cost = -(-h // tr) * nb
        if best is None or cost < best[0]:
            best = (cost, ThinPlan(tw, pw, nb, tr, bk, stages))
    if best is None:
        raise ValueError(f"thin path: no tile fits for {h}x{w}x{cin}->{co}")
    return best[1]


def _grouped_launch_args(x, plan, rows, co):
    """(tile index, parts, workspace) of a grouped wgmma launch."""
    tile = RESIDENT_TILE if plan.resident else CONV_TILES.index(
        (plan.tile_m, plan.tile_n))
    elems = grouped_ws_elems(rows, co, plan.parts)
    if elems * 4 > CONV_WS_CAP:
        raise ValueError(f"split-K workspace {elems} f32 over {CONV_WS_CAP} "
                         f"bytes")
    ws = (torch.empty(elems, dtype=torch.float32, device=x.device)
          if elems else None)
    return tile, plan.parts, ws


@profiling.spanned("kernels.deconv5x5_s2")
def _deconv_forward(x, w, scale, shift, act, plan=None):
    """`plan` forces a `GroupedPlan` on the wgmma path (the sweep and the
    smoke run hold every plan with it); None asks `deconv_plan`."""
    if x.device.type == "cpu":
        return deconv5x5_s2_plain(x, w, scale, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"deconv5x5_s2 runs on cuda or cpu, not {x.device}")
    _check(x, w, scale, shift, act)
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    y = torch.empty(b, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    tile, parts, ws = 0, (1, 1, 1, 1), None
    if deconv_path(cin, co, x.dtype, _aligned16(x, w, y)) == "wgmma":
        rows = b * h * wd
        tile, parts, ws = _grouped_launch_args(
            x, plan or deconv_plan(rows, co, cin), rows, co)
    rc = _deconv_lib().t2i_deconv5x5_s2(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, b, h, wd,
        cin, co, ACT_CODES[act], int(x.dtype == torch.bfloat16), tile,
        *parts, _stream(x))
    if rc != 0:
        raise RuntimeError(f"deconv5x5_s2 kernel launch failed: CUDA error {rc}")
    deconv5x5_s2.launches += 1
    return y


def deconv_path_on_card(x, w, y) -> str:
    """The path the C entry point itself reports for these tensors."""
    return DECONV_PATHS[_deconv_lib().t2i_deconv5x5_s2_path(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[-1], w.shape[-1],
        int(x.dtype == torch.bfloat16))]


def deconv_dx_weight(w: torch.Tensor) -> torch.Tensor:
    """The transposed conv is the adjoint of a stride-2 SAME conv over its
    output: its dx is conv5x5_s2 of the cotangent with the HWIO weight
    Wc[kh, kw, co, ci] = w[4−kh, 4−kw, ci, co] (w flipped, in and out
    swapped).  The conv's dx is in turn the transposed conv with the same
    map of its own w."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv_dx(gc: torch.Tensor, w: torch.Tensor, h: int, wd: int) -> torch.Tensor:
    """dx [B,h,wd,Cin] of conv5x5_s2 SAME over an h×wd map for the
    cotangent gc [B,⌈h/2⌉,⌈wd/2⌉,Co] (in w's dtype), the route chosen by
    shape (`conv_dx_path`): `conv5x5_s2_dx` (bf16, Cin and Co multiples of
    64: every deep layer, odd maps too), else the transposed conv of gc
    with `deconv_dx_weight(w)`, scale 1 and shift 0, through the
    differentiable `deconv5x5_s2` (the first layers' Cin 3 on its thin or
    direct path; f32 and ragged channels), which writes 2·⌈h/2⌉ rows with
    the (1, 2) pads of an even map; an odd map pads (2, 2), one more
    before, so its dx is rows 1..h."""
    if conv_dx_path(w.shape[2], w.shape[3], gc.dtype,
                    _aligned16(gc, w)) == "wgmma":
        return conv5x5_s2_dx(gc, w, h, wd)
    ci = w.shape[2]
    dx = deconv5x5_s2(gc, deconv_dx_weight(w),
                      torch.ones(ci, device=gc.device),
                      torch.zeros(ci, device=gc.device))
    ot, ol = same_pads(h)[1] - 1, same_pads(wd)[1] - 1
    if (ot, ol) == (0, 0):
        return dx
    return dx[:, ot:ot + h, ol:ol + wd].contiguous()


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
        # the two adjoints of the (linear) transposed conv: dx its own
        # kernel over d (`deconv_dx`: w as it lies), dw the weight-gradient
        # kernel with d as its map and x as its cotangent, written flipped
        # back (no copy)
        x, w, scale, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        g32 = g.float() * act_grad_from_output(ctx.act, y)
        d = (g32 * scale).to(x.dtype).contiguous()
        dx = dw = None
        if need[0]:
            dx = deconv_dx(d, w)
        if need[1]:
            dw = conv5x5_s2_dw(d, x, w.dtype, True)      # flipped
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
    return _build.bind("conv5x5_s2", {
        # x, w, b, y, ws; B, H, W, Cin, Co, act, bf16, tile, split; stream
        "t2i_conv5x5_s2": [_PTR] * 5 + [_INT] * 9 + [_PTR],
        # x, w, y; Cin, Co, bf16
        "t2i_conv5x5_s2_path": [_PTR] * 3 + [_INT] * 3})


# The kernel's code paths in the order of the C entry point's codes
# (csrc/conv5x5_s2.cu `Path`), chosen from shapes, types and alignment only.
CONV_PATHS = ("tile", "pipelined", "direct", "wgmma", "down0_mma")


def conv_path(cin: int, co: int, dtype: torch.dtype,
              aligned: bool = True) -> str:
    """The Python mirror of `conv_path` in csrc/conv5x5_s2.cu.  `aligned`:
    x, w and y start on 16-byte boundaries (every torch allocation does)."""
    bf16 = dtype == torch.bfloat16
    vec = 8 if bf16 else 4
    vec_a, vec_o = aligned and cin % vec == 0, aligned and co % vec == 0
    if cin <= 4:
        return "down0_mma" if bf16 and co == 64 and vec_o else "direct"
    if bf16 and cin % 64 == 0 and co % 64 == 0 and aligned:
        return "wgmma"
    return "pipelined" if bf16 and vec_a and vec_o else "tile"


# wgmma tiles in the order of igemm90::TileId; the splits of K a plan may
# choose (whole taps each); the most a split-K workspace may hold
CONV_TILES = ((128, 128), (128, 64), (64, 128), (128, 256))
CONV_SPLITS = (1, 2, 3, 4, 5)
CONV_WS_CAP = 64 * 2**20
SM_COUNT = 132          # H100 SXM
# The plan's cost model, in units of one 128x128x64 slice on one SM
# (0.28 us at the bf16 peak).  Set from the sweep of
# text_to_image_tpu_torch/tools/conv_plan_sweep.py on the H100.
_PLAN_WAVE_OVERHEAD = 24.0     # ring fill and epilogue of one wave of blocks
# work per product relative to the 128x128 tile: the narrow tiles move more
# bytes per product through the copy units, the wide one fewer
_PLAN_TILE_COST = {(128, 128): 1.0, (128, 64): 1.3, (64, 128): 1.2,
                   (128, 256): 0.95}
_PLAN_UNIT_S = 0.28e-6
_PLAN_WS_BYTES_PER_S = 5e12    # workspace written and read again, in L2


@functools.lru_cache(maxsize=None)   # a training run repeats a few shapes
def conv_plan(m: int, n: int, k: int, taps: int = 25):
    """(tile_m, tile_n, split_k) of the wgmma path for a GEMM of m rows, n
    columns and depth k = taps·Cin: the cheapest, by a small cost model, of
    the plans that give at least one block per SM (or, where none does, of
    those with the most blocks).  The model: two blocks share an SM, so the
    work of all blocks is spread over the SMs and divided by the share of
    the 2·132 block slots they fill; the 256-wide tile runs one block per
    SM in whole waves; each wave adds a fixed cost and a split its reduce
    pass.  split_k parts of K are whole taps; their f32 partial sums
    [split, m, n] stay under CONV_WS_CAP."""
    slices = k // taps // 64
    cands = []
    for index, (tm, tn) in enumerate(CONV_TILES):
        if n % tn:
            continue
        tiles = -(-m // tm) * (n // tn)
        for split in CONV_SPLITS:
            if split > 1 and split * m * n * 4 > CONV_WS_CAP:
                continue
            blocks = tiles * split
            block_work = (-(-taps // split) * slices * tm * tn / 16384.0
                          * _PLAN_TILE_COST[tm, tn])
            if tn == 256:
                waves = -(-blocks // SM_COUNT)
                cost = waves * block_work
            else:
                waves = -(-blocks // (2 * SM_COUNT))
                cost = (blocks * block_work / SM_COUNT
                        / min(1.0, blocks / (2 * SM_COUNT)))
            cost += waves * _PLAN_WAVE_OVERHEAD
            if split > 1:
                cost += (split + 1) * m * n * 4 / (
                    _PLAN_WS_BYTES_PER_S * _PLAN_UNIT_S)
            # ties go to the earlier tile and the smaller split
            cands.append((min(blocks, SM_COUNT), -cost, -index, -split))
    if not cands:
        raise ValueError(f"no wgmma tile divides n = {n}")
    _, _, index, split = max(cands)
    return (*CONV_TILES[-index], -split)


# ---- grouped wgmma plans (deconv5x5_s2 and upconv3x3: four parity GEMMs)

# taps of each output parity (py, px): the transposed conv's (2+py)(2+px),
# the upsampling conv's 2x2 combined taps
DECONV_PARITY_TAPS = (4, 6, 6, 9)
UPCONV_PARITY_TAPS = (4, 4, 4, 4)
RESIDENT_TILE = 4              # igemm90::kResident128x64
RESIDENT_MAX_SLICES = 4        # its weights, at most 32 KB, stay resident


class GroupedPlan(NamedTuple):
    """A launch of the grouped wgmma GEMM: the tile, each group's number
    of parts of K (whole taps each), and whether it is the resident kernel
    (128x64 tiles, N = 64, no split, two blocks per SM)."""
    tile_m: int
    tile_n: int
    parts: Tuple[int, ...]
    resident: bool = False


# The grouped plan's cost model, in the units of `conv_plan` (one 128x128x64
# slice on one SM).  Fitted to the sweep of
# text_to_image_tpu_torch/tools/conv_plan_sweep.py on the H100 (11 deconv
# and upconv shapes; the chosen plans within 6 % of the fastest, 12 % in sum).
_GPLAN_BLOCK_OVERHEAD = 8.0    # ring fill and epilogue of one block
# work per product relative to the 128x128 tile (A by TMA where the map
# allows it, else by cp.async: see `a_by_tma`)
_GPLAN_TILE_COST = {(128, 128): 1.0, (128, 64): 1.1, (64, 128): 1.2,
                    (128, 256): 1.0}
_GPLAN_RES_SLICE = 0.2         # a 128x64x64 slice of the resident kernel
_GPLAN_RES_TILE = 0.5          # its epilogue of one 128x64 tile
_GPLAN_RES_FIXED = 4.0         # its start: the weights by TMA


def grouped_ws_elems(m: int, n: int, parts) -> int:
    """f32 elements of the split-K workspace: one [m, n] plane per part of
    every group split in more than one."""
    return sum(p for p in parts if p > 1) * m * n


def _parts_for_cap(taps, cap):
    return tuple(min(CONV_SPLITS[-1], -(-t // cap)) for t in taps)


def grouped_candidates(m: int, n: int, cin: int, taps):
    """Every plan `grouped_plan` chooses from: each tile that divides n
    with the parts that cap the taps of a part at 1, 2, ... (at most
    CONV_SPLITS[-1] parts, the workspace under CONV_WS_CAP), and the
    resident kernel where n = 64 and each group's K is at most
    RESIDENT_MAX_SLICES slices of 64 channels."""
    plans = []
    for tm, tn in CONV_TILES:
        if n % tn:
            continue
        for cap in range(max(taps), 0, -1):
            parts = _parts_for_cap(taps, cap)
            plan = GroupedPlan(tm, tn, parts)
            if (plan not in plans
                    and grouped_ws_elems(m, n, parts) * 4 <= CONV_WS_CAP):
                plans.append(plan)
    if n == 64 and max(taps) * (cin // 64) <= RESIDENT_MAX_SLICES:
        plans.append(GroupedPlan(128, 64, (1,) * len(taps), True))
    return plans


def _makespan(durations, slots):
    """Blocks handed out in order to the first free of `slots` block slots
    (the hardware's dispatch, as a list schedule)."""
    if len(set(durations)) == 1:
        return -(-len(durations) // slots) * durations[0]
    free = [0.0] * min(slots, len(durations))
    heapq.heapify(free)
    end = 0.0
    for d in durations:
        t = heapq.heappop(free) + d
        end = max(end, t)
        heapq.heappush(free, t)
    return end


def grouped_cost(m: int, n: int, cin: int, taps, plan: GroupedPlan) -> float:
    """The model's relative time of `plan` (it ranks plans; it is not a
    prediction), in units of one 128x128x64 slice on one SM.  The blocks,
    in the launch's order (part, then tile, then group), go to 2 slots per
    SM (1 for 128x256 tiles) at the tile's cost per product plus a fixed
    cost each; a split adds its reduce pass.  The resident kernel runs two
    blocks per SM, each over ceil(tiles / blocks) tiles of its group at a
    cost per slice and per tile."""
    slices = cin // 64
    groups = len(taps)
    if plan.resident:
        row_tiles = -(-m // 128)
        per_group = min(row_tiles, 2 * SM_COUNT // groups)
        walk = -(-row_tiles // per_group)
        return (walk * 2 * (max(taps) * slices * _GPLAN_RES_SLICE
                            + _GPLAN_RES_TILE)
                + _GPLAN_RES_FIXED)
    tm, tn = plan.tile_m, plan.tile_n
    slots = SM_COUNT if tn == 256 else 2 * SM_COUNT
    rate = _GPLAN_TILE_COST[tm, tn] * tm * tn / 16384.0 * slots / SM_COUNT
    tiles = -(-m // tm) * (n // tn)
    durations = []
    for z in range(max(plan.parts)):
        row = [((z + 1) * t // p - z * t // p) * slices * rate
               + _GPLAN_BLOCK_OVERHEAD
               for t, p in zip(taps, plan.parts) if z < p]
        durations += row * tiles
    cost = _makespan(durations, slots)
    planes = sum(p + 1 for p in plan.parts if p > 1)
    if planes:
        cost += planes * m * n * 4 / (_PLAN_WS_BYTES_PER_S * _PLAN_UNIT_S)
    return cost


def grouped_blocks(m: int, n: int, cin: int, taps, plan: GroupedPlan) -> int:
    """Blocks the launch runs (the resident kernel: its grid)."""
    if plan.resident:
        return min(-(-m // 128), 2 * SM_COUNT // len(taps)) * len(taps)
    return -(-m // plan.tile_m) * (n // plan.tile_n) * sum(plan.parts)


def a_by_tma(h: int, w: int, plan: GroupedPlan) -> bool:
    """Whether the grouped kernel brings A by TMA, one box a slice
    (csrc/igemm_sm90.cuh `image_boxes`), rather than gathering it row by row
    with cp.async: where a tile of rows is whole rows of the h×w input map
    or whole maps."""
    hw = h * w
    return plan.tile_m % w == 0 and (hw % plan.tile_m == 0
                                     or plan.tile_m % hw == 0)


@functools.lru_cache(maxsize=None)
def grouped_plan(m: int, n: int, cin: int, taps) -> GroupedPlan:
    """The cheapest `grouped_candidates` plan by `grouped_cost` among those
    that give at least one block per SM (where none does, among those with
    the most blocks) for groups of m rows, n columns and taps[g]·cin deep;
    ties go to the earlier candidate."""
    cands = grouped_candidates(m, n, cin, taps)
    if not cands:
        raise ValueError(f"no wgmma tile divides n = {n}")
    return max(cands, key=lambda p: (
        min(grouped_blocks(m, n, cin, taps, p), SM_COUNT),
        -grouped_cost(m, n, cin, taps, p), -cands.index(p)))


def deconv_plan(m: int, n: int, cin: int) -> GroupedPlan:
    """`grouped_plan` of the transposed conv: m = B·H·W rows per parity,
    n = Co, parities of 4, 6, 6 and 9 taps of cin channels."""
    return grouped_plan(m, n, cin, DECONV_PARITY_TAPS)


def upconv_plan(m: int, n: int, cin: int) -> GroupedPlan:
    """`grouped_plan` of the upsampling conv: m = B·H·W rows per parity,
    n = Co, four parities of 4 combined taps of cin channels."""
    return grouped_plan(m, n, cin, UPCONV_PARITY_TAPS)


def _conv_check(x, w, b, act):
    rows = x.shape[0] * same_pads(x.shape[1])[0] * same_pads(x.shape[2])[0] \
        if x.dim() == 4 else None
    _check_common(x, w, (("b", b),), act, rows=rows)


def _aligned16(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


@profiling.spanned("kernels.conv5x5_s2_act")
def _conv_forward(x, w, b, act, plan=None):
    """`plan` forces (tile_m, tile_n, split_k) on the wgmma path (the sweep
    and the smoke run hold every plan with it); None asks `conv_plan`."""
    if x.device.type == "cpu":
        return conv5x5_s2_act_plain(x, w, b, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv5x5_s2_act runs on cuda or cpu, not {x.device}")
    _conv_check(x, w, b, act)
    bsz, h, wd, cin = x.shape
    co = w.shape[-1]
    y = torch.empty(bsz, same_pads(h)[0], same_pads(wd)[0], co, dtype=x.dtype,
                    device=x.device)
    tile, split, ws = 0, 1, None
    if conv_path(cin, co, x.dtype, _aligned16(x, w, y)) == "wgmma":
        rows = y.numel() // co
        tm, tn, split = plan or conv_plan(rows, co, 25 * cin)
        tile = CONV_TILES.index((tm, tn))
        if split > 1:
            if split * rows * co * 4 > CONV_WS_CAP:
                raise ValueError(f"split-K workspace {split}x{rows}x{co} f32 "
                                 f"over {CONV_WS_CAP} bytes")
            ws = torch.empty(split * rows * co, dtype=torch.float32,
                             device=x.device)
    rc = _conv_lib().t2i_conv5x5_s2(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, bsz, h, wd, cin, co,
        ACT_CODES[act], int(x.dtype == torch.bfloat16), tile, split,
        _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv5x5_s2 kernel launch failed: CUDA error {rc}")
    conv5x5_s2_act.launches += 1
    return y


def conv_path_on_card(x, w, y) -> str:
    """The path the C entry point itself reports for these tensors."""
    return CONV_PATHS[_conv_lib().t2i_conv5x5_s2_path(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[-1], w.shape[-1],
        int(x.dtype == torch.bfloat16))]


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
        # derivative taken from the saved output; dx through the transposed
        # conv's kernel, dw through the weight-gradient kernel
        x, w, y = ctx.saved_tensors
        need = ctx.needs_input_grad
        ga = g.float() * act_grad_from_output(ctx.act, y)
        gc = ga.to(x.dtype).contiguous()
        dx = conv_dx(gc, w, x.shape[1], x.shape[2]) if need[0] else None
        dw = conv5x5_s2_dw(x, gc, w.dtype) if need[1] else None
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


# ====================== nearest-upsample x2 + conv 3x3 ========================

# parity → padded-x slice start of combined tap a ∈ {0, 1}, x padded by 1
# per spatial dim (conv.py _UPCONV_TAPS): y[2m+p] = Σ_a Cw[p,a]·x[m+p+a−1]
UPCONV_TAPS = {0: (0, 1), 1: (1, 2)}
# Cw[p,a] = Σ_k UNCOMBINE[p][a][k]·W[k]: (0,0) → W0, (0,1) → W1+W2,
# (1,0) → W0+W1, (1,1) → W2; its transpose recombines dCw into dW
UNCOMBINE = (((1.0, 0.0, 0.0), (0.0, 1.0, 1.0)),
             ((1.0, 1.0, 0.0), (0.0, 0.0, 1.0)))


def combine_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """[3,3,Cin,Co] → [2,2,2,2,Cin,Co] indexed [py,px,a,b]
    (`_combine_upconv_weights`).  The sums W1+W2 and W0+W1 are taken in w's
    dtype, rows first and then columns, as the JAX package takes them: under
    the bf16 policy a corner tap is rounded to bf16 twice."""
    rows = torch.stack([torch.stack([w[0], w[1] + w[2]]),
                        torch.stack([w[0] + w[1], w[2]])])   # [py,a,3,ci,co]
    cols = torch.stack([
        torch.stack([rows[:, :, 0], rows[:, :, 1] + rows[:, :, 2]], 2),
        torch.stack([rows[:, :, 0] + rows[:, :, 1], rows[:, :, 2]], 2),
    ], 1)                                                    # [py,px,a,b,ci,co]
    return cols.contiguous()


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NHWC nearest-neighbour upsample (`L.upsample_nearest`)."""
    b, h, w, c = x.shape
    return (x[:, :, None, :, None, :].expand(b, h, factor, w, factor, c)
            .reshape(b, h * factor, w * factor, c))


def upconv3x3_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """The plain PyTorch version: four output-parity planes, each the sum of
    2×2 combined-tap matmuls over the 1-padded input, accumulated in f32."""
    b, h, wd, _ = x.shape
    co = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wc = combine_upconv_weights(w).float()
    rows = []
    for py in (0, 1):
        cols = []
        for px in (0, 1):
            acc = torch.zeros(b, h, wd, co, device=x.device)
            for a, sh in enumerate(UPCONV_TAPS[py]):
                for c, sw in enumerate(UPCONV_TAPS[px]):
                    acc = acc + xp[:, sh:sh + h, sw:sw + wd, :] @ wc[py, px, a, c]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=3))          # [B,H,W,2(px),Co]
    y = torch.stack(rows, dim=2).reshape(b, 2 * h, 2 * wd, co)
    return apply_act(y * scale.float() + shift.float(), act).to(x.dtype)


# The space-to-depth form (`upconv3x3_s2d`, JAX `conv.py` `upconv3x3_s2d`):
# conv3x3(up2(x), w) = depth_to_space(conv3x3(x, W')), W'[u, v, :, (py, px,
# co)] the combined tap whose padded-input shift is (u, v) (5/9 of each
# parity block is zero).  Plain torch; nothing dispatches to it, as nothing
# does in the JAX package (`fused._upconv_s2d_wins` returns False: slower in
# every graph it measured), so it stays the documented formulation, held
# against `upconv3x3_plain` and the JAX function by the tests.

def s2d_upconv_weights(w: torch.Tensor) -> torch.Tensor:
    """[3,3,Cin,Co] → [3,3,Cin,4·Co], output channels (py, px, co)-major
    (`_s2d_upconv_weights`)."""
    wc = combine_upconv_weights(w)
    ci, co = w.shape[2], w.shape[3]
    out = w.new_zeros(3, 3, ci, 4 * co)
    for py in (0, 1):
        for px in (0, 1):
            c0 = (py * 2 + px) * co
            for a, u in enumerate(UPCONV_TAPS[py]):
                for c, v in enumerate(UPCONV_TAPS[px]):
                    out[u, v, :, c0:c0 + co] = wc[py, px, a, c]
    return out


def upconv3x3_s2d(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """``act(conv3x3(upsample2_nearest(x))·scale + shift)`` in the
    space-to-depth form: one 3×3 convolution of x to 4·Co channels in x's
    dtype, the f32 epilogue, then depth-to-space.  Differentiable (autograd
    through the torch ops)."""
    b, h, wd, _ = x.shape
    co = w.shape[-1]
    wp = s2d_upconv_weights(w.to(x.dtype))
    y4 = _nhwc(F.conv2d(_nchw(x), wp.permute(3, 2, 0, 1), padding=1))
    y4 = apply_act(y4.float() * scale.float().repeat(4)
                   + shift.float().repeat(4), act).to(x.dtype)
    y4 = y4.reshape(b, h, wd, 2, 2, co).permute(0, 1, 3, 2, 4, 5)
    return y4.reshape(b, 2 * h, 2 * wd, co)


def upconv3x3_s2d_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       act: str = "none") -> torch.Tensor:
    """`upconv3x3_s2d` with scale 1 and shift b (a BN follows outside)."""
    return upconv3x3_s2d(x, w, torch.ones_like(b, dtype=torch.float32),
                         b.float(), act)


def _upconv_lib() -> ctypes.CDLL:
    return _build.bind("upconv3x3", {
        # x, wc, scale, shift, y, ws; B, H, W, Cin, Co, act, bf16, tile,
        # parts of parities 0-3; stream
        "t2i_upconv3x3": [_PTR] * 6 + [_INT] * 12 + [_PTR],
        # x, wc, y; W, Cin, Co, bf16
        "t2i_upconv3x3_path": [_PTR] * 3 + [_INT] * 4,
        # w, wc; Cin, Co, bf16; stream
        "t2i_upconv3x3_combine": [_PTR] * 2 + [_INT] * 3 + [_PTR]})


# The kernel's code paths in the order of the C entry point's codes
# (csrc/upconv3x3.cu `Path`), chosen from shapes, types and alignment.
UPCONV_PATHS = ("tile", "pipelined", "wgmma", "co32")

# The co32 kernel (csrc/upconv_co32.cuh): input pixels of its tile (one
# row segment) and staged rows in its ring
CO32_SEG = 128
CO32_RING = 4
# its 16 products in the order it stages their weights (csrc/upconv_co32.cuh
# `first`, `parity`, `wc_tap`): the shift (dy, dx) = (py+a−1, px+c−1) of x
# they read, row-major, then their parities (py, px), py-major; each
# (dy, dx, py, px, a, c)
CO32_PRODUCTS = tuple(sorted((py + a - 1, px + c - 1, py, px, a, c)
                             for py in (0, 1) for px in (0, 1)
                             for a in (0, 1) for c in (0, 1)))


def co32_covers(cin: int, co: int, width: int) -> bool:
    """Whether the co32 kernel takes these channels on a map `width` pixels
    wide (csrc/upconv_co32.cuh `applies`): Cin 64, Co a multiple of 32 but
    not of 64, rows of whole 128-pixel segments."""
    return cin == 64 and co % 32 == 0 and co % 64 != 0 and \
        width % CO32_SEG == 0


def upconv_path(width: int, cin: int, co: int, dtype: torch.dtype,
                aligned: bool = True) -> str:
    """The Python mirror of `upconv_path` in csrc/upconv3x3.cu for x
    [B,H,width,Cin] and Co.  `aligned`: x, the combined weights and y start
    on 16-byte boundaries."""
    bf16 = dtype == torch.bfloat16
    if bf16 and cin % 64 == 0 and co % 64 == 0 and aligned:
        return "wgmma"
    if bf16 and aligned and co32_covers(cin, co, width):
        return "co32"
    return ("pipelined" if bf16 and aligned and cin % 8 == 0 and co % 8 == 0
            else "tile")


def combined_weights(w: torch.Tensor) -> torch.Tensor:
    """`combine_upconv_weights` of w: on CUDA one launch of the combine
    kernel of csrc/upconv3x3.cu (bit-equal to the torch version: the same
    sums in w's dtype, in the same order), on the CPU the torch version."""
    if w.device.type != "cuda":
        return combine_upconv_weights(w)
    if w.dtype not in _DTYPES or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"w must be [3,3,Cin,Co] in {_DTYPES}, got "
                         f"{w.dtype} {tuple(w.shape)}")
    w = w.contiguous()
    cin, co = w.shape[2:]
    wc = torch.empty(2, 2, 2, 2, cin, co, dtype=w.dtype, device=w.device)
    rc = _upconv_lib().t2i_upconv3x3_combine(
        w.data_ptr(), wc.data_ptr(), cin, co, int(w.dtype == torch.bfloat16),
        _stream(w))
    if rc != 0:
        raise RuntimeError(f"upconv3x3 combine launch failed: CUDA error {rc}")
    return wc


def _upconv_check(x, w, scale, shift, act):
    rows = x.numel() // x.shape[-1] if x.dim() == 4 else None
    _check_common(x, w, (("scale", scale), ("shift", shift)), act, k=3,
                  rows=rows)


@profiling.spanned("kernels.upconv3x3")
def _upconv_forward(x, w, scale, shift, act, plan=None):
    """`plan` forces a `GroupedPlan` on the wgmma path; None asks
    `upconv_plan`."""
    if x.device.type == "cpu":
        return upconv3x3_plain(x, w, scale, shift, act)
    if x.device.type != "cuda":
        raise ValueError(f"upconv3x3 runs on cuda or cpu, not {x.device}")
    _upconv_check(x, w, scale, shift, act)
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    wc = combined_weights(w)
    y = torch.empty(b, 2 * h, 2 * wd, co, dtype=x.dtype, device=x.device)
    tile, parts, ws = 0, (1, 1, 1, 1), None
    if upconv_path(wd, cin, co, x.dtype, _aligned16(x, wc, y)) == "wgmma":
        rows = b * h * wd
        tile, parts, ws = _grouped_launch_args(
            x, plan or upconv_plan(rows, co, cin), rows, co)
    rc = _upconv_lib().t2i_upconv3x3(
        x.data_ptr(), wc.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        y.data_ptr(), ws.data_ptr() if ws is not None else None, b, h, wd,
        cin, co, ACT_CODES[act], int(x.dtype == torch.bfloat16), tile,
        *parts, _stream(x))
    if rc != 0:
        raise RuntimeError(f"upconv3x3 kernel launch failed: CUDA error {rc}")
    upconv3x3.launches += 1
    return y


def upconv_path_on_card(x, wc, y) -> str:
    """The path the C entry point itself reports for these tensors."""
    return UPCONV_PATHS[_upconv_lib().t2i_upconv3x3_path(
        x.data_ptr(), wc.data_ptr(), y.data_ptr(), x.shape[2], x.shape[-1],
        wc.shape[-1], int(x.dtype == torch.bfloat16))]


def _upconv_composed(x, w, scale, shift, act):
    """conv3×3 over the materialised upsampled map (`_lax_upconv`): what the
    kernel avoids; the tanh backward differentiates it."""
    y = F.conv2d(_nchw(upsample_nearest(x)), w.permute(3, 2, 0, 1), padding=1)
    y = _nhwc(y).float() * scale.float() + shift.float()
    return apply_act(y, act).to(x.dtype)


# ---- the up-block's backward: upconv3x3_dx and upconv3x3_dw

# the 16 combined taps, t = ((py·2+px)·2+a)·2+c (the order of the combined
# weights)
UPCONV_BWD_TAPS = tuple((py, px, a, c) for py in (0, 1) for px in (0, 1)
                        for a in (0, 1) for c in (0, 1))
# dx: tap t of dx pixel (i, j) reads g at (2i, 2j) + DX_G_OFFSETS[t], the
# pixel (i+1−py−a, j+1−px−c) of g's parity plane (py, px), zero outside it
# (csrc/upconv3x3_bwd.cu UpconvDx::tap_off)
DX_G_OFFSETS = tuple((2 - py - 2 * a, 2 - px - 2 * c)
                     for py, px, a, c in UPCONV_BWD_TAPS)
# dw: product t is x shifted by DW_X_SHIFTS[t] = (py+a−1, px+c−1), zero
# outside the map, against g's plane (py, px) (csrc/upconv3x3_bwd.cu
# `pixel`); then dW[kh,kw] = Σ_t RECOMBINE[t][kh][kw]·dCw[t]
DW_X_SHIFTS = tuple((py + a - 1, px + c - 1)
                    for py, px, a, c in UPCONV_BWD_TAPS)
RECOMBINE = tuple(tuple(tuple(UNCOMBINE[py][a][kh] * UNCOMBINE[px][c][kw]
                              for kw in range(3)) for kh in range(3))
                  for py, px, a, c in UPCONV_BWD_TAPS)


def upconv3x3_dx_plain(g: torch.Tensor, w: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """The adjoint in x of conv3×3(up2(x), w) for the cotangent g
    [B,2H,2W,Co] (`_parity_dx`), in the kernel's terms: 16 f32 matmuls,
    tap t reading g's parity plane (py, px) shifted by (1−py−a, 1−px−c)
    (zeros outside) against Cw[py,px,a,c]ᵀ, the combined weights of w in
    g's dtype; the sum rounded once to out_dtype."""
    b, h2, w2, co = g.shape
    h, wd = h2 // 2, w2 // 2
    wc = combine_upconv_weights(w.to(g.dtype)).float()
    # [B, H+2, 2, W+2, 2, Co]: each parity plane padded by one pixel
    planes = F.pad(g.float().reshape(b, h, 2, wd, 2, co),
                   (0, 0, 0, 0, 1, 1, 0, 0, 1, 1))
    dx = torch.zeros(b, h, wd, w.shape[2], device=g.device)
    for py, px, a, c in UPCONV_BWD_TAPS:
        sh, sw = 2 - py - a, 2 - px - c
        dx = dx + planes[:, sh:sh + h, py, sw:sw + wd, px, :] @ \
            wc[py, px, a, c].T
    return dx.to(out_dtype)


def upconv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor,
                       w_dtype: torch.dtype) -> torch.Tensor:
    """The adjoint in w of conv3×3(up2(x), w) for the cotangent g
    (`_parity_dw`), in the kernel's terms: the 16 f32 products dCw[t] =
    x shifted by DW_X_SHIFTS[t] (zeros outside) against g's parity plane
    (py, px), with g in x's dtype, each added into the 3×3 taps RECOMBINE
    gives it, in the order t = 0..15; rounded once to w_dtype."""
    b, h, wd, ci = x.shape
    co = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gp = g.to(x.dtype).float().reshape(b, h, 2, wd, 2, co)
    dw = torch.zeros(3, 3, ci, co, device=x.device)
    for t, (py, px, _, _) in enumerate(UPCONV_BWD_TAPS):
        dy, dx = DW_X_SHIFTS[t]
        xs = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + wd, :].reshape(-1, ci)
        dcw = xs.T @ gp[:, :, py, :, px, :].reshape(-1, co)
        for kh in range(3):
            for kw in range(3):
                if RECOMBINE[t][kh][kw]:
                    dw[kh, kw] += dcw
    return dw.to(w_dtype)


def _bwd_lib() -> ctypes.CDLL:
    return _build.bind("upconv3x3_bwd", {
        # g, wc, wct, dx, ws; B, H, W, Cin, Co, bf16, kernel, tile, parts;
        # stream
        "t2i_upconv3x3_dx": [_PTR] * 5 + [_INT] * 9 + [_PTR],
        # g, wc, dx; H, W, Cin, Co, bf16
        "t2i_upconv3x3_dx_path": [_PTR] * 3 + [_INT] * 5,
        "t2i_upconv3x3_dx_mode": [],
        # x, g, dw, ws; B, H, W, Cin, Co, bf16, w_bf16, tile_m, tile_n,
        # parts, cluster, chunk, fold; stream
        "t2i_upconv3x3_dw": [_PTR] * 4 + [_INT] * 13 + [_PTR],
        # x, g; H, W, Cin, Co, bf16
        "t2i_upconv3x3_dw_path": [_PTR] * 2 + [_INT] * 5,
        "t2i_upconv3x3_dw_mode": [],
        # csize, tile_n
        "t2i_upconv3x3_dw_clusters": [_INT] * 2})


# the code paths in the order of the C entry points' codes
# (csrc/upconv3x3_bwd.cu `DxPath`, `DwPath`)
DX_PATHS = ("tile", "pipelined", "wgmma")
DW_PATHS = ("tile", "wgmma", "mma")

# dx's wgmma loops (csrc/upconv_dx.cuh): their codes (dx90::Kernel), the
# rows of the ring kernel's tile, its tile widths and parts of K (one
# cluster of at most 8)
DX_KERNELS = ("cp_async", "ring", "transposed")
DX_BM = 128
DX_TILES_N = (256, 128, 64)
DX_PARTS = (1, 2, 4, 8)


def dx_boxes(h: int, w: int) -> bool:
    """Whether a tile of DX_BM rows of dx's h×w map is one TMA box of g's
    parity planes (csrc/upconv_dx.cuh `boxes`): a part of one image row,
    whole rows of one image or whole images."""
    hw = h * w
    return w % DX_BM == 0 or (DX_BM % w == 0 and (hw % DX_BM == 0
                                                  or DX_BM % hw == 0))


def dx_patches(h: int, w: int) -> bool:
    """Whether the transposed kernel's tiles, two image rows of a 128-pixel
    segment, cover dx's h×w map (csrc/upconv_dx.cuh `patches`): there the
    four taps of a parity plane share one staged patch."""
    return w % 128 == 0 and h % 2 == 0


def dx_path(h: int, w: int, cin: int, co: int, dtype: torch.dtype,
            aligned: bool = True) -> str:
    """The Python mirror of `dx_path` in csrc/upconv3x3_bwd.cu for dx's
    h×w map (the GEMM's N is Cin, its K slices Co's channels): wgmma for
    bf16 with Cin a multiple of 64 and Co of 64, or of 32 where a tile is a
    TMA box (`dx_boxes`); mma.sync (pipelined) for multiples of 8; else the
    simple tile.  `aligned`: g, the combined weights and dx start on
    16-byte boundaries."""
    bf16 = dtype == torch.bfloat16
    if bf16 and aligned and cin % 64 == 0 and (
            co % 64 == 0 or (co % 32 == 0 and dx_boxes(h, w))):
        return "wgmma"
    return ("pipelined" if bf16 and aligned and cin % 8 == 0 and co % 8 == 0
            else "tile")


class DxPlan(NamedTuple):
    """A launch of dx's wgmma path: the loop (`DX_KERNELS`), its tile (the
    transposed kernel's: 256 pixels × 64 input channels) and the parts of
    K (the ring kernel: one cluster of them, summed on chip; the gather
    loop: split planes through a workspace)."""
    kernel: str
    tile_m: int
    tile_n: int
    parts: int

    @property
    def cluster(self) -> int:
        """CTAs of one cluster: the ring kernel's parts, else 1."""
        return self.parts if self.kernel == "ring" else 1

    @property
    def staging(self) -> str:
        """How A reaches shared memory: a TMA box a tap ("tap", the ring
        kernel), one patch a plane for its four taps ("patch", the
        transposed kernel) or cp.async row by row ("gather")."""
        return {"ring": "tap", "transposed": "patch"}.get(self.kernel,
                                                           "gather")


# The ring kernel's cost model, in units of one 128x128x64 slice on one SM
# (ranks plans; not a prediction): work per product relative to the
# 128x128 tile, the fixed cost of a block (ring fill, epilogue) and of
# each extra part of a cluster (its tile through distributed shared memory)
_DX_TILE_COST = {256: 0.9, 128: 1.0, 64: 1.1}
_DX_PART_COST = 4.0


def dx_k_slice(co: int) -> int:
    """Channels of g a K slice of the TMA loops takes: 64 (128-byte rows),
    or 32 (64-byte rows) where Co is not a multiple of 64."""
    return 64 if co % 64 == 0 else 32


def dx_ring_cost(m: int, cin: int, co: int, tile_n: int, parts: int) -> float:
    """The model's time of the ring kernel with 128×tile_n tiles and
    `parts` parts of the 16·Co/slice items: its blocks in waves of one a
    SM (blocks an SM shares run at its shared rate), each the items of its
    part plus the cost of each other part's tile summed through the
    cluster."""
    items = 16 * co // dx_k_slice(co)
    blocks = -(-m // DX_BM) * (cin // tile_n) * parts
    per_item = tile_n / 128 * dx_k_slice(co) / 64 * _DX_TILE_COST[tile_n]
    work = -(-items // parts) * per_item + (parts - 1) * _DX_PART_COST
    return -(-blocks // SM_COUNT) * work


def dx_candidates(b: int, h: int, w: int, cin: int, co: int):
    """Every TMA plan the launcher takes at this shape (a map with a box):
    the ring kernel at each tile width dividing Cin and 1, 2, 4 or 8 parts
    (at most the items), and the transposed kernel at Co 32 and 64 on maps
    with `dx_patches`."""
    items = 16 * co // dx_k_slice(co)
    plans = [DxPlan("ring", DX_BM, tn, parts)
             for tn in DX_TILES_N if cin % tn == 0
             for parts in DX_PARTS if parts <= items]
    if co in (32, 64) and dx_patches(h, w):
        plans.append(DxPlan("transposed", 256, 64, 1))
    return plans


@functools.lru_cache(maxsize=None)   # a training run repeats a few shapes
def dx_plan(b: int, h: int, w: int, cin: int, co: int) -> DxPlan:
    """The plan of dx's wgmma path for x [b,h,w,Cin] and Co.  Maps with no
    box: the gather loop with `conv_plan`'s tile and split of the 16 taps.
    Co 32 and 64 on maps with `dx_patches` (the 128² maps, bound by
    bytes): the transposed kernel, 1.3-1.7× faster than the ring there
    (tools/conv_plan_sweep.py --ops dx on the H100).  Elsewhere the ring
    kernel, its tile and parts the cheapest by `dx_ring_cost` (ties to
    fewer parts, then the wider tile)."""
    m = b * h * w
    if not dx_boxes(h, w):
        tm, tn, split = conv_plan(m, cin, 16 * co, taps=16)
        return DxPlan("cp_async", tm, tn, split)
    cands = dx_candidates(b, h, w, cin, co)
    if cands[-1].kernel == "transposed":
        return cands[-1]
    return min(cands, key=lambda p: (dx_ring_cost(m, cin, co, p.tile_n,
                                                  p.parts),
                                     p.parts, -p.tile_n))


def dw_path(h: int, w: int, cin: int, co: int, dtype: torch.dtype,
            aligned: bool = True) -> str:
    """The Python mirror of `dw_path` in csrc/upconv3x3_bwd.cu for x
    [B,h,w,Cin].  `aligned`: x and g start on 16-byte boundaries."""
    if dtype != torch.bfloat16 or not aligned:
        return "tile"
    if cin % 64 == 0 and co % 32 == 0 and dw_box(h, w):
        return "wgmma"
    return "mma" if cin % 8 == 0 and co % 8 == 0 else "tile"


def dw_box(h: int, w: int):
    """(width, rows, images) of the box that brings one K slice of 64
    pixels by TMA on dw's wgmma path, or None where no box is one slice
    (csrc/wgrad.cuh `boxes`; such maps take the mma path): a
    64-pixel part of one image row, 64/W whole rows of one image, or
    64/(H·W) whole images."""
    hw = h * w
    if not (w % 64 == 0 or (64 % w == 0 and (hw % 64 == 0 or 64 % hw == 0))):
        return None
    if w >= 64:
        return 64, 1, 1
    return w, min(64 // w, h), (64 // hw if hw < 64 else 1)


class DwPlan(NamedTuple):
    """A launch of a weight-gradient kernel (upconv3x3_dw, conv5x5_s2_dw):
    the [rows × Co] tile of a block (the up-block's on-chip fold: 64 input
    channels × 64 or 32 output channels, all 16 products; the mma and tile
    paths' 64 × 64), the parts K is cut into, how many of them run as one
    thread-block cluster and are summed on chip (parts // cluster > 1: the
    clusters' sums go through a workspace), the input channels of a chunk
    (all of Cin where there is no workspace) and, for the up-block's wgmma
    path, whether its blocks fold the 16 products on chip or each computes
    one product's tile (then every part through the workspace)."""
    tile_m: int
    tile_n: int
    parts: int
    cluster: int
    chunk: int
    fold: bool = False   # the up-block's 16 products folded on chip

    @property
    def groups(self) -> int:
        """The clusters a tile's parts form: above 1, a workspace plane
        each."""
        return self.parts // self.cluster


DW_SLICE = {"wgmma": 64, "mma": 32, "tile": 16}   # pixels a K slice
DW_MAX_CLUSTER = 8                     # the portable cluster size
DW_MIN_SLICES = 8                      # the least K a part is given
DW_TAPS = {16: 9, 25: 25}              # dw's taps by the op's products
# The plans' targets, from tools/conv_plan_sweep.py --ops dw (every parts ×
# cluster at every main-path call, H100 80GB HBM3, 700 W; PERF.md): the
# CTAs a launch aims at, by kernel.  The conv's wgmma kernel does best with
# about 200 CTAs, its parts a power of two in one cluster (clusters of 3,
# 5-7 fit the GPCs worse); but where K is at least DW_LONG_SLICES slices
# and DW_WS_PARTS parts make at most 500 CTAs ("apart"), that many parts
# with no cluster and their sums through the workspace were faster than
# any cluster (up to 1.6×; eight parts in one cluster were slower than
# eight apart).  The up-block's per-product blocks do best at 256, the mma
# and tile paths at 512, the on-chip fold at 112 (the card holds 120 of
# its CTAs in clusters of 8, 132 alone).
DW_TARGET_CTAS = {"conv": 200, "apart": 500, "products": 256,
                  "latency": 512, "fold": 112}
DW_LONG_SLICES = 512
DW_WS_PARTS = 10
# the up-block folds on chip where K is at most this many slices (the 4²
# maps at batch 64, level with its per-product blocks) or Co is not a
# multiple of 64 (C-PGGAN's Co 32, 4.5× faster than mma.sync); its
# per-product blocks were faster at every other main-path call
DW_FOLD_SLICES = 16


def dw_ws_elems(cin: int, co: int, parts: int, products: int = 16) -> int:
    """f32 elements of `parts` workspace planes of `products` [cin × co]
    matrices (one chunk)."""
    return parts * products * cin * co


def wgrad_chunk(cin: int, co: int, products: int, unit: int) -> int:
    """The input channels one launch of a weight-gradient kernel covers
    where it has a workspace (csrc/wgrad.cuh): all of Cin where its
    `products` [Cin × Co] f32 planes fit CONV_WS_CAP, else the most
    channels, a multiple of `unit` (the tile's rows), that fit.  Each chunk
    holds every product of its channels (the up-block's per-product paths
    fold their 16 products into 9 taps within one), so the workspace stays
    under the cap at any Cin·Co; a chunk of one unit that does not fit
    raises."""
    if dw_ws_elems(cin, co, 1, products) * 4 <= CONV_WS_CAP:
        return cin
    chunk = CONV_WS_CAP // (dw_ws_elems(1, co, 1, products) * 4) // unit * unit
    if chunk < unit:
        raise ValueError(f"dw workspace of {products}x{unit}x{co} f32 over "
                         f"{CONV_WS_CAP} bytes")
    return chunk


def _wgrad_plan(k: int, cin: int, co: int, products: int, path: str,
                tm: int, tn: int, ctas_of, fold: bool = False) -> "DwPlan":
    """The parts of the k pixels and their clusters (`ctas_of(chunk)`: the
    CTAs of one part over a chunk), each part at least DW_MIN_SLICES
    slices, towards DW_TARGET_CTAS.  The conv's wgmma kernel: a power of
    two of parts, all in one cluster, no workspace; at long K with few
    tiles DW_WS_PARTS parts apart, through the workspace.  Its mma and tile
    paths: up to DW_MAX_CLUSTER parts a cluster, more as groups of
    clusters whose sums go through a workspace of 25 taps each.  The
    up-block's on-chip fold: up to 4 parts a cluster of 2 CTAs each, more
    as groups through a workspace of 9 taps; its per-product blocks: no
    cluster, every part's 16 products through the workspace.  A workspace
    is walked in chunks of `wgrad_chunk`."""
    slices = -(-k // DW_SLICE[path])
    most = max(1, slices // DW_MIN_SLICES)
    ctas = ctas_of(cin)
    if products == 25 and path == "wgmma":
        if (slices >= DW_LONG_SLICES and most >= DW_WS_PARTS
                and ctas * DW_WS_PARTS <= DW_TARGET_CTAS["apart"]):
            return DwPlan(tm, tn, DW_WS_PARTS, 1, wgrad_chunk(
                cin, co, DW_WS_PARTS * DW_TAPS[products], tm))
        top = min(most, DW_MAX_CLUSTER)
        parts = 1
        while parts * 2 <= top and ctas * parts * 2 <= DW_TARGET_CTAS["conv"]:
            parts *= 2
        return DwPlan(tm, tn, parts, parts, cin)
    kind = ("fold" if fold else "latency" if path != "wgmma"
            else "products")
    want = min(most, max(1, DW_TARGET_CTAS[kind] // ctas))
    cmax = (DW_MAX_CLUSTER // 2 if fold else
            DW_MAX_CLUSTER if products == 25 else 1)
    cluster = min(cmax, want)
    parts = want // cluster * cluster
    if parts == cluster and (products == 25 or fold):
        return DwPlan(tm, tn, parts, cluster, cin, fold)
    planes = parts // cluster * (DW_TAPS[products] if products == 25 or fold
                                 else products)
    return DwPlan(tm, tn, parts, cluster, wgrad_chunk(cin, co, planes, tm),
                  fold)


def plan_ws_elems(plan: "DwPlan", co: int, products: int) -> int:
    """f32 elements of the workspace a weight-gradient plan allocates (0:
    none): on the up-block's per-product blocks every product of every
    part; else a plane of every tap per cluster group, where there is more
    than one; one chunk each."""
    if products == 16 and not plan.fold:
        return dw_ws_elems(plan.chunk, co, plan.parts, 16)
    if plan.groups == 1:
        return 0
    return dw_ws_elems(plan.chunk, co, plan.groups, DW_TAPS[products])


def _dw_tile(path: str, cin: int, co: int):
    """The per-product blocks' wgmma tile (the conv's, the up-block's past
    the fold): the widest of 64 or 128 that divides Cin and Co; 64 × 64 on
    the other paths."""
    if path != "wgmma":
        return 64, 64
    return (128 if cin % 128 == 0 else 64), (128 if co % 128 == 0 else 64)


def dw_plan(b: int, h: int, w: int, cin: int, co: int, dtype: torch.dtype,
            aligned: bool = True) -> DwPlan:
    """The tile, the parts, their cluster, the chunk and the fold of
    upconv3x3_dw for x [b,h,w,Cin], over its k = b·h·w pixels.  wgmma with
    Co not a multiple of 64 or K of at most DW_FOLD_SLICES slices: a tile
    of 64 input channels × 64 output channels (32 where Co is not a
    multiple of 64), all 16 products, two CTAs a part (the row parities of
    g), the fold on chip; else (and on the mma and tile paths) a block one
    product's tile (`_dw_tile`), its parts through the workspace and
    folded there."""
    path = dw_path(h, w, cin, co, dtype, aligned)
    k = b * h * w
    if path == "wgmma" and (co % 64 or -(-k // DW_SLICE[path])
                            <= DW_FOLD_SLICES):
        tn = 64 if co % 64 == 0 else 32
        return _wgrad_plan(k, cin, co, 16, path, 64, tn,
                           lambda c: -(-c // 64) * -(-co // tn) * 2,
                           fold=True)
    tm, tn = _dw_tile(path, cin, co)
    return _wgrad_plan(k, cin, co, 16, path, tm, tn,
                       lambda c: -(-c // tm) * -(-co // tn) * 16)


def _bwd_common(what, ts, dtype_out):
    """Dtype, device, contiguity and extent checks of the two backward
    wrappers (`ts`: (name, tensor) pairs of the inputs)."""
    dtype = ts[0][1].dtype
    for name, t in ts:
        if t.dtype not in _DTYPES or t.dtype != dtype:
            raise TypeError(f"{what}: {name} must share a dtype in {_DTYPES}"
                            f", got {t.dtype}")
        if t.device != ts[0][1].device:
            raise ValueError(f"{what}: {name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.numel() >= 2**31:
            raise ValueError(f"{what}: {name} too large for the kernel's "
                             f"int32 extents")
    if dtype_out not in _DTYPES:
        raise TypeError(f"{what}: output dtype {dtype_out} not in {_DTYPES}")


def _g_check(g, b, h, wd, co, what):
    if g.dim() != 4 or tuple(g.shape) != (b, 2 * h, 2 * wd, co):
        raise ValueError(f"{what}: g must be [{b},{2 * h},{2 * wd},{co}], "
                         f"got {tuple(g.shape)}")


def _dx_check(g, w, out_dtype):
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"upconv3x3_dx: w must be [3,3,Cin,Co], got "
                         f"{tuple(w.shape)}")
    if g.dim() != 4 or g.shape[1] % 2 or g.shape[2] % 2:
        raise ValueError(f"upconv3x3_dx: g must be [B,2H,2W,Co], got "
                         f"{tuple(g.shape)}")
    b, h2, w2, _ = g.shape
    _g_check(g, b, h2 // 2, w2 // 2, w.shape[3], "upconv3x3_dx")
    _bwd_common("upconv3x3_dx", [("g", g)], out_dtype)
    if w.dtype not in _DTYPES or w.device != g.device:
        raise TypeError(f"upconv3x3_dx: w must be {_DTYPES} on {g.device}")
    if out_dtype != g.dtype:
        raise TypeError(f"upconv3x3_dx: dx is written in g's dtype "
                        f"{g.dtype}, not {out_dtype}")
    if g.numel() // 4 // w.shape[3] * w.shape[2] >= 2**31:
        raise ValueError("upconv3x3_dx: dx too large for the kernel's int32 "
                         "extents")


@profiling.spanned("kernels.upconv3x3_dx")
def upconv3x3_dx(g: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype, plan: DxPlan = None) -> torch.Tensor:
    """dx [B,H,W,Cin] of conv3×3(up2(x), w) for the cotangent g
    [B,2H,2W,Co] (the activation's derivative already in it), in g's dtype
    (out_dtype must be it): the combined weights of w in g's dtype, then
    one hand-written GEMM over the 16 taps (on its wgmma path the loop,
    tile and parts of `dx_plan`, or `plan`: a sweep's).  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _dx_check(g, w, out_dtype)
    if g.device.type == "cpu":
        return upconv3x3_dx_plain(g, w, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"upconv3x3_dx runs on cuda or cpu, not {g.device}")
    b, h2, w2, co = g.shape
    h, wd, cin = h2 // 2, w2 // 2, w.shape[2]
    wc = combined_weights(w.to(g.dtype))
    dx = torch.empty(b, h, wd, cin, dtype=g.dtype, device=g.device)
    path = dx_path(h, wd, cin, co, g.dtype, _aligned16(g, wc, dx))
    kernel, tile, parts, ws = 0, 0, 1, None
    if path == "wgmma":
        plan = plan or dx_plan(b, h, wd, cin, co)
        kernel, parts = DX_KERNELS.index(plan.kernel), plan.parts
        if plan.kernel == "cp_async":
            tile = CONV_TILES.index((plan.tile_m, plan.tile_n))
            if parts > 1:
                ws = torch.empty(parts * b * h * wd * cin,
                                 dtype=torch.float32, device=g.device)
        else:
            tile = plan.tile_n
    # the weights transposed to [16][Co][Cin], for the loops that read them
    # N-major (the gather, mma.sync and FMA tiles)
    wct = (torch.empty_like(wc)
           if path != "wgmma" or plan.kernel == "cp_async" else None)
    rc = _bwd_lib().t2i_upconv3x3_dx(
        g.data_ptr(), wc.data_ptr(),
        wct.data_ptr() if wct is not None else None, dx.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, h, wd, cin, co,
        int(g.dtype == torch.bfloat16), kernel, tile, parts, _stream(g))
    if rc != 0:
        raise RuntimeError(f"upconv3x3_dx kernel launch failed: CUDA error "
                           f"{rc}")
    upconv3x3_dx.launches += 1
    return dx


upconv3x3_dx.launches = 0


def dx_path_on_card(g, dx) -> str:
    """The path t2i_upconv3x3_dx takes for these tensors (the combined
    weights come from the caching allocator: 16-byte aligned)."""
    return DX_PATHS[_bwd_lib().t2i_upconv3x3_dx_path(
        g.data_ptr(), dx.data_ptr(), dx.data_ptr(), dx.shape[1], dx.shape[2],
        dx.shape[-1], g.shape[-1], int(g.dtype == torch.bfloat16))]


# what a dx launch did, in the order of csrc/upconv_dx.cuh's Mode bits: A
# by TMA (the ring and transposed kernels, both with a producer warp), the
# four taps of a plane from one shared patch (the transposed kernel),
# 64-byte K slices (Co not a multiple of 64), the parts of K summed in a
# cluster, a workspace and its reduce launch, A gathered by cp.async
DX_MODES = ("tma_a", "patch", "k32", "cluster", "workspace", "cp_async")


def dx_modes(path: str, plan: DxPlan, co: int) -> frozenset:
    """The Python mirror of the Mode bits a dx launch reports, from its path
    and plan (none on the mma.sync and FMA tiles)."""
    if path != "wgmma":
        return frozenset()
    if plan.kernel == "cp_async":
        return frozenset({"cp_async"} | ({"workspace"} if plan.parts > 1
                                         else set()))
    modes = {"tma_a"}
    if co % 64:
        modes.add("k32")
    if plan.kernel == "ring" and plan.parts > 1:
        modes.add("cluster")
    if plan.kernel == "transposed":
        modes.add("patch")
    return frozenset(modes)


def dx_mode_on_card() -> frozenset:
    """What the last upconv3x3_dx launch of this process did (its C entry
    point's Mode bits)."""
    bits = _bwd_lib().t2i_upconv3x3_dx_mode()
    return frozenset(n for i, n in enumerate(DX_MODES) if bits >> i & 1)


def _dw_check(x, g, w_dtype):
    if x.dim() != 4:
        raise ValueError(f"upconv3x3_dw: x must be NHWC, got "
                         f"{tuple(x.shape)}")
    b, h, wd, _ = x.shape
    _g_check(g, b, h, wd, g.shape[-1] if g.dim() == 4 else -1,
             "upconv3x3_dw")
    _bwd_common("upconv3x3_dw", [("x", x), ("g", g)], w_dtype)


@profiling.spanned("kernels.upconv3x3_dw")
def upconv3x3_dw(x: torch.Tensor, g: torch.Tensor, w_dtype: torch.dtype,
                 plan: "DwPlan" = None) -> torch.Tensor:
    """dw [3,3,Cin,Co] in w_dtype of conv3×3(up2(x), w) for the cotangent
    g [B,2H,2W,Co] in x's dtype: the 16 combined-tap products summed in f32
    over every pixel and folded into the 3×3 taps by one hand-written
    kernel (on its wgmma path on chip, the parts a cluster holds summed
    there; a workspace and a fixed-order reduction only past that), the
    same bits every launch.  `plan` overrides `dw_plan` (a sweep's).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _dw_check(x, g, w_dtype)
    if x.device.type == "cpu":
        return upconv3x3_dw_plain(x, g, w_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"upconv3x3_dw runs on cuda or cpu, not {x.device}")
    b, h, wd, cin = x.shape
    co = g.shape[-1]
    aligned = _aligned16(x, g)
    plan = plan or dw_plan(b, h, wd, cin, co, x.dtype, aligned)
    n_ws = plan_ws_elems(plan, co, 16)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    dw = torch.empty(3, 3, cin, co, dtype=w_dtype, device=x.device)
    rc = _bwd_lib().t2i_upconv3x3_dw(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, h, wd, cin, co,
        int(x.dtype == torch.bfloat16), int(w_dtype == torch.bfloat16),
        plan.tile_m, plan.tile_n, plan.parts, plan.cluster, plan.chunk,
        int(plan.fold), _stream(x))
    if rc != 0:
        raise RuntimeError(f"upconv3x3_dw kernel launch failed: CUDA error "
                           f"{rc}")
    upconv3x3_dw.launches += 1
    return dw


upconv3x3_dw.launches = 0


def dw_path_on_card(x, g) -> str:
    """The path t2i_upconv3x3_dw takes for these tensors."""
    return DW_PATHS[_bwd_lib().t2i_upconv3x3_dw_path(
        x.data_ptr(), g.data_ptr(), x.shape[1], x.shape[2], x.shape[-1],
        g.shape[-1], int(x.dtype == torch.bfloat16))]


# what a weight-gradient launch did, in the order of csrc/wgrad.cuh's Mode
# bits: dw written by the kernel itself (no workspace), parts summed across
# a cluster, a workspace and its reduction, the up-block's 16 products
# folded on chip, its 32-column tile, the RGB layers' staged gather, the
# producer-warp main loop
DW_MODES = ("direct", "cluster", "workspace", "fold", "bn32", "staged",
            "producer")


def dw_modes(path: str, plan: DwPlan, products: int, cin: int, hp: int,
             wp: int) -> frozenset:
    """The Python mirror of the Mode bits a launch of either weight-gradient
    kernel reports, from its path and plan (`products` 16: upconv3x3_dw, 25:
    conv5x5_s2_dw; hp × wp the map K runs over: g's for the conv).  The
    conv's RGB layers stage their rows where 64 pixels are one row of g's
    map or two whole rows of 32 (csrc/conv5x5_s2_bwd.cu can_stage)."""
    fold_apart = products == 16 and not plan.fold
    split = 2 if plan.fold else 1
    modes = {"workspace" if plan.groups > 1 or fold_apart else "direct"}
    if plan.cluster * split > 1:
        modes.add("cluster")
    if path == "wgmma":
        modes.add("producer")
    if plan.fold:
        modes.add("fold")
        if plan.tile_n == 32:
            modes.add("bn32")
    if (products == 25 and path == "mma" and cin <= 4
            and (wp % 64 == 0 or (wp == 32 and hp % 2 == 0))):
        modes.add("staged")
    return frozenset(modes)


def _modes(bits: int) -> frozenset:
    return frozenset(n for i, n in enumerate(DW_MODES) if bits >> i & 1)


def dw_mode_on_card() -> frozenset:
    """What the last upconv3x3_dw launch of this process did (its C entry
    point's Mode bits)."""
    return _modes(_bwd_lib().t2i_upconv3x3_dw_mode())


def act_backward(act: str, g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """g·act′(p) from y = act(p) in g's dtype, rounded once, as the f32
    product with `act_grad_from_output` cast to g's dtype rounds it: g
    itself for none, g where y > 0 for relu, g·0.2 where y < 0 for lrelu
    (no f32 copy of g for these three); tanh through that f32 product."""
    if act == "none":
        return g
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
    if act == "lrelu":
        return torch.where(y >= 0, g, g * 0.2)
    return (acc(g) * act_grad_from_output(act, y)).to(g.dtype)


def bias_grad(act: str, g: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ g·act′(y) over all but the channel axis in f32, as the JAX package
    sums its f32 products g32 (`_upconv_bias_bwd`), with no f32 copy of g
    for none, relu and lrelu: relu's terms are g or 0, lrelu's the f32 sum
    of g where y ≥ 0 plus 0.2 times that of g where y < 0; tanh through the
    f32 product."""
    dims = (0, 1, 2)
    if act == "none":
        return g.sum(dims, dtype=torch.float32)
    if act == "relu":
        return torch.where(y > 0, g, 0).sum(dims, dtype=torch.float32)
    if act == "lrelu":
        pos = torch.where(y >= 0, g, 0).sum(dims, dtype=torch.float32)
        return pos + 0.2 * torch.where(y < 0, g, 0).sum(dims,
                                                        dtype=torch.float32)
    return (acc(g) * act_grad_from_output(act, y)).sum(dims)


class _Upconv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, scale, shift, act):
        y = _upconv_forward(x, w, scale, shift, act)
        ctx.act = act
        ctx.save_for_backward(x, w, scale, shift, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _upconv_bwd: the epilogue's derivative and the conv output from
        # the saved y for the invertible activations, then the parity
        # adjoints; tanh differentiates the composed version again
        x, w, scale, shift, y = ctx.saved_tensors
        if ctx.act == "tanh":
            with torch.enable_grad():
                ins = [v.detach().requires_grad_(True)
                       for v in (x, w, scale, shift)]
                out = _upconv_composed(*ins, ctx.act)
            return (*torch.autograd.grad(out, ins, g), None)
        g32 = g.float() * act_grad_from_output(ctx.act, y)
        y32 = y.float()
        pre = y32 if ctx.act != "lrelu" else torch.where(y32 >= 0, y32,
                                                         y32 / 0.2)
        d0 = torch.where(g32 != 0, (pre - shift) / scale,
                         torch.zeros_like(pre))            # the conv output
        d_conv = (g32 * scale).to(x.dtype)
        need = ctx.needs_input_grad
        dx = upconv3x3_dx(d_conv, w, x.dtype) if need[0] else None
        dw = upconv3x3_dw(x, d_conv, w.dtype) if need[1] else None
        ds = (g32 * d0).sum((0, 1, 2)) if need[2] else None
        dt = g32.sum((0, 1, 2)) if need[3] else None
        return dx, dw, ds, dt, None


class _UpconvBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, act):
        y = _upconv_forward(x, w, torch.ones_like(b), b, act)
        ctx.act = act
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _upconv_bias_bwd: no scale, so no conv output to recover; the
        # conv's cotangent in g's dtype with no f32 copy, then the two
        # kernels; db the f32 sum of the unrounded g·act′(y)
        x, w, y = ctx.saved_tensors
        d_conv = act_backward(ctx.act, g.to(x.dtype), y).contiguous()
        need = ctx.needs_input_grad
        dx = upconv3x3_dx(d_conv, w, x.dtype) if need[0] else None
        dw = upconv3x3_dw(x, d_conv, w.dtype) if need[1] else None
        db = bias_grad(ctx.act, g, y) if need[2] else None
        return dx, dw, db, None


def upconv3x3(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
              shift: torch.Tensor, act: str = "none") -> torch.Tensor:
    """Fused ``act(conv3x3(upsample2_nearest(x), w)·scale + shift)``.

    x [B,H,W,Cin] and the ordinary kernel w [3,3,Cin,Co] share a dtype (bf16
    or f32); scale and shift are f32 [Co]: (1, bias) plain, the folded BN
    for inference.  Any H, W, Cin, Co.  Returns [B,2H,2W,Co] in x's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Differentiable in every tensor argument."""
    if needs_grad(x, w, scale, shift):
        return _Upconv.apply(x, w, scale, shift, act)
    return _upconv_forward(x, w, scale, shift, act)


upconv3x3.launches = 0


def upconv3x3_bias(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   act: str = "none") -> torch.Tensor:
    """``act(conv3x3(upsample2_nearest(x), w) + b)``: the training-path
    up-block (a BN follows outside).  The same kernel as `upconv3x3` with
    scale 1, counted on `upconv3x3.launches`; its backward skips the scale
    gradient.  b is f32 [Co]."""
    if needs_grad(x, w, b):
        return _UpconvBias.apply(x, w, b, act)
    return _upconv_forward(x, w, torch.ones_like(b), b, act)


# ================= conv 5x5 s2: the weight gradient (both ops) ================

def conv5x5_s2_dw_plain(x: torch.Tensor, g: torch.Tensor,
                        w_dtype: torch.dtype,
                        flip: bool = False) -> torch.Tensor:
    """The adjoint in w of conv5x5_s2 SAME for the cotangent g
    [B,⌈H/2⌉,⌈W/2⌉,Co] (in x's dtype): dw[kh,kw] = the f32 product of the
    SAME-padded x's tap view (every second pixel from (kh, kw)) against g
    over every pixel, 25 matmuls; rounded once to w_dtype.  `flip`: in the
    transposed conv's weight layout, `deconv_dx_weight(dw)` [5,5,Co,Cin]."""
    b, h, wd, ci = x.shape
    co = g.shape[-1]
    ho, pt, pb = same_pads(h)
    wo, pl, pr = same_pads(wd)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    g2 = g.to(x.dtype).float().reshape(-1, co)
    dw = torch.empty(5, 5, ci, co, device=x.device)
    for kh in range(5):
        for kw in range(5):
            tap = xp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2, :]
            dw[kh, kw] = tap.reshape(-1, ci).T @ g2
    return (deconv_dx_weight(dw) if flip else dw).to(w_dtype)


def _cdw_lib() -> ctypes.CDLL:
    return _build.bind("conv5x5_s2_bwd", {
        # x, g, dw, ws; B, H, W, Cin, Co, bf16, w_bf16, tile_m, tile_n,
        # parts, cluster, chunk, flip; stream
        "t2i_conv5x5_s2_dw": [_PTR] * 4 + [_INT] * 13 + [_PTR],
        # x, g; H, W, Cin, Co, bf16
        "t2i_conv5x5_s2_dw_path": [_PTR] * 2 + [_INT] * 5,
        "t2i_conv5x5_s2_dw_mode": [],
        # csize, tile_m, tile_n
        "t2i_conv5x5_s2_dw_clusters": [_INT] * 3,
        # gc, w, dx; B, H, W, Cin, Co, kernel, tile_n, parts; stream
        "t2i_conv5x5_s2_dx": [_PTR] * 3 + [_INT] * 8 + [_PTR],
        # gc, w, dx; Cin, Co, bf16
        "t2i_conv5x5_s2_dx_path": [_PTR] * 3 + [_INT] * 3,
        "t2i_conv5x5_s2_dx_mode": [],
        # d, w, dx; B, H, W, Cin, Co, tile_n, parts; stream
        "t2i_deconv5x5_s2_dx": [_PTR] * 3 + [_INT] * 7 + [_PTR],
        # d, w, dx; Cin, Co, bf16
        "t2i_deconv5x5_s2_dx_path": [_PTR] * 3 + [_INT] * 3})


def conv_dw_path(h: int, w: int, cin: int, co: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """The Python mirror of `cdw_path` in csrc/conv5x5_s2_bwd.cu for x
    [B,h,w,Cin] (codes in DW_PATHS' order).  `aligned`: x and g start on
    16-byte boundaries.  wgmma needs an even map whose half has a TMA box
    (x's parity planes are coordinates of its tensor map); mma takes the
    RGB layers (Cin <= 4) too, gathering x an element a row."""
    if dtype != torch.bfloat16 or not aligned:
        return "tile"
    if (cin % 64 == 0 and co % 64 == 0 and h % 2 == 0 and w % 2 == 0
            and dw_box(h // 2, w // 2)):
        return "wgmma"
    return ("mma" if (cin % 8 == 0 or cin <= 4) and co % 8 == 0
            else "tile")


def conv_dw_plan(b: int, h: int, w: int, cin: int, co: int,
                 dtype: torch.dtype, aligned: bool = True) -> DwPlan:
    """The tile, the parts, their cluster and the chunk of conv5x5_s2_dw
    for x [b,h,w,Cin] (`_wgrad_plan` of its 25 products over k =
    b·⌈h/2⌉·⌈w/2⌉ pixels; a block is a tile of the 25·Cin rows of the
    product matrix, which are dw's (tap, ci))."""
    path = conv_dw_path(h, w, cin, co, dtype, aligned)
    tm, tn = _dw_tile(path, cin, co)
    k = b * same_pads(h)[0] * same_pads(w)[0]
    return _wgrad_plan(k, cin, co, 25, path, tm, tn,
                       lambda c: -(-25 * c // tm) * -(-co // tn))


def _cdw_shapes(x, g):
    if x.dim() != 4:
        raise ValueError(f"conv5x5_s2_dw: x must be NHWC, got "
                         f"{tuple(x.shape)}")
    b, h, wd, _ = x.shape
    want = (b, same_pads(h)[0], same_pads(wd)[0])
    if g.dim() != 4 or tuple(g.shape[:3]) != want:
        raise ValueError(f"conv5x5_s2_dw: g must be [{want[0]},{want[1]},"
                         f"{want[2]},Co], got {tuple(g.shape)}")


@profiling.spanned("kernels.conv5x5_s2_dw")
def _conv_dw_forward(x, g, w_dtype, flip=False, plan=None):
    b, h, wd, cin = x.shape
    co = g.shape[-1]
    aligned = _aligned16(x, g)
    plan = plan or conv_dw_plan(b, h, wd, cin, co, x.dtype, aligned)
    n_ws = plan_ws_elems(plan, co, 25)
    ws = (torch.empty(n_ws, dtype=torch.float32, device=x.device)
          if n_ws else None)
    dw = torch.empty((5, 5, co, cin) if flip else (5, 5, cin, co),
                     dtype=w_dtype, device=x.device)
    rc = _cdw_lib().t2i_conv5x5_s2_dw(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, h, wd, cin, co,
        int(x.dtype == torch.bfloat16), int(w_dtype == torch.bfloat16),
        plan.tile_m, plan.tile_n, plan.parts, plan.cluster, plan.chunk,
        int(flip), _stream(x))
    if rc != 0:
        raise RuntimeError(f"conv5x5_s2_dw kernel launch failed: CUDA error "
                           f"{rc}")
    conv5x5_s2_dw.launches += 1
    return dw


class _ConvDw(torch.autograd.Function):
    """dw is bilinear in (x, g): its adjoints are the conv's dx of g with
    the cotangent as the weight, and the conv of x with it (a cotangent in
    the flipped layout turned back to the conv's first)."""

    @staticmethod
    def forward(ctx, x, g, w_dtype, flip=False):
        ctx.save_for_backward(x, g)
        ctx.flip = flip
        return _conv_dw_forward(x, g, w_dtype, flip)

    @staticmethod
    def backward(ctx, gdw):
        x, g = ctx.saved_tensors
        need = ctx.needs_input_grad
        if ctx.flip:
            gdw = deconv_dx_weight(gdw)
        wd = gdw.to(x.dtype).contiguous()
        dx = conv_dx(g, wd, x.shape[1], x.shape[2]) if need[0] else None
        dg = None
        if need[1]:
            dg = conv5x5_s2_act(x, wd,
                                torch.zeros(g.shape[-1], device=x.device),
                                "none")
        return dx, dg, None, None


def conv5x5_s2_dw(x: torch.Tensor, g: torch.Tensor, w_dtype: torch.dtype,
                  flip: bool = False) -> torch.Tensor:
    """dw [5,5,Cin,Co] in w_dtype of conv5x5_s2 SAME over x [B,H,W,Cin]
    for the cotangent g [B,⌈H/2⌉,⌈W/2⌉,Co] in x's dtype: 25 long-K products
    summed in f32 over every pixel by one hand-written kernel, which writes
    dw itself where one cluster holds every part of K (the same bits every
    launch).  The transposed conv's dw is this with its cotangent as x and
    its input as g, flipped and transposed: `flip` has the kernel write it
    in that layout, [5,5,Co,Cin] = `deconv_dx_weight(dw)`, with no copy.
    CPU tensors take the plain version (in any float dtype, as the
    forwards' plain versions); CUDA tensors launch the kernel or raise.
    Differentiable in x and g."""
    _cdw_shapes(x, g)
    if x.device.type == "cpu":
        return conv5x5_s2_dw_plain(x, g, w_dtype, flip)
    if x.device.type != "cuda":
        raise ValueError(f"conv5x5_s2_dw runs on cuda or cpu, not {x.device}")
    _bwd_common("conv5x5_s2_dw", [("x", x), ("g", g)], w_dtype)
    if needs_grad(x, g):
        return _ConvDw.apply(x, g, w_dtype, flip)
    return _conv_dw_forward(x, g, w_dtype, flip)


conv5x5_s2_dw.launches = 0


def conv_dw_path_on_card(x, g) -> str:
    """The path t2i_conv5x5_s2_dw takes for these tensors."""
    return DW_PATHS[_cdw_lib().t2i_conv5x5_s2_dw_path(
        x.data_ptr(), g.data_ptr(), x.shape[1], x.shape[2], x.shape[-1],
        g.shape[-1], int(x.dtype == torch.bfloat16))]


def conv_dw_mode_on_card() -> frozenset:
    """What the last conv5x5_s2_dw launch of this process did (its C entry
    point's Mode bits)."""
    return _modes(_cdw_lib().t2i_conv5x5_s2_dw_mode())


# ================= conv 5x5 s2: the input gradient (conv5x5_s2_dx) ============

def conv5x5_s2_dx_plain(gc: torch.Tensor, w: torch.Tensor, h: int,
                        wd: int) -> torch.Tensor:
    """The adjoint in x of conv5x5_s2 SAME over an h×wd map for the
    cotangent gc [B,⌈h/2⌉,⌈wd/2⌉,Co]: 25 f32 tap matmuls with w as it lies,
    tap (kh, kw) adding gc·w[kh,kw]ᵀ to every second pixel of the
    SAME-padded map from (kh, kw), then the map cropped; rounded once to
    gc's dtype."""
    b, ho, wo, _ = gc.shape
    _, pt, pb = same_pads(h)
    _, pl, pr = same_pads(wd)
    dxp = torch.zeros(b, h + pt + pb, wd + pl + pr, w.shape[2],
                      device=gc.device)
    g32, w32 = gc.float(), w.float()
    for kh in range(5):
        for kw in range(5):
            dxp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2, :] += \
                g32 @ w32[kh, kw].T
    return dxp[:, pt:pt + h, pl:pl + wd].to(gc.dtype)


# the route of the conv's dx (csrc/conv5x5_s2_bwd.cu t2i_conv5x5_s2_dx_path:
# 0 the caller's deconv5x5_s2 route, 1 conv5x5_s2_dx); the kernel's two
# loops (CDxKernel); what a launch did (CDxMode bits)
CDX_PATHS = ("deconv", "wgmma")
CDX_KERNELS = ("ring", "patch")
CDX_MODES = ("tma_a", "cluster", "patch")
CDX_BM = 128                   # dx90::BM: pixels of a ring tile
CDX_TILES_N = (256, 128, 64)
CDX_PARTS = (1, 2, 4, 8)


def conv_dx_path(cin: int, co: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """The Python mirror of `cdx_applies` in csrc/conv5x5_s2_bwd.cu:
    `wgmma` (conv5x5_s2_dx) for bf16 with Cin and Co multiples of 64 on
    any map, `deconv` (deconv5x5_s2 of gc with w flipped and transposed)
    otherwise.  `aligned`: gc, w and dx start on 16-byte boundaries."""
    if (dtype == torch.bfloat16 and aligned and cin % 64 == 0
            and co % 64 == 0):
        return "wgmma"
    return "deconv"


class CdxPlan(NamedTuple):
    """A launch of conv5x5_s2_dx: the loop (`CDX_KERNELS`: the ring, or at
    Cin 64 on maps of 64-pixel plane rows the patch kernel, every tap of a
    parity from one staged patch), its tile (pixels of a parity plane ×
    input channels) and the parts of K, one cluster of them."""
    kernel: str
    tile_m: int
    tile_n: int
    parts: int


def _log2_ceil(n: int) -> int:
    return max(0, (n - 1).bit_length())


def cdx_box(b: int, ho: int, wo: int, bm: int):
    """(log2 pixels, log2 rows, log2 images, tiles of a parity) of the box
    of gc that is one tile of bm pixels of a ⌈h/2⌉×⌈w/2⌉ parity plane
    (csrc/conv5x5_s2_bwd.cu `cdx_box`): the row's power of two (at most
    bm), then rows, then images."""
    lbm = _log2_ceil(bm)
    lw = min(_log2_ceil(wo), lbm)
    lh = min(_log2_ceil(ho), lbm - lw)
    lb = lbm - lw - lh
    tiles = (-(-b // (1 << lb)) * -(-ho // (1 << lh))
             * -(-wo // (1 << lw)))
    return lw, lh, lb, tiles


# the parities' taps in launch order (the heaviest first)
CDX_PARITY_TAPS = (9, 6, 6, 4)
# The ring plan's cost model, in units of one 128x128x64 slice on one SM
# (ranks plans; not a prediction): work per product of each tile width
# relative to the 128x128 tile, a block's fixed cost, and the cost of each
# extra part of a cluster (its tile through distributed shared memory).
# Fitted to tools/conv_plan_sweep.py --ops cdx on the H100 (16 deep calls:
# the pick within 4 % of the fastest plan at each)
_CDX_TILE_COST = {256: 0.8, 128: 1.0, 64: 1.6}
_CDX_BLOCK_COST = 12.0
_CDX_PART_COST = 8.0


def cdx_patches(h: int, w: int) -> bool:
    """Whether the patch kernel's tiles, 8 plane rows of 64 pixels, cover
    dx's h×w map, viewed by parity plane (csrc/conv5x5_s2_bwd.cu
    `cdx_patches`): the 256 px D's 128² dx."""
    return h % 16 == 0 and w % 128 == 0


CDX_PATCH_TILE = (512, 64)     # 8 plane rows × 64 pixels, 64 channels


def conv_dx_candidates(b: int, h: int, w: int, cin: int, co: int):
    """Every plan conv5x5_s2_dx takes at this shape: the ring at each tile
    width dividing Cin with 1, 2, 4 or 8 parts (at most the lightest
    parity's 4·Co/64 items), whose grid fits the launch's y extent; at Cin
    64 on maps with `cdx_patches` the patch kernel (one part)."""
    tiles = cdx_box(b, -(-h // 2), -(-w // 2), CDX_BM)[3]
    plans = [CdxPlan("ring", CDX_BM, tn, parts)
             for tn in CDX_TILES_N
             if cin % tn == 0 and 4 * tiles * (cin // tn) <= 65535
             for parts in CDX_PARTS if parts <= 4 * (co // 64)]
    if cin == 64 and cdx_patches(h, w):
        plans.append(CdxPlan("patch", *CDX_PATCH_TILE, 1))
    return plans


def conv_dx_blocks(b: int, h: int, w: int, cin: int, plan: CdxPlan) -> int:
    """Tiles × parts of a launch: 4 parities × tiles × column tiles × parts
    (the patch kernel's persistent CTAs walk its tiles)."""
    if plan.kernel == "patch":
        return 4 * b * (h // 16) * (w // 128)
    tiles = cdx_box(b, -(-h // 2), -(-w // 2), plan.tile_m)[3]
    return 4 * tiles * (cin // plan.tile_n) * plan.parts


def conv_dx_cost(b: int, h: int, w: int, cin: int, co: int,
                 plan: CdxPlan) -> float:
    """The model's relative time of a ring plan: its CTAs in launch order
    (the parities heaviest first, each tile's parts together) handed to
    the SMs' block slots (one a SM for the 256-wide tile, two otherwise,
    each then at half the rate), each its part's items at the tile's cost
    plus a block's and the cluster's fixed costs."""
    tiles = cdx_box(b, -(-h // 2), -(-w // 2), plan.tile_m)[3]
    per_sm = 1 if plan.tile_n == 256 else 2
    per_item = (plan.tile_m * plan.tile_n / 16384.0
                * _CDX_TILE_COST[plan.tile_n])
    durations = []
    for taps in CDX_PARITY_TAPS:
        d = per_sm * (-(-taps * (co // 64) // plan.parts) * per_item
                      + _CDX_BLOCK_COST
                      + (plan.parts - 1) * _CDX_PART_COST)
        durations += [d] * (tiles * (cin // plan.tile_n) * plan.parts)
    return _makespan(durations, per_sm * SM_COUNT)


@functools.lru_cache(maxsize=None)   # a training run repeats a few shapes
def conv_dx_plan(b: int, h: int, w: int, cin: int, co: int) -> CdxPlan:
    """The plan of conv5x5_s2_dx for dx [b,h,w,Cin] and Co: among
    `conv_dx_candidates`, the patch kernel where it is one of them;
    otherwise those that give every SM a CTA (where none does, those with
    the most), the cheapest by `conv_dx_cost`; ties to fewer parts, then
    the wider tile.  No plan has a workspace: every part of a
    tile is in its cluster."""
    cands = conv_dx_candidates(b, h, w, cin, co)
    if not cands:
        raise ValueError(f"conv5x5_s2_dx: no plan for {(b, h, w, cin)}->{co}")
    if cands[-1].kernel == "patch":
        return cands[-1]
    return min(cands, key=lambda p: (
        -min(conv_dx_blocks(b, h, w, cin, p), SM_COUNT),
        conv_dx_cost(b, h, w, cin, co, p), p.parts, -p.tile_n))


def conv_dx_modes(plan: CdxPlan) -> frozenset:
    """The Python mirror of the CDxMode bits a launch reports."""
    modes = {"tma_a"}
    if plan.parts > 1:
        modes.add("cluster")
    if plan.kernel == "patch":
        modes.add("patch")
    return frozenset(modes)


def conv_dx_route(b: int, h: int, w: int, cin: int, co: int,
                  dtype: torch.dtype) -> str:
    """A tag of the route `conv_dx` takes (tools and the smoke run): the
    kernel with its plan, or the deconv and its path."""
    if conv_dx_path(cin, co, dtype) == "wgmma":
        p = conv_dx_plan(b, h, w, cin, co)
        return (f"conv5x5_s2_dx {p.kernel} {p.tile_m}x{p.tile_n} parts "
                f"{p.parts}")
    return f"deconv5x5_s2 {deconv_path(co, cin, dtype)}"


def _cdx_check(gc, w, h, wd):
    if w.dim() != 4 or tuple(w.shape[:2]) != (5, 5):
        raise ValueError(f"conv5x5_s2_dx: w must be [5,5,Cin,Co], got "
                         f"{tuple(w.shape)}")
    want = (same_pads(h)[0], same_pads(wd)[0], w.shape[3])
    if gc.dim() != 4 or tuple(gc.shape[1:]) != want:
        raise ValueError(f"conv5x5_s2_dx: gc must be [B,{want[0]},{want[1]},"
                         f"{want[2]}], got {tuple(gc.shape)}")
    _bwd_common("conv5x5_s2_dx", [("gc", gc), ("w", w)], gc.dtype)
    if gc.shape[0] * h * wd * w.shape[2] >= 2**31:
        raise ValueError("conv5x5_s2_dx: dx too large for the kernel's "
                         "int32 extents")


@profiling.spanned("kernels.conv5x5_s2_dx")
def _conv_dx_forward(gc, w, h, wd, plan=None):
    if gc.device.type == "cpu":
        return conv5x5_s2_dx_plain(gc, w, h, wd)
    if gc.device.type != "cuda":
        raise ValueError(f"conv5x5_s2_dx runs on cuda or cpu, not "
                         f"{gc.device}")
    b, cin, co = gc.shape[0], w.shape[2], w.shape[3]
    dx = torch.empty(b, h, wd, cin, dtype=gc.dtype, device=gc.device)
    if conv_dx_path(cin, co, gc.dtype, _aligned16(gc, w, dx)) != "wgmma":
        raise ValueError(f"conv5x5_s2_dx takes bf16 with Cin and Co "
                         f"multiples of 64, not {gc.dtype} {cin}->{co}")
    plan = plan or conv_dx_plan(b, h, wd, cin, co)
    rc = _cdw_lib().t2i_conv5x5_s2_dx(
        gc.data_ptr(), w.data_ptr(), dx.data_ptr(), b, h, wd, cin, co,
        CDX_KERNELS.index(plan.kernel), plan.tile_n, plan.parts, _stream(gc))
    if rc != 0:
        raise RuntimeError(f"conv5x5_s2_dx kernel launch failed: CUDA error "
                           f"{rc}")
    conv5x5_s2_dx.launches += 1
    return dx


class _ConvDx(torch.autograd.Function):
    """dx is linear in gc and in w: its adjoints are the conv of the
    cotangent with w (the forward the dx is the adjoint of) and the conv's
    weight gradient with the cotangent as x and gc as g, both on kernels,
    both differentiable again."""

    @staticmethod
    def forward(ctx, gc, w, h, wd):
        ctx.save_for_backward(gc, w)
        return _conv_dx_forward(gc, w, h, wd)

    @staticmethod
    def backward(ctx, gdx):
        gc, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        gdx = gdx.to(gc.dtype).contiguous()
        dgc = dw = None
        if need[0]:
            dgc = conv5x5_s2_act(gdx, w, torch.zeros(w.shape[3],
                                                     device=gc.device),
                                 "none")
        if need[1]:
            dw = conv5x5_s2_dw(gdx, gc, w.dtype)
        return dgc, dw, None, None


def conv5x5_s2_dx(gc: torch.Tensor, w: torch.Tensor, h: int, wd: int,
                  plan: CdxPlan = None) -> torch.Tensor:
    """dx [B,h,wd,Cin] of conv5x5_s2 SAME for the cotangent gc
    [B,⌈h/2⌉,⌈wd/2⌉,Co] (the activation's derivative already in it) and w
    [5,5,Cin,Co] in gc's dtype, by one hand-written kernel (four parity
    GEMMs of 9, 6, 6 and 4 taps, w read as it lies, the parts of K of a
    tile summed in a cluster; `plan` overrides `conv_dx_plan`: a sweep's).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (bf16, Cin and Co multiples of 64) or raise.  Differentiable in gc and
    w, at every order on kernels."""
    _cdx_check(gc, w, h, wd)
    if needs_grad(gc, w):
        return _ConvDx.apply(gc, w, h, wd)
    return _conv_dx_forward(gc, w, h, wd, plan)


conv5x5_s2_dx.launches = 0


def conv_dx_path_on_card(gc, w, dx) -> str:
    """The route t2i_conv5x5_s2_dx_path reports for these tensors."""
    return CDX_PATHS[_cdw_lib().t2i_conv5x5_s2_dx_path(
        gc.data_ptr(), w.data_ptr(), dx.data_ptr(), w.shape[2], w.shape[3],
        int(gc.dtype == torch.bfloat16))]


def conv_dx_mode_on_card() -> frozenset:
    """What the last conv5x5_s2_dx launch of this process did (its C entry
    point's CDxMode bits)."""
    bits = _cdw_lib().t2i_conv5x5_s2_dx_mode()
    return frozenset(n for i, n in enumerate(CDX_MODES) if bits >> i & 1)


# ============ transposed conv 5x5 s2: the input gradient (deconv5x5_s2_dx) ===

def deconv5x5_s2_dx_plain(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The adjoint in x of deconv5x5_s2 for its cotangent d [B,2H,2W,Co]
    and w [5,5,Cin,Co]: 25 f32 tap matmuls over d padded (1, 2), tap (kh,
    kw) reading every second pixel from (kh, kw) against w[4−kh, 4−kw] as
    it lies (contracted over Co); rounded once to d's dtype."""
    b, h2, w2, _ = d.shape
    h, wd = h2 // 2, w2 // 2
    dp = F.pad(d.float(), (0, 0, 1, 2, 1, 2))
    w32 = w.float()
    acc = torch.zeros(b, h, wd, w.shape[2], device=d.device)
    for kh in range(5):
        for kw in range(5):
            tap = dp[:, kh:kh + 2 * h - 1:2, kw:kw + 2 * wd - 1:2, :]
            acc = acc + tap @ w32[4 - kh, 4 - kw].T
    return acc.to(d.dtype)


# the paths of the deconv's dx (csrc/conv5x5_s2_bwd.cu DDxPath: 0 the
# caller's conv5x5_s2_act route, 1 the ring, 2 the thin path); the ring's
# tile widths and parts of K (4 and 8 parts lost at every generator call
# of tools/conv_plan_sweep.py --ops ddx, so the plan offers 1 and 2)
DDX_PATHS = ("conv", "ring", "thin")
DDX_TILES_N = (256, 128, 64)
DDX_PARTS = (1, 2)


def deconv_dx_path(cin: int, co: int, dtype: torch.dtype,
                   aligned: bool = True) -> str:
    """The Python mirror of `ddx_path` in csrc/conv5x5_s2_bwd.cu for the
    deconv's w [5,5,Cin,Co]: bf16 with Cin a multiple of 64 takes `ring`
    where Co is a multiple of 64 (every deep generator layer) and `thin`
    where Co <= 4 (the RGB layer, the critic's first-layer dx in the
    gradient penalty); everything else `conv` (conv5x5_s2_act of d with w
    flipped and transposed and a zero bias).  `aligned`: d, w and dx start
    on 16-byte boundaries."""
    if dtype != torch.bfloat16 or not aligned or cin % 64:
        return "conv"
    if co % 64 == 0:
        return "ring"
    return "thin" if co <= 4 else "conv"


class DdxPlan(NamedTuple):
    """A launch of deconv5x5_s2_dx: the path (`ring` or `thin`), its tile
    (pixels of dx × its channels) and the parts of K of the ring, one
    cluster of them."""
    kernel: str
    tile_m: int
    tile_n: int
    parts: int


# The ring plan's cost model, in units of one 128x128x64 slice on one SM
# (ranks plans; not a prediction): work per product of each tile width
# relative to the 128x128 tile, a block's fixed cost, and the cost of each
# extra part of a cluster (its f32 tile through distributed shared memory);
# conv_dx_cost's form, in whole waves of one CTA an SM.  Fitted to the
# ring's twelve plans (1, 2, 4, 8 parts) at each of the generator's three
# deep calls on the H100 (tools/conv_plan_sweep.py --ops ddx): the pick is
# the fastest at each.  It ranks by cost alone: a second part to fill the card lost at
# 16²×256 (128 CTAs of the 256-wide tile)
_DDX_TILE_COST = {256: 0.6, 128: 1.0, 64: 1.6}
_DDX_BLOCK_COST = 12.0
_DDX_PART_COST = 24.0


def deconv_dx_candidates(b: int, h: int, w: int, cin: int, co: int):
    """Every plan deconv5x5_s2_dx takes for dx [b,h,w,Cin] and Co: the ring
    at each tile width dividing Cin with each of DDX_PARTS, its grid
    within the launch's y extent; the thin path's one tile (128 pixels ×
    128 channels, 64 where Cin is not a multiple of 128)."""
    path = deconv_dx_path(cin, co, torch.bfloat16)
    if path == "thin":
        return [DdxPlan("thin", 128, 128 if cin % 128 == 0 else 64, 1)]
    if path != "ring":
        return []
    tiles = cdx_box(b, h, w, CDX_BM)[3]
    return [DdxPlan("ring", CDX_BM, tn, parts)
            for tn in DDX_TILES_N
            if cin % tn == 0 and tiles * (cin // tn) <= 65535
            for parts in DDX_PARTS]


def deconv_dx_blocks(b: int, h: int, w: int, cin: int, plan: DdxPlan) -> int:
    """CTAs of a ring launch: tiles × column tiles × parts."""
    tiles = cdx_box(b, h, w, plan.tile_m)[3]
    return tiles * (cin // plan.tile_n) * plan.parts


def deconv_dx_cost(b: int, h: int, w: int, cin: int, co: int,
                   plan: DdxPlan) -> float:
    """The model's relative time of a ring plan: its CTAs, each its part of
    the 25·Co/64 items at the tile's cost plus a block's and the cluster's
    fixed costs, in whole waves of one CTA an SM (DDxRing's deep ring)."""
    per_item = (plan.tile_m * plan.tile_n / 16384.0
                * _DDX_TILE_COST[plan.tile_n])
    d = (-(-25 * (co // 64) // plan.parts) * per_item
         + _DDX_BLOCK_COST + (plan.parts - 1) * _DDX_PART_COST)
    return -(-deconv_dx_blocks(b, h, w, cin, plan) // SM_COUNT) * d


@functools.lru_cache(maxsize=None)   # a training run repeats a few shapes
def deconv_dx_plan(b: int, h: int, w: int, cin: int, co: int) -> DdxPlan:
    """The plan of deconv5x5_s2_dx for dx [b,h,w,Cin] and Co: the thin
    path's tile, or the ring's candidate cheapest by `deconv_dx_cost`;
    ties to fewer parts, then the wider tile.  No plan has a workspace:
    every part of a tile is in its cluster."""
    cands = deconv_dx_candidates(b, h, w, cin, co)
    if not cands:
        raise ValueError(f"deconv5x5_s2_dx: no plan for {(b, h, w, cin)}"
                         f"->{co}")
    if cands[0].kernel == "thin":
        return cands[0]
    return min(cands, key=lambda p: (
        deconv_dx_cost(b, h, w, cin, co, p), p.parts, -p.tile_n))


def deconv_dx_route(b: int, h: int, w: int, cin: int, co: int,
                    dtype: torch.dtype) -> str:
    """A tag of the route `deconv_dx` takes for dx [b,h,w,Cin] (tools and
    the smoke run): the kernel with its plan, or the conv and its path."""
    if deconv_dx_path(cin, co, dtype) != "conv":
        p = deconv_dx_plan(b, h, w, cin, co)
        return (f"deconv5x5_s2_dx {p.kernel} {p.tile_m}x{p.tile_n} parts "
                f"{p.parts}")
    return f"conv5x5_s2_act {conv_path(co, cin, dtype)}"


def _ddx_check(d, w):
    if w.dim() != 4 or tuple(w.shape[:2]) != (5, 5):
        raise ValueError(f"deconv5x5_s2_dx: w must be [5,5,Cin,Co], got "
                         f"{tuple(w.shape)}")
    if (d.dim() != 4 or d.shape[1] % 2 or d.shape[2] % 2
            or d.shape[3] != w.shape[3]):
        raise ValueError(f"deconv5x5_s2_dx: d must be [B,2H,2W,"
                         f"{w.shape[3]}], got {tuple(d.shape)}")
    _bwd_common("deconv5x5_s2_dx", [("d", d), ("w", w)], d.dtype)
    if d.numel() // 4 // w.shape[3] * w.shape[2] >= 2**31:
        raise ValueError("deconv5x5_s2_dx: dx too large for the kernel's "
                         "int32 extents")


@profiling.spanned("kernels.deconv5x5_s2_dx")
def _deconv_dx_forward(d, w, plan=None):
    if d.device.type == "cpu":
        return deconv5x5_s2_dx_plain(d, w)
    if d.device.type != "cuda":
        raise ValueError(f"deconv5x5_s2_dx runs on cuda or cpu, not "
                         f"{d.device}")
    b, h, wd = d.shape[0], d.shape[1] // 2, d.shape[2] // 2
    cin, co = w.shape[2], w.shape[3]
    dx = torch.empty(b, h, wd, cin, dtype=d.dtype, device=d.device)
    if deconv_dx_path(cin, co, d.dtype, _aligned16(d, w, dx)) == "conv":
        raise ValueError(f"deconv5x5_s2_dx takes bf16 with Cin a multiple "
                         f"of 64 and Co a multiple of 64 or at most 4, not "
                         f"{d.dtype} {cin}->{co}")
    plan = plan or deconv_dx_plan(b, h, wd, cin, co)
    rc = _cdw_lib().t2i_deconv5x5_s2_dx(
        d.data_ptr(), w.data_ptr(), dx.data_ptr(), b, h, wd, cin, co,
        plan.tile_n, plan.parts, _stream(d))
    if rc != 0:
        raise RuntimeError(f"deconv5x5_s2_dx kernel launch failed: CUDA "
                           f"error {rc}")
    deconv5x5_s2_dx.launches += 1
    return dx


class _DeconvDx(torch.autograd.Function):
    """dx is linear in d and in w: its adjoints are the transposed conv of
    the cotangent with w (the forward whose dx it is) and the weight
    gradient of the conv of d with w flipped and transposed, written in the
    deconv's layout (conv5x5_s2_dw with flip), both on kernels, both
    differentiable again."""

    @staticmethod
    def forward(ctx, d, w):
        ctx.save_for_backward(d, w)
        return _deconv_dx_forward(d, w)

    @staticmethod
    def backward(ctx, gdx):
        d, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        gdx = gdx.to(d.dtype).contiguous()
        dd = dw = None
        if need[0]:
            co = w.shape[3]
            dd = deconv5x5_s2(gdx, w, torch.ones(co, device=d.device),
                              torch.zeros(co, device=d.device), "none")
        if need[1]:
            dw = conv5x5_s2_dw(d, gdx, w.dtype, True)
        return dd, dw


def deconv5x5_s2_dx(d: torch.Tensor, w: torch.Tensor,
                    plan: DdxPlan = None) -> torch.Tensor:
    """dx [B,H,W,Cin] of deconv5x5_s2 for its cotangent d [B,2H,2W,Co]
    (the activation's derivative and the scale already in it) and w
    [5,5,Cin,Co] in d's dtype, by one hand-written kernel: w read as it
    lies (no flipped copy), no bias, the parts of K of a tile summed in a
    cluster (`plan` overrides `deconv_dx_plan`: a sweep's).  CPU tensors
    take the plain version; CUDA tensors launch the kernel (bf16, Cin a
    multiple of 64, Co a multiple of 64 or at most 4) or raise.
    Differentiable in d and w, at every order on kernels."""
    _ddx_check(d, w)
    if needs_grad(d, w):
        return _DeconvDx.apply(d, w)
    return _deconv_dx_forward(d, w, plan)


deconv5x5_s2_dx.launches = 0


def deconv_dx(d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of deconv5x5_s2 for its cotangent d, the route chosen by shape
    (`deconv_dx_path`): `deconv5x5_s2_dx` (bf16 with Cin a multiple of 64
    and Co a multiple of 64 or at most 4), else conv5x5_s2 of d with
    `deconv_dx_weight(w)` and a zero bias through the differentiable
    `conv5x5_s2_act` (f32, ragged channels)."""
    if deconv_dx_path(w.shape[2], w.shape[3], d.dtype,
                      _aligned16(d, w)) != "conv":
        return deconv5x5_s2_dx(d, w)
    return conv5x5_s2_act(d, deconv_dx_weight(w),
                          torch.zeros(w.shape[2], device=d.device), "none")


def deconv_dx_path_on_card(d, w, dx) -> str:
    """The path t2i_deconv5x5_s2_dx_path reports for these tensors."""
    return DDX_PATHS[_cdw_lib().t2i_deconv5x5_s2_dx_path(
        d.data_ptr(), w.data_ptr(), dx.data_ptr(), w.shape[2], w.shape[3],
        int(d.dtype == torch.bfloat16))]

