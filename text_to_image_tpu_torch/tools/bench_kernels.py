"""The port's kernel microbench on one NVIDIA GPU (counterpart of the JAX
package's ``scripts/bench_pallas.py``): every kernel at every main-path
shape against one PyTorch library call that computes the same function.

    python -m text_to_image_tpu_torch.tools.bench_kernels
    python -m text_to_image_tpu_torch.tools.bench_kernels --upconv --grad
    python -m text_to_image_tpu_torch.tools.bench_kernels --conv --deconv --grad

At its defaults, bf16 at batch 64 (the discriminator's calls at its 3·64
rows too): ``deconv5x5_s2`` at the GAN-CLS generator's four calls beside
cuDNN's ``conv_transpose2d``; ``conv5x5_s2_act`` at the 64 px
discriminator's four calls beside cuDNN's ``conv2d`` + the activation;
``upconv3x3_bias`` at the StackGAN generators' eight up-blocks and the
C-PGGAN shapes of ``bench_pallas.py`` beside ``F.interpolate`` +
``conv2d``; ``conditioning_join`` beside ``addmm`` over the built concat;
the four batch-norm kernels at the GAN-CLS generator's and
discriminator's calls and Stage-II's two largest beside PyTorch's
``batch_norm_stats`` / ``batch_norm_elemt`` / ``batch_norm_backward_reduce``
/ ``batch_norm_backward_elemt`` on each stream.  Each output is held
against the kernel's plain version on the same inputs before it is timed;
a disagreement raises.  Each row gives the kernel's ms, the library call's
ms, the bound (bytes at 3.35 TB/s or operations at 989 TFLOP/s in bf16, 67
TFLOP/s in f32, the larger), the kernel/library ratio and the path, tile
and split (or batch-norm plan) read back from the C entry point.

``--upconv --grad`` times ``upconv3x3_bias``'s forward and backward (its
``autograd.Function``: the kernel forward, the ``upconv3x3_dx`` and
``upconv3x3_dw`` kernels backward) against autograd through
``F.interpolate`` + ``F.conv2d``, at ``bench_pallas.py``'s five gradient
shapes and the eight up-blocks of a Stage-II forward, after holding its
gradients against autograd through the plain version in f32 (TF32 off) on
two images of each shape; then each of the two backward kernels alone at
those shapes and the six C-PGGAN up-blocks, beside its plain version and
one library call: for dx the backward of autograd through
``F.interpolate`` + ``F.conv2d`` with x alone requiring a gradient, for dw
``torch.nn.grad.conv2d_weight`` over the materialised upsampled x.

``--conv --grad`` and ``--deconv --grad`` do the same for the two 5×5
stride-2 ops at their main-path shapes: forward + backward (the
``autograd.Function``: the forward kernel, the dx kernel, dw on
``conv5x5_s2_dw``) against autograd through cuDNN's ``conv2d`` /
``conv_transpose2d``, after the f32 gradients are held on two images; then
dx (``conv5x5_s2_dx`` for the conv, its row tagged with its plan and the
modes its launch reports, or ``deconv5x5_s2`` at the RGB layer;
``deconv5x5_s2_dx`` for the deconv, tagged alike, its whole route
``conv.deconv_dx`` timed) and dw alone beside their plain versions and
cuDNN's ``conv2d_input`` (the deconv's: ``conv2d`` over the padded
cotangent) and ``conv2d_weight`` over the SAME-padded input; then ``conv5x5_s2_dw`` alone at every main-path call
(``CONV_DW_CALLS``: the 64 px and 256 px discriminators' convs at 3·64 and
64 rows, the generator's deconvs in their own weight layout) beside
``conv2d_weight``, each dw row tagged with its plan: tile, parts of K and
how many a cluster sums on chip, dw written directly or through a
workspace.  The flags combine: one call, one build.

Times are CUDA-event medians over launches each after an L2 flush
(`time_ms`; ``chip_smoke.py`` times its kernels with the same function).
Prints a markdown table and the card's name and power limit, and writes
``chiprun_out/bench_kernels.json`` (``bench_kernels_grad.json`` for
``--grad``) under the working directory.  Needs a GPU.

Not ported: ``bench_pallas.py``'s ``--train``, ``--eval`` and
``--train-graph`` A/B the JAX package's dispatch table between its Pallas
kernels and XLA; the port has no such table (every call on the card runs
its kernel).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version, bf16: a rounding flip (2^-7 relative) after f32
# sums taken in another order
TOL = (1e-2, 1e-2)
# the batch-norm statistics and backward sums are f32: sums over up to
# 4 M rows in another order
STATS_TOL = (1e-5, 1e-5)
GRAD_REL = 1e-4
# device spin before a timed call whose host side is long (autograd, the
# batch-norm wrappers): ~2 ms
HOST_SPIN = 4_000_000

B = 64
# (B, H, W, Cin), Co, act
DECONV_SHAPES = [((B, 4, 4, 1024), 512, "relu"), ((B, 8, 8, 512), 256, "relu"),
                 ((B, 16, 16, 256), 128, "relu"), ((B, 32, 32, 128), 3, "tanh")]
CONV_SHAPES = [((b, 64, 64, 3), 64, "lrelu") for b in (3 * B, B)] + [
    ((b, r, r, cin), 2 * cin, "none") for b in (3 * B, B)
    for r, cin in ((32, 64), (16, 128), (8, 256))]
# the StackGAN generators' up-blocks (a BN follows: no act), then the
# C-PGGAN shapes of bench_pallas.py that are not among them (lrelu)
STACKGAN_UPCONV = [((B, 4, 4, 1024), 512), ((B, 8, 8, 512), 256),
                   ((B, 16, 16, 256), 128), ((B, 32, 32, 128), 64),
                   ((B, 16, 16, 512), 256), ((B, 32, 32, 256), 128),
                   ((B, 64, 64, 128), 64), ((B, 128, 128, 64), 64)]
UPCONV_SHAPES = ([(s, co, "none") for s, co in STACKGAN_UPCONV]
                 + [((B, 32, 32, 128), 128, "lrelu"),
                    ((B, 128, 128, 64), 32, "lrelu"),
                    ((B, 64, 64, 512), 256, "lrelu")])
# bench_pallas.py --upconv --grad's five, then Stage-II's eight not among
# them
UPCONV_GRAD_SHAPES = list(dict.fromkeys(
    [((B, 16, 16, 256), 128), ((B, 32, 32, 256), 128),
     ((B, 64, 64, 128), 64), ((B, 128, 128, 64), 32),
     ((B, 64, 64, 512), 256)] + STACKGAN_UPCONV))
# (B, H, W, Cin) → Co: the upconv3x3_bias calls of the C-PGGAN generator's
# up-blocks (lrelu fused, PixelNorm after): stages 2-5 at 64 px (B 64), and
# the two calls only the 256 px progression adds (stages 6-7, B 32)
PGGAN_UPCONV_SHAPES = [((B, 4, 4, 512), 512), ((B, 8, 8, 512), 512),
                       ((B, 16, 16, 512), 256), ((B, 32, 32, 256), 128),
                       ((32, 64, 64, 128), 64), ((32, 128, 128, 64), 32)]
# the dx and dw rows: the gradient shapes, then the C-PGGAN ones not among
# them
UPCONV_BWD_SHAPES = list(dict.fromkeys(UPCONV_GRAD_SHAPES
                                       + PGGAN_UPCONV_SHAPES))
# (B, H, W, Cin), Co, flip of every conv5x5_s2_dw call on the training
# paths: the 64 px D at 3·64 and 64 rows, the 256 px D, the GAN-CLS
# generator's deconvs (their d as the map, x's channels as Co, written in
# the deconv's weight layout)
CONV_DW_CALLS = ([((b, 64, 64, 3), 64, False) for b in (3 * B, B)]
                 + [((b, r, r, c), 2 * c, False) for b in (3 * B, B)
                    for r, c in ((32, 64), (16, 128), (8, 256))]
                 + [((b, 256, 256, 3), 64, False) for b in (3 * B, B)]
                 + [((b, r, r, cin), co, False) for b in (3 * B, B)
                    for r, cin, co in ((128, 64, 128), (64, 128, 256),
                                       (32, 256, 512), (16, 512, 512),
                                       (8, 512, 512))]
                 + [((B, 2 * h, 2 * w, co), cin, True)
                    for (_, h, w, cin), co, _ in DECONV_SHAPES])
# (B, H, W, Cx), E, Co: the discriminator's text join over the D step's
# three streams and the G step's one
JOIN_SHAPES = [((3 * B, 4, 4, 512), 128, 512), ((B, 4, 4, 512), 128, 512)]
# (x, streams, act): the GAN-CLS generator's four BN calls, the 64 px
# discriminator's three over its three streams, Stage-II's two largest
BN_CALLS = ([((B, 4, 4, 1024), 1, "relu"), ((B, 8, 8, 512), 1, "relu"),
             ((B, 16, 16, 256), 1, "relu"), ((B, 32, 32, 128), 1, "relu")]
            + [((3 * B, r, r, c), 3, "lrelu")
               for r, c in ((16, 128), (8, 256), (4, 512))]
            + [((B, 128, 128, 64), 1, "relu"), ((B, 256, 256, 64), 1, "relu")])
BN_STEPS = ("bn_stats", "bn_act", "bn_bwd_reduce", "bn_bwd_apply")
# the kernel of each row of the default table, and of each op's ``--grad``
# table: the forward + backward row, then the backward's kernels alone (the
# conv's dx conv5x5_s2_dx, or at the RGB layer, Cin 3, the transposed conv:
# CONV_DX_VIA_DECONV; the deconv's dx deconv5x5_s2_dx, or for f32 and
# ragged channels the conv's forward kernel: DECONV_DX_VIA_CONV)
KERNELS = ("deconv5x5_s2", "conv5x5_s2_act", "upconv3x3_bias",
           "conditioning_join", *BN_STEPS)
GRAD_TABLES = {
    "upconv": ("upconv3x3_bias fwd+bwd", "upconv3x3_dx", "upconv3x3_dw"),
    "conv": ("conv5x5_s2_act fwd+bwd", "conv5x5_s2_dx", "conv5x5_s2_dw"),
    "deconv": ("deconv5x5_s2 fwd+bwd", "deconv5x5_s2_dx", "conv5x5_s2_dw")}
CONV_DX_VIA_DECONV = "deconv5x5_s2 (conv dx)"
DECONV_DX_VIA_CONV = "conv5x5_s2_act (deconv dx)"
GRAD_KERNELS = GRAD_TABLES["upconv"]
# the kernels that only the backwards launch
BACKWARD_KERNELS = ("upconv3x3_dx", "upconv3x3_dw", "conv5x5_s2_dw",
                    "conv5x5_s2_dx", "deconv5x5_s2_dx")


class L2Flush:
    """Evicts the 50 MB L2 by writing a larger buffer."""

    def __init__(self, device):
        self.buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


def time_ms(fn, flush, iters=20, warmup=3, spin=200_000):
    """Median device time of fn() over `iters` launches, each measured
    with CUDA events after an L2 flush.  A spin of `spin` cycles (~0.1 ms
    by default) on the device after the flush keeps the host's launch
    overhead out of the window; a call whose host side takes longer (a
    Python wrapper, autograd) needs a longer one (HOST_SPIN)."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound(nbytes, flops, dtype):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the peak rate of `dtype`."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def randn(gen: torch.Generator, *shape) -> torch.Tensor:
    """N(0, 1) of `shape` drawn on the generator's device."""
    return torch.randn(*shape, generator=gen, device=gen.device)


def rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(*shape, generator=gen, device=gen.device)


def half(n: int) -> int:
    """The output size of a SAME 5×5 stride-2 conv."""
    return (n + 1) // 2


def s2_taps(n: int) -> int:
    """The (output, tap) pairs along one axis of a 5×5 stride-2 SAME conv
    over an n-long input whose tap lands inside the input (the pads take
    the rest): the conv, its transposed conv and both gradients pair the
    same indices, so each does s2_taps(H)·s2_taps(W) products a channel
    pair, not 25 an output pixel."""
    no = half(n)
    lo = ((no - 1) * 2 + 5 - n) // 2   # the SAME pad before the map
    return sum(1 for i in range(no) for k in range(5)
               if 0 <= 2 * i + k - lo < n)


def up_taps(n: int) -> int:
    """The same for upconv3x3 over an n-long input: each of the 2n outputs
    sums two combined taps of the input, less the one past each end."""
    return 4 * n - 2


def s2_ops(b, h, w, cin, co) -> int:
    """Operations of a 5×5 stride-2 SAME conv of [b,h,w,Cin] into Co
    channels (or of its transposed conv, or either gradient)."""
    return 2 * b * s2_taps(h) * s2_taps(w) * cin * co


def deconv_work(shape, co, esize=2):
    """(bytes, operations) of one deconv5x5_s2: x, w, scale, shift and y
    once; 2 operations a product whose tap lands in the 2H×2W map."""
    b, h, w, cin = shape
    nb = esize * (b * h * w * cin + 25 * cin * co + b * 4 * h * w * co) + 8 * co
    return nb, s2_ops(b, 2 * h, 2 * w, cin, co)


def conv_work(shape, co, esize=2):
    """(bytes, operations) of one conv5x5_s2_act: x, w, bias and y once;
    the products whose tap lands in x."""
    b, h, w, cin = shape
    m = b * half(h) * half(w)
    return (esize * (b * h * w * cin + 25 * cin * co + m * co) + 4 * co,
            s2_ops(b, h, w, cin, co))


def upconv_work(shape, co, esize=2):
    """(bytes, operations) of one upconv3x3_bias: x, w, bias and y once;
    the combined taps (4 for each of the 4 output parities) that land in
    x."""
    b, h, w, cin = shape
    return (esize * (b * h * w * cin + 9 * cin * co + b * 4 * h * w * co)
            + 4 * co, 2 * b * up_taps(h) * up_taps(w) * cin * co)


def upconv_grad_work(shape, co, esize=2):
    """(bytes, operations) of upconv3x3_bias forward and backward: the
    forward's, then g, x and w read and dx, dw, db written; dx and dw each
    as many multiply-adds as the forward."""
    b, h, w, cin = shape
    fb, fo = upconv_work(shape, co, esize)
    return (fb + esize * (b * 4 * h * w * co + 2 * b * h * w * cin
                          + 2 * 9 * cin * co) + 4 * co, 3 * fo)


def upconv_dx_work(shape, co, esize=2):
    """(bytes, operations) of one upconv3x3_dx: g and w read once, dx
    written once; the forward's products."""
    b, h, w, cin = shape
    return (esize * (b * 4 * h * w * co + 9 * cin * co + b * h * w * cin),
            upconv_work(shape, co, esize)[1])


def upconv_dw_work(shape, co, esize=2):
    """(bytes, operations) of one upconv3x3_dw: x and g read once, dw
    written once; the forward's products."""
    b, h, w, cin = shape
    return (esize * (b * h * w * cin + b * 4 * h * w * co + 9 * cin * co),
            upconv_work(shape, co, esize)[1])


def conv_dw_work(shape, co, esize=2):
    """(bytes, operations) of one conv5x5_s2_dw for x `shape` and Co: x
    and g read once, dw written once; the forward's products."""
    b, h, w, cin = shape
    m = b * half(h) * half(w)
    return (esize * (b * h * w * cin + m * co + 25 * cin * co),
            s2_ops(b, h, w, cin, co))


def conv_dx_work(shape, co, esize=2):
    """(bytes, operations) of the conv's dx (the transposed conv of g): g
    and w read once, dx written once; the forward's products."""
    b, h, w, cin = shape
    m = b * half(h) * half(w)
    return (esize * (m * co + 25 * cin * co + b * h * w * cin),
            s2_ops(b, h, w, cin, co))


def deconv_dx_work(shape, co, esize=2):
    """(bytes, operations) of the deconv's dx for its input `shape` and Co:
    the cotangent d [B,2H,2W,Co] and w read once, dx written once; the
    deconv's products."""
    b, h, w, cin = shape
    return (esize * (b * 4 * h * w * co + 25 * cin * co + b * h * w * cin),
            deconv_work(shape, co, esize)[1])


def conv5_grad_work(shape, co, esize=2):
    """(bytes, operations) of a 5×5 stride-2 conv's forward and backward
    (`shape` its input): the forward's, then g, x and w read and dx, dw, db
    written; dx and dw each as many multiply-adds as the forward."""
    fb, fo = conv_work(shape, co, esize)
    b, h, w, cin = shape
    m = b * half(h) * half(w)
    return (fb + esize * (m * co + 2 * b * h * w * cin + 2 * 25 * cin * co)
            + 4 * co, 3 * fo)


def join_work(shape, e, co, esize=2):
    """(bytes, operations) of one conditioning_join: x, t, wx, wt, b and y
    once."""
    b, h, w, cx = shape
    return (esize * (b * h * w * cx + b * e + cx * co + e * co + b * h * w * co)
            + 4 * co, 2 * b * h * w * cx * co + 2 * b * e * co)


def ratio(ms, library_ms):
    return ms / library_ms if library_ms else float("nan")


def table(rows: List[Dict]) -> str:
    """The rows as a markdown table (plain ms "—" where a row has none)."""
    out = ["| kernel | shape | path / plan | ms | library | library ms | "
           "kernel/library | bound ms | bound by | max abs err | plain ms |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        plain = f"{r['plain_ms']:.4f}" if "plain_ms" in r else "—"
        out.append(
            f"| {r['kernel']} | {r['shape']} | {r['path']} | {r['ms']:.4f} | "
            f"{r['library']} | {r['library_ms']:.4f} | {r['ratio']:.2f} | "
            f"{r['bound_ms']:.4f} | {r['bound_by']} | "
            f"{r['max_abs_err']:.3e} | {plain} |")
    return "\n".join(out)


def hold(got, ref, atol, rtol, what, rel_to_max=False) -> float:
    """max|got − ref|; raises where an element is past atol + rtol·|ref|
    (atol relative to max|ref| with `rel_to_max`)."""
    err = (got.float() - ref.float()).abs()
    tol = atol * (float(ref.float().abs().max()) if rel_to_max else 1.0)
    bad = err > tol + rtol * ref.float().abs()
    if bool(bad.any()):
        raise RuntimeError(f"{what}: {int(bad.sum())} elements out of "
                           f"tolerance, max|err| {float(err.max()):.3e}")
    return float(err.max())


def _row(kernel, shape, path, ms, library, library_ms, work, dtype, err):
    bms, by = bound(*work, dtype)
    return {"kernel": kernel, "shape": shape, "path": path, "ms": ms,
            "library": library, "library_ms": library_ms,
            "ratio": ratio(ms, library_ms), "bound_ms": bms, "bound_by": by,
            "max_abs_err": err}


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def bench_deconv(device, flush, gen) -> List[Dict]:
    from text_to_image_tpu_torch.ops.kernels import conv
    rows = []
    for shape, co, act in DECONV_SHAPES:
        x = torch.relu(randn(gen, shape)).to(torch.bfloat16)
        w = (randn(gen, 5, 5, shape[-1], co) * 0.02
             ).to(torch.bfloat16)
        s = 1.0 + 0.1 * randn(gen, co)
        t = 0.1 * randn(gen, co)
        x, w, s, t = (v.to(device) for v in (x, w, s, t))
        y = conv.deconv5x5_s2(x, w, s, t, act)
        err = hold(y, conv.deconv5x5_s2_plain(x, w, s, t, act), *TOL,
                   f"deconv5x5_s2 {shape}->{co}")
        b, h, wd, cin = shape
        path = conv.deconv_path_on_card(x, w, y)
        if path == "wgmma":
            plan = conv.deconv_plan(b * h * wd, co, cin)
            path += f" {plan.tile_m}x{plan.tile_n} parts {list(plan.parts)}"
        x_cl = _nchw(x)
        w_t = w.permute(2, 3, 0, 1).flip(2, 3).contiguous()
        rows.append(_row(
            "deconv5x5_s2", f"{list(shape)}->{co} {act}", path,
            time_ms(lambda: conv.deconv5x5_s2(x, w, s, t, act), flush),
            "cuDNN conv_transpose2d",
            time_ms(lambda: F.conv_transpose2d(x_cl, w_t, stride=2,
                                               padding=1), flush),
            deconv_work(shape, co), torch.bfloat16, err))
    return rows


def bench_conv(device, flush, gen) -> List[Dict]:
    from text_to_image_tpu_torch.ops.kernels import conv
    rows = []
    for shape, co, act in CONV_SHAPES:
        x = randn(gen, shape).to(torch.bfloat16).to(device)
        w = (randn(gen, 5, 5, shape[-1], co) * 0.05
             ).to(torch.bfloat16).to(device)
        bias = (0.1 * randn(gen, co)).to(device)
        y = conv.conv5x5_s2_act(x, w, bias, act)
        err = hold(y, conv.conv5x5_s2_act_plain(x, w, bias, act), *TOL,
                   f"conv5x5_s2_act {shape}->{co}")
        b, h, wd, cin = shape
        path = conv.conv_path_on_card(x, w, y)
        if path == "wgmma":
            tm, tn, split = conv.conv_plan(b * half(h) * half(wd), co, 25 * cin)
            path += f" {tm}x{tn} split {split}"
        xp = F.pad(_nchw(x), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        w_t = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)

        def lib():
            out = F.conv2d(xp, w_t, b16, stride=2)
            return F.leaky_relu(out, 0.2) if act == "lrelu" else out
        rows.append(_row(
            "conv5x5_s2_act", f"{list(shape)}->{co} {act}", path,
            time_ms(lambda: conv.conv5x5_s2_act(x, w, bias, act), flush),
            "cuDNN conv2d + act", time_ms(lib, flush),
            conv_work(shape, co), torch.bfloat16, err))
    return rows


def upconv_inputs(shape, co, dtype, device, gen):
    x = torch.relu(randn(gen, shape)).to(dtype).to(device)
    w = (randn(gen, 3, 3, shape[-1], co) * 0.02
         ).to(dtype).to(device)
    b = (0.1 * randn(gen, co)).to(device)
    return x, w, b


def upconv_library(x_cl, w_oihw, b, act):
    """act(conv3×3(upsample2(x)) + b) as F.interpolate + cuDNN conv2d on
    the NHWC tensors' channels_last views (the 4× map through memory)."""
    out = F.conv2d(F.interpolate(x_cl, scale_factor=2, mode="nearest"),
                   w_oihw, b, padding=1)
    return F.leaky_relu(out, 0.2) if act == "lrelu" else out


def bench_upconv(device, flush, gen) -> List[Dict]:
    from text_to_image_tpu_torch.ops.kernels import conv
    rows = []
    for shape, co, act in UPCONV_SHAPES:
        x, w, b = upconv_inputs(shape, co, torch.bfloat16, device, gen)
        y = conv.upconv3x3_bias(x, w, b, act)
        err = hold(y, conv.upconv3x3_plain(x, w, torch.ones_like(b), b, act),
                   *TOL, f"upconv3x3_bias {shape}->{co}")
        bsz, h, wd, cin = shape
        path = conv.upconv_path_on_card(x, conv.combined_weights(w), y)
        if path == "wgmma":
            plan = conv.upconv_plan(bsz * h * wd, co, cin)
            path += (" resident 128x64" if plan.resident else
                     f" {plan.tile_m}x{plan.tile_n} parts {list(plan.parts)}")
        x_cl, b16 = _nchw(x), b.to(torch.bfloat16)
        w_t = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        rows.append(_row(
            "upconv3x3_bias", f"{list(shape)}->{co} {act}", path,
            time_ms(lambda: conv.upconv3x3_bias(x, w, b, act), flush),
            "F.interpolate + cuDNN conv2d",
            time_ms(lambda: upconv_library(x_cl, w_t, b16, act), flush),
            upconv_work(shape, co), torch.bfloat16, err))
        del x, w, y
        torch.cuda.empty_cache()
    return rows


def _grads(fn, x, w, b, g):
    xs = [v.detach().requires_grad_(True) for v in (x, w, b)]
    return torch.autograd.grad(fn(*xs), xs, g)


def bench_upconv_grad(device, flush, gen) -> List[Dict]:
    """upconv3x3_bias forward + backward (act none, as the StackGAN
    up-blocks) against autograd through F.interpolate + conv2d."""
    from text_to_image_tpu_torch.ops.kernels import conv
    rows = []
    for shape, co in UPCONV_GRAD_SHAPES:
        # the gradients held in f32 on 2 images of the shape (the same code
        # paths; f32 sums over a few rows, so 1e-4 of the largest holds)
        x, w, b = upconv_inputs((2, *shape[1:]), co, torch.float32, device,
                                gen)
        g = randn(gen, (2, 2 * shape[1], 2 * shape[2], co)).to(device)
        got = _grads(lambda *v: conv.upconv3x3_bias(*v, "none"), x, w, b, g)
        ref = _grads(lambda x_, w_, b_: conv.upconv3x3_plain(
            x_, w_, torch.ones_like(b_), b_, "none"), x, w, b, g)
        err = max(hold(u, v, GRAD_REL, GRAD_REL,
                       f"upconv3x3_bias grad {name} {shape}->{co} (f32)",
                       rel_to_max=True)
                  for name, u, v in zip(("dx", "dw", "db"), got, ref))
        x, w, b = upconv_inputs(shape, co, torch.bfloat16, device, gen)
        g = randn(gen, (shape[0], 2 * shape[1], 2 * shape[2], co)).to(
            torch.bfloat16)
        xs = [v.detach().requires_grad_(True) for v in (x, w, b)]
        x_cl = _nchw(x).detach().requires_grad_(True)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last).detach().requires_grad_(True)
        b_lib = b.detach().to(torch.bfloat16).requires_grad_(True)
        g_cl = _nchw(g)

        def ours():
            return torch.autograd.grad(conv.upconv3x3_bias(*xs, "none"), xs, g)

        def lib():
            return torch.autograd.grad(upconv_library(x_cl, w_cl, b_lib,
                                                      "none"),
                                       (x_cl, w_cl, b_lib), g_cl)
        rows.append(_row(
            "upconv3x3_bias fwd+bwd", f"{list(shape)}->{co} none",
            "forward kernel, dx and dw kernels",
            time_ms(ours, flush, iters=10, spin=HOST_SPIN),
            "autograd F.interpolate + conv2d",
            time_ms(lib, flush, iters=10, spin=HOST_SPIN),
            upconv_grad_work(shape, co), torch.bfloat16, err))
        del x, w, g, xs, x_cl, w_cl, g_cl
        torch.cuda.empty_cache()
    return rows


def dw_plan_tag(path, plan, modes) -> str:
    """A weight-gradient launch's plan as the tables print it: the path,
    the tile (wgmma), the parts of K and how many a cluster sums on chip,
    whether dw came straight from the kernel or through a workspace, the
    chunk where Cin is walked in chunks, and the launch's other modes."""
    tile = f" {plan.tile_m}x{plan.tile_n}" if path == "wgmma" else ""
    chunk = f" chunk {plan.chunk}" if "workspace" in modes else ""
    extra = sorted(modes & {"fold", "staged"})
    return (f"{path}{tile} parts {plan.parts} cluster {plan.cluster} "
            f"{'direct' if 'direct' in modes else 'workspace'}{chunk}"
            + "".join(f" {m}" for m in extra))


def dx_plan_tag(plan, modes) -> str:
    """A dx launch's plan as the tables print it: the loop (the ring
    kernel, the transposed one, the gather loop), its tile, the parts of K
    (the ring's in one cluster, the gather loop's through a workspace),
    and the launch's modes."""
    parts = (f" parts {plan.parts}" if plan.kernel != "transposed" else "")
    return (f"wgmma {plan.kernel} {plan.tile_m}x{plan.tile_n}{parts} "
            f"{plan.staging} [{' '.join(sorted(modes))}]")


def bwd_path_tag(kernel, path, shape, co) -> str:
    """The path of an upconv3x3_dx / upconv3x3_dw call with its plan: dx's
    `dx_plan_tag`, dw's `dw_plan_tag`."""
    from text_to_image_tpu_torch.ops.kernels import conv
    b, h, wd, cin = shape
    if kernel == "upconv3x3_dx":
        if path != "wgmma":
            return path
        plan = conv.dx_plan(b, h, wd, cin, co)
        return dx_plan_tag(plan, conv.dx_modes(path, plan, co))
    dtype = torch.bfloat16 if path in ("wgmma", "mma") else torch.float32
    plan = conv.dw_plan(b, h, wd, cin, co, dtype)
    return dw_plan_tag(path, plan, conv.dw_modes(path, plan, 16, cin, h, wd))


def bench_upconv_bwd(device, flush, gen) -> List[Dict]:
    """upconv3x3_dx and upconv3x3_dw alone (bf16), each held against its
    plain version (within 1e-2 of the largest |ref| plus 1e-2 relative: a
    rounding flip after f32 sums in another order) and timed beside it and
    one library call; dx's row names its plan and modes, on the card read
    back from its C entry point and held against `dx_modes`."""
    from text_to_image_tpu_torch.ops.kernels import conv
    bf = torch.bfloat16
    rows = []
    for shape, co in UPCONV_BWD_SHAPES:
        bsz, h, wd, cin = shape
        x, w, _ = upconv_inputs(shape, co, bf, device, gen)
        g = randn(gen, (bsz, 2 * h, 2 * wd, co)).to(bf)
        dx = conv.upconv3x3_dx(g, w, bf)
        dw = conv.upconv3x3_dw(x, g, bf)
        err_dx = hold(dx, conv.upconv3x3_dx_plain(g, w, bf), *TOL,
                      f"upconv3x3_dx {shape}->{co}", rel_to_max=True)
        err_dw = hold(dw, conv.upconv3x3_dw_plain(x, g, bf), *TOL,
                      f"upconv3x3_dw {shape}->{co}", rel_to_max=True)
        on_card = conv.dx_path_on_card(g, dx)
        dx_path = bwd_path_tag("upconv3x3_dx", on_card, shape, co)
        if torch.device(device).type == "cuda" and on_card == "wgmma":
            modes = conv.dx_mode_on_card()
            want = conv.dx_modes(on_card, conv.dx_plan(bsz, h, wd, cin, co),
                                 co)
            if modes != want:
                raise RuntimeError(f"upconv3x3_dx {shape}->{co}: modes "
                                   f"{sorted(modes)}, the mirror says "
                                   f"{sorted(want)}")
        dw_path = bwd_path_tag("upconv3x3_dw", conv.dw_path_on_card(x, g),
                               shape, co)
        # the library: autograd's backward through F.interpolate +
        # F.conv2d (x alone requiring a gradient), and the weight gradient
        # of the conv over the upsampled x, built beforehand
        x_cl = _nchw(x).detach().requires_grad_(True)
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out = upconv_library(x_cl, w_cl, None, "none")
        g_cl = _nchw(g)
        up = F.interpolate(_nchw(x), scale_factor=2, mode="nearest")
        for name, fn, plain, lib_name, lib, work, path, err in (
                ("upconv3x3_dx", lambda: conv.upconv3x3_dx(g, w, bf),
                 lambda: conv.upconv3x3_dx_plain(g, w, bf),
                 "autograd F.interpolate + conv2d, dx",
                 lambda: torch.autograd.grad(out, x_cl, g_cl,
                                             retain_graph=True),
                 upconv_dx_work(shape, co), dx_path, err_dx),
                ("upconv3x3_dw", lambda: conv.upconv3x3_dw(x, g, bf),
                 lambda: conv.upconv3x3_dw_plain(x, g, bf),
                 "conv2d_weight over the upsampled x",
                 lambda: torch.nn.grad.conv2d_weight(up, w_cl.shape, g_cl,
                                                     padding=1),
                 upconv_dw_work(shape, co), dw_path, err_dw)):
            r = _row(name, f"{list(shape)}->{co}", path,
                     time_ms(fn, flush, spin=HOST_SPIN), lib_name,
                     time_ms(lib, flush, spin=HOST_SPIN), work, bf, err)
            r["plain_ms"] = time_ms(plain, flush, iters=5, spin=HOST_SPIN)
            rows.append(r)
        del x, w, g, dx, dw, x_cl, out, g_cl, up
        torch.cuda.empty_cache()
    return rows


def conv_dw_tag(conv, x, g) -> str:
    """The path of a conv5x5_s2_dw call, read back from the C entry point,
    with its plan (`dw_plan_tag`)."""
    b, h, wd, cin = x.shape
    path = conv.conv_dw_path_on_card(x, g)
    plan = conv.conv_dw_plan(b, h, wd, cin, g.shape[-1], x.dtype)
    return dw_plan_tag(path, plan,
                       conv.dw_modes(path, plan, 25, cin, *g.shape[1:3]))


def bench_conv_dw(device, flush, gen) -> List[Dict]:
    """``conv5x5_s2_dw`` alone at every main-path call (CONV_DW_CALLS; the
    generator's deconvs in their own weight layout, as their backward
    writes it), bf16, held against its plain version and timed beside
    cuDNN's ``conv2d_weight`` over the SAME-padded input (padded
    beforehand); the plan read back from the C entry point."""
    from text_to_image_tpu_torch.ops.kernels import conv
    bf = torch.bfloat16
    rows = []
    for shape, co, flip in CONV_DW_CALLS:
        b, h, wd, cin = shape
        x = randn(gen, shape).to(bf)
        g = randn(gen, (b, half(h), half(wd), co)).to(bf)
        dw = conv.conv5x5_s2_dw(x, g, bf, flip)
        modes = conv.conv_dw_mode_on_card()
        err = hold(dw, conv.conv5x5_s2_dw_plain(x, g, bf, flip), *TOL,
                   f"conv5x5_s2_dw {shape}->{co}", rel_to_max=True)
        path = conv.conv_dw_path_on_card(x, g)
        plan = conv.conv_dw_plan(b, h, wd, cin, co, bf)
        want = conv.dw_modes(path, plan, 25, cin, *g.shape[1:3])
        if modes != want:
            raise RuntimeError(f"conv5x5_s2_dw {shape}->{co}: modes "
                               f"{sorted(modes)}, the mirror says "
                               f"{sorted(want)}")
        xp = F.pad(_nchw(x), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        g_cl = _nchw(g)
        r = _row("conv5x5_s2_dw", f"{list(shape)}->{co}"
                 + (" (deconv layout)" if flip else ""),
                 dw_plan_tag(path, plan, modes),
                 time_ms(lambda: conv.conv5x5_s2_dw(x, g, bf, flip), flush),
                 "cuDNN conv2d_weight (input padded beforehand)",
                 time_ms(lambda: torch.nn.grad.conv2d_weight(
                     xp, (co, cin, 5, 5), g_cl, stride=2), flush),
                 conv_dw_work(shape, co), bf, err)
        r["op"], r["batch"] = "dw", b
        rows.append(r)
        del x, g, dw, xp, g_cl
        torch.cuda.empty_cache()
    return rows


def _timed_row(flush, op, shape, co, kind, ours, lib_name, lib, plain, work,
               path, err):
    """A row of `bench_conv5_grad`: ours, the library call and (where
    given) the plain version timed; the op and the batch kept."""
    r = _row(kind, f"{list(shape)}->{co}", path,
             time_ms(ours, flush, spin=HOST_SPIN), lib_name,
             time_ms(lib, flush, spin=HOST_SPIN), work, torch.bfloat16, err)
    if plain is not None:
        r["plain_ms"] = time_ms(plain, flush, iters=5, spin=HOST_SPIN)
    r["op"], r["batch"] = op, shape[0]
    return r


def bench_conv5_grad(op, device, flush, gen) -> List[Dict]:
    """``--conv --grad`` / ``--deconv --grad``: the op's forward + backward
    (its autograd.Function: the forward kernel, dx on the other op's
    kernel, dw on conv5x5_s2_dw) against autograd through cuDNN's
    conv2d / conv_transpose2d, after its gradients are held against
    autograd through the plain version in f32 (TF32 off) on two images;
    then dx and dw alone beside their plain versions and cuDNN's
    conv2d_input / conv2d (the deconv's dx) and conv2d_weight over the
    SAME-padded input, built beforehand.  bf16 at the op's main-path
    shapes (DECONV_SHAPES, CONV_SHAPES)."""
    from text_to_image_tpu_torch.ops.kernels import conv
    bf = torch.bfloat16
    rows = []
    shapes = DECONV_SHAPES if op == "deconv" else CONV_SHAPES
    for shape, co, act in shapes:
        b, h, wd, cin = shape
        small = (2, *shape[1:])
        if op == "conv":
            x, w = randn(gen, small).to(device), (
                randn(gen, 5, 5, cin, co) * 0.05).to(device)
            extra = [(0.1 * randn(gen, co)).to(device)]
            fn, plain_fn = conv.conv5x5_s2_act, conv.conv5x5_s2_act_plain
            out_shape = (b, half(h), half(wd), co)
        else:
            x, w = torch.relu(randn(gen, small)).to(device), (
                randn(gen, 5, 5, cin, co) * 0.02).to(device)
            extra = [torch.ones(co, device=device),
                     (0.1 * randn(gen, co)).to(device)]
            fn, plain_fn = conv.deconv5x5_s2, conv.deconv5x5_s2_plain
            out_shape = (b, 2 * h, 2 * wd, co)
        args = [x, w, *extra]
        need = [0, 1, len(args) - 1]            # x, w and the bias / shift
        g = randn(gen, (2, *out_shape[1:])).to(device)

        def grads(f, args=args, g=g, need=need):
            xs = [v.detach().requires_grad_(i in need)
                  for i, v in enumerate(args)]
            y = f(*xs, act)
            return torch.autograd.grad(y, [xs[i] for i in need], g)
        err = max(hold(u, v, GRAD_REL, GRAD_REL,
                       f"{op} grad {name} {shape}->{co} (f32)",
                       rel_to_max=True)
                  for name, u, v in zip(("dx", "dw", "db"), grads(fn),
                                        grads(plain_fn)))
        # bf16 at the full batch
        x = (randn(gen, shape) if op == "conv"
             else torch.relu(randn(gen, shape))).to(bf)
        w = (randn(gen, 5, 5, cin, co) * 0.05).to(bf)
        g = randn(gen, out_shape).to(bf)
        xs = [x, w, *extra]
        leaves = [v.detach().requires_grad_(i in need)
                  for i, v in enumerate(xs)]
        x_cl = _nchw(x).detach().requires_grad_(True)
        g_cl = _nchw(g)
        if op == "conv":
            w_lib = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last).requires_grad_(True)
            b_lib = extra[0].to(bf).requires_grad_(True)

            def lib_fwd():
                out = F.conv2d(F.pad(x_cl, (1, 2, 1, 2)), w_lib, b_lib,
                               stride=2)
                return F.leaky_relu(out, 0.2) if act == "lrelu" else out
            lib_name = "autograd cuDNN conv2d"
        else:
            w_lib = w.permute(2, 3, 0, 1).flip(2, 3).contiguous(
                ).requires_grad_(True)
            b_lib = extra[1].to(bf).requires_grad_(True)

            def lib_fwd():
                out = F.conv_transpose2d(x_cl, w_lib, b_lib, stride=2,
                                         padding=2, output_padding=1)
                return torch.tanh(out) if act == "tanh" else torch.relu(out)
            lib_name = "autograd cuDNN conv_transpose2d"
        rows.append(_timed_row(
            flush, op, shape, co, GRAD_TABLES[op][0],
            lambda: torch.autograd.grad(fn(*leaves, act),
                                        [leaves[i] for i in need], g),
            lib_name,
            lambda: torch.autograd.grad(lib_fwd(), (x_cl, w_lib, b_lib),
                                        g_cl),
            None, conv5_grad_work(shape, co) if op == "conv"
            else conv5_grad_work(out_shape[:3] + (co,), cin),
            "forward kernel, dx and dw kernels", err))
        # dx alone: the conv's on conv5x5_s2_dx (its plan and the modes
        # the launch reports tagged), the RGB layer's on the transposed
        # conv; the deconv's on the conv's forward kernel
        dx_kind = GRAD_TABLES[op][1]
        if op == "conv":
            gc = g
            dx = conv.conv_dx(gc, w, h, wd)
            if conv.conv_dx_path(cin, co, bf) == "wgmma":
                plan = conv.conv_dx_plan(b, h, wd, cin, co)
                modes = conv.conv_dx_mode_on_card()
                if modes != conv.conv_dx_modes(plan):
                    raise RuntimeError(
                        f"conv dx {shape}->{co}: modes {sorted(modes)}, the "
                        f"mirror says {sorted(conv.conv_dx_modes(plan))}")
                dx_path = (f"{conv.conv_dx_path_on_card(gc, w, dx)} "
                           f"{plan.kernel} {plan.tile_m}x{plan.tile_n} parts "
                           f"{plan.parts} ({', '.join(sorted(modes))})")
                dx_plain = (lambda: conv.conv5x5_s2_dx_plain(gc, w, h, wd))
            else:
                wc = conv.deconv_dx_weight(w)
                one = torch.ones(cin, device=device)
                zero = torch.zeros(cin, device=device)
                dx_path = conv.deconv_path_on_card(gc, wc, dx)
                dx_kind = CONV_DX_VIA_DECONV
                dx_plain = (lambda: conv.deconv5x5_s2_plain(gc, wc, one, zero))
            dx_ref = dx_plain()
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            padded = (b, cin, h + 3, wd + 3)
            dx_lib = ("cuDNN conv2d_input", lambda: torch.nn.grad.conv2d_input(
                padded, w_oihw, g_cl, stride=2))
            dx_fn = (lambda: conv.conv_dx(gc, w, h, wd), dx_plain)
            dx_work = conv_dx_work(shape, co)
            dw_x, dw_g, dw_shape, dw_co = x, g, shape, co
        else:
            # the deconv's dx through its route (`deconv_dx`): on
            # deconv5x5_s2_dx (its path read back and its plan tagged), else
            # the conv of d with w flipped and a zero bias, the copy and
            # fill included
            d, wc = g, conv.deconv_dx_weight(w)
            dx = conv.deconv_dx(d, w)
            if conv.deconv_dx_path(cin, co, bf) != "conv":
                plan = conv.deconv_dx_plan(b, h, wd, cin, co)
                dx_path = (f"{conv.deconv_dx_path_on_card(d, w, dx)} "
                           f"{plan.tile_m}x{plan.tile_n} parts {plan.parts}")
                dx_plain = (lambda: conv.deconv5x5_s2_dx_plain(d, w))
            else:
                zero = torch.zeros(cin, device=device)
                dx_path = conv.conv_path_on_card(d, wc, dx)
                dx_kind = DECONV_DX_VIA_CONV
                dx_plain = (lambda: conv.conv5x5_s2_act_plain(d, wc, zero,
                                                              "none"))
            dx_ref = dx_plain()
            d_pad = F.pad(_nchw(d), (1, 2, 1, 2)).contiguous(
                memory_format=torch.channels_last)
            wc_oihw = wc.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            dx_lib = ("cuDNN conv2d", lambda: F.conv2d(d_pad, wc_oihw,
                                                       stride=2))
            dx_fn = (lambda: conv.deconv_dx(d, w), dx_plain)
            dx_work = deconv_dx_work(shape, co)
            dw_x, dw_g, dw_shape, dw_co = d, x, out_shape[:3] + (co,), cin
        err_dx = hold(dx, dx_ref, *TOL, f"{op} dx {shape}->{co}",
                      rel_to_max=True)
        rows.append(_timed_row(flush, op, shape, co, dx_kind,
                               dx_fn[0], dx_lib[0], dx_lib[1], dx_fn[1],
                               dx_work, dx_path, err_dx))
        # dw alone (the deconv's in its own weight layout, as its backward
        # writes it)
        flip = op == "deconv"
        dw = conv.conv5x5_s2_dw(dw_x, dw_g, bf, flip)
        err_dw = hold(dw, conv.conv5x5_s2_dw_plain(dw_x, dw_g, bf, flip),
                      *TOL, f"{op} dw {shape}->{co}", rel_to_max=True)
        xp = F.pad(_nchw(dw_x), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        dw_oihw = (dw_co, dw_shape[-1], 5, 5)
        rows.append(_timed_row(
            flush, op, shape, co, "conv5x5_s2_dw",
            lambda: conv.conv5x5_s2_dw(dw_x, dw_g, bf, flip),
            "cuDNN conv2d_weight (input padded beforehand)",
            lambda: torch.nn.grad.conv2d_weight(xp, dw_oihw, _nchw(dw_g),
                                                stride=2),
            lambda: conv.conv5x5_s2_dw_plain(dw_x, dw_g, bf, flip),
            conv_dw_work(dw_shape, dw_co), conv_dw_tag(conv, dw_x, dw_g),
            err_dw))
        del x, w, g, xs, leaves, x_cl, g_cl, dx, dx_ref, dw, xp
        torch.cuda.empty_cache()
    return rows


def bench_join(device, flush, gen) -> List[Dict]:
    from text_to_image_tpu_torch.ops.kernels import fused
    rows = []
    bf = torch.bfloat16
    for shape, e, co in JOIN_SHAPES:
        b = shape[0]
        x = randn(gen, shape).to(bf).to(device)
        t = randn(gen, b, e).to(bf).to(device)
        wx = (randn(gen, shape[-1], co) * 0.02).to(bf).to(device)
        wt = (randn(gen, e, co) * 0.02).to(bf).to(device)
        bias = (0.1 * randn(gen, co)).to(device)
        y = fused.conditioning_join(x, t, wx, wt, bias, "none")
        err = hold(y, fused.conditioning_join_plain(x, t, wx, wt, bias,
                                                    "none"),
                   *TOL, f"conditioning_join {shape} e{e}->{co}")
        cat = torch.cat([x, t[:, None, None, :].expand(*shape[:3], e)],
                        -1).reshape(-1, shape[-1] + e)
        wcat, b16 = torch.cat([wx, wt]), bias.to(bf)
        rows.append(_row(
            "conditioning_join", f"{list(shape)} e{e}->{co} none",
            fused.join_path(shape[-1], e, co, bf),
            time_ms(lambda: fused.conditioning_join(x, t, wx, wt, bias,
                                                    "none"), flush),
            "addmm (concat built)",
            time_ms(lambda: torch.addmm(b16, cat, wcat), flush),
            join_work(shape, e, co), bf, err))
    return rows


def bench_bn(device, flush, gen) -> List[Dict]:
    """The four train-mode batch-norm kernels at each call, beside
    PyTorch's SyncBatchNorm kernel of the same step on each stream's
    channels_last view (without the activation)."""
    from text_to_image_tpu_torch.ops.kernels import fused
    rows = []
    for shape, s, act in BN_CALLS:
        c = shape[-1]
        x = (0.5 + 1.5 * randn(gen, shape)).to(
            torch.bfloat16).to(device)
        gamma, beta, rm = (v.to(device) for v in (
            1.0 + 0.1 * randn(gen, c),
            0.1 * randn(gen, c),
            0.1 * randn(gen, c)))
        rv = (1.0 + 0.2 * rand(gen, c)).to(device)
        g = randn(gen, shape).to(device, torch.bfloat16)
        stats = fused.bn_stats(x, s, gamma, beta, rm, rv)
        errs = {"bn_stats": max(hold(u, v, *STATS_TOL, f"bn_stats {shape}")
                                for u, v in zip(stats, fused.bn_stats_plain(
                                    x, s, gamma, beta, rm, rv)))}
        mean, rstd, a, b = stats[:4]
        y = fused._bn_act_forward(x, a, b, act)
        errs["bn_act"] = hold(y, fused.bn_act_plain(x, a, b, act), *TOL,
                              f"bn_act {shape}")
        sums = fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act)
        errs["bn_bwd_reduce"] = max(
            hold(u, v, GRAD_REL, GRAD_REL, f"bn_bwd_reduce {shape}",
                 rel_to_max=True)
            for u, v in zip(sums, fused.bn_bwd_reduce_plain(
                g, y, x, mean, rstd, s, act)))
        dx = fused.bn_bwd_apply(g, y, x, mean, rstd, gamma, *sums[:2], s, act)
        errs["bn_bwd_apply"] = hold(
            dx, fused.bn_bwd_apply_plain(g, y, x, mean, rstd, gamma,
                                         *sums[:2], s, act),
            *TOL, f"bn_bwd_apply {shape}")
        plan = "plan " + " ".join(map(str, fused.bn_plan_on_card(x, s)))
        xs = [v.permute(0, 3, 1, 2) for v in x.chunk(s)]
        gs = [v.permute(0, 3, 1, 2) for v in g.chunk(s)]
        lib_stats = [torch.batch_norm_stats(v, 1e-5) for v in xs]
        lib_sums = [torch.batch_norm_backward_reduce(gi, xi, m, i, gamma, True,
                                                     True, True)
                    for gi, xi, (m, i) in zip(gs, xs, lib_stats)]
        count = torch.tensor([x.numel() // c // s], dtype=torch.int32,
                             device=device)
        ya = [y] if act != "none" else []
        per_c = nbytes(gamma, beta, rm, rv)
        n = x.numel()
        steps = {
            "bn_stats": (lambda: fused.bn_stats(x, s, gamma, beta, rm, rv),
                         "batch_norm_stats",
                         lambda: [torch.batch_norm_stats(v, 1e-5) for v in xs],
                         nbytes(x, *stats) + per_c, 6 * n),
            "bn_act": (lambda: fused._bn_act_forward(x, a, b, act),
                       "batch_norm_elemt",
                       lambda: [torch.batch_norm_elemt(v, gamma, beta, m, i,
                                                       1e-5)
                                for v, (m, i) in zip(xs, lib_stats)],
                       nbytes(x, y, a, b), 3 * n),
            "bn_bwd_reduce": (
                lambda: fused.bn_bwd_reduce(g, y, x, mean, rstd, s, act),
                "batch_norm_backward_reduce",
                lambda: [torch.batch_norm_backward_reduce(
                    gi, xi, m, i, gamma, True, True, True)
                    for gi, xi, (m, i) in zip(gs, xs, lib_stats)],
                nbytes(g, x, *ya, mean, rstd, *sums), 6 * n),
            "bn_bwd_apply": (
                lambda: fused.bn_bwd_apply(g, y, x, mean, rstd, gamma,
                                           *sums[:2], s, act),
                "batch_norm_backward_elemt",
                lambda: [torch.batch_norm_backward_elemt(
                    gi, xi, m, i, gamma, r[0], r[1], count)
                    for gi, xi, (m, i), r in zip(gs, xs, lib_stats,
                                                 lib_sums)],
                nbytes(g, x, *ya, dx, mean, rstd, gamma, *sums[:2]), 8 * n)}
        for name, (fn, library, lib, nb, ops) in steps.items():
            rows.append(_row(
                name, f"{list(shape)} S={s} {act}", plan,
                time_ms(fn, flush, spin=HOST_SPIN), library,
                time_ms(lib, flush, spin=HOST_SPIN), (nb, ops),
                torch.float32, errs[name]))
        del x, g, y, dx, xs, gs
        torch.cuda.empty_cache()
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def run(grad, device=None) -> Dict:
    """Every row of the default bench (or, `grad` naming ops of
    GRAD_TABLES, of their ``--grad`` tables) on `device` (card 0); returns
    {"card", "rows"}."""
    from text_to_image_tpu_torch.ops.kernels import _build
    device = device or torch.device("cuda", 0)
    _build.build(_build.sources())
    flush = L2Flush(device)
    gen = torch.Generator(device).manual_seed(0)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if grad:
            rows = []
            if "upconv" in grad:
                rows += (bench_upconv_grad(device, flush, gen)
                         + bench_upconv_bwd(device, flush, gen))
            for op in ("conv", "deconv"):
                if op in grad:
                    rows += bench_conv5_grad(op, device, flush, gen)
            if "conv" in grad or "deconv" in grad:
                rows += bench_conv_dw(device, flush, gen)
        else:
            rows = []
            for fn in (bench_deconv, bench_conv, bench_upconv, bench_join,
                       bench_bn):
                rows += fn(device, flush, gen)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    for r in rows:
        for k in ("ms", "library_ms", "ratio", "bound_ms", "max_abs_err",
                  *(("plain_ms",) if "plain_ms" in r else ())):
            if not (isinstance(r[k], float) and math.isfinite(r[k])):
                raise RuntimeError(f"{r['kernel']} {r['shape']}: {k} "
                                   f"{r[k]!r}")
    return {"card": card(), "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for op in GRAD_TABLES:
        p.add_argument(f"--{op}", action="store_true",
                       help=f"with --grad: the {op} forward + backward table")
    p.add_argument("--grad", action="store_true",
                   help="with --upconv, --conv or --deconv: time forward + "
                        "backward and the backward's kernels")
    args = p.parse_args(argv)
    ops = [op for op in GRAD_TABLES if getattr(args, op)]
    if args.grad != bool(ops):
        p.error("--grad goes with --upconv, --conv or --deconv (the default "
                "table has every kernel's forward)")
    if not torch.cuda.is_available():
        print("bench_kernels needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out = run(ops)
    print(table(out["rows"]))
    print(out["card"])
    path = os.path.join(os.getcwd(), "chiprun_out",
                        "bench_kernels_grad.json" if args.grad
                        else "bench_kernels.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
