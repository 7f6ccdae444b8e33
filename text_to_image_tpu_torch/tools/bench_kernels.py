"""The port's kernel microbench on one NVIDIA GPU (counterpart of the JAX
package's ``scripts/bench_pallas.py``): every kernel at every main-path
shape against one PyTorch library call that computes the same function.

    python -m text_to_image_tpu_torch.tools.bench_kernels
    python -m text_to_image_tpu_torch.tools.bench_kernels --upconv --grad

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
``autograd.Function``: the kernel forward, the parity backward) against
autograd through ``F.interpolate`` + ``F.conv2d``, at ``bench_pallas.py``'s
five gradient shapes and the eight up-blocks of a Stage-II forward, after
holding its gradients against autograd through the plain version in f32
(TF32 off) on two images of each shape.

Times are CUDA-event medians over launches each after an L2 flush
(`time_ms`; ``chip_smoke.py`` times its kernels with the same function).
Prints a markdown table and the card's name and power limit, and writes
``chiprun_out/bench_kernels.json`` (``bench_kernels_grad.json`` for
``--upconv --grad``) under the working directory.  Needs a GPU.

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
# the kernel of each row of the default table
KERNELS = ("deconv5x5_s2", "conv5x5_s2_act", "upconv3x3_bias",
           "conditioning_join", *BN_STEPS)


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


def deconv_work(shape, co, esize=2):
    """(bytes, operations) of one deconv5x5_s2: x, w, scale, shift and y
    once; 2·25 multiply-adds a tap."""
    b, h, w, cin = shape
    nb = esize * (b * h * w * cin + 25 * cin * co + b * 4 * h * w * co) + 8 * co
    return nb, 2 * 25 * b * h * w * cin * co


def conv_work(shape, co, esize=2):
    """(bytes, operations) of one conv5x5_s2_act: x, w, bias and y once."""
    b, h, w, cin = shape
    m = b * half(h) * half(w)
    return (esize * (b * h * w * cin + 25 * cin * co + m * co) + 4 * co,
            2 * 25 * m * cin * co)


def upconv_work(shape, co, esize=2):
    """(bytes, operations) of one upconv3x3_bias: x, w, bias and y once;
    4 combined taps for each of the 4 output parities."""
    b, h, w, cin = shape
    return (esize * (b * h * w * cin + 9 * cin * co + b * 4 * h * w * co)
            + 4 * co, 2 * 16 * b * h * w * cin * co)


def upconv_grad_work(shape, co, esize=2):
    """(bytes, operations) of upconv3x3_bias forward and backward: the
    forward's, then g, x and w read and dx, dw, db written; dx and dw each
    as many multiply-adds as the forward."""
    b, h, w, cin = shape
    fb, fo = upconv_work(shape, co, esize)
    return (fb + esize * (b * 4 * h * w * co + 2 * b * h * w * cin
                          + 2 * 9 * cin * co) + 4 * co, 3 * fo)


def join_work(shape, e, co, esize=2):
    """(bytes, operations) of one conditioning_join: x, t, wx, wt, b and y
    once."""
    b, h, w, cx = shape
    return (esize * (b * h * w * cx + b * e + cx * co + e * co + b * h * w * co)
            + 4 * co, 2 * b * h * w * cx * co + 2 * b * e * co)


def ratio(ms, library_ms):
    return ms / library_ms if library_ms else float("nan")


def table(rows: List[Dict]) -> str:
    """The rows as a markdown table."""
    out = ["| kernel | shape | path / plan | ms | library | library ms | "
           "kernel/library | bound ms | bound by | max abs err |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['kernel']} | {r['shape']} | {r['path']} | {r['ms']:.4f} | "
            f"{r['library']} | {r['library_ms']:.4f} | {r['ratio']:.2f} | "
            f"{r['bound_ms']:.4f} | {r['bound_by']} | "
            f"{r['max_abs_err']:.3e} |")
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
            "forward kernel, parity backward",
            time_ms(ours, flush, iters=10, spin=HOST_SPIN),
            "autograd F.interpolate + conv2d",
            time_ms(lib, flush, iters=10, spin=HOST_SPIN),
            upconv_grad_work(shape, co), torch.bfloat16, err))
        del x, w, g, xs, x_cl, w_cl, g_cl
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


def run(grad: bool, device=None) -> Dict:
    """Every row of the default bench (or of ``--upconv --grad``) on
    `device` (card 0); returns {"card", "rows"}."""
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
            rows = bench_upconv_grad(device, flush, gen)
        else:
            rows = []
            for fn in (bench_deconv, bench_conv, bench_upconv, bench_join,
                       bench_bn):
                rows += fn(device, flush, gen)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    for r in rows:
        for k in ("ms", "library_ms", "ratio", "bound_ms", "max_abs_err"):
            if not (isinstance(r[k], float) and math.isfinite(r[k])):
                raise RuntimeError(f"{r['kernel']} {r['shape']}: {k} "
                                   f"{r[k]!r}")
    return {"card": card(), "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--upconv", action="store_true",
                   help="with --grad: the upconv forward + backward table")
    p.add_argument("--grad", action="store_true",
                   help="with --upconv: time forward + backward")
    args = p.parse_args(argv)
    if args.grad != args.upconv:
        p.error("--upconv and --grad go together (the default table has "
                "every kernel's forward)")
    if not torch.cuda.is_available():
        print("bench_kernels needs an NVIDIA GPU", file=sys.stderr)
        return 2
    out = run(args.grad)
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
