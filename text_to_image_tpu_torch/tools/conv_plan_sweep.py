"""Hold and time every wgmma plan of ``conv5x5_s2_act``, ``deconv5x5_s2``
and ``upconv3x3`` on the card.

    python -m text_to_image_tpu_torch.tools.conv_plan_sweep [--ops conv deconv upconv]

For each deep discriminator shape (64 px and 256 px D, batch 192 and 64,
bf16) it runs every (tile, split) the plan may choose, holds the output
against the plain version, and prints the time of each beside the plan
`conv_plan` picks and cuDNN's time: the numbers the constants of the plan's
cost model in ``ops/kernels/conv.py`` were set from.  It also times the
tensor-core down0 path and ``conditioning_join`` at the main-path shapes
beside their library calls (the join's and ``addmm``'s kernels also alone,
by torch.profiler).  ``deconv`` does the same for the GAN-CLS generator's
three deep transposed convs and ``upconv`` for the eight StackGAN up-blocks
(batch 64, bf16): every `grouped_candidates` plan (tile, parts of K per
parity, the resident kernel) held against the plain version, split outputs
bit for bit between two runs, timed beside cuDNN's ``conv_transpose2d`` /
``F.interpolate`` + ``conv2d`` and beside the cost model's estimate, from
which the constants of `grouped_plan` were set.  It prints the compiler's
register report (``chip_smoke.py`` holds every path at odd shapes) and
writes ``conv_plan_sweep.json`` to the output directory of ``chip_smoke.py``.
``--ops dw`` sweeps the two weight-gradient kernels instead
(``conv5x5_s2_dw`` at every main-path call, ``upconv3x3_dw`` at the
up-block shapes of the microbench): every (parts, cluster) plan held
against the plain version and timed beside the plan `conv_dw_plan` /
`dw_plan` picks and cuDNN's ``conv2d_weight``, after the card's cluster
capacity (the constants of `_wgrad_plan` were set from it).  ``--ops
dx`` sweeps ``upconv3x3_dx`` at the up-block shapes of the microbench
(``UPCONV_BWD_SHAPES``): every plan of `dx_candidates` (the ring kernel's
tiles × parts in one cluster, the transposed kernel with its shared
patch) and the gather loop's `conv_plan` plan, each held against the
plain version, bit for bit between two runs, and timed beside the plan
`dx_plan` picks, the ring's cost-model estimate and cuDNN's input
gradient (autograd through ``F.interpolate`` + ``conv2d``).  ``--ops
cdx`` sweeps ``conv5x5_s2_dx`` at every deep conv dx of the 64 px and
256 px D at batch 192 and 64 (`cdx_shapes`): every plan of
`conv_dx_candidates` (the ring at each tile and 1-8 parts in a cluster,
at Cin 64 on the 128² maps the patch kernel), each held
against the plain version, bit for bit between two runs, its modes read
back against `conv_dx_modes`, and timed beside the plan `conv_dx_plan`
picks, `conv_dx_cost`'s estimate, the route the conv's dx took before it
(``deconv5x5_s2`` of gc with w flipped and transposed, the copy and the
scale and shift fills timed with it) and cuDNN's ``conv2d_input``: the
numbers the constants of `conv_dx_cost` were set from.  ``--ops ddx``
sweeps ``deconv5x5_s2_dx`` at every deconv dx of the generators and the
gradient penalty (`ddx_shapes`): every plan of `deconv_dx_candidates` (the
ring at each tile and each of ``DDX_PARTS`` in a cluster; the thin path's
one tile), each held against the plain version, bit for bit between two
runs, and timed beside the plan `deconv_dx_plan` picks, `deconv_dx_cost`'s
estimate, the route the deconv's dx took before it (``conv5x5_s2_act`` of
d with w flipped and a zero bias, the copy and the fill timed with it) and
cuDNN's ``conv2d``: the numbers the constants of `deconv_dx_cost` were set
from.  ``--ops up32`` holds ``upconv3x3``'s co32 kernel (C-PGGAN 256
px's 128²×64→32 call at batch 32 and 64, Co 96, odd maps it covers; it
has no plan to pick) against the plain version, bit for bit between two
runs, and times it beside the bound and F.interpolate + cuDNN + act.
Needs one NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from text_to_image_tpu_torch.ops.kernels import _build, conv, fused
from text_to_image_tpu_torch.tools import bench_kernels

TOL = 1e-2   # bf16: atol + rtol·|ref|


def conv_shapes(b, res):
    if res == 64:
        return [((b, 32, 32, 64), 128), ((b, 16, 16, 128), 256),
                ((b, 8, 8, 256), 512)]
    return [((b, 128, 128, 64), 128), ((b, 64, 64, 128), 256),
            ((b, 32, 32, 256), 512), ((b, 16, 16, 512), 512),
            ((b, 8, 8, 512), 512)]


def time_ms(fn, flush, iters=10):
    return bench_kernels.time_ms(fn, flush, iters=iters, warmup=2)


def inputs(shape, co, gen, dev):
    x = torch.randn(shape, generator=gen).to(torch.bfloat16).to(dev)
    w = (torch.randn(5, 5, shape[-1], co, generator=gen) * 0.02).to(
        torch.bfloat16).to(dev)
    b = (0.1 * torch.randn(co, generator=gen)).to(dev)
    return x, w, b


def worst(got, ref):
    err = (got.float() - ref.float()).abs()
    return float(err.max()), int((err > TOL + TOL * ref.float().abs()).sum())


def plans(m, n):
    for tm, tn in conv.CONV_TILES:
        if n % tn:
            continue
        for split in conv.CONV_SPLITS:
            if split == 1 or split * m * n * 4 <= conv.CONV_WS_CAP:
                yield tm, tn, split


DECONV_SHAPES = [((64, 4, 4, 1024), 512), ((64, 8, 8, 512), 256),
                 ((64, 16, 16, 256), 128)]
UPCONV_SHAPES = [((64, 4, 4, 1024), 512), ((64, 8, 8, 512), 256),
                 ((64, 16, 16, 256), 128), ((64, 32, 32, 128), 64),
                 ((64, 16, 16, 512), 256), ((64, 32, 32, 256), 128),
                 ((64, 64, 64, 128), 64), ((64, 128, 128, 64), 64)]


def sweep_grouped(op, shapes, gen, dev, flush):
    """Every grouped plan of `op` ("deconv" or "upconv") at `shapes`."""
    bad, rows = 0, []
    taps = conv.DECONV_PARITY_TAPS if op == "deconv" else conv.UPCONV_PARITY_TAPS
    k = 5 if op == "deconv" else 3
    for shape, co in shapes:
        cin = shape[-1]
        x = torch.relu(torch.randn(shape, generator=gen)).to(torch.bfloat16).to(dev)
        w = (torch.randn(k, k, cin, co, generator=gen) * 0.02).to(
            torch.bfloat16).to(dev)
        s = (1.0 + 0.1 * torch.randn(co, generator=gen)).to(dev)
        t = (0.1 * torch.randn(co, generator=gen)).to(dev)
        m = shape[0] * shape[1] * shape[2]
        x_cl = x.permute(0, 3, 1, 2)
        if op == "deconv":
            ref = conv.deconv5x5_s2_plain(x, w, s, t, "relu")
            w_t = w.permute(2, 3, 0, 1).flip(2, 3).contiguous()
            lib = time_ms(lambda: F.conv_transpose2d(x_cl, w_t, stride=2,
                                                     padding=1), flush)

            def run(plan):
                return conv._deconv_forward(x, w, s, t, "relu", plan=plan)
            flops = bench_kernels.deconv_work(shape, co)[1]
        else:
            ref = conv.upconv3x3_plain(x, w, s, t, "relu")
            w_t = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            t16 = t.to(torch.bfloat16)
            lib = time_ms(lambda: F.conv2d(F.interpolate(
                x_cl, scale_factor=2, mode="nearest"), w_t, t16, padding=1),
                flush)

            def run(plan):
                return conv._upconv_forward(x, w, s, t, "relu", plan=plan)
            flops = bench_kernels.upconv_work(shape, co)[1]
        chosen = (conv.deconv_plan(m, co, cin) if op == "deconv"
                  else conv.upconv_plan(m, co, cin))
        times, model = {}, {}
        for plan in conv.grouped_candidates(m, co, cin, taps):
            got = run(plan)
            again = run(plan)
            torch.cuda.synchronize()
            e, n = worst(got, ref)
            same = torch.equal(got, again)
            bad += (n > 0) + (not same)
            if n or not same:
                print(f"  FAIL {op} {shape}->{co} {plan}: max|err| {e:.3e}, "
                      f"{n} out of tolerance, two runs bit-identical {same}",
                      flush=True)
            times[plan] = time_ms(lambda: run(plan), flush)
            model[plan] = conv.grouped_cost(m, co, cin, taps, plan) * \
                conv._PLAN_UNIT_S * 1e3
        best = min(times, key=times.get)
        print(f"{op} {shape}->{co}: library {lib:.4f} ms; plan {chosen} "
              f"{times[chosen]:.4f} ms ({flops / times[chosen] / 1e9:.0f} "
              f"TFLOP/s); best {best} {times[best]:.4f} ms", flush=True)
        for plan, ms in sorted(times.items(), key=lambda kv: kv[1]):
            a_mode = "TMA" if conv.a_by_tma(shape[1], shape[2], plan) else \
                "cp.async"
            print(f"    {plan} (A by {a_mode}): {ms:.4f} ms, model "
                  f"{model[plan]:.4f} ms", flush=True)
        rows.append({"op": op, "shape": [list(shape), co], "library_ms": lib,
                     "plan": list(chosen), "best": list(best),
                     "ms": [[list(p), ms, model[p]] for p, ms in times.items()]})
        del x, ref
        torch.cuda.empty_cache()
    return bad, rows


def sweep_conv(gen, dev, flush):
    bad, rows = 0, []
    for res in (64, 256):
        for bsz in (192, 64):
            for shape, co in conv_shapes(bsz, res):
                x, w, b = inputs(shape, co, gen, dev)
                ref = conv.conv5x5_s2_act_plain(x, w, b, "none")
                m = ref.numel() // co
                xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
                    memory_format=torch.channels_last)
                w_t = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                b16 = b.to(torch.bfloat16)
                lib = time_ms(lambda: F.conv2d(xp, w_t, b16, stride=2), flush)
                flops = bench_kernels.conv_work(shape, co)[1]
                chosen = conv.conv_plan(m, co, 25 * shape[-1])
                times = {}
                for plan in plans(m, co):
                    got = conv._conv_forward(x, w, b, "none", plan=plan)
                    e, n = worst(got, ref)
                    bad += n > 0
                    times[plan] = time_ms(
                        lambda: conv._conv_forward(x, w, b, "none", plan=plan),
                        flush)
                best = min(times, key=times.get)
                print(f"{shape}->{co}: cuDNN {lib:.4f} ms; plan {chosen} "
                      f"{times[chosen]:.4f} ms "
                      f"({flops / times[chosen] / 1e9:.0f} TFLOP/s); best "
                      f"{best} {times[best]:.4f} ms; all: "
                      + ", ".join(f"{p}: {t:.4f}" for p, t in times.items()),
                      flush=True)
                rows.append({"shape": [list(shape), co], "cudnn_ms": lib,
                             "plan": chosen, "best": best,
                             "ms": {str(p): t for p, t in times.items()}})
                del x, ref, xp
                torch.cuda.empty_cache()
    # down0 and the join beside their library calls and bytes bounds
    for shape, co in ([((b, r, r, 3), 64) for r in (64, 256)
                       for b in (192, 64)]):
        x, w, b = inputs(shape, co, gen, dev)
        y = conv.conv5x5_s2_act(x, w, b, "lrelu")
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        w_t = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        b16 = b.to(torch.bfloat16)
        lib = time_ms(lambda: F.leaky_relu(F.conv2d(xp, w_t, b16, stride=2),
                                           0.2), flush)
        ms = time_ms(lambda: conv.conv5x5_s2_act(x, w, b, "lrelu"), flush)
        nb = 2 * (x.numel() + w.numel() + y.numel()) + 4 * co
        print(f"down0 {shape}->{co}: {ms:.4f} ms ({nb / ms / 1e6:.0f} GB/s; "
              f"bytes bound {nb / 3.35e12 * 1e3:.4f}), cuDNN + act {lib:.4f}",
              flush=True)
        rows.append({"shape": [list(shape), co], "ms": ms, "cudnn_ms": lib})
        del x, y, xp
        torch.cuda.empty_cache()
    for bsz in (192, 64):
        shape, e_dim, co = (bsz, 4, 4, 512), 128, 512
        bf = torch.bfloat16
        x = torch.randn(shape, generator=gen).to(bf).to(dev)
        t = torch.randn(bsz, e_dim, generator=gen).to(bf).to(dev)
        wx = (torch.randn(512, co, generator=gen) * 0.02).to(bf).to(dev)
        wt = (torch.randn(e_dim, co, generator=gen) * 0.02).to(bf).to(dev)
        b = (0.1 * torch.randn(co, generator=gen)).to(dev)
        cat = torch.cat([x, t[:, None, None, :].expand(bsz, 4, 4, e_dim)],
                        -1).reshape(-1, 512 + e_dim)
        wcat, b16 = torch.cat([wx, wt]), b.to(bf)
        lib = time_ms(lambda: torch.addmm(b16, cat, wcat), flush, 20)
        ms = time_ms(lambda: fused.conditioning_join(x, t, wx, wt, b, "none"),
                     flush, 20)
        print(f"join {shape} e{e_dim}->{co}: {ms:.4f} ms, addmm on the concat "
              f"{lib:.4f}", flush=True)
        # the kernels alone (torch.profiler, L2 warm): what the events
        # above add around a call of a few microseconds
        alone = {}
        for name, fn in (("join", lambda: fused.conditioning_join(
                x, t, wx, wt, b, "none")),
                         ("addmm", lambda: torch.addmm(b16, cat, wcat))):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            alone[name] = {e.key[:60]: e.device_time_total / e.count
                           for e in prof.key_averages()
                           if e.device_time_total > 0}
            print(f"  {name} kernels alone, us: {alone[name]}", flush=True)
        rows.append({"join": list(shape), "ms": ms, "addmm_ms": lib,
                     "kernels_alone_us": alone})
    return bad, rows


def dw_candidates(slices, cmax):
    """(parts, cluster) plans a weight-gradient launch may take: parts as
    groups × cluster with at most cmax in a cluster, each part at least
    DW_MIN_SLICES slices."""
    seen = []
    for want in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32,
                 40, 48, 56, 64, 72, 80, 96, 128, 192, 256):
        if want > max(1, slices // conv.DW_MIN_SLICES):
            break
        groups = -(-want // cmax)
        cluster = -(-want // groups)
        if (groups * cluster, cluster) not in seen:
            seen.append((groups * cluster, cluster))
    return seen


def sweep_dw(gen, dev, flush):
    """Both weight-gradient kernels at every main-path call, bf16: every
    (parts, cluster) plan of `dw_candidates` (for the up-block's wgmma
    path, of its on-chip fold and of its per-product blocks) held against
    the plain version (within 1e-2 of the largest |ref| plus 1e-2 of the
    element: a rounding flip after f32 sums in another order) and timed,
    beside the plan `conv_dw_plan` / `dw_plan` picks and cuDNN's
    `conv2d_weight`; first the card's cluster capacity per cluster size
    (cudaOccupancyMaxActiveClusters of each wgmma kernel)."""
    bf = torch.bfloat16
    bad, rows = 0, []
    cdw, udw = conv._cdw_lib(), conv._bwd_lib()
    caps = {f"conv {tm}x{tn}": [cdw.t2i_conv5x5_s2_dw_clusters(c, tm, tn)
                                for c in range(1, 9)]
            for tm, tn in ((64, 64), (64, 128), (128, 64), (128, 128))}
    caps.update({f"upconv fold n{tn}": [udw.t2i_upconv3x3_dw_clusters(c, tn)
                                        for c in range(1, 9)]
                 for tn in (64, 32)})
    print(f"clusters held at once, cluster size 1..8: {caps}", flush=True)
    rows.append({"max_active_clusters": caps})
    cases = [("conv", shape, co, flip)
             for shape, co, flip in bench_kernels.CONV_DW_CALLS]
    cases += [("upconv", shape, co, False)
              for shape, co in bench_kernels.UPCONV_BWD_SHAPES]
    for op, shape, co, flip in cases:
        b, h, w, cin = shape
        if op == "conv":
            x = torch.randn(shape, generator=gen).to(bf).to(dev)
            g = torch.randn(b, (h + 1) // 2, (w + 1) // 2, co,
                            generator=gen).to(bf).to(dev)
            path = conv.conv_dw_path(h, w, cin, co, bf)
            chosen = conv.conv_dw_plan(b, h, w, cin, co, bf)
            k, products = b * ((h + 1) // 2) * ((w + 1) // 2), 25
            ref = conv.conv5x5_s2_dw_plain(x, g, bf, flip)

            def run(plan):
                return conv._conv_dw_forward(x, g, bf, flip, plan)
            xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
                memory_format=torch.channels_last)
            g_cl = g.permute(0, 3, 1, 2)

            def lib():
                return torch.nn.grad.conv2d_weight(xp, (co, cin, 5, 5), g_cl,
                                                   stride=2)
        else:
            x = torch.randn(shape, generator=gen).to(bf).to(dev)
            g = torch.randn(b, 2 * h, 2 * w, co, generator=gen).to(bf).to(dev)
            path = conv.dw_path(h, w, cin, co, bf)
            chosen = conv.dw_plan(b, h, w, cin, co, bf)
            k, products = b * h * w, 16
            ref = conv.upconv3x3_dw_plain(x, g, bf)

            def run(plan):
                return conv.upconv3x3_dw(x, g, bf, plan)
            up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                               mode="nearest").contiguous(
                memory_format=torch.channels_last)
            g_cl = g.permute(0, 3, 1, 2)

            def lib():
                return torch.nn.grad.conv2d_weight(up, (co, cin, 3, 3), g_cl,
                                                   padding=1)
        slices = -(-k // conv.DW_SLICE[path])
        # the up-block's wgmma path: the on-chip fold and the per-product
        # blocks, each at every (parts, cluster)
        variants = [(False, chosen.tile_m, chosen.tile_n)]
        # the conv's wgmma path: one cluster of a power of two of parts,
        # and parts through the workspace with no cluster (cmax 1 below)
        if op == "conv" and path == "wgmma":
            variants.append((None, chosen.tile_m, chosen.tile_n))
        if op == "upconv" and path == "wgmma":
            variants = ([(True, 64, 64 if co % 64 == 0 else 32)]
                        + ([(False, *conv._dw_tile(path, cin, co))]
                           if co % 64 == 0 else []))
        times = {}
        lim = TOL * float(ref.float().abs().max())
        for fold, tm, tn in variants:
            apart = fold is None             # the conv: no cluster
            fold = bool(fold)
            folds_apart = products == 16 and not fold
            cmax = (1 if folds_apart or apart else
                    conv.DW_MAX_CLUSTER // (2 if fold else 1))
            for parts, cluster in dw_candidates(slices, cmax):
                if op == "conv" and path == "wgmma" and not apart and (
                        parts != cluster or parts & (parts - 1)):
                    continue                 # the plan's powers of two
                if apart and (parts == 1 or parts > 16):
                    continue
                groups = parts // cluster
                planes = groups * (products if folds_apart
                                   else conv.DW_TAPS[products])
                try:
                    chunk = (cin if groups == 1 and not folds_apart else
                             conv.wgrad_chunk(cin, co, planes, tm))
                except ValueError:       # a workspace over the cap
                    continue
                plan = conv.DwPlan(tm, tn, parts, cluster, chunk, fold)
                got = run(plan)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs()
                n_bad = int((err > lim + TOL * ref.float().abs()).sum())
                if n_bad:
                    bad += 1
                    print(f"  FAIL {op} dw {shape}->{co} {tuple(plan)}: "
                          f"{n_bad} elements, max |err| "
                          f"{float(err.max()):.3e}", flush=True)
                key = (f"{'fold ' if fold else ''}{'ws ' if apart else ''}"
                       f"{parts}/{cluster}")
                times[key] = time_ms(lambda: run(plan), flush)
        lib_ms = time_ms(lib, flush)
        best = min(times, key=times.get)
        pick = (f"{'fold ' if chosen.fold else ''}{chosen.parts}/"
                f"{chosen.cluster}")
        print(f"{op} dw {list(shape)}->{co}{' flip' if flip else ''} "
              f"{path} {chosen.tile_m}x{chosen.tile_n}: plan {pick} "
              f"{times.get(pick, float('nan')):.4f} ms, best {best} "
              f"{times[best]:.4f}, cuDNN {lib_ms:.4f}; "
              + " ".join(f"{k_}:{v:.4f}" for k_, v in times.items()),
              flush=True)
        rows.append({"op": f"{op} dw", "shape": list(shape), "co": co,
                     "path": path, "plan": pick, "best": best,
                     "ms": times, "cudnn_ms": lib_ms})
        del x, g, ref
        torch.cuda.empty_cache()
    return bad, rows


def dx_plans(b, h, w, cin, co):
    """Every plan dx's wgmma path takes at this shape: `dx_candidates`
    where a tile is a box, and the gather loop's `conv_plan` plan where K
    slices are 64 channels."""
    plans = conv.dx_candidates(b, h, w, cin, co) if conv.dx_boxes(h, w) \
        else []
    if co % 64 == 0:
        tm, tn, split = conv.conv_plan(b * h * w, cin, 16 * co, taps=16)
        plans.append(conv.DxPlan("cp_async", tm, tn, split))
    return plans


def dx_key(plan) -> str:
    if plan.kernel == "ring":
        return f"ring {plan.tile_n} x{plan.parts}"
    if plan.kernel == "transposed":
        return "transposed patch"
    return f"gather {plan.tile_m}x{plan.tile_n} split {plan.parts}"


def sweep_dx(gen, dev, flush):
    """upconv3x3_dx at the microbench's up-block shapes, bf16: every plan of
    `dx_plans` held against the plain version (within 1e-2 of the largest
    |ref| plus 1e-2 of the element), bit for bit between two launches, its
    modes read back against `dx_modes`, and timed; beside the plan
    `dx_plan` picks, the ring plans' `dx_ring_cost` and cuDNN's dx."""
    bf = torch.bfloat16
    bad, rows = 0, []
    for shape, co in bench_kernels.UPCONV_BWD_SHAPES:
        b, h, w, cin = shape
        g = torch.randn(b, 2 * h, 2 * w, co, generator=gen).to(bf).to(dev)
        wt = (torch.randn(3, 3, cin, co, generator=gen) * 0.05).to(bf).to(dev)
        ref = conv.upconv3x3_dx_plain(g, wt, bf).float()
        lim = TOL * float(ref.abs().max())
        path = conv.dx_path(h, w, cin, co, bf)
        chosen = conv.dx_plan(b, h, w, cin, co)
        times, costs = {}, {}
        for plan in dx_plans(b, h, w, cin, co):
            got = conv.upconv3x3_dx(g, wt, bf, plan)
            again = conv.upconv3x3_dx(g, wt, bf, plan)
            torch.cuda.synchronize()
            modes = conv.dx_mode_on_card()
            err = (got.float() - ref).abs()
            n_bad = int((err > lim + TOL * ref.abs()).sum())
            if (n_bad or not torch.equal(got, again)
                    or modes != conv.dx_modes(path, plan, co)):
                bad += 1
                print(f"  FAIL dx {shape}->{co} {dx_key(plan)}: {n_bad} "
                      f"elements, max |err| {float(err.max()):.3e}, modes "
                      f"{sorted(modes)}", flush=True)
            times[dx_key(plan)] = time_ms(
                lambda: conv.upconv3x3_dx(g, wt, bf, plan), flush)
            if plan.kernel == "ring":
                costs[dx_key(plan)] = conv.dx_ring_cost(
                    b * h * w, cin, co, plan.tile_n, plan.parts)
            del got, again
        x_cl = torch.randn(b, cin, h, w, generator=gen).to(bf).to(dev) \
            .contiguous(memory_format=torch.channels_last) \
            .requires_grad_(True)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        out = F.conv2d(F.interpolate(x_cl, scale_factor=2, mode="nearest"),
                       w_cl, padding=1)
        g_cl = g.permute(0, 3, 1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(out, x_cl, g_cl,
                                                     retain_graph=True),
                         flush)
        best = min(times, key=times.get)
        pick = dx_key(chosen)
        print(f"dx {list(shape)}->{co}: plan {pick} {times[pick]:.4f} ms, "
              f"best {best} {times[best]:.4f}, cuDNN {lib_ms:.4f}; "
              + " ".join(f"[{k}] {v:.4f}"
                         + (f" (model {costs[k]:.0f})" if k in costs else "")
                         for k, v in times.items()), flush=True)
        rows.append({"op": "dx", "shape": list(shape), "co": co,
                     "plan": pick, "best": best, "ms": times,
                     "model": costs, "cudnn_ms": lib_ms})
        del g, wt, ref, x_cl, out, g_cl
        torch.cuda.empty_cache()
    return bad, rows


def cdx_shapes():
    """((B, H, W, Cin), Co) of every deep conv dx of a training tick: the
    64 px and the 256 px D at the D step's 3·64 rows and the G step's 64."""
    return [(shape, co) for b in (3 * bench_kernels.B, bench_kernels.B)
            for res in (64, 256) for shape, co in conv_shapes(b, res)]


def cdx_key(plan) -> str:
    if plan.kernel == "ring":
        return f"ring {plan.tile_n} x{plan.parts}"
    return "patch"


def sweep_cdx(gen, dev, flush):
    """conv5x5_s2_dx at `cdx_shapes`, bf16: every plan of
    `conv_dx_candidates` held against the plain version (within 1e-2 of
    the largest |ref| plus 1e-2 of the element), bit for bit between two
    launches, its modes read back against `conv_dx_modes`, and timed;
    beside the plan `conv_dx_plan` picks, `conv_dx_cost`, the deconv route
    and cuDNN's conv2d_input."""
    bf = torch.bfloat16
    bad, rows = 0, []
    for shape, co in cdx_shapes():
        b, h, w, cin = shape
        gc = torch.randn(b, h // 2, w // 2, co, generator=gen).to(bf).to(dev)
        wt = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(bf).to(dev)
        ref = conv.conv5x5_s2_dx_plain(gc, wt, h, w).float()
        lim = TOL * float(ref.abs().max())
        chosen = conv.conv_dx_plan(b, h, w, cin, co)
        times, costs = {}, {}
        for plan in conv.conv_dx_candidates(b, h, w, cin, co):
            got = conv.conv5x5_s2_dx(gc, wt, h, w, plan)
            modes = conv.conv_dx_mode_on_card()
            again = conv.conv5x5_s2_dx(gc, wt, h, w, plan)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            n_bad = int((err > lim + TOL * ref.abs()).sum())
            if (n_bad or not torch.equal(got, again)
                    or modes != conv.conv_dx_modes(plan)):
                bad += 1
                print(f"  FAIL cdx {shape}->{co} {cdx_key(plan)}: {n_bad} "
                      f"elements, max |err| {float(err.max()):.3e}, modes "
                      f"{sorted(modes)}", flush=True)
            times[cdx_key(plan)] = time_ms(
                lambda: conv.conv5x5_s2_dx(gc, wt, h, w, plan), flush)
            if plan.kernel != "patch":
                costs[cdx_key(plan)] = conv.conv_dx_cost(b, h, w, cin, co,
                                                         plan)
            del got, again
        deconv_ms = time_ms(lambda: conv.deconv5x5_s2(
            gc, conv.deconv_dx_weight(wt), torch.ones(cin, device=dev),
            torch.zeros(cin, device=dev)), flush)
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        g_cl = gc.permute(0, 3, 1, 2)
        lib_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
            (b, cin, h + 3, w + 3), w_oihw, g_cl, stride=2), flush)
        best = min(times, key=times.get)
        pick = cdx_key(chosen)
        print(f"cdx {list(shape)}->{co}: plan {pick} {times[pick]:.4f} ms, "
              f"best {best} {times[best]:.4f}, deconv route {deconv_ms:.4f}, "
              f"cuDNN {lib_ms:.4f}; "
              + " ".join(f"[{k}] {v:.4f}"
                         + (f" (model {costs[k]:.0f})" if k in costs else "")
                         for k, v in times.items()), flush=True)
        rows.append({"op": "cdx", "shape": list(shape), "co": co,
                     "plan": pick, "best": best, "ms": times,
                     "model": costs, "deconv_route_ms": deconv_ms,
                     "cudnn_ms": lib_ms})
        del gc, wt, ref, g_cl, w_oihw
        torch.cuda.empty_cache()
    return bad, rows


def ddx_shapes():
    """((B, H, W, Cin), Co) of every deconv dx of a training tick at batch
    64: the generator's four deconvs (GAN-CLS, GAN-INT, WGAN-CLS), then
    the critic's first-layer dx that the gradient penalty's second order
    differentiates (Cin 64 to Co 3)."""
    b = bench_kernels.B
    return [((b, 4, 4, 1024), 512), ((b, 8, 8, 512), 256),
            ((b, 16, 16, 256), 128), ((b, 32, 32, 128), 3),
            ((b, 32, 32, 64), 3)]


def ddx_key(plan) -> str:
    if plan.kernel == "ring":
        return f"ring {plan.tile_n} x{plan.parts}"
    return f"thin {plan.tile_n}"


def sweep_ddx(gen, dev, flush):
    """deconv5x5_s2_dx at `ddx_shapes`, bf16: every plan of
    `deconv_dx_candidates` held against the plain version (within 1e-2 of
    the largest |ref| plus 1e-2 of the element), bit for bit between two
    launches, and timed;
    beside the plan `deconv_dx_plan` picks, `deconv_dx_cost`, the conv
    route and cuDNN's conv2d over the padded cotangent."""
    bf = torch.bfloat16
    bad, rows = 0, []
    for shape, co in ddx_shapes():
        b, h, w, cin = shape
        d = torch.randn(b, 2 * h, 2 * w, co, generator=gen).to(bf).to(dev)
        wt = (torch.randn(5, 5, cin, co, generator=gen) * 0.05).to(bf).to(dev)
        ref = conv.deconv5x5_s2_dx_plain(d, wt).float()
        lim = TOL * float(ref.abs().max())
        chosen = conv.deconv_dx_plan(b, h, w, cin, co)
        times, costs = {}, {}
        for plan in conv.deconv_dx_candidates(b, h, w, cin, co):
            got = conv.deconv5x5_s2_dx(d, wt, plan)
            again = conv.deconv5x5_s2_dx(d, wt, plan)
            torch.cuda.synchronize()
            err = (got.float() - ref).abs()
            n_bad = int((err > lim + TOL * ref.abs()).sum())
            if n_bad or not torch.equal(got, again):
                bad += 1
                print(f"  FAIL ddx {shape}->{co} {ddx_key(plan)}: {n_bad} "
                      f"elements, max |err| {float(err.max()):.3e}",
                      flush=True)
            times[ddx_key(plan)] = time_ms(
                lambda: conv.deconv5x5_s2_dx(d, wt, plan), flush)
            if plan.kernel == "ring":
                costs[ddx_key(plan)] = conv.deconv_dx_cost(b, h, w, cin, co,
                                                           plan)
            del got, again
        conv_ms = time_ms(lambda: conv.conv5x5_s2_act(
            d, conv.deconv_dx_weight(wt), torch.zeros(cin, device=dev),
            "none"), flush)
        wc = conv.deconv_dx_weight(wt)
        d_pad = F.pad(d.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
            memory_format=torch.channels_last)
        wc_oihw = wc.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib_ms = time_ms(lambda: F.conv2d(d_pad, wc_oihw, stride=2), flush)
        best = min(times, key=times.get)
        pick = ddx_key(chosen)
        print(f"ddx {list(shape)}->{co}: plan {pick} {times[pick]:.4f} ms, "
              f"best {best} {times[best]:.4f}, conv route {conv_ms:.4f}, "
              f"cuDNN {lib_ms:.4f}; "
              + " ".join(f"[{k}] {v:.4f}"
                         + (f" (model {costs[k]:.0f})" if k in costs else "")
                         for k, v in times.items()), flush=True)
        rows.append({"op": "ddx", "shape": list(shape), "co": co,
                     "plan": pick, "best": best, "ms": times,
                     "model": costs, "conv_route_ms": conv_ms,
                     "cudnn_ms": lib_ms})
        del d, wt, ref, wc, d_pad, wc_oihw
        torch.cuda.empty_cache()
    return bad, rows


# upconv3x3's co32 kernel: C-PGGAN 256 px's call (B 32) and at B 64, Co 96,
# and maps it covers at odd sizes (two and three segments, one row, odd
# rows, one image); act with each
UP32_SHAPES = [((32, 128, 128, 64), 32, "lrelu"),
               ((64, 128, 128, 64), 32, "lrelu"),
               ((8, 128, 128, 64), 96, "lrelu"),
               ((1, 5, 256, 64), 32, "relu"), ((3, 1, 128, 64), 32, "none"),
               ((2, 3, 384, 64), 96, "tanh")]


def sweep_up32(gen, dev, flush):
    """upconv3x3's co32 kernel at `UP32_SHAPES` (it has no plan to pick):
    held against the plain version, bit for bit between two launches, its
    path read back from C, and timed beside the bound and F.interpolate +
    cuDNN + act."""
    bf = torch.bfloat16
    bad, rows = 0, []
    for shape, co, act in UP32_SHAPES:
        b, h, w, cin = shape
        x = torch.randn(shape, generator=gen).to(bf).to(dev)
        wt = (torch.randn(3, 3, cin, co, generator=gen)
              * (2.0 / (9 * cin)) ** 0.5).to(bf).to(dev)
        s = (1.0 + 0.1 * torch.randn(co, generator=gen)).to(dev)
        t = (0.1 * torch.randn(co, generator=gen)).to(dev)
        ref = conv.upconv3x3_plain(x, wt, s, t, act)
        got = conv.upconv3x3(x, wt, s, t, act)
        again = conv.upconv3x3(x, wt, s, t, act)
        torch.cuda.synchronize()
        path = conv.upconv_path_on_card(x, conv.combined_weights(wt), got)
        e, n = worst(got, ref)
        same = torch.equal(got, again)
        if path != "co32" or conv.upconv_path(w, cin, co, bf) != "co32" \
                or n or not same:
            bad += 1
            print(f"  FAIL up32 {shape}->{co}: path {path}, max|err| "
                  f"{e:.3e}, {n} out of tolerance, two runs bit-identical "
                  f"{same}", flush=True)
        ms = time_ms(lambda: conv.upconv3x3(x, wt, s, t, act), flush)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t16 = t.to(bf)

        def lib():
            out = F.conv2d(F.interpolate(x_cl, scale_factor=2,
                                         mode="nearest"), w_cl, t16,
                           padding=1)
            return {"lrelu": lambda v: F.leaky_relu(v, 0.2),
                    "relu": F.relu, "tanh": torch.tanh}.get(
                        act, lambda v: v)(out)
        lib_ms = time_ms(lib, flush)
        nb, flops = bench_kernels.upconv_work(shape, co)
        bound_ms, by = bench_kernels.bound(nb, flops, bf)
        print(f"up32 {list(shape)}->{co} {act} [{path}]: {ms:.4f} ms, bound "
              f"{bound_ms:.4f} ({by}, {ms / bound_ms:.2f}x), "
              f"interpolate+cuDNN {lib_ms:.4f}, max|err| {e:.3e}",
              flush=True)
        rows.append({"op": "up32", "shape": [list(shape), co, act],
                     "path": path, "ms": ms, "bound_ms": bound_ms,
                     "bound_by": by, "library_ms": lib_ms,
                     "max_abs_err": e})
        del x, wt, ref, got, again, x_cl, w_cl
        torch.cuda.empty_cache()
    return bad, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", nargs="+", default=["conv", "deconv", "upconv"],
                    choices=["conv", "deconv", "upconv", "dw", "dx", "cdx",
                             "ddx", "up32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    names = ["conv5x5_s2", "conditioning_join", "deconv5x5_s2", "upconv3x3",
             "conv5x5_s2_bwd", "upconv3x3_bwd"]
    _build.build(names)
    for name in names:
        for line in _build.ptxas_report(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "warning", "error", "Performance")):
                print(f"ptxas {name}: {line.strip()}", flush=True)
    flush = bench_kernels.L2Flush(dev)
    bad, rows = 0, []
    if "conv" in args.ops:
        b, r = sweep_conv(gen, dev, flush)
        bad, rows = bad + b, rows + r
    for op, shapes in (("deconv", DECONV_SHAPES), ("upconv", UPCONV_SHAPES)):
        if op in args.ops:
            b, r = sweep_grouped(op, shapes, gen, dev, flush)
            bad, rows = bad + b, rows + r
    if "dw" in args.ops:
        b, r = sweep_dw(gen, dev, flush)
        bad, rows = bad + b, rows + r
    if "dx" in args.ops:
        b, r = sweep_dx(gen, dev, flush)
        bad, rows = bad + b, rows + r
    if "cdx" in args.ops:
        b, r = sweep_cdx(gen, dev, flush)
        bad, rows = bad + b, rows + r
    if "ddx" in args.ops:
        b, r = sweep_ddx(gen, dev, flush)
        bad, rows = bad + b, rows + r
    if "up32" in args.ops:
        b, r = sweep_up32(gen, dev, flush)
        bad, rows = bad + b, rows + r
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    out = os.path.join(os.getcwd(), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "conv_plan_sweep.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(f"failures: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
