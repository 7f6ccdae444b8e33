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
            flops = 2 * 25 * m * cin * co
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
            flops = 2 * 16 * m * cin * co
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
                flops = 2 * m * co * 25 * shape[-1]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ops", nargs="+", default=["conv", "deconv", "upconv"],
                    choices=["conv", "deconv", "upconv"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    names = ["conv5x5_s2", "conditioning_join", "deconv5x5_s2", "upconv3x3"]
    _build.build(names)
    for name in names:
        for line in _build.ptxas_report(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling",
                                       "warning", "error")):
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
