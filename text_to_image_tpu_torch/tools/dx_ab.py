"""The input gradients of the two 5×5 stride-2 ops and the thin transposed
conv of several checkouts of this repository, in turns on one card: the
dx of ``conv5x5_s2_act`` (``conv.conv_dx``, the public route every
backward takes) at every call of the 64 px and the 256 px discriminators
at the D step's 3·64 rows and the G step's 64; the dx of
``deconv5x5_s2`` (``conv.deconv_dx`` where the checkout has it, else the
conv of the cotangent with the flipped weight and a zero bias, the route
``_Deconv.backward`` took before it) at the GAN-CLS generator's four
calls and the WGAN-CLS critic's first-layer dx in the gradient penalty
(d 64²×3 → 32²×64), with the old route's parts timed alone (the flipped
weight's copy, the zero bias, the conv kernel with both made
beforehand); the GAN-CLS generator's RGB layer (``deconv5x5_s2``
32²×128→64²×3, tanh, batch 64); and the 64 px discriminator's RGB layer
forward (``conv5x5_s2_act`` 64²×3→64, lrelu) at the D step's 3·64 rows
and the G step's 64 — device ms of the whole route (its copies and fills
included), beside cuDNN's ``conv2d_input`` (the deconv's dx: ``conv2d``
over the padded cotangent; the generator's RGB layer:
``conv_transpose2d`` + tanh; the discriminator's: ``conv2d`` over the
padded input + leaky ReLU) and the bound, for a before/after comparison
inside one run.

    python text_to_image_tpu_torch/tools/dx_ab.py OLD NEW NEW OLD

Each positional argument is the root of a checkout (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory); each
runs in a process of its own, which builds that checkout's kernels and
times them with that checkout's own ``tools/bench_kernels.py``
(`time_ms`: CUDA events, the L2 flushed before each launch), after holding
each output against the checkout's plain version.  Every row's bound is
this tree's (``bench_kernels``' work of the call: each input read once,
each output written once, the products whose taps land in the map), the
same for every checkout.  bf16.
Writes ``chiprun_out/dx_ab.json`` and prints one table per run.  Needs a
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

B = 64
# (B, H, W, Cin) → Co of every conv whose dx a training tick takes: the
# 64 px D (GAN-CLS, GAN-INT, WGAN-CLS's critic) and the 256 px D
# (Stage-II); the first layer's dx (the gradient into the image) only in
# the G step, at 64 rows
D64 = ((64, 3, 64), (32, 64, 128), (16, 128, 256), (8, 256, 512))
D256 = ((256, 3, 64), (128, 64, 128), (64, 128, 256), (32, 256, 512),
        (16, 512, 512), (8, 512, 512))
DX_CALLS = [((b, r, r, cin), co) for d in (D64, D256)
            for b in (3 * B, B) for r, cin, co in d
            if cin > 3 or b == B]
# the deconv's dx, (B, H, W, Cin) → Co of the deconv: the GAN-CLS (and
# GAN-INT, WGAN-CLS) generator's four calls, then the critic's first-layer
# dx that the gradient penalty's second order differentiates (a deconv of
# Cin 64 to Co 3)
DDX_CALLS = [((B, 4, 4, 1024), 512), ((B, 8, 8, 512), 256),
             ((B, 16, 16, 256), 128), ((B, 32, 32, 128), 3),
             ((B, 32, 32, 64), 3)]
# the GAN-CLS generator's RGB layer: (B, H, W, Cin) → Co
RGB_CALLS = [((B, 32, 32, 128), 3)]
# the 64 px discriminator's RGB layer forward, at the D step's rows and the
# G step's
D_RGB_CALLS = [((3 * B, 64, 64, 3), 64), ((B, 64, 64, 3), 64)]

# run inside the child, with the checkout's root first on sys.path
_CHILD = r"""
import json, sys, torch
import torch.nn.functional as F
root, dx_calls, ddx_calls, rgb_calls, d_rgb_calls = (
    sys.argv[1], *map(json.loads, sys.argv[2:6]))
sys.path.insert(0, root)
from text_to_image_tpu_torch.ops.kernels import _build, conv
from text_to_image_tpu_torch.tools import bench_kernels as bk
if not torch.cuda.is_available():
    raise SystemExit("dx_ab needs a GPU")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(_build.sources())
device = torch.device("cuda", 0)
flush = bk.L2Flush(device)
gen = torch.Generator(device).manual_seed(0)
bf = torch.bfloat16
rows = []


def row(kind, shape, co, route, ms, lib, lib_ms, err, parts=None):
    return {"kernel": kind, "shape": list(shape), "co": co, "route": route,
            "ms": ms, "library": lib, "library_ms": lib_ms,
            "max_abs_err": err, "parts": parts or {}}


def route_tag(gc, w, h, wd, dx):
    b, _, _, cin = dx.shape
    co = w.shape[-1]
    if hasattr(conv, "conv_dx_route"):
        return conv.conv_dx_route(b, h, wd, cin, co, gc.dtype)
    path = conv.deconv_path_on_card(gc, conv.deconv_dx_weight(w),
                                    torch.empty(1, device=device))
    return f"deconv5x5_s2 {path}"


for (b, h, wd, cin), co in dx_calls:
    ho, wo = (h + 1) // 2, (wd + 1) // 2
    gc = bk.randn(gen, b, ho, wo, co).to(bf)
    w = (bk.randn(gen, 5, 5, cin, co) * 0.05).to(bf)
    dx = conv.conv_dx(gc, w, h, wd)
    small = slice(0, 2)
    ref = conv.conv_dx(gc[small].cpu(), w.cpu(), h, wd)
    err = bk.hold(dx[small], ref.to(device), *bk.TOL,
                  f"conv dx {(b, h, wd, cin)}->{co}", rel_to_max=True)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    g_cl = gc.permute(0, 3, 1, 2)
    padded = (b, cin, h + 3, wd + 3)
    rows.append(row(
        "conv dx", (b, h, wd, cin), co, route_tag(gc, w, h, wd, dx),
        bk.time_ms(lambda: conv.conv_dx(gc, w, h, wd), flush,
                   spin=bk.HOST_SPIN),
        "cuDNN conv2d_input",
        bk.time_ms(lambda: torch.nn.grad.conv2d_input(padded, w_oihw, g_cl,
                                                      stride=2), flush,
                   spin=bk.HOST_SPIN), err))
    del gc, w, dx, w_oihw, g_cl
    torch.cuda.empty_cache()

def old_deconv_dx(d, w):
    return conv.conv5x5_s2_act(d, conv.deconv_dx_weight(w),
                               torch.zeros(w.shape[2], device=d.device),
                               "none")


deconv_dx = getattr(conv, "deconv_dx", old_deconv_dx)
for (b, h, wd, cin), co in ddx_calls:
    d = bk.randn(gen, b, 2 * h, 2 * wd, co).to(bf)
    w = (bk.randn(gen, 5, 5, cin, co) * 0.05).to(bf)
    dx = deconv_dx(d, w)
    small = slice(0, 2)
    ref = conv.conv5x5_s2_act_plain(d[small].cpu(),
                                    conv.deconv_dx_weight(w.cpu()),
                                    torch.zeros(cin), "none")
    err = bk.hold(dx[small], ref.to(device), *bk.TOL,
                  f"deconv dx {(b, h, wd, cin)}->{co}", rel_to_max=True)
    wc = conv.deconv_dx_weight(w)
    zero = torch.zeros(cin, device=device)
    if hasattr(conv, "deconv_dx_route"):
        tag = conv.deconv_dx_route(b, h, wd, cin, co, bf)
    else:
        path = conv.conv_path_on_card(d, wc, dx)
        plan = (" %dx%d split %d" % conv.conv_plan(b * h * wd, cin, 25 * co)
                if path == "wgmma" else "")
        tag = f"conv5x5_s2_act {path}{plan}"
    # the old route's parts alone, in every checkout
    parts = {"flip copy": bk.time_ms(lambda: conv.deconv_dx_weight(w), flush),
             "zero bias": bk.time_ms(
                 lambda: torch.zeros(cin, device=device), flush),
             "conv5x5_s2_act alone": bk.time_ms(
                 lambda: conv.conv5x5_s2_act(d, wc, zero, "none"), flush)}
    d_pad = F.pad(d.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
        memory_format=torch.channels_last)
    wc_oihw = wc.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    rows.append(row(
        "deconv dx", (b, h, wd, cin), co, tag,
        bk.time_ms(lambda: deconv_dx(d, w), flush, spin=bk.HOST_SPIN),
        "cuDNN conv2d (cotangent padded beforehand)",
        bk.time_ms(lambda: F.conv2d(d_pad, wc_oihw, stride=2), flush), err,
        parts))
    del d, w, dx, wc, d_pad, wc_oihw
    torch.cuda.empty_cache()

for (b, h, wd, cin), co in rgb_calls:
    x = torch.relu(bk.randn(gen, b, h, wd, cin)).to(bf)
    w = (bk.randn(gen, 5, 5, cin, co) * 0.02).to(bf)
    s = 1.0 + 0.1 * bk.randn(gen, co)
    t = 0.1 * bk.randn(gen, co)
    y = conv.deconv5x5_s2(x, w, s, t, "tanh")
    err = bk.hold(y, conv.deconv5x5_s2_plain(x, w, s, t, "tanh"), *bk.TOL,
                  f"deconv5x5_s2 {(b, h, wd, cin)}->{co}")
    path = conv.deconv_path_on_card(x, w, y)
    x_cl = x.permute(0, 3, 1, 2)
    w_t = w.permute(2, 3, 0, 1).flip(2, 3).contiguous()
    rows.append(row(
        "deconv5x5_s2 (RGB)", (b, h, wd, cin), co, f"deconv5x5_s2 {path}",
        bk.time_ms(lambda: conv.deconv5x5_s2(x, w, s, t, "tanh"), flush),
        "cuDNN conv_transpose2d + tanh",
        bk.time_ms(lambda: torch.tanh(F.conv_transpose2d(
            x_cl, w_t, stride=2, padding=1)), flush), err))
    del x, w, y, x_cl, w_t
    torch.cuda.empty_cache()

for (b, h, wd, cin), co in d_rgb_calls:
    x = bk.randn(gen, b, h, wd, cin).to(bf)
    w = (bk.randn(gen, 5, 5, cin, co) * 0.05).to(bf)
    bias = 0.1 * bk.randn(gen, co)
    y = conv.conv5x5_s2_act(x, w, bias, "lrelu")
    err = bk.hold(y, conv.conv5x5_s2_act_plain(x, w, bias, "lrelu"),
                  *bk.TOL, f"conv5x5_s2_act {(b, h, wd, cin)}->{co}")
    path = conv.conv_path_on_card(x, w, y)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 2, 1, 2)).contiguous(
        memory_format=torch.channels_last)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    b16 = bias.to(bf)
    rows.append(row(
        "conv5x5_s2_act (D RGB)", (b, h, wd, cin), co,
        f"conv5x5_s2_act {path}",
        bk.time_ms(lambda: conv.conv5x5_s2_act(x, w, bias, "lrelu"), flush),
        "cuDNN conv2d + leaky_relu (input padded beforehand)",
        bk.time_ms(lambda: F.leaky_relu(F.conv2d(xp, w_oihw, b16, stride=2),
                                        0.2), flush), err))
    del x, w, y, xp, w_oihw
    torch.cuda.empty_cache()
print("DX_AB " + json.dumps({"card": bk.card(), "rows": rows}))
"""


def work(bk, r):
    """(bytes, operations) of a row's call by `bk`, this tree's
    ``tools/bench_kernels``."""
    shape, co = tuple(r["shape"]), r["co"]
    return {"conv dx": bk.conv_dx_work, "deconv dx": bk.deconv_dx_work,
            "deconv5x5_s2 (RGB)": bk.deconv_work,
            "conv5x5_s2_act (D RGB)": bk.conv_work}[r["kernel"]](shape, co)


def with_bounds(bk, rows):
    """Each row with the bound of its call (bf16)."""
    for r in rows:
        r["bound_ms"], r["bound_by"] = bk.bound(*work(bk, r), torch.bfloat16)
    return rows


def table(rows) -> str:
    lines = ["| call | route | ms | bound ms | cuDNN ms | parts ms |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        parts = ", ".join(f"{k} {v:.4f}"
                          for k, v in r.get("parts", {}).items())
        lines.append(
            f"| {r['kernel']} {r['shape']}->{r['co']} | {r['route']} | "
            f"{r['ms']:.4f} | {r['bound_ms']:.4f} {r['bound_by'][0].upper()}"
            f" | {r['library_ms']:.4f} | {parts} |")
    return "\n".join(lines)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("roots", nargs="+", help="checkouts, run in this order")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    sys.path.insert(0, repo)   # this tree's work counts bound every row
    from text_to_image_tpu_torch.tools import bench_kernels as bk
    runs = []
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, root, json.dumps(DX_CALLS),
             json.dumps(DDX_CALLS), json.dumps(RGB_CALLS),
             json.dumps(D_RGB_CALLS)],
            cwd=root, capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-2000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise RuntimeError(f"{root}: rc {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("DX_AB ")][-1]
        res = json.loads(line[len("DX_AB "):])
        with_bounds(bk, res["rows"])
        runs.append({"root": root, **res})
        print(f"{root} ({res['card']}):\n{table(res['rows'])}", flush=True)
    out_dir = os.path.join(repo, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "dx_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
