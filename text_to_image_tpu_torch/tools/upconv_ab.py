"""The up-block's forward (``upconv3x3_bias``) of several checkouts of this
repository, in turns on one card: the eight StackGAN calls (batch 64, no
activation, a BN after) and the six C-PGGAN calls (lrelu; stages 2-5 at
batch 64, the 256 px progression's two at batch 32), then C-PGGAN 256 px's
128²×64→32 call at batch 64 — device ms of each call beside
``F.interpolate`` + cuDNN ``conv2d`` (+ leaky ReLU) and the bound, with
the code path the checkout's C entry point reports, for a before/after
comparison inside one run.

    python text_to_image_tpu_torch/tools/upconv_ab.py OLD NEW NEW OLD

Each positional argument is the root of a checkout (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory); each
runs in a process of its own, which builds that checkout's kernels and
times them with that checkout's own ``tools/bench_kernels.py``
(`time_ms`: CUDA events, the L2 flushed before each launch), after holding
each output against the checkout's plain version.  Every row's bound is
this tree's (``bench_kernels.upconv_work``: x, w, the bias and y once, the
products whose taps land in the map), the same for every checkout.  bf16.
Writes ``chiprun_out/upconv_ab.json`` and prints one table per run.  Needs
a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

# (B, H, W, Cin), Co, act of every call, in this tree's microbench terms
STACKGAN = [((64, 4, 4, 1024), 512), ((64, 8, 8, 512), 256),
            ((64, 16, 16, 256), 128), ((64, 32, 32, 128), 64),
            ((64, 16, 16, 512), 256), ((64, 32, 32, 256), 128),
            ((64, 64, 64, 128), 64), ((64, 128, 128, 64), 64)]
PGGAN = [((64, 4, 4, 512), 512), ((64, 8, 8, 512), 512),
         ((64, 16, 16, 512), 256), ((64, 32, 32, 256), 128),
         ((32, 64, 64, 128), 64), ((32, 128, 128, 64), 32),
         ((64, 128, 128, 64), 32)]
CALLS = ([(s, co, "none") for s, co in STACKGAN]
         + [(s, co, "lrelu") for s, co in PGGAN])

# run inside the child, with the checkout's root first on sys.path
_CHILD = r"""
import json, math, sys, torch
import torch.nn.functional as F
root, calls = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
from text_to_image_tpu_torch.ops.kernels import _build, conv
from text_to_image_tpu_torch.tools import bench_kernels as bk
if not torch.cuda.is_available():
    raise SystemExit("upconv_ab needs a GPU")
torch.backends.cudnn.allow_tf32 = False
_build.build(["upconv3x3"])
device = torch.device("cuda", 0)
flush = bk.L2Flush(device)
gen = torch.Generator(device).manual_seed(0)
bf = torch.bfloat16
rows = []
for (b, h, wd, cin), co, act in calls:
    x = bk.randn(gen, b, h, wd, cin).to(bf)
    w = (bk.randn(gen, 3, 3, cin, co) * math.sqrt(2.0 / (9 * cin))).to(bf)
    t = 0.1 * bk.randn(gen, co)
    y = conv.upconv3x3_bias(x, w, t, act)
    ref = conv.upconv3x3_plain(x, w, torch.ones_like(t), t, act)
    err = bk.hold(y, ref, *bk.TOL, f"upconv3x3_bias {(b, h, wd, cin)}->{co}")
    path = conv.upconv_path_on_card(x, conv.combined_weights(w), y)
    x_cl = x.permute(0, 3, 1, 2)
    w_t = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    t16 = t.to(bf)

    def lib():
        out = F.conv2d(F.interpolate(x_cl, scale_factor=2, mode="nearest"),
                       w_t, t16, padding=1)
        return F.leaky_relu(out, 0.2) if act == "lrelu" else out
    rows.append({"shape": [b, h, wd, cin], "co": co, "act": act,
                 "path": path,
                 "ms": bk.time_ms(lambda: conv.upconv3x3_bias(x, w, t, act),
                                  flush),
                 "library_ms": bk.time_ms(lib, flush),
                 "max_abs_err": err})
    del x, w, y, ref, x_cl, w_t
    torch.cuda.empty_cache()
print("UPCONV_AB " + json.dumps({"card": bk.card(), "rows": rows}))
"""


def table(rows) -> str:
    lines = ["| call | path | ms | bound ms | cuDNN route ms |",
             "|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['shape']}->{r['co']} {r['act']} | {r['path']} | "
            f"{r['ms']:.4f} | {r['bound_ms']:.4f} "
            f"{r['bound_by'][0].upper()} | {r['library_ms']:.4f} |")
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
            [sys.executable, "-c", _CHILD, root, json.dumps(CALLS)],
            cwd=root, capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-2000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise RuntimeError(f"{root}: rc {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("UPCONV_AB ")][-1]
        res = json.loads(line[len("UPCONV_AB "):])
        for r in res["rows"]:
            r["bound_ms"], r["bound_by"] = bk.bound(
                *bk.upconv_work(tuple(r["shape"]), r["co"]), torch.bfloat16)
        runs.append({"root": root, **res})
        print(f"{root} ({res['card']}):\n{table(res['rows'])}", flush=True)
    out_dir = os.path.join(repo, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "upconv_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
