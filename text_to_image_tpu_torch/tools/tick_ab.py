"""Training ticks of several checkouts of this repository, in turns on one
card: by default the StackGAN Stage-I 64 px and Stage-II 256 px ticks
(batch 64) and the C-PGGAN stage-7 tick (256 px, batch 32), the paths that
run the up-block's backward, at the shipped configs' full widths in bf16 —
ms per tick, images/s, peak memory, and device time by kernel family with
the launches per tick — for a before/after comparison inside one run.

    python text_to_image_tpu_torch/tools/tick_ab.py OLD NEW NEW OLD
    python text_to_image_tpu_torch/tools/tick_ab.py OLD NEW NEW OLD --models gancls wgancls stackgan_stage2

Each positional argument is the root of a checkout (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory); each
runs in a process of its own, which builds that checkout's kernels and
times it with that checkout's own ``tools/ticks.py`` (`tick_timing` and
`tick_profile`, the functions ``chip_smoke.py`` reports the ticks with; a
checkout without that module predates it and cannot take part).  The
C-PGGAN stage-7 tick, whose config is not `tick_timing`'s (batch 32, the
256 px progression), is timed the same way in the child from the
checkout's `init_train_state` and `make_train_step`.  ``--models`` names
the ticks: ``gancls``, ``wgancls``, ``stackgan_stage1``,
``stackgan_stage2`` (configs/<model>_flowers.yml) and ``pggan_stage7``
(configs/pggan_flowers_256.yml at stage 7).  Writes
``chiprun_out/tick_ab.json`` and prints one line per run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (config and overrides for the child's own timing, or None for
# `ticks.tick_timing`; ticks a window) of each model
MODELS = {
    "gancls": (None, 10),
    "wgancls": (None, 5),
    "stackgan_stage1": (None, 10),
    "stackgan_stage2": (None, 5),
    "pggan_stage7": (("pggan_flowers_256.yml", {"pggan.stage": 7}), 3),
}
DEFAULT = ("stackgan_stage1", "stackgan_stage2", "pggan_stage7")

# run inside the child, with the checkout's root first on sys.path
_CHILD = r"""
import json, os, sys, time, torch
root, specs = sys.argv[1], json.loads(sys.argv[2])
sys.path.insert(0, root)
from text_to_image_tpu_torch.config import load_config
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.tools import ticks
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_train_step)
if not torch.cuda.is_available():
    raise SystemExit("tick_ab needs a GPU")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(_build.sources())
device = torch.device("cuda", 0)
out = {}
for model, (own, n) in specs.items():
    if own is None:
        tick, state = ticks.tick_timing(device, model, n)
        tick["profile"] = ticks.tick_profile(*state, tick["tick_ms"])
        out[model] = tick
        del state
        torch.cuda.empty_cache()
        continue
    yml, extra = own
    cfg = load_config(os.path.join(root, "configs", yml),
                      {"data.dataset_name": "synthetic",
                       "stage1_checkpoint": "",
                       "train.summary_interval": 1, **extra})
    bsz = cfg.train.batch_size
    ds = get_dataset(cfg)
    spe = max(1, ds.num_examples // bsz)
    ts = init_train_state(cfg.seed, cfg, spe, device)
    step = make_train_step(cfg, spe, device)
    slices = [ds.next_batch(bsz) for _ in range(cfg.train.n_critic)]
    batch = {k: torch.stack([torch.as_tensor(b[k]) for b in slices])
             .to(device) for k in slices[0]}
    for _ in range(2):
        ts, m = step(ts, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            ts, m = step(ts, batch)
        float(m["g_loss"])
        rates.append(n * bsz / (time.perf_counter() - t0))
    rate = sorted(rates)[1]
    tick = {"tick_ms": bsz / rate * 1e3, "images_per_s": rate,
            "windows_images_per_s": rates, "batch": bsz,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    tick["profile"] = ticks.tick_profile(ts, step, batch, tick["tick_ms"])
    out[model] = tick
    del ts, step, batch
    torch.cuda.empty_cache()
print("TICK_AB " + json.dumps(out))
"""


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", nargs="+", choices=sorted(MODELS),
                   default=list(DEFAULT))
    p.add_argument("roots", nargs="+", help="checkouts, run in this order")
    args = p.parse_args(argv)
    specs = json.dumps({m: MODELS[m] for m in args.models})
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    runs = []
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root, specs],
                              cwd=root, capture_output=True, text=True,
                              timeout=1800)
        sys.stderr.write(proc.stderr[-2000:])
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            raise RuntimeError(f"{root}: rc {proc.returncode}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("TICK_AB ")][-1]
        res = json.loads(line[len("TICK_AB "):])
        runs.append({"root": root, **res})
        print(f"{root}: " + "; ".join(
            f"{m} {r['tick_ms']:.3f} ms/tick, device busy "
            f"{r['profile']['device_busy_ms']:.3f} ms, "
            f"{r['profile']['kernels_per_tick']:.0f} launches, peak "
            f"{r['peak_memory_gib']:.2f} GiB" for m, r in res.items()),
            flush=True)
    out_dir = os.path.join(repo, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "tick_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
