"""Training ticks of several checkouts of this repository, in turns on one
card: the GAN-CLS 64 px, the WGAN-CLS 64 px and the StackGAN Stage-II 256 px
tick at the shipped configs' full widths (batch 64, bf16) — ms per tick,
images/s, peak memory,
and device time by kernel family with the launches per tick — for a
before/after comparison inside one run.

    python text_to_image_tpu_torch/tools/tick_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory); each runs in a
process of its own, which builds that checkout's kernels and times it with
that checkout's own ``tools/ticks.py`` (`tick_timing` and `tick_profile`,
the functions ``chip_smoke.py`` reports the ticks with; a checkout without
that module predates it and cannot take part).  Writes
``chiprun_out/tick_ab.json`` and prints one line per run.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# run inside the child, with the checkout's root first on sys.path
_CHILD = r"""
import json, sys, torch
root = sys.argv[1]
sys.path.insert(0, root)
from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.tools import ticks
if not torch.cuda.is_available():
    raise SystemExit("tick_ab needs a GPU")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build(_build.sources())
device = torch.device("cuda", 0)
out = {}
for model, n in (("gancls", 10), ("wgancls", 5), ("stackgan_stage2", 5)):
    tick, state = ticks.tick_timing(device, model, n)
    tick["profile"] = ticks.tick_profile(*state, tick["tick_ms"])
    out[model] = tick
    del state
    torch.cuda.empty_cache()
print("TICK_AB " + json.dumps(out))
"""


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    runs = []
    for root in argv:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root], cwd=root,
                              capture_output=True, text=True, timeout=1200)
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
