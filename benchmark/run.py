"""One run of one benchmark cell of ``text_to_image_tpu_torch``:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the program's kernels built or loaded from ``build/`` in the
checkout, the weights and the split made on the card from the seed, the
cell's checking steps, which warm up every shape it uses), then a window
of ``--seconds`` in which the cell's traffic runs.  ``--trace 0`` prints
the cell's end-to-end metrics; ``--trace 1`` times the same window, then
profiles a short stretch and prints the cell's per-layer metrics, with the
device's busy time and a breakdown.  After the window the program's state
is freed and the plain reference (``benchmark/reference/<config>.py``, f32,
TF32 off) checks what the program produced; each number compared is
printed beside its limit, last on standard error and last in the result.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
``checks``.

Exits non-zero without a result when the machine has fewer CUDA devices
than the cell asks for, and when a module of JAX or of the JAX package
(``text_to_image_tpu``) is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))

# caches of anything that compiles, at fixed paths inside the checkout
_CACHE = ROOT / "build" / "bench_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(_CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(_CACHE / "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = ROOT, device: str = "cuda") -> int:
    """Run the cell; `device` "cpu" skips the look for a card (tests)."""
    args = parse(argv)
    import torch

    from benchmark.common import compare, harness, traffic

    run = harness.load_run(Path(root), args.workload, args.seed, device)
    chips = run.entry["chips"]
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()

    drv = traffic.driver(run)
    drv.setup()
    setup_s = time.perf_counter() - T0
    e2e = drv.window(args.seconds)
    run.timing = {"count": drv.count, "seconds": drv.seconds,
                  "unit": drv.unit}
    run.trace = None
    if args.trace:
        run.trace = drv.profile(drv.p["profile_seconds"])
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    drv.release()

    numbers = drv.check()
    limits = run.cell["limits"]
    correct = compare.verdict(numbers, limits)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in
              numbers.items()}

    metrics = {}
    if args.trace:
        for m in run.per_layer:
            v = harness.read_metric(Path(root), m, run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in run.e2e:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": chips if device == "cuda" else 0,
           "memory_peak_bytes": peak}
    breakdown = None
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        breakdown = run.trace.breakdown()
    banned = harness.banned_modules()
    if banned:
        print(f"loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(harness.result_line(correct, drv.attempted, drv.failed, metrics,
                              dev, breakdown, checks))
    return 0


if __name__ == "__main__":
    sys.exit(main())
