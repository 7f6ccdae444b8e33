"""The readings that a training cell's limits are set from, on the card
at the cell's own size (not run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13] [--fault-seeds 14 15 16] \
        [--out readings.json]

For each seed the program runs as a benchmark run does up to its window
(set-up and its checking ticks), its state is freed, and the f32
reference works out the same ticks.  The program's gaps to it are the
lower readings.  On the control seeds the reference itself also runs in
the program's place, once in float8 (the control) and once on half of
each batch (a fault): their gaps to the f32 reference are upper readings.
On the fault seeds the program runs again with each fault of `PLANTED`
planted in it.  A state left unchanged reads 1 on ``change`` by
definition and needs no run.  Writes every reading, and each side's
per-leaf gaps, as JSON, anew after each seed.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path.pop(0)
sys.path.insert(0, str(ROOT))


def _upconv_dw(transform):
    def plant():
        from text_to_image_tpu_torch.ops.kernels import conv
        full = conv.upconv3x3_dw

        @functools.wraps(full)      # its attributes too (a launch count)
        def broken(*args, **kwargs):
            return transform(full(*args, **kwargs))
        return conv, "upconv3x3_dw", broken
    return plant


# faults of the generator's backward alone, planted in the program: each
# gives (module, attribute, replacement)
PLANTED = {
    # the up-block's weight gradient with its rows of taps swapped: a
    # permutation within the leaf, its norm kept
    "upconv_dw_flipped": _upconv_dw(lambda dw: dw.flip(0)),
    # the same gradient doubled
    "upconv_dw_scaled": _upconv_dw(lambda dw: dw * 2),
}


@contextmanager
def planted(name: str):
    mod, attr, fn = PLANTED[name]()
    old = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        yield
    finally:
        setattr(mod, attr, old)


def side_readings(drv, side: dict) -> tuple:
    """A side's numbers against the f32 reference, and its leaf changes
    and per-leaf first-gradient gaps, as JSON."""
    from benchmark.common import compare
    ref = drv._ref
    ref_g = drv.g_reference(side["d_at_g"]) if side.get("d_at_g") else None
    numbers = compare.train_numbers(side, ref, ref_g)
    leaves = {"change": side["change"],
              "d_diff": compare.diff_gaps(side["grad"].get("d", {}),
                                          ref["grad"]["d"]),
              "g_diff": (compare.diff_gaps(side["grad"].get("g", {}), ref_g)
                         if ref_g is not None else None)}
    return numbers, leaves


def _program(cell, seed, root, device):
    from benchmark.common import harness, traffic
    drv = traffic.driver(harness.load_run(root, cell, seed, device))
    drv.setup()
    drv.release()
    drv._ref = drv.reference()
    return drv


def readings(cell: str, seeds, control_seeds=(), fault_seeds=(),
             root: Path = ROOT, device: str = "cuda", out_path=None) -> dict:
    import torch
    sides = ("program", "control", "half_batch", *PLANTED)
    out = {"cell": cell, **{s: {} for s in sides}, "raw": {}}
    if device == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    for seed in dict.fromkeys([*seeds, *control_seeds, *fault_seeds]):
        t0 = time.perf_counter()
        raw = out["raw"].setdefault(seed, {})
        runs = {}
        if seed in seeds or seed in control_seeds:
            drv = _program(cell, seed, root, device)
            runs["program"] = (drv, drv.ours)
            if seed in control_seeds:
                runs["control"] = (drv, drv.reference(prec="fp8"))
                runs["half_batch"] = (drv, drv.reference(fault="half_batch"))
        if seed in fault_seeds:
            for name in PLANTED:
                with planted(name):
                    d = _program(cell, seed, root, device)
                runs[name] = (d, d.ours)
        for side, (d, r) in runs.items():
            out[side][seed], raw[side] = side_readings(d, r)
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0,
                          **{k: out[k].get(seed) for k in sides}}),
              flush=True)
        del runs
        if out_path:
            Path(out_path).write_text(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    readings(a.workload, a.seeds, a.control_seeds, a.fault_seeds,
             out_path=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
