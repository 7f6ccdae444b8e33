"""The one generator of the benchmark's traffic.  A mix
(``benchmark/traffic/<mix>.json``) is data: the name of its ``driver`` and
its parameters; a cell (``benchmark/workloads/<cell>.json``) may set more.
The driver, ``benchmark/drivers/<driver>.py``, is found by that name and
runs the program under those parameters: a new kind of traffic is a new
driver file and a mix that names it, with no edit to this one.

A driver module defines ``Driver``, a subclass of `Driver` below, with
these phases: `setup`, `window` (the end-to-end metrics), `profile` (a
short traced stretch inside the driver's spans, through `one`),
`release` (the program's state freed) and `check` (the numbers that
decide ``correct``).  After `window` it holds ``count`` units of work
(``unit``, such as "tick") done in ``seconds``, and ``attempted``
and ``failed``.
"""

from __future__ import annotations

import gc
import time
from contextlib import contextmanager
from typing import Dict

import torch

from benchmark.common import harness, program, trace


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def f32_exact():
    """TF32 off for float32 products while the reference runs."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Driver:
    spans: tuple = ()
    unit = ""
    heavy: tuple = ()

    def __init__(self, ctx):
        self.ctx = ctx
        self.p = {**ctx.traffic, **ctx.cell.get("params", {})}
        self.conf, self.seed, self.device = ctx.conf, ctx.seed, ctx.device
        self.cfg = program.load_config(self.conf, self.seed)
        self.spec = ctx.reference.param_spec(self.conf["config"])
        self.attempted = self.failed = self.count = 0
        self.seconds = 0.0

    def profile(self, seconds: float) -> trace.Trace:
        holder: Dict = {}
        sync(self.device)
        with trace.profiled(self.spans, holder) as spans:
            t0 = time.perf_counter()
            n = 0
            while n < 2 or time.perf_counter() - t0 < seconds:
                self.one(spans)
                n += 1
        return holder["trace"]

    def check(self) -> Dict[str, float]:
        """The numbers that decide ``correct``: what the program produced
        against the f32 reference."""
        return self.judge(self.ours)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for k in self.heavy:
            if hasattr(self, k):
                delattr(self, k)
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def driver(ctx) -> Driver:
    """The driver that the cell's mix names, loaded from its file."""
    name = ctx.traffic["driver"]
    path = ctx.root / "benchmark" / "drivers" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"traffic {ctx.entry['traffic']!r}: no driver "
                         f"{name!r} ({path.name} not in benchmark/drivers)")
    return harness.load_module(path, f"benchmark_driver_{name}").Driver(ctx)
