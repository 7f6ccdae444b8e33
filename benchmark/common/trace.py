"""The device trace of a short steady stretch: ``torch.profiler`` over
the card's activity alone (kernels, copies, fills and the runtime calls
that launched them), written as a Chrome trace and read back.  Host
activity is not profiled: recording every host op slowed a Stage-II tick
by 40 % on the card (CUDA alone: 10 %), which the idle share would read.

A driver's spans (``closed_train``'s ``data`` and ``tick``) are timed on
the host's monotonic clock by `Spans` and moved onto the trace's
clock by one marker: a device synchronisation issued just after reading
the clock, whose runtime call the trace records.  Each device operation
belongs to the span in which the host launched it (the launch's
correlation id).  From the operations:

* `busy_s`: the union of the operations' intervals; `window_s`: from the
  first span's start to the end of the last operation or span;
* `family_s` / `span_s`: device seconds by family and by span;
* `breakdown()`: the ten families that took the most device time, and the
  ten longest idle gaps of the window, each named by the span in which the
  host launched the operation that ended it ("none" outside every span).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from benchmark.common.kernels import family

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "cudaDeviceSynchronize"


class Spans:
    """The benchmark's spans of a traced stretch: (name, start ns, end ns)
    on the host's monotonic clock."""

    def __init__(self):
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.monotonic_ns()))


class Trace:
    def __init__(self, events: List[Dict], names: Tuple[str, ...],
                 spans: List[Tuple[str, int, int]], mark_ns: int):
        launches = {}
        ops = []
        marks = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = e["ts"]
                if e.get("name") == MARKER:
                    marks.append(e["ts"])
            elif cat in DEVICE_CATS:
                ops.append(e)
        # the trace's clock (µs) minus the host's monotonic clock (µs)
        offset = min(marks) - mark_ns / 1e3 if marks else 0.0
        self.spans = sorted((t0 / 1e3 + offset, t1 / 1e3 + offset, name)
                            for name, t0, t1 in spans if name in names)
        starts = [s[0] for s in self.spans]

        def span_at(ts: Optional[float]) -> str:
            if ts is None:
                return "none"
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= self.spans[i][1]:
                return self.spans[i][2]
            return "none"

        # (start, end, family, span, name) of each device operation, µs
        self.ops = sorted(
            (e["ts"], e["ts"] + e.get("dur", 0.0), family(e["cat"], e["name"]),
             span_at(launches.get(e.get("args", {}).get("correlation"))),
             e["name"])
            for e in ops)
        self.counts = {name: sum(1 for s in self.spans if s[2] == name)
                       for name in names}

    @property
    def empty(self) -> bool:
        return not self.ops

    def _merged(self) -> List[Tuple[float, float, str]]:
        """The busy intervals, each with the span of its first operation."""
        out: List[List] = []
        for s, e, _, span, _ in self.ops:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e, span])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self._merged()) / 1e6

    @property
    def window(self) -> Tuple[float, float]:
        start = min([s[0] for s in self.spans] + [o[0] for o in self.ops[:1]])
        end = max([s[1] for s in self.spans] + [o[1] for o in self.ops])
        return start, end

    @property
    def window_s(self) -> float:
        s, e = self.window
        return (e - s) / 1e6

    def family_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, fam, _, _ in self.ops:
            out[fam] = out.get(fam, 0.0) + (e - s) / 1e6
        return out

    def span_s(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s, e, _, span, _ in self.ops:
            out[span] = out.get(span, 0.0) + (e - s) / 1e6
        return out

    def gaps(self) -> List[Tuple[str, float]]:
        """(span, seconds) of each idle stretch of the window, the leading
        one included, longest first."""
        out = []
        prev = self.window[0]
        for s, e, span in self._merged():
            if s > prev:
                out.append((span, (s - prev) / 1e6))
            prev = max(prev, e)
        return sorted(out, key=lambda g: -g[1])

    def breakdown(self) -> Dict[str, List]:
        fams = sorted(self.family_s().items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in fams],
                "idle_gaps": [[k, v] for k, v in self.gaps()[:10]]}


@contextlib.contextmanager
def profiled(names: Tuple[str, ...], holder: Dict):
    """Profile the card's activity over the body, which gets a `Spans`
    to time its spans; on exit the trace is read into
    ``holder["trace"]``.  The Chrome trace goes to a temporary directory
    and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    spans = Spans()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            mark = time.monotonic_ns()
            if cuda:
                torch.cuda.synchronize()
            yield spans
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    holder["trace"] = Trace(events, names, spans.items, mark)
