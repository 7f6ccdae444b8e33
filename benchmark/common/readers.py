"""What the per-layer metrics' readers (``benchmark/metrics/<name>.py``)
share.  Each reader returns None where it finds nothing to read: no card,
no trace, or no device time in the families it reads (a kernel renamed
by a later change), so the harness leaves the metric out of the line."""

from __future__ import annotations

from typing import Iterable, Optional

from benchmark.common import kernels, work


def _traced(run):
    t = getattr(run, "trace", None)
    if run.device != "cuda" or t is None or t.empty:
        return None
    return t


def _units(run, t) -> int:
    return t.counts.get(run.timing["unit"], 0)


def device_ms(run, families: Iterable[str]) -> Optional[float]:
    """Device ms a unit of work in `families`."""
    t = _traced(run)
    if t is None or not _units(run, t):
        return None
    fams = t.family_s()
    return 1e3 * sum(fams.get(f, 0.0) for f in families) / _units(run, t)


def span_ms(run, span: str) -> Optional[float]:
    """Device ms a unit of work of the operations launched inside the
    benchmark's span `span`."""
    t = _traced(run)
    if t is None or not _units(run, t) or not t.counts.get(span):
        return None
    return 1e3 * t.span_s().get(span, 0.0) / _units(run, t)


def roofline(run, op: str) -> Optional[float]:
    """% of the least time of op `op`'s calls a unit of work over the
    device time of its kernel families."""
    ms = device_ms(run, kernels.OP_FAMILIES[op])
    if not ms:
        return None
    least = work.family_least_s(run.conf, _phase(run), op)
    return 100.0 * least * 1e3 / ms


def mfu(run) -> Optional[float]:
    """% of the bf16 peak: a unit's operations times the window's count,
    over the window's host-clock seconds."""
    if run.device != "cuda" or not run.timing["seconds"]:
        return None
    flops = work.work_flops(run.conf, _phase(run)) * run.timing["count"]
    return 100.0 * flops / (run.timing["seconds"] * work.PEAK_FLOPS)


def idle_share(run) -> Optional[float]:
    t = _traced(run)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def _phase(run) -> str:
    """The unit the driver counts (``tick``) names the passes of the
    configuration's table that one unit runs."""
    return run.timing["unit"]
