"""The program's own spans and counters of the traced stretch
(``text_to_image_tpu_torch.utils.profiling``, whose spans are live while
the benchmark's profiler is), as numbers a tick for the per-layer
metrics' readers.

A span's device time is the distance between its two CUDA events on the
stream: its work and any idle inside it.  A tick is a ``train.tick`` span;
a quantity a tick is its total over the stretch over the ticks recorded.
Where spans of the names read nest (a kernel wrapper inside another), the
outermost counts.  Each function returns None where there is nothing to
read: no card, no trace, a program that records no spans, or no span of
the names read.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from benchmark.common import work

TICK = "train.tick"


def records(run) -> Optional[List]:
    """The program's span records (``profiling.SpanRecord``), or None."""
    if run.device != "cuda" or getattr(run, "trace", None) is None:
        return None
    from text_to_image_tpu_torch.utils import profiling
    take = getattr(profiling, "spans", None)
    if take is None:
        return None
    recs = take()
    return recs if any(r.name == TICK for r in recs) else None


def named(*names: str) -> Callable:
    return lambda r: r.name in names


def waits(r) -> bool:
    return r.wait


def _ticks(recs) -> int:
    return sum(r.name == TICK for r in recs)


def _nested(recs, r, pick) -> bool:
    p = r.parent
    while p is not None:
        if pick(recs[p]):
            return True
        p = recs[p].parent
    return False


def device_ms(run, pick: Callable) -> Optional[float]:
    """Device ms a tick in the spans `pick` selects."""
    recs = records(run)
    if recs is None:
        return None
    picked = [r for r in recs if pick(r) and not _nested(recs, r, pick)]
    if not picked or any(r.device_ms is None for r in picked):
        return None
    return sum(r.device_ms for r in picked) / _ticks(recs)


def count(run, name: str) -> Optional[float]:
    """The counter `name` a tick, as the spans it was made in hold it."""
    recs = records(run)
    if recs is None:
        return None
    return sum(r.counts.get(name, 0) for r in recs) / _ticks(recs)


def roofline(run, op: str) -> Optional[float]:
    """% of the least time of op `op`'s calls a tick over the device time
    of its wrappers' spans (``kernels.<op>``, ``kernels.<op>_dx``,
    ``kernels.<op>_dw``)."""
    ms = device_ms(run, named(f"kernels.{op}", f"kernels.{op}_dx",
                              f"kernels.{op}_dw"))
    if not ms:
        return None
    least = work.family_least_s(run.conf, run.timing["unit"], op)
    return 100.0 * least * 1e3 / ms
