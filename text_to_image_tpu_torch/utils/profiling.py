"""Profiling, the program's spans and counters, and step timing
(counterpart of ``text_to_image_tpu/utils/profiling.py``).

* `trace(log_dir)` — a context manager over `torch.profiler` (CPU and, on
  a machine with a card, CUDA activities) that writes a Chrome-trace JSON
  under `log_dir`, which TensorBoard's profiler plugin and Perfetto load.
* `span(name)` — a span at a layer boundary of the program (the training
  tick and its phases, the data tier's draw, each kernel wrapper).  A span
  is live only while a `torch.profiler` profile runs (`trace`, or any other
  profiler); otherwise it is one check and a shared null context.  A live
  span records its name, its tick (``step``, given or its parent's), its
  parent, its host start and end on ``time.monotonic_ns()``, and, where
  the process uses CUDA, a pair of timing events on the current stream
  whose distance is the span's device time (its work and any idle inside
  it).  It also opens ``torch.profiler.record_function(name)``, so the
  profiler's trace shows it beside the kernels.  A span opened on a thread
  with none open (autograd's device thread, in a backward) takes as parent
  the innermost span open on another thread: the one that called backward.
  A *wait* span (``wait=True``) brackets host work the card may wait on
  (a copy from pageable memory, which CUDA may make wait for the card);
  its device time runs on to the next span boundary, the host's next
  enqueue, so it holds the card's idle until the host has caught up.
  Live spans stay in memory, at most `SPAN_CAP` (past it they are dropped
  and counted), until `clear()`; `spans()` lists them.
* `count(name, n)` — a counter with a dotted name: a plain integer, also
  added to the innermost live span.  `counters()` lists every kernel
  wrapper's ``launches`` (by the wrapper's name, with no dot) and these.
* `time_step(fn, *args, iters)` — steady-state step timer, synchronised by
  fetching one scalar of the step's output to the host.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (CPU activity, and the card's where there is one);
    on exit write ``<host>_<pid>.<time>.pt.trace.json`` under `log_dir`
    (``torch.profiler.tensorboard_trace_handler``)."""
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
            ) as prof:
        yield prof


# --- spans and counters -------------------------------------------------------

SPAN_CAP = 1 << 17            # live spans kept until `clear()`
_NULL = contextlib.nullcontext()


def _live() -> bool:
    """Whether a torch.profiler profile runs, on any thread (the
    profiler's own flag for fast checks)."""
    return _autograd_profiler._is_profiler_enabled


class SpanRecord(NamedTuple):
    """A recorded span.  The first three fields are the (name, start,
    end) triple, host ``time.monotonic_ns()``, that a trace reader places
    on the device trace's clock."""
    name: str
    t0_ns: int
    t1_ns: int
    step: Optional[int]        # the tick it belongs to
    parent: Optional[int]      # index in `spans()`'s list
    thread: int
    device_ms: Optional[float]  # None without CUDA events
    wait: bool
    counts: Dict[str, int]     # `count`s made while it was innermost


class _Span:
    __slots__ = ("rec", "name", "step", "wait", "parent", "thread", "t0",
                 "t1", "stream", "ev0", "ev1", "ms", "counts", "rf", "kept")

    def __init__(self, rec: "Recorder", name: str, step: Optional[int],
                 wait: bool):
        self.rec, self.name, self.step, self.wait = rec, name, step, wait
        self.ev0 = self.ev1 = self.ms = None
        self.counts: Dict[str, int] = {}

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec._close(self)
        return False


class Recorder:
    """The live spans and the counters of one process (`RECORDER`)."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.counts: Dict[str, int] = {}
        self.dropped = 0
        self._lock = threading.Lock()
        self._kept: List[_Span] = []
        self._live = 0                       # kept spans still open
        self._stacks: Dict[int, List[_Span]] = {}
        self._pending: Optional[_Span] = None   # a wait span's end to move
        self._pool: List = []                # free timing events

    def _event(self, stream):
        ev = (self._pool.pop() if self._pool
              else torch.cuda.Event(enable_timing=True))
        ev.record(stream)
        return ev

    def _boundary(self, stream):
        """The event of a span boundary on `stream` (None without CUDA),
        after moving a closed wait span's end to it."""
        if stream is None:
            return None
        if self._pending is not None:
            wait, self._pending = self._pending, None
            self._pool.append(wait.ev1)
            wait.ev1 = self._event(stream)
        return self._event(stream)

    def _innermost(self, thread: int) -> Optional[_Span]:
        """The innermost span open on `thread`, else the latest opened of
        those innermost on the other threads."""
        stack = self._stacks.get(thread)
        if stack:
            return stack[-1]
        tops = [st[-1] for t, st in list(self._stacks.items())
                if st and t != thread]
        return max(tops, key=lambda s: s.t0, default=None)

    def _open(self, s: _Span) -> None:
        s.thread = threading.get_ident()
        with self._lock:
            s.kept = len(self._kept) + self._live < self.cap
            if not s.kept:
                self.dropped += 1
                return
            self._live += 1
            s.parent = self._innermost(s.thread)
            if s.step is None and s.parent is not None:
                s.step = s.parent.step
            self._stacks.setdefault(s.thread, []).append(s)
            s.t0 = time.monotonic_ns()
            s.rf = record_function(s.name)
            s.rf.__enter__()
            # read once a span: the stream lookup costs more than a record
            s.stream = (torch.cuda.current_stream()
                        if torch.cuda.is_initialized() else None)
            s.ev0 = self._boundary(s.stream)

    def _close(self, s: _Span) -> None:
        if not s.kept:
            return
        with self._lock:
            s.ev1 = self._boundary(s.stream)
            s.rf.__exit__(None, None, None)
            s.t1 = time.monotonic_ns()
            self._stacks[s.thread].pop()
            self._live -= 1
            self._kept.append(s)
            if s.wait and s.ev1 is not None:
                self._pending = s

    def count(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n
        if _live():
            s = self._innermost(threading.get_ident())
            if s is not None:
                s.counts[name] = s.counts.get(name, 0) + n

    def spans(self) -> List[SpanRecord]:
        """The closed spans kept, by start, each with its device ms (the
        card is synchronised first where events are still unread; a wait
        span that no boundary has followed yet ends at its own exit)."""
        with self._lock:
            self._pending = None
            kept = sorted(self._kept, key=lambda s: s.t0)
            unread = [s for s in kept if s.ev0 is not None and s.ms is None]
            if unread:
                torch.cuda.synchronize()
            for s in unread:
                s.ms = s.ev0.elapsed_time(s.ev1)
                self._pool += (s.ev0, s.ev1)
                s.ev0 = s.ev1 = None
        index = {id(s): i for i, s in enumerate(kept)}
        return [SpanRecord(s.name, s.t0, s.t1, s.step,
                           index.get(id(s.parent)), s.thread, s.ms, s.wait,
                           dict(s.counts)) for s in kept]

    def clear(self) -> None:
        """Drop the closed spans kept and the count of those dropped."""
        with self._lock:
            for s in self._kept:
                self._pool += [e for e in (s.ev0, s.ev1) if e is not None]
            self._kept, self._pending, self.dropped = [], None, 0


RECORDER = Recorder()


def span(name: str, step: Optional[int] = None, wait: bool = False):
    """A span of the program (module docstring); off, the shared null
    context."""
    if not _live():
        return _NULL
    return _Span(RECORDER, name, step, wait)


def spanned(name: str):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _live():
                return fn(*args, **kwargs)
            with _Span(RECORDER, name, None, False):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def spans() -> List[SpanRecord]:
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()


def counters() -> Dict[str, int]:
    """Every kernel wrapper's ``launches`` by the wrapper's name, then the
    counters of `count` by theirs."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    wrappers = (conv.deconv5x5_s2, conv.conv5x5_s2_act, conv.upconv3x3,
                conv.upconv3x3_dx, conv.upconv3x3_dw, fused.bn_stats,
                fused.bn_partials, fused.bn_finish, fused.bn_act,
                fused.bn_bwd_reduce, fused.bn_bwd_apply,
                fused.conditioning_join, conv.conv5x5_s2_dw,
                conv.conv5x5_s2_dx, conv.deconv5x5_s2_dx)
    return {**{f.__name__: f.launches for f in wrappers}, **RECORDER.counts}


def _first_leaf(tree):
    if isinstance(tree, torch.Tensor):
        return tree
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else ())
    for v in items:
        leaf = _first_leaf(v)
        if leaf is not None:
            return leaf
    return None


def _sync(tree) -> None:
    """Wait for the work behind `tree`: fetch one element of its first
    tensor to the host."""
    leaf = _first_leaf(tree)
    if leaf is not None:
        float(leaf.reshape(-1)[0])


def time_step(step_fn: Callable, *args, iters: int = 30, warmup: int = 3
              ) -> Dict[str, float]:
    """Times ``state, aux = step_fn(state, *rest)``-shaped functions.
    Returns {'ms_per_iter', 'iters_per_sec'}."""
    state, rest = args[0], args[1:]
    for _ in range(warmup):
        state, aux = step_fn(state, *rest)
    _sync(aux)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, aux = step_fn(state, *rest)
    _sync(aux)
    dt = time.perf_counter() - t0
    return {"ms_per_iter": dt / iters * 1e3, "iters_per_sec": iters / dt}
