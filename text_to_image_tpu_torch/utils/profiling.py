"""Profiling and step timing (counterpart of
``text_to_image_tpu/utils/profiling.py``).

* `trace(log_dir)` — a context manager over `torch.profiler` (CPU and, on
  a machine with a card, CUDA activities) that writes a Chrome-trace JSON
  under `log_dir`, which TensorBoard's profiler plugin and Perfetto load.
* `time_step(fn, *args, iters)` — steady-state step timer, synchronised by
  fetching one scalar of the step's output to the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch
from torch.profiler import ProfilerActivity


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
