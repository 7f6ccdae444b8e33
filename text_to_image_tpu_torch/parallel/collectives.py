"""The collectives of the data-parallel tick, over one batch group.

Only ``all_reduce`` (SUM) is used, because the ``gloo`` backend moves CUDA
tensors through ``all_reduce`` and ``broadcast`` alone: the all-gather is a
``[D, …]`` zero buffer with this rank's row filled, summed over the group.
That is exact (x + 0 = x), and the same code runs under ``nccl`` and under
``gloo`` on one shared card.

Both have differentiable forms.  Every rank's loss is its own, and the sum
over ranks is what the gradient all-reduce of ``train/steps.py`` averages,
so the cotangent of an all-reduce's output is the sum of the ranks'
cotangents: its backward is again an all-reduce (`_AllReduceSum`), which
can be differentiated in turn (the critic runs inside the gradient
penalty's ``create_graph=True`` gradient).

`batch_sync` names the group of the data-parallel tick for the code under
it (the train-mode batch norm, C-PGGAN's minibatch stddev, GAN-INT's
pairing); `active` reads it.  Outside the tick (sample grids on rank 0,
eval-mode BN) it is None, and nothing syncs.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Sync:
    """A batch group: its process group, D ranks, this rank's shard."""

    group: dist.ProcessGroup
    size: int
    index: int


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("batch_sync",
                                                         default=None)


@contextlib.contextmanager
def batch_sync(sync: Optional[Sync]) -> Iterator[None]:
    """Code under this context syncs its batch statistics over `sync`
    (nothing when it is None)."""
    token = _ACTIVE.set(sync)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Sync]:
    """The batch group of the enclosing `batch_sync`, or None."""
    return _ACTIVE.get()


def _all_reduce(t: torch.Tensor, sync: Sync) -> torch.Tensor:
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=sync.group)
    all_reduce_sum.bytes += out.numel() * out.element_size()
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sync):
        ctx.sync = sync
        return _all_reduce(t, sync)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.sync), None


def all_reduce_sum(t: torch.Tensor, sync: Sync) -> torch.Tensor:
    """Σ over the group's ranks of `t`, on every rank (a new tensor).
    Differentiable any number of times."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllReduceSum.apply(t, sync)
    return _all_reduce(t, sync)


all_reduce_sum.bytes = 0     # bytes all-reduced, for the measurements


def all_gather(t: torch.Tensor, sync: Sync) -> torch.Tensor:
    """[D, *t.shape]: every rank's `t` in shard order, on every rank, as the
    sum of zero buffers that each hold one rank's row.  Differentiable: the
    gradient of a rank's `t` is its row of the summed cotangents."""
    rows = [t if i == sync.index else torch.zeros_like(t)
            for i in range(sync.size)]
    return all_reduce_sum(torch.stack(rows), sync)
