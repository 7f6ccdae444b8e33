"""The column-parallel linear over the model group: the counterpart of the
JAX dry run's ``P(None, "model")`` placement of a 2-D ``w``
(``__graft_entry__.py`` shards the ``stem`` and ``embed`` linears so).

On model rank m of M, ``w_m`` is this rank's contiguous block of out/M
columns of ``w`` and ``b`` stays whole (JAX leaves it replicated):

    y = gather_cols(copy(x) @ w_m) + b

* ``copy`` is the identity forward and an all-reduce SUM over the model
  group backward: each rank's ``dy_m·w_mᵀ`` is its part of ``dx``;
* ``gather_cols`` all-gathers the ranks' column blocks forward (the
  zero-buffer all-gather of ``collectives``, exact) and hands back **this
  rank's column block of the cotangent** backward, with no sum.

The model ranks of one batch shard hold the same rows and compute the
same loss: a tensor that all of them hold has the same cotangent on each.
That is another convention from the batch group's, where every rank's loss
is its own and ``collectives.all_gather``'s backward *sums* the ranks'
cotangents: used here, that sum would multiply the stem's gradient by M.
So the two pairs are their own Functions, each the other's backward
(``copy`` ↔ ``reduce``, ``gather_cols`` ↔ ``split_cols``), and both can be
differentiated any number of times: the critic's ``embed`` runs inside the
gradient penalty's ``create_graph=True`` gradient.

`model_sync` names the model group for the code under it (the tick, as
``collectives.batch_sync`` names the batch group); `ops.layers.linear`
takes the column-parallel form only there, and only for a leaf whose ``w``
is a column slice of its whole ``b``.  `shard_columns` and
`gather_columns` place a params tree and put it back together.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence

import torch

from text_to_image_tpu_torch.parallel import collectives
from text_to_image_tpu_torch.parallel.collectives import Sync

# the layers the JAX dry run column-shards: the generator's stem and every
# text compressor
SHARDED_LAYERS = ("stem", "embed")

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("model_sync",
                                                         default=None)


@contextlib.contextmanager
def model_sync(sync: Optional[Sync]) -> Iterator[None]:
    """Linears under this context with a column-sliced ``w`` run
    column-parallel over `sync` (nothing when it is None)."""
    token = _ACTIVE.set(sync)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Sync]:
    """The model group of the enclosing `model_sync`, or None."""
    return _ACTIVE.get()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sync):
        ctx.sync = sync
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce(g, ctx.sync), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sync):
        ctx.sync = sync
        return collectives._all_reduce(x, sync)

    @staticmethod
    def backward(ctx, g):
        return copy(g, ctx.sync), None


def _gathered(y: torch.Tensor, sync: Sync) -> torch.Tensor:
    return collectives._all_reduce(torch.cat(
        [y if i == sync.index else torch.zeros_like(y)
         for i in range(sync.size)], dim=-1), sync)


def _block(y: torch.Tensor, sync: Sync) -> torch.Tensor:
    k = y.shape[-1] // sync.size
    return y[..., sync.index * k:(sync.index + 1) * k].contiguous()


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, sync):
        ctx.sync = sync
        return _gathered(y, sync)

    @staticmethod
    def backward(ctx, g):
        return split_cols(g, ctx.sync), None


class _SplitCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, sync):
        ctx.sync = sync
        return _block(y, sync)

    @staticmethod
    def backward(ctx, g):
        return gather_cols(g, ctx.sync), None


def copy(x: torch.Tensor, sync: Sync) -> torch.Tensor:
    """`x` itself; its cotangent is the sum of the model ranks'."""
    return _Copy.apply(x, sync)


def reduce(x: torch.Tensor, sync: Sync) -> torch.Tensor:
    """Σ over the model ranks of `x`; its cotangent passes as it is."""
    return _Reduce.apply(x, sync)


def gather_cols(y: torch.Tensor, sync: Sync) -> torch.Tensor:
    """[..., M·k]: the model ranks' [..., k] blocks side by side, in model
    order; the cotangent of this rank's block is its block of the
    cotangent."""
    return _GatherCols.apply(y, sync)


def split_cols(y: torch.Tensor, sync: Sync) -> torch.Tensor:
    """This rank's block of the last axis; its cotangent is gathered."""
    return _SplitCols.apply(y, sync)


def is_column_slice(p: Dict[str, torch.Tensor], sync: Optional[Sync]) -> bool:
    """Whether linear leaf `p` holds a column block of its ``w`` over
    `sync`: a 2-D ``w`` whose columns times the model size are ``b``'s."""
    return (sync is not None and "b" in p and p["w"].dim() == 2
            and p["w"].shape[1] * sync.size == p["b"].shape[0])


def column_parallel_linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
                           sync: Sync) -> torch.Tensor:
    """``x @ w + b`` with ``p["w"]`` this rank's column block."""
    y = copy(x, sync) @ p["w"].to(x.dtype)
    return gather_cols(y, sync) + p["b"].to(x.dtype)


def is_sharded_leaf(path: Sequence[str], leaf: torch.Tensor,
                    names: Sequence[str]) -> bool:
    """The JAX dry run's rule: a 2-D ``w`` under a layer named in
    `names`."""
    return path[-1] == "w" and leaf.dim() == 2 and any(
        n in path[:-1] for n in names)


def _map_sharded(tree: Dict, fn, names: Sequence[str], path=()) -> Dict:
    return {k: (_map_sharded(v, fn, names, path + (k,))
                if isinstance(v, dict)
                else fn(v) if is_sharded_leaf(path + (k,), v, names) else v)
            for k, v in tree.items()}


def shard_columns(params: Dict, sync: Sync,
                  names: Sequence[str] = SHARDED_LAYERS) -> Dict:
    """A copy of `params` with the ``w`` of every linear named in `names`
    cut to this rank's column block (a leaf again where the whole one
    was); every other leaf is the same object."""
    def cut(w):
        block = _block(w.detach(), sync)
        return block.requires_grad_(w.requires_grad)
    return _map_sharded(params, cut, names)


def gather_columns(params: Dict, sync: Sync,
                   names: Sequence[str] = SHARDED_LAYERS) -> Dict:
    """`shard_columns` undone: each column block all-gathered over the
    model group (detached)."""
    return _map_sharded(params, lambda w: _gathered(w.detach(), sync), names)
