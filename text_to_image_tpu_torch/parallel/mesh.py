"""The device mesh of data-parallel training over ``torch.distributed``
(counterpart of ``text_to_image_tpu/parallel/mesh.py``).

A run of W processes (ranks, one a card) forms a ``(slice, data, model)``
mesh in rank-major order: rank = (slice·data_size + data)·model_size +
model.  Under ``torchrun``, whose ranks are node-major, the slice axis then
falls on node boundaries, as the JAX package groups devices by
``slice_index``.  The global batch is sharded over (slice, data): the ranks
that share a model coordinate form the ``batch_group``, and this rank holds
rows ``shard_index·B/D … (shard_index + 1)·B/D`` of it (D = slice·data).
The ranks that share this rank's (slice, data) coordinate form the
``model_group``: they hold the same rows.  The JAX trainer replicates every
parameter, so those ranks compute the same thing; the port does the same.
Only the multi-device dry run (``entry.py``) column-shards the 2-D ``w``
of the ``stem`` and ``embed`` linears over the model group
(``parallel/tensor.py``), as JAX's dry run places them.

A group exists only where it has ranks to reduce over: ``batch_group`` is
None when D = 1 and ``model_group`` is None when model = 1, as a mesh of
one device has nothing to reduce in JAX.  So a process group of one rank
(``torchrun --nproc_per_node 1``) runs the one-process tick.  Without a
process group the mesh is 1×1×1 and no collective is ever called.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# how long a rank waits in init or in a collective before it raises
INIT_TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    """This rank's place in the (slice, data, model) mesh, the group of
    ranks its batch is sharded over (None unless D > 1) and the group of
    ranks that hold its rows (None unless model > 1); `live` when a
    process group made it."""

    slice_size: int = 1
    data_size: int = 1
    model_size: int = 1
    rank: int = 0
    batch_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    live: bool = False

    @property
    def world(self) -> int:
        return self.slice_size * self.data_size * self.model_size

    @property
    def coords(self):
        """(slice, data, model) of this rank."""
        m = self.model_size
        return (self.rank // (m * self.data_size),
                (self.rank // m) % self.data_size, self.rank % m)

    @property
    def shards(self) -> int:
        """D = slice·data: the ranks one global batch is cut over."""
        return self.slice_size * self.data_size

    @property
    def shard_index(self) -> int:
        s, d, _ = self.coords
        return s * self.data_size + d

    def batch_ranks(self) -> List[int]:
        """The ranks of this rank's batch group, in shard order."""
        m = self.coords[2]
        return [i * self.model_size + m for i in range(self.shards)]

    def model_ranks(self) -> List[int]:
        """The ranks of this rank's model group, in model order."""
        first = self.shard_index * self.model_size
        return list(range(first, first + self.model_size))

    @property
    def is_main(self) -> bool:
        """Rank 0 writes checkpoints, metrics and grids."""
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` examples."""
        if batch % self.shards:
            raise ValueError(f"batch {batch} not divisible by the "
                             f"{self.shards} batch-axis ranks")
        b = batch // self.shards
        return slice(self.shard_index * b, (self.shard_index + 1) * b)


def create_mesh(data: int = -1, model: int = 1, slices: int = 1,
                world: Optional[int] = None, rank: Optional[int] = None
                ) -> MeshEnv:
    """A (slice, data, model) mesh over `world` ranks (the process group's
    size and this process's rank by default; 1 and 0 without one); data=-1
    takes the ranks that remain.  Raises where the JAX package's raises.
    With a process group every rank must call it, in the same order: it
    makes one batch group per model coordinate when D > 1 and model > 1,
    and one model group per (slice, data) coordinate when model > 1 and
    D > 1 (the whole world serves where the group spans it)."""
    live = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    if world % slices != 0:
        raise ValueError(f"{world} devices not divisible by slices={slices}")
    per_slice = world // slices
    if data == -1:
        if per_slice % model != 0:
            raise ValueError(
                f"{per_slice} devices/slice not divisible by model={model}")
        data = per_slice // model
    if slices * data * model != world:
        raise ValueError(f"mesh {slices}x{data}x{model} != {world} devices")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    env = MeshEnv(slices, data, model, rank)
    if not live:
        return env
    return dataclasses.replace(
        env, live=True,
        batch_group=_group_of(env, env.shards, model, env.coords[2],
                              lambda m: dataclasses.replace(
                                  env, rank=m).batch_ranks()),
        model_group=_group_of(env, model, env.shards, env.shard_index,
                              lambda s: dataclasses.replace(
                                  env, rank=s * model).model_ranks()))


def _group_of(env: MeshEnv, size: int, count: int, mine: int, ranks_of
              ) -> Optional[dist.ProcessGroup]:
    """This rank's group among `count` disjoint groups of `size` ranks
    (``ranks_of(i)`` the ranks of group i): None when `size` is 1, the
    world when one group spans it, else one ``new_group`` each (every rank
    makes them all, in order)."""
    if size == 1:
        return None
    if count == 1:
        return dist.group.WORLD
    return [dist.new_group(ranks_of(i)) for i in range(count)][mine]


def init_distributed(backend: Optional[str] = None, device: str = "cuda"
                     ) -> Optional[torch.device]:
    """Join the process group that ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
    describes, or the one the caller made already.  Returns this rank's
    device (``cuda:LOCAL_RANK % device_count``, or the CPU when `device` is
    "cpu"), or None when there is no such environment and no group.

    `backend` defaults to nccl on the card and gloo on the CPU.  nccl wants
    a card a rank: ranks share one only over gloo, which the caller names.
    A failed init raises; nothing swaps one backend for the other.  A
    collective that waits longer than INIT_TIMEOUT raises too."""
    cpu = torch.device(device).type == "cpu"
    if dist.is_initialized():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        backend = backend or ("gloo" if cpu else "nccl")
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        if backend == "nccl":
            if cpu:
                raise ValueError("the nccl backend needs a card; name gloo "
                                 "for ranks on the CPU")
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
            if local_world > torch.cuda.device_count():
                raise ValueError(
                    f"{local_world} ranks on {torch.cuda.device_count()} "
                    f"cards: nccl takes one card a rank; name --dist-backend "
                    f"gloo to share cards")
        dist.init_process_group(backend, timeout=INIT_TIMEOUT)
    else:
        return None
    if cpu:
        return torch.device("cpu")
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def shard_batch(env: MeshEnv, tree, axis: int = 0):
    """This rank's rows of every tensor or array of a (nested) dict whose
    `axis` is the global batch; the tree itself without a group."""
    if env.batch_group is None:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(env, v, axis) for k, v in tree.items()}
    if tree is None:
        return None
    index = [slice(None)] * axis + [env.rows(tree.shape[axis])]
    return tree[tuple(index)]


def _checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """A float64 fingerprint of `tensors`: their values weighted by their
    position, summed in a fixed order on the host.  The same bits give the
    same checksum; another value in any element changes it."""
    total = torch.zeros((), dtype=torch.float64)
    for i, t in enumerate(tensors):
        v = t.detach().reshape(-1).to("cpu", torch.float64)
        w = torch.arange(1, v.numel() + 1, dtype=torch.float64)
        total += (i + 1) * (v * w).sum()
    return total


def check_replicated(env: MeshEnv, tensors: Sequence[torch.Tensor],
                     what: str, sharded: Sequence[torch.Tensor] = ()
                     ) -> None:
    """Raise unless every rank of the process group holds the same
    `tensors` (their `_checksum` agrees with rank 0's) and every rank of
    this rank's batch group the same `sharded` ones (column slices over the
    model group: against the batch group's first rank); nothing in a
    group of one rank or without one."""
    if not env.live or env.world == 1:
        return
    checks = [(tensors, dist.group.WORLD, 0, "rank 0's")]
    if sharded and env.batch_group is not None:
        first = env.batch_ranks()[0]
        checks.append((sharded, env.batch_group, first, f"rank {first}'s"))
    for group_tensors, group, src, whose in checks:
        if not group_tensors:
            continue
        mine = _checksum(group_tensors)
        ref = mine.to(group_tensors[0].device)  # nccl broadcasts on the card
        dist.broadcast(ref, src=src, group=group)
        if float(ref) != float(mine):
            raise RuntimeError(
                f"rank {env.rank}: {what} differ from {whose} (checksum "
                f"{float(mine)!r} vs {float(ref)!r})")

