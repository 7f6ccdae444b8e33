"""Device-resident data tier (counterpart of the replicated tier of
``text_to_image_tpu/data/device.py``): the training split is staged on the
card once, and each tick's ``[n_critic, B, …]`` batch (index draw, random
crop, horizontal flip, caption window-average, wrong-pair selection) is
drawn and gathered there, so no data crosses from the host in a tick.

Every draw of a tick comes from one `torch.Generator` on the data's device,
seeded from ``fold_in(fold_in(seed, step), 2)`` (`batch_key`), so the
stream depends on (seed, step) alone and replays exactly after a restore.
Each sampler is split into `draw` (the random variables) and `assemble`
(the gathers), so that tests can feed the JAX package's draws into the
port's assembly; ``assemble(data, draw(...))`` is what JAX's ``vmap`` of
``sample_batch`` computes from its keys.

Sampling semantics match the JAX tier:

* ``real``: uniform example draw, random crop + flip, served uint8 (the
  tick normalises to the generator's tanh range on the card),
* ``wrong``: exactly uniform over the examples of another class.  Staging
  sorts the examples by class into ``class_perm``; for an example of class
  c, occupying ``class_perm[s : s+m]``, the n−m others are
  ``class_perm[(s+m+u) mod n]`` for u ∈ [0, n−m).  JAX draws u with a
  per-row bound (``randint(0, other_count[idx])``), which torch has no form
  of; here u = ⌊U·(n−m)⌋ with U uniform in [0, 1) in f64 (clamped to
  n−m−1): each u has probability 1/(n−m) within (n−m)·2⁻⁵³,
* ``emb``: ``window`` distinct captions per image, averaged; the draw
  without replacement is an argsort of a row of uniform keys.

Data parallel (``parallel/mesh.py``): on the replicated tier every rank
stages the whole split, draws the global ``[n_critic, B]`` variables from
(seed, step) and gathers only its own rows, so D ranks see the batch one
device would.  The sharded tier (`stage_sharded`, for a split that fits
the ranks' memory together but not one card's) shuffles the examples onto
D equal shards once, as the JAX tier does (the same numpy permutation, the
tail wrapped), and each rank draws its B/D rows from its own shard with
key ``fold_in(key, shard_index)``: uniform within the shard, a stream that
depends on the number of shards.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from text_to_image_tpu_torch.utils import prng, profiling


@dataclasses.dataclass(frozen=True)
class DeviceData:
    """The split on the card plus the class tables of the wrong-pair draw."""

    images: torch.Tensor       # [N, S, S, 3] uint8 (S = crop source size)
    embeddings: torch.Tensor   # [N, C, E] float32 (C captions per image)
    class_perm: torch.Tensor   # [N] int64: example indices sorted by class
    other_start: torch.Tensor  # [N] int64: where the other classes' ring
    # begins in class_perm, i.e. (start + count) of the example's class
    other_count: torch.Tensor  # [N] int64: N − |the example's class|


def class_tables(class_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """(class_perm, other_start, other_count) as int32, the JAX package's
    arrays."""
    cls = np.asarray(class_ids)
    n = len(cls)
    perm = np.argsort(cls, kind="stable")
    uniq, starts, counts = np.unique(cls[perm], return_index=True,
                                     return_counts=True)
    pos = {c: i for i, c in enumerate(uniq)}
    at = np.array([pos[c] for c in cls])
    count = counts[at]
    if (count == n).any():
        raise ValueError("a class covers the whole dataset — no wrong pair "
                         "exists (matching-aware loss needs >=2 classes)")
    other_start = (starts[at] + count) % n
    return (perm.astype(np.int32), other_start.astype(np.int32),
            (n - count).astype(np.int32))


@dataclasses.dataclass(frozen=True)
class ShardedDeviceData(DeviceData):
    """One rank's shard of the split (`stage_sharded`): its examples and
    its class tables, which index within the shard."""

    shard: int = 0             # this rank's shard index
    shards: int = 1            # D, the batch-axis ranks


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _staged(images, embeddings, class_ids, device, **extra) -> DeviceData:
    perm, other_start, other_count = class_tables(class_ids)
    cls = ShardedDeviceData if extra else DeviceData
    return cls(images=_put(images, np.uint8, device),
               embeddings=_put(embeddings, np.float32, device),
               class_perm=_put(perm, np.int64, device),
               other_start=_put(other_start, np.int64, device),
               other_count=_put(other_count, np.int64, device), **extra)


def stage(dataset, device="cuda") -> DeviceData:
    """One host→device copy of a TextDataset / SyntheticDataset split."""
    return _staged(dataset.images, dataset.embeddings, dataset.class_ids,
                   device)


def stage_sharded(dataset, shard: int, shards: int, seed: int = 0,
                  device="cuda") -> ShardedDeviceData:
    """Shard `shard` of `shards` of the split on `device`, with its own
    class tables: the JAX tier's ``default_rng(seed).permutation(n)`` of
    the examples, wrapped round to ⌈n/shards⌉ a shard.  Raises ValueError,
    as the JAX tier does, when any shard holds one class (no wrong pair
    could be drawn there)."""
    cls = np.asarray(dataset.class_ids)
    n = len(cls)
    order = np.random.default_rng(seed).permutation(n)
    idx = order[np.arange(shards * -(-n // shards)) % n].reshape(shards, -1)
    for s in range(shards):
        if len(np.unique(cls[idx[s]])) < 2:
            raise ValueError(
                f"shard {s}/{shards} is single-class after shuffling — "
                f"dataset too small/skewed for the sharded tier; use the host "
                f"pipeline")
    mine = idx[shard]
    return _staged(np.asarray(dataset.images)[mine],
                   np.asarray(dataset.embeddings)[mine], cls[mine], device,
                   shard=shard, shards=shards)


def nbytes(dataset) -> int:
    """Device footprint of staging `dataset` as the JAX package counts it
    (images uint8 + embeddings f32 + three int32 tables)."""
    return (int(np.prod(dataset.images.shape))
            + int(np.prod(dataset.embeddings.shape)) * 4
            + 3 * 4 * len(dataset.class_ids))


def batch_key(seed: int, step: int) -> int:
    """The key of step `step`'s batch: ``fold_in(fold_in(seed, step), 2)``
    (0 and 1 are the tick's D and G noise, ``train/steps.draw_noise``)."""
    return prng.fold_in(prng.fold_in(seed, step), 2)


def draw(data: DeviceData, generator: torch.Generator, lead: Tuple[int, ...],
         image_size: int, window: int, random_crop: bool, random_flip: bool
         ) -> Dict[str, Optional[torch.Tensor]]:
    """The random variables of a batch of shape `lead` (e.g. (K, B)), in a
    fixed order on the data's device: ``idx`` (example), ``u`` (position in
    the example's other-class ring), per stream ``<s>_off`` [2, *lead]
    (crop rows, columns; None without a random crop or when the source is
    already `image_size`) and ``<s>_flip`` (None without random flips), and
    ``cap_keys`` [*lead, C] (None when `window` covers every caption)."""
    n, src = data.images.shape[:2]
    c = data.embeddings.shape[1]
    kw = {"generator": generator, "device": data.images.device}
    idx = torch.randint(0, n, lead, **kw)
    count = data.other_count[idx]
    u = (torch.rand(lead, dtype=torch.float64, **kw) * count).long()
    out = {"idx": idx, "u": torch.minimum(u, count - 1)}
    for s in ("real", "wrong"):
        out[f"{s}_off"] = (torch.randint(0, src - image_size + 1, (2, *lead),
                                         **kw)
                           if random_crop and src != image_size else None)
        out[f"{s}_flip"] = (torch.rand(lead, **kw) < 0.5 if random_flip
                            else None)
    out["cap_keys"] = torch.rand((*lead, c), **kw) if window < c else None
    return out


def crop_flip(images: torch.Tensor, idx: torch.Tensor, size: int,
              off: Optional[torch.Tensor], flip: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """images[idx] cropped at `off` ([2, *idx.shape] rows, columns; the
    centre when None) and mirrored where `flip`, as one gather; uint8
    [*idx.shape, size, size, 3]."""
    src = images.shape[1]
    lead = idx.shape
    ar = torch.arange(size, device=images.device)
    if off is None:
        ys = xs = torch.full((idx.numel(), 1), (src - size) // 2,
                             device=images.device)
    else:
        ys, xs = off.reshape(2, -1, 1)
    cols = ar if flip is None else torch.where(flip.reshape(-1, 1),
                                               size - 1 - ar, ar)
    out = images[idx.reshape(-1, 1, 1), (ys + ar)[:, :, None],
                 (xs + cols)[:, None, :]]
    return out.reshape(*lead, size, size, images.shape[-1])


def avg_captions(embeddings: torch.Tensor, idx: torch.Tensor,
                 keys: Optional[torch.Tensor], window: int) -> torch.Tensor:
    """Mean of `window` distinct captions of each example: those with the
    smallest `keys` (every caption when `keys` is None); f32
    [*idx.shape, E]."""
    if keys is None:
        rows = embeddings[idx]
    else:
        picks = torch.argsort(keys, dim=-1, stable=True)[..., :window]
        rows = embeddings[idx[..., None], picks]
    # in order, then × 1/w: the f32 arithmetic of the JAX tier's jnp.mean
    acc = rows[..., 0, :]
    for j in range(1, rows.shape[-2]):
        acc = acc + rows[..., j, :]
    return acc * (1.0 / rows.shape[-2])


def assemble(data: DeviceData, d: Dict[str, Optional[torch.Tensor]],
             image_size: int, window: int) -> Dict[str, torch.Tensor]:
    """The batch the draws `d` select: real and wrong uint8
    [*lead, s, s, 3], emb f32 [*lead, E]."""
    n = data.images.shape[0]
    idx = d["idx"]
    wrong = data.class_perm[(data.other_start[idx] + d["u"]) % n]
    return {"real": crop_flip(data.images, idx, image_size, d["real_off"],
                              d["real_flip"]),
            "wrong": crop_flip(data.images, wrong, image_size,
                               d["wrong_off"], d["wrong_flip"]),
            "emb": avg_captions(data.embeddings, idx, d["cap_keys"], window)}


def _keep_rows(d: Dict[str, Optional[torch.Tensor]], rows: slice
               ) -> Dict[str, Optional[torch.Tensor]]:
    """The draws of batch rows `rows` (axis 1 of each; axis 2 of the crop
    offsets, whose axis 0 is rows / columns)."""
    return {k: None if v is None else
            v[:, :, rows] if k.endswith("_off") else v[:, rows]
            for k, v in d.items()}


def sample_stacked(data: DeviceData, key: int, n_critic: int,
                   batch_size: int, image_size: int, window: int,
                   random_crop: bool, random_flip: bool,
                   rows: Optional[slice] = None, step: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """A tick's input, [n_critic, B, …] with a fresh batch per critic
    update, from a generator on the data's device seeded with `key`; with
    `rows`, only those rows of it are gathered (a rank's share of the
    global batch, drawn whole on every rank).  Drawn and gathered inside
    the span ``data.draw`` of tick `step`."""
    with profiling.span("data.draw", step=step):
        g = torch.Generator(device=data.images.device)
        g.manual_seed(int(key))
        d = draw(data, g, (n_critic, batch_size), image_size, window,
                 random_crop, random_flip)
        if rows is not None:
            d = _keep_rows(d, rows)
        return assemble(data, d, image_size, window)


def sample_stacked_sharded(data: ShardedDeviceData, key: int, n_critic: int,
                           batch_size: int, image_size: int, window: int,
                           random_crop: bool, random_flip: bool,
                           step: Optional[int] = None
                           ) -> Dict[str, torch.Tensor]:
    """This rank's [n_critic, B/D, …] share of a tick's input, drawn from
    its own shard with key ``fold_in(key, shard)`` (`sample_stacked`'s
    span)."""
    if batch_size % data.shards:
        raise ValueError(f"batch_size {batch_size} not divisible by the "
                         f"{data.shards} batch-axis ranks")
    return sample_stacked(data, prng.fold_in(key, data.shard), n_critic,
                          batch_size // data.shards, image_size, window,
                          random_crop, random_flip, step=step)
