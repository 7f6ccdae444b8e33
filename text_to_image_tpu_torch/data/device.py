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

The sharded tier of the JAX package (the example dimension spread over the
data-parallel devices) waits for multi-GPU, ROADMAP.md item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from text_to_image_tpu_torch.utils import prng


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


def stage(dataset, device="cuda") -> DeviceData:
    """One host→device copy of a TextDataset / SyntheticDataset split."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    perm, other_start, other_count = class_tables(dataset.class_ids)
    return DeviceData(images=put(dataset.images, np.uint8),
                      embeddings=put(dataset.embeddings, np.float32),
                      class_perm=put(perm, np.int64),
                      other_start=put(other_start, np.int64),
                      other_count=put(other_count, np.int64))


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


def sample_stacked(data: DeviceData, key: int, n_critic: int,
                   batch_size: int, image_size: int, window: int,
                   random_crop: bool, random_flip: bool
                   ) -> Dict[str, torch.Tensor]:
    """A tick's input, [n_critic, B, …] with a fresh batch per critic
    update, from a generator on the data's device seeded with `key`."""
    g = torch.Generator(device=data.images.device)
    g.manual_seed(int(key))
    d = draw(data, g, (n_critic, batch_size), image_size, window,
             random_crop, random_flip)
    return assemble(data, d, image_size, window)
