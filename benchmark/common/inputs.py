"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the weights of every network and the training split.

Everything is drawn on the run's device from ``torch.Generator``s seeded
by `derive(seed, tag)`, in a few large calls: one normal draw for all the
weights of a network tree, one byte draw for all the images.  The same seed
gives the same tensors on the same kind of device, so the reference can
make them again after the window instead of keeping a copy.

The split has the shape of the configuration's ``split`` entry (images,
classes, source pixels, captions an image, embedding width).  Every seed
gives the same class sizes (the classes dealt round-robin, then shuffled),
so a seed changes the values and never the work.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one named input, from the run's seed."""
    seq = np.random.SeedSequence([int(seed) % 2**63,
                                  zlib.crc32(tag.encode())])
    return int(seq.generate_state(1, np.uint64)[0] % 2**63)


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def _flat(spec: Dict, prefix: str = ""):
    for k, v in spec.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, t in flat.items():
        *path, leaf = name.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def make_tree(spec: Dict, seed: int, tag: str, device) -> Dict:
    """A tensor tree (f32) after `spec`, whose leaves are (shape, init):
    ``normal:σ`` σ·N(0, 1), ``bn_scale`` 1 + 0.02·N(0, 1), ``zeros``,
    ``ones``.  One normal draw covers every random leaf, in spec order."""
    items = list(_flat(spec))
    sizes = [int(np.prod(shape)) for _, (shape, init) in items
             if init.startswith("normal") or init == "bn_scale"]
    noise = torch.randn(sum(sizes), generator=generator(seed, tag, device),
                        device=device) if sizes else None
    out, at = {}, 0
    for name, (shape, init) in items:
        if init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, device=device)
            continue
        n = int(np.prod(shape))
        x = noise[at:at + n].reshape(shape)
        at += n
        out[name] = (1.0 + 0.02 * x if init == "bn_scale"
                     else float(init.split(":")[1]) * x)
    return _nest(out)


def make_weights(spec: Dict[str, Dict], seed: int, device) -> Dict[str, Dict]:
    """Every tree of a reference's `param_spec`, each from its own
    stream."""
    return {name: make_tree(tree, seed, f"weights/{name}", device)
            for name, tree in spec.items()}


def class_ids(split: Dict, seed: int) -> np.ndarray:
    n, k = split["images"], split["classes"]
    rng = np.random.default_rng(derive(seed, "classes"))
    return rng.permutation(np.arange(n) % k)


def make_split(split: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``images`` uint8 [N, S, S, 3], ``embeddings`` f32 [N, C, E] (a class centroid plus 0.1 of noise a
    caption), ``class_ids`` int64 [N]."""
    n, s = split["images"], split["source_px"]
    caps, e = split["captions"], split["embed_dim"]
    ids = torch.as_tensor(class_ids(split, seed), device=device)
    g = generator(seed, "split", device)
    centroids = torch.randn(split["classes"], e, generator=g, device=device)
    emb = centroids[ids][:, None, :] + 0.1 * torch.randn(
        n, caps, e, generator=g, device=device)
    imgs = torch.randint(0, 256, (n, s, s, 3), dtype=torch.uint8,
                         generator=g, device=device)
    return {"images": imgs, "embeddings": emb, "class_ids": ids}
