"""Inception-score evaluation (counterpart of
``text_to_image_tpu/eval/inception.py``; protocol of Salimans et al. as
StackGAN uses it: generate ~30k images from test captions, classify them
with a dataset-finetuned Inception network, IS = exp(E_x KL(p(y|x) ‖ p(y)))
over 10 splits, mean ± std).

The classifier is pluggable: any ``images[B,H,W,3] (tanh range) →
logits[B, n_classes]`` on the generator's device.  `load_classifier` reads
the JAX package's ``.npz`` (``scripts/convert_inception.py``): a full
InceptionV3 (``eval/inception_v3.py``) or a `simple_classifier` tree.  The
IS maths is a copy of the JAX package's numpy code.

`torch.Generator` and `jax.random` never agree, so z (and the
conditioning-augmentation ε of StackGAN and C-PGGAN) comes from the port's
own keys, or from the caller (``noise``).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.utils import prng

# (z, eps) of one batch; eps is None for a model without CA noise
Noise = Tuple[torch.Tensor, Optional[torch.Tensor]]


def inception_score(probs: np.ndarray, splits: int = 10
                    ) -> Tuple[float, float]:
    """IS from class posteriors p(y|x) [N, C]: exp(mean KL(p(y|x) ‖ p(y)))
    per split, mean ± std over `splits` equal chunks — the protocol of
    openai/improved-gan, in float64."""
    probs = np.asarray(probs, dtype=np.float64)
    n = len(probs)
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def batch_noise(key: int, batch_size: int, z_dim: int,
                eps_shape: Optional[Callable] = None) -> Noise:
    """z [B, z_dim], then ε of ``eps_shape(B)`` (None when the model has no
    CA noise), drawn on the CPU from one generator seeded by `key`."""
    g = prng.generator(key)
    z = torch.randn(batch_size, z_dim, generator=g)
    shape = eps_shape(batch_size) if eps_shape is not None else None
    return z, (None if shape is None else torch.randn(*shape, generator=g))


def compute_inception_score(
    gen_fn: Callable,               # (z, emb, eps) -> images[B,r,r,3]
    classifier_fn: Callable,        # images -> logits[B, C]
    embeddings: np.ndarray,         # test-caption embeddings pool [M, E]
    num_images: int = 30000,
    batch_size: int = 64,
    z_dim: int = 100,
    splits: int = 10,
    seed: int = 0,
    eps_shape: Optional[Callable] = None,
    noise: Optional[Callable[[int], Noise]] = None,
) -> Tuple[float, float]:
    """Batched generation and classification on the generator's device, IS
    on the host.  Batch b takes the embeddings ``(arange(B) + b·B) % M`` of
    the test pool and the noise ``noise(b)``, by default `batch_noise` from
    ``fold_in(seed, b)`` (ε where ``eps_shape(B)`` is not None); the softmax
    is taken in f32 on the device and only the probabilities come to the
    host; the last batch is cut to `num_images`."""
    probs = []
    n_batches = -(-num_images // batch_size)
    for b in range(n_batches):
        idx = (np.arange(batch_size) + b * batch_size) % len(embeddings)
        z, eps = (noise(b) if noise is not None else batch_noise(
            prng.fold_in(seed, b), batch_size, z_dim, eps_shape))
        logits = classifier_fn(gen_fn(z, embeddings[idx], eps))
        probs.append(torch.softmax(logits.float(), -1).cpu().numpy())
    return inception_score(np.concatenate(probs)[:num_images], splits)


# --- self-contained classifier (synthetic pipelines, tests, the CLI) ---------

def simple_classifier_init(key: int, num_classes: int, width: int = 32):
    ks = prng.split_tree(key, ("c1", "c2", "c3", "fc"))
    return {
        "c1": L.conv2d_init(ks["c1"], 3, 3, width),
        "c2": L.conv2d_init(ks["c2"], 3, width, width * 2),
        "c3": L.conv2d_init(ks["c3"], 3, width * 2, width * 4),
        "fc": L.linear_init(ks["fc"], width * 4, num_classes),
    }


def simple_classifier_shapes(num_classes: int, width: int = 32):
    """The shape of every leaf of a `simple_classifier_init` tree."""
    chans = ((3, width), (width, 2 * width), (2 * width, 4 * width))
    tree = {f"c{i + 1}": {"w": (3, 3, cin, cout), "b": (cout,)}
            for i, (cin, cout) in enumerate(chans)}
    tree["fc"] = {"w": (4 * width, num_classes), "b": (num_classes,)}
    return tree


def simple_classifier_apply(params, images: torch.Tensor) -> torch.Tensor:
    """Tiny conv net: 3×[3×3 conv s2 TF-SAME + relu] → global mean pool →
    FC logits (NHWC in)."""
    h = images
    for name in ("c1", "c2", "c3"):
        h = torch.relu(L.conv2d(params[name], h, stride=2))
    return L.linear(params["fc"], h.mean(dim=(1, 2)))


def load_classifier(path: str, device="cuda") -> Callable:
    """The classifier of a converted checkpoint: the JAX package's ``.npz``
    layout (``np.load(path, allow_pickle=True)["params"].item()``, as
    ``scripts/convert_inception.py`` writes it), carried to `device` by
    `convert.from_jax_classifier`.  A tree with ``mixed_5b`` is a full
    InceptionV3, anything else a `simple_classifier` tree.  A missing file
    raises `FileNotFoundError`."""
    from text_to_image_tpu_torch import convert
    from text_to_image_tpu_torch.eval import inception_v3 as iv3
    from text_to_image_tpu_torch.eval.classifier import make_classifier_fn

    if not os.path.exists(path):
        raise FileNotFoundError(
            f"classifier checkpoint {path} not found — convert a torchvision "
            "InceptionV3 with scripts/convert_inception.py")
    with np.load(path, allow_pickle=True) as data:
        host = data["params"].item()
    params = convert.from_jax_classifier(host, device)
    if "mixed_5b" in params:
        return iv3.make_classifier(params)
    return make_classifier_fn(params)
