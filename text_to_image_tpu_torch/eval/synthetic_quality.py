"""Quality metrics for the class-structured synthetic task (counterpart of
``text_to_image_tpu/eval/synthetic_quality.py``; the offline stand-in for
the reference's Oxford-102/CUB quality runs).

At the model's own resolution:

* **fixed-z class-colour correlation** ``r`` — with one fixed z, sweeping
  the class embedding must sweep the generated mean colour in lockstep with
  the real class colours (r > 0.9: conditioned);
* **synthetic Inception score** — the IS protocol (``eval/inception.py``)
  with a classifier finetuned on this resolution's real images (max = the
  number of classes);
* **conditional accuracy** — a generated image classified as the class
  whose embedding conditioned it.

Every image comes from the EMA weights where the state keeps them
(`sampler.eval_g_params`).  The noise of each draw comes from fixed port
keys (`protocol_noise`; the JAX package's ``PRNGKey(0)``, ``(1)``, ``(2)``
and ``fold_in(base_key(0), b)`` become keys 0, 1, ``fold_in(2, i)`` and
``fold_in(0, b)``), or from the caller's ``noise(part, i, n) → (z, eps)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from text_to_image_tpu_torch.eval.classifier import (make_classifier_fn,
                                                     train_classifier)
from text_to_image_tpu_torch.eval.inception import (batch_noise,
                                                    compute_inception_score)
from text_to_image_tpu_torch.eval.sampler import eval_g_params
from text_to_image_tpu_torch.utils import prng

IS_BATCH = 64
COND_BATCH = 64
COND_EXAMPLES = 512


def protocol_noise(z_dim: int, eps_shape: Optional[Callable] = None
                   ) -> Callable:
    """``noise(part, i, n) → (z, eps)`` of the protocol's draws: ``"fixed"``
    one z from key 0 for all n rows and ε from key 1; ``"score"`` IS batch
    i from ``fold_in(0, i)``; ``"cond"`` the conditional-accuracy batch at
    offset i from ``fold_in(2, i)``."""
    def noise(part: str, i: int, n: int):
        if part == "fixed":
            z = torch.randn(z_dim, generator=prng.generator(0)).expand(n, z_dim)
            shape = eps_shape(n) if eps_shape is not None else None
            return z, (None if shape is None else
                       torch.randn(*shape, generator=prng.generator(1)))
        key = prng.fold_in(0 if part == "score" else 2, i)
        return batch_noise(key, n, z_dim, eps_shape)
    return noise


def color_correlation(imgs: np.ndarray, ds, num_classes: int) -> float:
    """r between the mean colours of `imgs` (one per class, in tanh range)
    and the real mean colour of each class."""
    gen_colors = ((imgs + 1) / 2).mean(axis=(1, 2))
    real_colors = np.stack(
        [(ds.images[ds.class_ids == c].astype(np.float32) / 255
          ).mean(axis=(0, 1, 2)) for c in range(num_classes)])
    return float(np.corrcoef(gen_colors.ravel(), real_colors.ravel())[0, 1])


def center_crop(images: np.ndarray, out: int) -> np.ndarray:
    """Crop-source datasets store images larger than the model's resolution:
    the classifier is finetuned on their centre crop at the generated
    size."""
    if images.shape[1] == out:
        return images
    o = (images.shape[1] - out) // 2
    return images[:, o:o + out, o:o + out]


def _score(gen, ts, cfg, ds, clf, num_images: int, noise: Callable):
    return compute_inception_score(
        lambda z, e, eps: gen(eval_g_params(ts), ts.g_state, ts.aux, z, e,
                              eps),
        clf, ds.test_embeddings().astype(np.float32), num_images=num_images,
        batch_size=IS_BATCH, z_dim=cfg.gan.z_dim,
        noise=lambda b: noise("score", b, IS_BATCH))


def evaluate(gen, ts, cfg, ds, num_classes: int = 8,
             num_images: int = 1280, clf_cache: Optional[dict] = None,
             noise: Optional[Callable] = None, device="cuda"
             ) -> Dict[str, float]:
    """gen = `sampler.make_generator_fn(cfg, device=device)`; ts = a
    TrainState or `sampler.GeneratorState`; ds = a SyntheticDataset (or a
    crop-source dataset).

    ``clf_cache``: the same dict across calls finetunes the SimpleCNN once
    per resolution and reuses it — trajectory evals need one consistent
    instrument, and the real images it trains on do not change."""
    noise = noise or protocol_noise(cfg.gan.z_dim, gen.eps_shape)
    # one z for all classes, each conditioned on its first example's first
    # caption
    embs = np.stack([ds.embeddings[np.where(ds.class_ids == c)[0][0], 0]
                     for c in range(num_classes)])
    z, eps = noise("fixed", 0, num_classes)
    imgs = gen(eval_g_params(ts), ts.g_state, ts.aux, z, embs, eps
               ).cpu().numpy()
    r = color_correlation(imgs, ds, num_classes)
    out = imgs.shape[1]
    if clf_cache is not None and out in clf_cache:
        clf_params, acc = clf_cache[out]
    else:
        clf_params, acc = train_classifier(center_crop(ds.images, out),
                                           ds.class_ids, num_classes,
                                           steps=300, device=device)
        if clf_cache is not None:
            clf_cache[out] = (clf_params, acc)
    clf = make_classifier_fn(clf_params)
    is_mean, is_std = _score(gen, ts, cfg, ds, clf, num_images, noise)
    cond_acc = cond_accuracy(gen, ts, ds, clf, noise)
    return {"r": round(r, 3), "clf_acc": round(acc, 3),
            "cond_acc": round(cond_acc, 3),
            "is_mean": round(float(is_mean), 2),
            "is_std": round(float(is_std), 2)}


def cond_accuracy(gen, ts, ds, clf, noise: Callable) -> float:
    """The share of the first ``min(512, N)`` examples whose image, drawn
    from their first caption in batches of 64, the classifier gives their
    class."""
    n_eval = min(COND_EXAMPLES, len(ds.class_ids))
    labels = np.asarray(ds.class_ids[:n_eval])
    embs_all = ds.embeddings[:n_eval, 0, :].astype(np.float32)
    preds = []
    for i in range(0, n_eval, COND_BATCH):
        e = embs_all[i:i + COND_BATCH]
        z, eps = noise("cond", i, len(e))
        logits = clf(gen(eval_g_params(ts), ts.g_state, ts.aux, z, e, eps))
        preds.append(logits.argmax(-1).cpu().numpy())
    return float((np.concatenate(preds) == labels).mean())


def evaluate_iv3(gen, ts, cfg, ds, num_classes: int = 8,
                 num_images: int = 1280, clf_steps: int = 600,
                 noise: Optional[Callable] = None, device="cuda"
                 ) -> Dict[str, float]:
    """The same IS / conditional-accuracy protocol scored with the full
    InceptionV3 (``eval/inception_v3.py``) finetuned from its random init on
    this dataset's real images (lr 3e-4), instead of the 3-conv SimpleCNN,
    which saturates on the offline tasks."""
    from text_to_image_tpu_torch.eval import inception_v3 as iv3

    noise = noise or protocol_noise(cfg.gan.z_dim, gen.eps_shape)
    params, acc = train_classifier(
        center_crop(ds.images, int(cfg.data.image_size)), ds.class_ids,
        num_classes, steps=clf_steps, lr=3e-4,
        init_fn=lambda k: iv3.init(k, num_classes), apply_fn=iv3.apply,
        device=device)
    clf = make_classifier_fn(params, apply_fn=iv3.apply)
    is_mean, is_std = _score(gen, ts, cfg, ds, clf, num_images, noise)
    cond_acc = cond_accuracy(gen, ts, ds, clf, noise)
    return {"iv3_clf_acc": round(acc, 3), "iv3_cond_acc": round(cond_acc, 3),
            "iv3_is_mean": round(float(is_mean), 2),
            "iv3_is_std": round(float(is_std), 2)}
