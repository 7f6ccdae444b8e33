"""Dataset-finetuned classifier for Inception-score evaluation (counterpart
of ``text_to_image_tpu/eval/classifier.py``): supervised Adam on (image,
class) pairs for any classifier in the port's functional form — by default
the self-contained `simple_classifier`, or the full InceptionV3
(``eval/inception_v3.py``) through ``init_fn`` / ``apply_fn``.

**TF32.** cuDNN runs f32 convolutions in TF32 by default on the card.  Every
classifier call of the eval path — each finetune step and each
`make_classifier_fn` forward — runs with TF32 off for cuDNN and cuBLAS
(`exact_f32`, which restores the process's flags on exit), so the
classifier computes in f32 as the JAX package's does on the CPU and the IS
does not depend on the card's math mode.  ``chip_smoke.py`` measures the
score and the InceptionV3 time both ways.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.eval import inception as E
from text_to_image_tpu_torch.models.registry import tree_to
from text_to_image_tpu_torch.train.optim import Adam, flatten


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside; the
    process's flags come back on exit."""
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, cublas.allow_tf32
    cudnn.allow_tf32 = cublas.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, cublas.allow_tf32 = saved


def train_classifier(images_u8: np.ndarray, class_ids: np.ndarray,
                     num_classes: int, steps: int = 500,
                     batch_size: int = 64, lr: float = 1e-3,
                     width: int = 32, seed: int = 0,
                     init_fn=None, apply_fn=None, device="cuda"
                     ) -> Tuple[Dict, float]:
    """Supervised finetune; returns (params on `device`, the last step's
    batch accuracy).  ``init_fn(seed)`` gives the initial params (on the
    CPU, moved to `device`); each step takes the batch
    ``np.random.default_rng(seed).integers(0, N, batch_size)``, as the JAX
    package draws it, normalises ``u8 / 127.5 − 1`` on the device and takes
    one Adam step (b1 0.9, b2 0.999, eps 1e-8, constant `lr`: ``optax.adam``)
    on the mean softmax cross-entropy."""
    init_fn = init_fn or (lambda k: E.simple_classifier_init(
        k, num_classes, width))
    apply_fn = apply_fn or E.simple_classifier_apply

    params = tree_to(init_fn(seed), device)
    leaves = [p.requires_grad_(True) for _, p in flatten(params)]
    opt = Adam(params, lambda count: lr, 0.9, 0.999)
    rng = np.random.default_rng(seed)
    acc = torch.zeros(())
    with exact_f32():
        for _ in range(steps):
            idx = rng.integers(0, len(images_u8), batch_size)
            imgs = torch.from_numpy(images_u8[idx]).to(device)
            labels = torch.from_numpy(
                np.asarray(class_ids[idx], np.int64)).to(device)
            logits = apply_fn(params, imgs.float() / 127.5 - 1.0)
            loss = F.cross_entropy(logits.float(), labels)
            opt.update(torch.autograd.grad(loss, leaves))
            acc = (logits.detach().argmax(-1) == labels).float().mean()
    for p in leaves:
        p.requires_grad_(False)
    return params, float(acc)


def make_classifier_fn(params, apply_fn=None) -> Callable:
    """``images → logits`` for `compute_inception_score`: inference mode,
    TF32 off, the images taken to the params' device."""
    apply_fn = apply_fn or E.simple_classifier_apply
    device = flatten(params)[0][1].device

    def classifier(images):
        with torch.inference_mode(), exact_f32():
            return apply_fn(params, torch.as_tensor(images, device=device))
    return classifier
