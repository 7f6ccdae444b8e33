"""The absolute Inception-score parity runbook, ``synthetic`` mode
(counterpart of the JAX package's ``scripts/parity_runbook.sh``).

The reference's quality claim is the IS on Oxford-102 / CUB with a
dataset-finetuned InceptionV3 (StackGAN paper, arXiv:1612.03242, Tab. 2:
GAN-INT-CLS Oxford-102 2.66 ± .03, CUB 2.88 ± .04; StackGAN 3.20 ± .01,
3.70 ± .04).  Without the downloaded artifacts the number cannot be
produced, but every step of the chain runs on stand-ins made from a seed:

0. stand-ins: 60 class-coloured JPGs of 6 classes in Oxford-102's raw
   layout (``jpg/image_%05d.jpg``, ``setid.mat``, ``imagelabels.mat``),
   class-structured char-CNN-RNN-shaped embeddings (4 × 1024) in image-id
   order, and a torchvision-layout InceptionV3 ``.pth`` of random weights
   (only the values differ from a real finetune);
1. ``python -m text_to_image_tpu_torch.data.preprocess flowers`` →
   StackGAN-format pickles (76 px and 304 px crop sources);
2. ``python -m text_to_image_tpu_torch.scripts.convert_inception`` → the
   classifier ``<work>/data/inception.npz`` that ``--eval-is`` finds;
3. GAN-INT-CLS ``python -m text_to_image_tpu_torch.main --train``;
4. ``main --eval-is`` with that classifier;
5. the anchors printed beside it (in this mode the number only proves the
   chain).

    python -m text_to_image_tpu_torch.scripts.parity_runbook [synthetic] \
        [WORK] [--device cpu]

Python where the JAX package has a shell script, so that the tests can run
it at a small size: `main` takes the step count, the IS image count, the
device and config overrides (``--set`` pairs for both ``main`` runs).  The
defaults are the script's: 200 steps at batch 16, 320 IS images.  Steps
0–1 write and read JPGs with Pillow (and ``.mat`` files with scipy).

The JAX script's ``flowers`` mode (the real Oxford-102 images, the
char-CNN-RNN embeddings and a finetuned InceptionV3) is not ported: it
needs those downloads.  Prints ``PARITY RESULT {json}`` and ``parity
runbook OK``.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import torch

from text_to_image_tpu_torch.scripts import run_module, split_device
from text_to_image_tpu_torch.scripts.e2e_demo import score, train

WORK = "/tmp/t2i_parity"
N, NCLS = 60, 6
ANCHOR = "GAN-INT-CLS Oxford-102: 2.66 ± .03   (StackGAN paper Tab. 2)"


def fabricate(work: str) -> None:
    """Step 0 (Pillow, scipy): a stand-in for every external artifact."""
    from PIL import Image
    from scipy.io import savemat

    from text_to_image_tpu_torch.eval import inception_v3 as iv3
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(work, "raw", "jpg"))
    colors = rng.uniform(0.2, 0.8, (NCLS, 3))
    labels = np.array([1 + i % NCLS for i in range(N)])
    for i in range(1, N + 1):
        arr = np.clip(colors[labels[i - 1] - 1]
                      + rng.uniform(-.2, .2, (80, 80, 3)), 0, 1)
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            os.path.join(work, "raw", "jpg", f"image_{i:05d}.jpg"))
    ids = rng.permutation(np.arange(1, N + 1))
    savemat(os.path.join(work, "raw", "setid.mat"),
            {"trnid": ids[:40], "valid": ids[40:50], "tstid": ids[50:]})
    savemat(os.path.join(work, "raw", "imagelabels.mat"), {"labels": labels})
    cents = rng.normal(size=(NCLS, 1024)).astype(np.float32)
    emb = (cents[labels - 1][:, None, :]
           + .1 * rng.normal(size=(N, 4, 1024))).astype(np.float32)
    np.savez(os.path.join(work, "emb.npz"), embeddings=emb)
    params = iv3.init(0, num_classes=NCLS)
    torch.save({"state_dict": iv3.export_torchvision_state_dict(params)},
               os.path.join(work, "finetuned_inception.pth"))
    print("stand-ins under", work, flush=True)


def write_config(work: str, data_dir: str) -> str:
    """The runbook's GAN-INT-CLS config (batch 16)."""
    path = os.path.join(work, "cfg.yml")
    with open(path, "w") as f:
        f.write(f"model: gancls\n"
                f"data: {{dataset_name: flowers, data_dir: {data_dir}, "
                f"image_size: 64}}\n"
                f"train:\n"
                f"  batch_size: 16\n"
                f"  use_interpolation: true\n"
                f"  summary_interval: 100\n"
                f"  sample_interval: 2000\n"
                f"  snapshot_interval: 2000\n"
                f"dtype: bfloat16\n"
                f"checkpoint_dir: {os.path.join(work, 'run', 'ck')}\n"
                f"sample_dir: {os.path.join(work, 'run', 'samples')}\n"
                f"log_dir: {os.path.join(work, 'run', 'logs')}\n")
    return path


def main(mode: str = "synthetic", work: str = WORK, steps: int = 200,
         is_images: int = 320, device: str = "cuda", overrides=()) -> int:
    if mode != "synthetic":
        raise SystemExit(f"mode {mode!r}: only the synthetic mode is ported "
                         f"(the flowers mode needs downloaded artifacts)")
    data_dir = os.path.join(work, "data")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print("== 0. fabricate stand-ins for every external artifact", flush=True)
    fabricate(work)
    print("== 1. preprocess → StackGAN-format pickles (76px + 304px crop "
          "sources)", flush=True)
    run_module("text_to_image_tpu_torch.data.preprocess", "flowers",
               "--raw", os.path.join(work, "raw"),
               "--embeddings", os.path.join(work, "emb.npz"),
               "--out", data_dir)
    print("== 2. convert the finetuned Inception checkpoint (autodetected by "
          "--eval-is)", flush=True)
    run_module("text_to_image_tpu_torch.scripts.convert_inception",
               "--pth", os.path.join(work, "finetuned_inception.pth"),
               "--out", os.path.join(data_dir, "inception.npz"))
    print("== 3. train GAN-INT-CLS", flush=True)
    cfg = write_config(work, data_dir)
    train(cfg, steps, device, overrides)
    print("== 4. Inception score with the finetuned classifier (reference "
          "protocol)", flush=True)
    out = score(work, cfg, is_images, device, overrides)
    print("== 5. compare against the anchors:")
    print(f"   {ANCHOR}")
    print("   (synthetic mode: the number is meaningless — the run only "
          "proves the chain; the real artifacts give the parity figure)")
    print("PARITY RESULT " + json.dumps(out), flush=True)
    print("parity runbook OK", flush=True)
    return 0


if __name__ == "__main__":
    dev, rest = split_device(sys.argv[1:])
    sys.exit(main(*rest[:2], device=dev))
