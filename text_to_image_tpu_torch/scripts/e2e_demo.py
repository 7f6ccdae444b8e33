"""End-to-end demo on synthetic raw data, all through the port's public
surfaces (counterpart of the JAX package's ``scripts/e2e_demo.sh``):

1. raw data: 48 class-coloured 80×80 JPGs of 6 classes, fake
   char-CNN-RNN embeddings (3 captions × 1024) and a ``classes.txt``;
2. ``python -m text_to_image_tpu_torch.data.preprocess generic`` →
   StackGAN-format pickles under ``<work>/data``;
3. a GAN-CLS config and ``python -m text_to_image_tpu_torch.main --train``
   (checkpoints, sample grids, metrics under ``<work>/run``);
4. ``main --eval-is``: the three grids and the Inception score with the
   classifier finetuned on the data.

    python -m text_to_image_tpu_torch.scripts.e2e_demo [WORK] [--device cpu]

Python where the JAX package has a shell script, so that the tests can run
it at a small size: `main` takes the step count, the IS image count, the
device and config overrides (``--set`` pairs for both ``main`` runs).  Steps
1–2 write and read JPGs with Pillow.
Prints ``E2E RESULT {json}`` (the IS and the grids written) and ``e2e demo
OK``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import numpy as np

from text_to_image_tpu_torch.scripts import run_module, split_device

WORK = "/tmp/t2i_e2e"
IS_LINE = re.compile(r"Inception score: ([-+0-9.eEnaif]+) ± ([-+0-9.eEnaif]+)")


def make_raw_data(work: str) -> None:
    """Step 1 (Pillow): the raw images, embeddings and class list."""
    from PIL import Image
    rng = np.random.default_rng(0)
    img_dir = os.path.join(work, "raw")
    os.makedirs(img_dir)
    colors = rng.uniform(0.2, 0.8, (6, 3))
    names, lines = [], []
    for i in range(48):
        cls = i % 6
        arr = np.clip(colors[cls] + rng.uniform(-.2, .2, (80, 80, 3)), 0, 1)
        name = f"img_{i:03d}.jpg"
        Image.fromarray((arr * 255).astype(np.uint8)).save(
            os.path.join(img_dir, name))
        names.append(name)
        lines.append(f"{name} {cls} {'test' if i % 7 == 0 else 'train'}")
    cents = rng.normal(size=(6, 1024)).astype(np.float32)
    emb = np.stack([np.stack([cents[i % 6] + .1 * rng.normal(size=1024
                                                             ).astype(np.float32)
                              for _ in range(3)]) for i in range(48)])
    # preprocess pairs sorted(filenames) with the embedding rows
    order = np.argsort(names)
    np.savez(os.path.join(work, "emb.npz"), embeddings=emb[order])
    with open(os.path.join(work, "classes.txt"), "w") as f:
        f.write("\n".join(lines))
    print("raw data under", img_dir, flush=True)


def write_config(work: str, data_dir: str) -> str:
    """The demo's GAN-CLS config (batch 16, snapshot every 400 steps)."""
    path = os.path.join(work, "cfg.yml")
    with open(path, "w") as f:
        f.write(f"model: gancls\n"
                f"data: {{dataset_name: demo, data_dir: {data_dir}, "
                f"image_size: 64}}\n"
                f"train: {{batch_size: 16, summary_interval: 50, "
                f"sample_interval: 200, snapshot_interval: 400}}\n"
                f"dtype: bfloat16\n"
                f"checkpoint_dir: {os.path.join(work, 'run', 'ck')}\n"
                f"sample_dir: {os.path.join(work, 'run', 'samples')}\n"
                f"log_dir: {os.path.join(work, 'run', 'logs')}\n")
    return path


def train(cfg: str, steps: int, device: str, overrides=()) -> None:
    """``main --train`` to `steps` (`overrides`: ``--set`` pairs)."""
    run_module("text_to_image_tpu_torch.main", "--cfg", cfg, "--train",
               "--steps", str(steps), "--device", device,
               *(["--set", *overrides] if overrides else []))


def score(work: str, cfg: str, is_images: int, device: str,
          overrides=()) -> dict:
    """``main --eval-is``: its Inception score and the grids under
    ``<work>/run``."""
    said = run_module("text_to_image_tpu_torch.main", "--cfg", cfg,
                      "--eval-is", "--is-images", str(is_images),
                      "--device", device,
                      *(["--set", *overrides] if overrides else []))
    m = IS_LINE.search(said)
    if m is None:
        raise RuntimeError("main --eval-is printed no Inception score")
    grids = sorted(os.path.join(d, f) for d, _, fs in
                   os.walk(os.path.join(work, "run")) for f in fs
                   if f.endswith(".png"))
    return {"is_mean": float(m.group(1)), "is_std": float(m.group(2)),
            "grids": grids}


def main(work: str = WORK, steps: int = 400, is_images: int = 320,
         device: str = "cuda", overrides=()) -> int:
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    print("== 1. make raw data (class-colored images + fake char-CNN-RNN "
          "embeddings)", flush=True)
    make_raw_data(work)
    data_dir = os.path.join(work, "data")
    print("== 2. preprocess → StackGAN pickles", flush=True)
    run_module("text_to_image_tpu_torch.data.preprocess", "generic",
               "--images", os.path.join(work, "raw"),
               "--embeddings", os.path.join(work, "emb.npz"),
               "--classes", os.path.join(work, "classes.txt"),
               "--out", data_dir)
    print("== 3. write config + train", flush=True)
    cfg = write_config(work, data_dir)
    train(cfg, steps, device, overrides)
    print("== 4. eval: grids + Inception score (dataset-finetuned "
          "classifier)", flush=True)
    out = score(work, cfg, is_images, device, overrides)
    print("== artifacts:")
    print("\n".join(out["grids"]))
    print("E2E RESULT " + json.dumps(out), flush=True)
    print("e2e demo OK", flush=True)
    return 0


if __name__ == "__main__":
    dev, rest = split_device(sys.argv[1:])
    sys.exit(main(*rest[:1], device=dev))
