"""A copy of ``text_to_image_tpu/data/preprocess.py`` (same outputs; PIL and
scipy imported only where a function needs them).

Preprocessing: raw Oxford-102 flowers / CUB-200 birds images + reedscot
char-CNN-RNN embeddings → StackGAN-format pickles (rebuild of the reference's
``preprocess/`` scripts — SURVEY.md §2 "Preprocess scripts").

Outputs per split (train/test) under ``<out_dir>/<split>/``:
* ``76images.pickle``   — images resized to 76×76   (64-px random-crop source)
* ``304images.pickle``  — images resized to 304×304 (256-px random-crop source)
* ``char-CNN-RNN-embeddings.pickle`` — [N, C, 1024] float32
* ``filenames.pickle``, ``class_info.pickle``

Embedding sources supported:
* ``.t7`` torch7 files from reedscot/icml2016 (needs the ``torchfile`` pip
  package — gated import, with a clear error if absent), or
* a pre-converted ``.npz``/``.pickle`` with the same content.

Usage:
    python -m text_to_image_tpu_torch.data.preprocess \
        --images /path/oxford102/jpg --embeddings /path/flowers_icml \
        --classes /path/classes.txt --out data/flowers
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

TARGET_SIZES = (76, 304)  # load-bearing: crop sources for 64 and 256 px


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ImportError("preprocessing needs PIL") from e
    return np.asarray(
        Image.fromarray(img).resize((size, size), Image.BILINEAR),
        dtype=np.uint8)


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def load_t7_embeddings(path: str) -> np.ndarray:
    """Load a reedscot/icml2016 char-CNN-RNN .t7 embedding file using the
    bundled dependency-free torch7 reader (`data/t7.py`) — no `torchfile`
    needed.  Accepts a bare tensor, a lua array of per-image tensors, or a
    table with a tensor under 'fea_txt'/'embeddings'/'txt'."""
    from text_to_image_tpu_torch.data.t7 import load_t7
    data = load_t7(path)
    if isinstance(data, dict):
        for key in ("fea_txt", "embeddings", "txt"):
            if key in data:
                data = data[key]
                break
        else:
            raise ValueError(
                f".t7 table at {path} has no tensor under fea_txt/embeddings/"
                f"txt (keys: {sorted(map(str, data))})")
    if isinstance(data, list):
        data = np.stack([np.asarray(x) for x in data])
    return np.asarray(data, dtype=np.float32)


def load_embeddings(path: str) -> np.ndarray:
    """[N, C, 1024] embeddings from .t7 / .npz / .pickle."""
    if path.endswith(".t7"):
        emb = load_t7_embeddings(path)
    elif path.endswith(".npz"):
        emb = np.load(path)["embeddings"]
    else:
        with open(path, "rb") as f:
            emb = np.asarray(pickle.load(f, encoding="latin1"))
    emb = np.asarray(emb, dtype=np.float32)
    if emb.ndim == 2:
        emb = emb[:, None, :]
    assert emb.ndim == 3, f"expected [N,C,E] embeddings, got {emb.shape}"
    return emb


def write_split(out_dir: str, split: str, filenames: Sequence[str],
                images, embeddings: np.ndarray,
                class_ids: Sequence[int]) -> None:
    """`images` may be any iterable (incl. a lazy generator): each image is
    decoded once, immediately resized to every target size, and the full-res
    array is dropped — peak memory is one full-res image plus the RESIZED
    split (the output itself: ≈(76²+304²)·3 B ≈ 294 KB/image, ~1.8 GB for
    the 5,994-image CUB train split), never the full-res dataset."""
    resized: Dict[int, List[np.ndarray]] = {s: [] for s in TARGET_SIZES}
    count = 0
    for img in images:
        for size in TARGET_SIZES:
            resized[size].append(_resize(img, size))
        count += 1
    assert len(filenames) == count == len(embeddings) == len(class_ids)
    base = os.path.join(out_dir, split)
    os.makedirs(base, exist_ok=True)
    for size in TARGET_SIZES:
        with open(os.path.join(base, f"{size}images.pickle"), "wb") as f:
            pickle.dump(resized.pop(size), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(base, "char-CNN-RNN-embeddings.pickle"), "wb") as f:
        pickle.dump(np.asarray(embeddings, np.float32), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(base, "filenames.pickle"), "wb") as f:
        pickle.dump(list(filenames), f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(base, "class_info.pickle"), "wb") as f:
        pickle.dump(list(map(int, class_ids)), f,
                    protocol=pickle.HIGHEST_PROTOCOL)


def preprocess(images_dir: str, embeddings_path: str, out_dir: str,
               class_map: Dict[str, int], split_map: Dict[str, str]) -> None:
    """Generic converter: `class_map` filename→class id, `split_map`
    filename→'train'|'test'."""
    # pass 1: metadata only; pass 2: stream-decode per split (write_split
    # resizes each image as it arrives — full-res arrays never accumulate)
    per_split: Dict[str, Tuple[List, List, List]] = {
        "train": ([], [], []), "test": ([], [], [])}
    embeddings = load_embeddings(embeddings_path)
    names = sorted(class_map)
    assert len(names) == len(embeddings), (
        f"{len(names)} images vs {len(embeddings)} embedding rows")
    for i, name in enumerate(names):
        fn, em, cl = per_split[split_map.get(name, "train")]
        fn.append(name)
        em.append(embeddings[i])
        cl.append(class_map[name])
    for split, (fn, em, cl) in per_split.items():
        if fn:
            imgs = (load_image(os.path.join(images_dir, nm)) for nm in fn)
            write_split(out_dir, split, fn, imgs, np.stack(em), cl)


# -- dataset-specific converters (SURVEY.md §2 "Preprocess scripts":
# reference preprocess_flowers / preprocess_birds) -------------------------


def preprocess_flowers(raw_dir: str, embeddings_path: str, out_dir: str
                       ) -> None:
    """Oxford-102 flowers → StackGAN pickles.

    Expects the official raw layout under ``raw_dir``:
    * ``jpg/image_%05d.jpg`` — 8189 images
    * ``setid.mat``      — 'trnid'/'valid'/'tstid' 1-based image-id splits
    * ``imagelabels.mat`` — 'labels' [1,N] 1..102 class per image

    Split convention: train = trnid ∪ valid, test = tstid.  Embeddings must
    be [N, C, 1024] in image-id order (reedscot/icml2016 char-CNN-RNN).
    """
    from scipy.io import loadmat

    setid = loadmat(os.path.join(raw_dir, "setid.mat"))
    labels = loadmat(os.path.join(raw_dir, "imagelabels.mat"))
    class_per_image = np.asarray(labels["labels"]).ravel().astype(int)  # 1-based idx
    train_ids = np.sort(np.concatenate([
        np.asarray(setid["trnid"]).ravel(),
        np.asarray(setid["valid"]).ravel()])).astype(int)
    test_ids = np.sort(np.asarray(setid["tstid"]).ravel()).astype(int)

    embeddings = load_embeddings(embeddings_path)
    n = len(class_per_image)
    assert len(embeddings) == n, (
        f"{len(embeddings)} embedding rows vs {n} labeled images")

    for split, ids in (("train", train_ids), ("test", test_ids)):
        names = [f"image_{i:05d}.jpg" for i in ids]
        imgs = (load_image(os.path.join(raw_dir, "jpg", nm)) for nm in names)
        write_split(out_dir, split, names, imgs,
                    embeddings[ids - 1], class_per_image[ids - 1])


def _cub_bbox_crop(img: np.ndarray, bbox: Sequence[float]) -> np.ndarray:
    """StackGAN bird crop: a square of radius 0.75·max(w,h) centred on the
    bounding-box centre, clipped to the image (the bird fills ~2/3 of the
    crop — the published StackGAN preprocessing recipe)."""
    x, y, w, h = bbox
    height, width = img.shape[:2]
    r = int(np.maximum(w, h) * 0.75)
    cx = int((2 * x + w) / 2)
    cy = int((2 * y + h) / 2)
    y1, y2 = max(0, cy - r), min(height, cy + r)
    x1, x2 = max(0, cx - r), min(width, cx + r)
    return img[y1:y2, x1:x2]


def _read_cub_index(path: str) -> Dict[int, List[str]]:
    out: Dict[int, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                out[int(parts[0])] = parts[1:]
    return out


def preprocess_birds(raw_dir: str, embeddings_path: str, out_dir: str
                     ) -> None:
    """CUB-200-2011 birds → StackGAN pickles.

    Expects the official raw layout under ``raw_dir``:
    * ``images/<class_dir>/<name>.jpg``
    * ``images.txt``            — '<id> <relpath>'
    * ``train_test_split.txt``  — '<id> <is_train>'
    * ``image_class_labels.txt``— '<id> <class 1..200>'
    * ``bounding_boxes.txt``    — '<id> <x> <y> <w> <h>'

    Images are bounding-box cropped (StackGAN recipe) before resizing.
    Embeddings must be [N, C, 1024] in image-id order.
    """
    names = _read_cub_index(os.path.join(raw_dir, "images.txt"))
    split = _read_cub_index(os.path.join(raw_dir, "train_test_split.txt"))
    labels = _read_cub_index(os.path.join(raw_dir, "image_class_labels.txt"))
    bboxes = _read_cub_index(os.path.join(raw_dir, "bounding_boxes.txt"))

    embeddings = load_embeddings(embeddings_path)
    ids = sorted(names)
    assert len(embeddings) == len(ids), (
        f"{len(embeddings)} embedding rows vs {len(ids)} images")

    # pass 1: metadata; pass 2: stream decode+bbox-crop per split (full-res
    # CUB images never accumulate — see write_split's memory bound)
    per_split: Dict[str, Tuple[List, List, List, List]] = {
        "train": ([], [], [], []), "test": ([], [], [], [])}
    for pos, i in enumerate(ids):
        dest = "train" if int(split[i][0]) == 1 else "test"
        fn, bb, em, cl = per_split[dest]
        fn.append(names[i][0])
        bb.append([float(v) for v in bboxes[i]])
        em.append(embeddings[pos])
        cl.append(int(labels[i][0]))
    for dest, (fn, bb, em, cl) in per_split.items():
        if fn:
            imgs = (_cub_bbox_crop(
                load_image(os.path.join(raw_dir, "images", rel)), box)
                for rel, box in zip(fn, bb))
            write_split(out_dir, dest, fn, imgs, np.stack(em), cl)


def main():  # pragma: no cover
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset")

    for name in ("flowers", "birds"):
        sp = sub.add_parser(name, help=f"official raw {name} layout")
        sp.add_argument("--raw", required=True, help="raw dataset root")
        sp.add_argument("--embeddings", required=True)
        sp.add_argument("--out", required=True)

    gen = sub.add_parser("generic", help="user-supplied classes.txt mapping")
    gen.add_argument("--images", required=True)
    gen.add_argument("--embeddings", required=True)
    gen.add_argument("--classes", required=True,
                     help="txt: '<filename> <class_id> [train|test]' per line")
    gen.add_argument("--out", required=True)

    args = p.parse_args()
    if args.dataset == "flowers":
        preprocess_flowers(args.raw, args.embeddings, args.out)
    elif args.dataset == "birds":
        preprocess_birds(args.raw, args.embeddings, args.out)
    elif args.dataset == "generic":
        class_map, split_map = {}, {}
        with open(args.classes) as f:
            for line in f:
                parts = line.split()
                class_map[parts[0]] = int(parts[1])
                if len(parts) > 2:
                    split_map[parts[0]] = parts[2]
        preprocess(args.images, args.embeddings, args.out, class_map,
                   split_map)
    else:
        p.print_help()


if __name__ == "__main__":  # pragma: no cover
    main()
