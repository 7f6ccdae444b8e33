"""StackGAN-format dataset loader (rebuild of the reference's TextDataset;
a copy of ``text_to_image_tpu/data/textdataset.py`` over the port's own
``data/native.py``, so the same pickles and seed give the same batches in
both packages).

The reference (SURVEY.md §2 "Dataset loader") reads StackGAN-style pickles
from ``<data_dir>/<split>/``:

* ``76images.pickle``  — N×76×76×3 uint8 (random-crop source for 64-px stages)
* ``304images.pickle`` — N×304×304×3 uint8 (for the 256-px Stage-II)
* ``char-CNN-RNN-embeddings.pickle`` — N×C×1024 float (C captions per image,
  precomputed by reedscot/icml2016 — the text encoder is never run here)
* ``filenames.pickle`` — N filenames
* ``class_info.pickle`` — N integer class ids

``next_batch`` serves matched (image, embedding) pairs plus a *wrong* image
drawn from a different class (matching-aware discriminator), with random crop
+ horizontal flip augmentation and caption sub-sampling: ``window`` captions
sampled per image and averaged (reference ``sample_embeddings``).

All randomness flows from a seeded ``numpy.random.Generator`` so batches are
deterministic and resumable.  Output images are float32 in the generator's
tanh range [-1, 1].
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from text_to_image_tpu_torch.data import native

# crop-source sizes per training resolution (StackGAN convention: images are
# pre-resized ~19% larger than the crop target)
CROP_SOURCE = {64: 76, 256: 304}


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


class TextDataset:
    def __init__(self, data_dir: str, split: str = "train",
                 image_size: int = 64, embed_dim: int = 1024,
                 random_crop: bool = True, random_flip: bool = True,
                 seed: int = 0, raw_uint8: bool = True):
        # raw_uint8: serve uint8 images (normalized to tanh range ON DEVICE
        # by the train step) — 4x smaller host→HBM transfers. False gives
        # float32 [-1,1] for host-side consumers.
        base = os.path.join(data_dir, split)
        src = CROP_SOURCE.get(image_size)
        img_file = (os.path.join(base, f"{src}images.pickle") if src else None)
        if img_file is None or not os.path.exists(img_file):
            raise FileNotFoundError(
                f"no {src}images.pickle for size {image_size} under {base} — "
                f"run text_to_image_tpu_torch.data.preprocess first")
        self._init_from_arrays(
            np.asarray(_load_pickle(img_file), dtype=np.uint8),
            np.asarray(_load_pickle(
                os.path.join(base, "char-CNN-RNN-embeddings.pickle")),
                dtype=np.float32),
            _load_pickle(os.path.join(base, "filenames.pickle")),
            _load_pickle(os.path.join(base, "class_info.pickle")),
            image_size, embed_dim, random_crop, random_flip, seed, raw_uint8)

    @classmethod
    def from_arrays(cls, images: np.ndarray, embeddings: np.ndarray,
                    class_ids: np.ndarray, filenames=None,
                    image_size: int = 64, random_crop: bool = True,
                    random_flip: bool = True, seed: int = 0,
                    raw_uint8: bool = True) -> "TextDataset":
        """In-memory construction (benchmarks/tests): same serving path —
        C++ crop/flip/gather kernels, caption windowing, wrong-pair draw —
        without pickle files on disk."""
        self = cls.__new__(cls)
        self._init_from_arrays(
            np.asarray(images, dtype=np.uint8),
            np.asarray(embeddings, dtype=np.float32),
            filenames if filenames is not None else list(range(len(images))),
            class_ids, image_size, int(embeddings.shape[-1]),
            random_crop, random_flip, seed, raw_uint8)
        return self

    def _init_from_arrays(self, images, embeddings, filenames, class_info,
                          image_size, embed_dim, random_crop, random_flip,
                          seed, raw_uint8):
        self.images = images
        self.embeddings = embeddings
        self.filenames = filenames
        self.class_ids = np.asarray(class_info, dtype=np.int64)
        if self.embeddings.shape[-1] != embed_dim:
            raise ValueError(
                f"embedding dim {self.embeddings.shape[-1]} != cfg {embed_dim}")
        self.image_size = image_size
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.raw_uint8 = raw_uint8
        self._rng = np.random.default_rng(seed)

    @property
    def num_examples(self) -> int:
        return len(self.images)

    @property
    def embed_dim(self) -> int:
        return int(self.embeddings.shape[-1])

    def spawn(self, seed: int) -> "TextDataset":
        """Shallow view sharing the arrays but with its own RNG stream —
        for parallel pipeline workers (numpy Generators aren't thread-safe)."""
        import copy
        clone = copy.copy(self)
        clone._rng = np.random.default_rng(seed)
        return clone

    # -- augmentation ----------------------------------------------------

    def _crop_flip(self, idx: np.ndarray) -> np.ndarray:
        """Gather + crop + flip + normalize → float32 [-1, 1] (native C++
        kernel when available; numpy fallback inside `native`)."""
        n = len(idx)
        _, h, w, _ = self.images.shape
        s = self.image_size
        if self.random_crop:
            ys = self._rng.integers(0, h - s + 1, size=n)
            xs = self._rng.integers(0, w - s + 1, size=n)
        else:
            ys = np.full(n, (h - s) // 2)
            xs = np.full(n, (w - s) // 2)
        flips = (self._rng.random(n) < 0.5) if self.random_flip else np.zeros(n, bool)
        fn = native.crop_flip_u8 if self.raw_uint8 else native.crop_flip_normalize
        return fn(self.images, idx, s, ys, xs, flips)

    def _sample_embeddings(self, idx: np.ndarray, window: int) -> np.ndarray:
        """Sample `window` captions per image and average (reference
        ``sample_embeddings``); window >= #captions uses all of them.
        Without-replacement draw vectorized over the batch: argsort a row of
        uniform keys and keep the first `window` — no per-example Python."""
        n = len(idx)
        c = self.embeddings.shape[1]
        if window >= c:
            picks = np.tile(np.arange(c), (n, 1))
        else:
            picks = np.argsort(self._rng.random((n, c)), axis=1)[:, :window]
        return native.gather_average_embeddings(self.embeddings, idx, picks)

    def _wrong_indices(self, idx: np.ndarray) -> np.ndarray:
        """A mismatched image per example: uniformly random with a different
        class id (the matching-aware 'wrong' pair).  Vectorized rejection —
        only the colliding lanes resample each round, so the host cost stays
        O(batch) regardless of class skew."""
        out = self._rng.integers(0, self.num_examples, size=len(idx))
        same = self.class_ids[out] == self.class_ids[idx]
        while same.any():
            out[same] = self._rng.integers(0, self.num_examples,
                                           size=int(same.sum()))
            same = self.class_ids[out] == self.class_ids[idx]
        return out

    # -- batching ---------------------------------------------------------

    def next_batch(self, batch_size: int, window: int = 4) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self.num_examples, size=batch_size)
        wrong_idx = self._wrong_indices(idx)
        return {
            "real": self._crop_flip(idx),
            "wrong": self._crop_flip(wrong_idx),
            "emb": self._sample_embeddings(idx, window),
        }

    def test_embeddings(self, n: Optional[int] = None) -> np.ndarray:
        """First caption embedding per example (deterministic eval input)."""
        embs = self.embeddings[:n] if n else self.embeddings
        return embs[:, 0, :]
