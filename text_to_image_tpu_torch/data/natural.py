"""A copy of ``text_to_image_tpu/data/natural.py`` over the port's
``SyntheticDataset``: the same seed gives the same dataset in both packages.
The photographs are found with ``importlib.util.find_spec`` and read with
PIL only when the dataset is built; `available` is False where no package
that holds them is installed.

Natural-photograph dataset built from images bundled with installed
packages — the offline stand-in for REAL-photo convergence evidence.

The synthetic dataset (data/synthetic.py) validates conditioning and the IS
protocol on flat class-colored noise, but GAN training on photographs
exercises different failure modes (texture statistics, sharp edges, multi
modal local structure — SURVEY.md §7 hard part #6).  This environment has no
network and no Oxford-102/CUB, but three genuine photographs ship inside
installed packages:

* sklearn ``china.jpg``   (427x640 — pagoda, roof tiles, foliage, lake),
* sklearn ``flower.jpg``  (427x640 — dahlia close-up, bokeh background),
* matplotlib ``grace_hopper.jpg`` (600x512 — portrait, flag stripes),

plus (round 4, ``ANCHORS16``) eight real photographic textures bundled with
gymnasium_robotics / dm_control assets: wood grain, skin, kitchen tile,
crumpled foil, grass, cumulus sky, veined marble, brushed metal — eleven
distinct source images in total.

Visually distinct texture regions of those photos become classes; each
example is a jittered, scale-perturbed crop of its region (anchored
classes) or a randomly positioned, rotated crop of the whole texture
(roaming classes) resized to ``source_size`` (default 76 px, so the
standard 76 -> 64 random crop / flip of the training pipeline applies real
augmentation, matching the reference's TextDataset geometry — SURVEY.md §2
dataset-loader row).
Embeddings follow the reference's data model (precomputed per-caption
vectors, class-clustered): centroid + per-caption noise, as the e2e demo's
fake char-CNN-RNN embeddings do.

The class interface mirrors ``SyntheticDataset`` (images / embeddings /
class_ids / next_batch / test_embeddings), so the Trainer's device-resident
staging (data/device.py) and every evaluator work unchanged.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from text_to_image_tpu_torch.data.synthetic import SyntheticDataset

# (photo key, top, left, box) -- top/left in source pixels, box = square
# region side.  Regions chosen for distinct texture statistics (inspected
# 2026-08-17): architecture, tiled roof, foliage, water, flower core, bokeh,
# face, flag stripes.
ANCHORS: Tuple[Tuple[str, int, int, int], ...] = (
    ("china", 130, 150, 220),   # pagoda mid-tower (red/teal structure)
    ("china", 250, 180, 170),   # orange roof tiers close-up
    ("china", 290, 0, 130),     # tree foliage, bottom-left
    ("china", 220, 400, 150),   # lake surface with boats
    ("flower", 110, 220, 210),  # dahlia center (petal spiral)
    ("flower", 40, 10, 180),    # dark teal bokeh background
    ("hopper", 140, 150, 230),  # portrait face
    ("hopper", 40, 0, 180),     # flag stripes
)

# Roaming texture classes (round 4, VERDICT #7): each draws crops at RANDOM
# positions over the WHOLE source texture, with a wider 0.7-1.3x scale range
# and a random 90-degree-multiple rotation, so intra-class layout diversity
# is much higher than the jittered fixed-region ANCHORS above.  top/left are
# the ROAM sentinel (-1); box sets the nominal crop side.  Sources are real
# photographic textures bundled with installed packages (gymnasium_robotics
# kitchen/adroit assets, dm_control outdoor arena), inspected 2026-08-19.
ROAM = -1
ANCHORS16: Tuple[Tuple[str, int, int, int], ...] = ANCHORS + (
    ("wood1", ROAM, ROAM, 360),    # oiled wood grain, knots
    ("skin", ROAM, ROAM, 360),     # skin close-up, pores
    ("tile1", ROAM, ROAM, 220),    # glazed kitchen tile, grout lines
    ("foil", ROAM, ROAM, 220),     # crumpled foil, specular facets
    ("grass", ROAM, ROAM, 220),    # grass lawn, blade clutter
    ("sky", ROAM, ROAM, 500),      # cumulus clouds over blue sky
    ("marble2", ROAM, ROAM, 360),  # white marble, grey veins
    ("silver", ROAM, ROAM, 220),   # raw brushed metal
)

# source key -> (python package that bundles it, path inside the package).
# Resolved via importlib.util.find_spec, so no package is imported (the
# JAX package imports sklearn and matplotlib for the three photographs).
_PKG_FILES = {
    "china": ("sklearn", "datasets/images/china.jpg"),
    "flower": ("sklearn", "datasets/images/flower.jpg"),
    "hopper": ("matplotlib", "mpl-data/sample_data/grace_hopper.jpg"),
    "wood1": ("gymnasium_robotics",
              "envs/assets/kitchen_franka/kitchen_assets/textures/wood1.png"),
    "skin": ("gymnasium_robotics",
             "envs/assets/adroit_hand/resources/textures/skin.png"),
    "tile1": ("gymnasium_robotics",
              "envs/assets/kitchen_franka/kitchen_assets/textures/tile1.png"),
    "foil": ("gymnasium_robotics",
             "envs/assets/adroit_hand/resources/textures/foil.png"),
    "grass": ("dm_control",
              "locomotion/arenas/assets/outdoor_natural/"
              "OutdoorGrassFloorD.png"),
    "sky": ("dm_control",
            "locomotion/arenas/assets/outdoor_natural/"
            "OutdoorSkybox2048.png"),
    "marble2": ("gymnasium_robotics",
                "envs/assets/kitchen_franka/kitchen_assets/textures/"
                "white_marble_tile2.png"),
    "silver": ("gymnasium_robotics",
               "envs/assets/adroit_hand/resources/textures/silverRaw.png"),
}


def photo_paths() -> dict:
    """Locate the three bundled photographs; raises ImportError/
    FileNotFoundError when a providing package is absent (callers/tests gate
    on this)."""
    return source_paths(["china", "flower", "hopper"])


def source_paths(keys: Sequence[str]) -> dict:
    """Locate the source images for `keys` without importing the packages
    that hold them."""
    import importlib.util
    out = {}
    for k in dict.fromkeys(keys):
        pkg, rel = _PKG_FILES[k]
        spec = importlib.util.find_spec(pkg)
        if spec is None or not spec.submodule_search_locations:
            raise ImportError(pkg)
        p = os.path.join(list(spec.submodule_search_locations)[0], rel)
        if not os.path.isfile(p):
            raise FileNotFoundError(p)
        out[k] = p
    return out


def available(anchors: Sequence = ANCHORS) -> bool:
    try:
        source_paths([a[0] for a in anchors])
        return True
    except Exception:
        return False


def _load_photos(keys: Sequence[str]) -> dict:
    from PIL import Image
    return {k: np.asarray(Image.open(p).convert("RGB"))
            for k, p in source_paths(keys).items()}


def render_class_crops(rng: np.random.Generator, photo: np.ndarray,
                       top: int, left: int, box: int, n: int,
                       out_size: int) -> np.ndarray:
    """n jittered crops of one anchor region, resized to out_size.

    Anchored regions (top/left >= 0): +-12% of box translation, 0.85-1.15x
    scale — enough that no two examples are pixel-identical while every crop
    stays on the region's texture.  Roaming classes (top = ROAM): random
    position over the WHOLE image, 0.7-1.3x scale, and a random 90-degree-
    multiple rotation — far higher intra-class layout diversity for
    homogeneous textures.  Returns [n, out_size, out_size, 3] uint8."""
    from PIL import Image
    h, w = photo.shape[:2]
    roam = top < 0
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    for i in range(n):
        if roam:
            s = int(round(box * rng.uniform(0.7, 1.3)))
            s = max(16, min(s, h, w))
            t = int(rng.integers(0, h - s + 1))
            l = int(rng.integers(0, w - s + 1))
        else:
            s = int(round(box * rng.uniform(0.85, 1.15)))
            jt = int(round(box * rng.uniform(-0.12, 0.12)))
            jl = int(round(box * rng.uniform(-0.12, 0.12)))
            t = int(np.clip(top + jt, 0, max(0, h - s)))
            l = int(np.clip(left + jl, 0, max(0, w - s)))
            s = min(s, h - t, w - l)
        patch = photo[t:t + s, l:l + s]
        if roam:
            patch = np.rot90(patch, k=int(rng.integers(0, 4)))
        crop = Image.fromarray(np.ascontiguousarray(patch))
        out[i] = np.asarray(
            crop.resize((out_size, out_size), Image.BILINEAR))
    return out


class NaturalPhotoDataset(SyntheticDataset):
    """Texture classes of real-photograph crops, TextDataset-shaped (eight
    anchored-region classes by default; pass ``anchors=ANCHORS16`` for the
    16-class / 11-source-image set with roaming high-diversity classes).

    Follows TextDataset's size convention exactly (data/textdataset.py
    CROP_SOURCE): ``self.images`` holds uint8 **source-size** crops
    (default image_size·19/16, i.e. 76 for 64 / 304 for 256 — the StackGAN
    pre-resize ratio) and ``next_batch`` serves random-crop + flip
    ``image_size`` batches, so the reference's augmentation geometry runs on
    real pixels on BOTH data paths (host ``next_batch`` here; the
    device-resident path crops the staged source arrays inside the compiled
    step).  Embeddings are class-centroid vectors with per-caption noise
    (the reference's precomputed-embedding data model)."""

    def __init__(self, examples_per_class: int = 64, image_size: int = 64,
                 source_size: Optional[int] = None,
                 embed_dim: int = 1024, captions_per_image: int = 4,
                 random_crop: bool = True, random_flip: bool = True,
                 seed: int = 0, anchors: Sequence = ANCHORS,
                 raw_uint8: bool = True):
        # intentionally NOT calling super().__init__ — same interface,
        # different construction; test_embeddings/spawn inherit.
        self.raw_uint8 = raw_uint8
        self.image_size = image_size
        self.random_crop = random_crop
        self.random_flip = random_flip
        source_size = source_size or (image_size * 19) // 16
        rng = np.random.default_rng(seed)
        photos = _load_photos([a[0] for a in anchors])

        n_classes = len(anchors)
        chunks: List[np.ndarray] = []
        for (key, top, left, box) in anchors:
            chunks.append(render_class_crops(
                rng, photos[key], top, left, box, examples_per_class,
                source_size))
        self.images = np.concatenate(chunks, axis=0)
        self.class_ids = np.repeat(np.arange(n_classes), examples_per_class)

        centroids = rng.normal(
            size=(n_classes, embed_dim)).astype(np.float32)
        self.embeddings = (
            centroids[self.class_ids][:, None, :]
            + 0.1 * rng.normal(size=(len(self.images), captions_per_image,
                                     embed_dim))
        ).astype(np.float32)

        # shuffle so any contiguous test slice spans all classes
        perm = rng.permutation(len(self.images))
        self.images = self.images[perm]
        self.class_ids = self.class_ids[perm]
        self.embeddings = self.embeddings[perm]
        self._rng = np.random.default_rng(seed + 1)

    @property
    def num_classes(self) -> int:
        return int(self.class_ids.max()) + 1

    def _crop_flip(self, imgs: np.ndarray) -> np.ndarray:
        """Random image_size crop + horizontal flip of source-size uint8
        batches — TextDataset's host augmentation on real pixels."""
        b, src, s = len(imgs), imgs.shape[1], self.image_size
        if src != s:
            if self.random_crop:
                ys = self._rng.integers(0, src - s + 1, size=b)
                xs = self._rng.integers(0, src - s + 1, size=b)
            else:
                ys = xs = np.full(b, (src - s) // 2)
            imgs = np.stack([im[y:y + s, x:x + s]
                             for im, y, x in zip(imgs, ys, xs)])
        if self.random_flip:
            flips = self._rng.random(b) < 0.5
            imgs = np.where(flips[:, None, None, None],
                            imgs[:, :, ::-1, :], imgs)
        return imgs

    def next_batch(self, batch_size: int, window: int = 4):
        batch = super().next_batch(batch_size, window)
        batch["real"] = self._crop_flip(batch["real"])
        batch["wrong"] = self._crop_flip(batch["wrong"])
        return batch
