from text_to_image_tpu_torch.data.synthetic import SyntheticDataset  # noqa: F401
from text_to_image_tpu_torch.data.textdataset import TextDataset  # noqa: F401


def get_dataset(cfg, split: str = "train"):
    """Dataset factory from a Config (counterpart of the JAX package's):
    ``synthetic``, ``natural`` / ``natural16`` (the photographs bundled with
    installed packages, ``data/natural.py``), else the StackGAN-format
    pickles under ``<data_dir>/<split>/`` (``data/textdataset.py``; a split
    that is not there raises `FileNotFoundError` naming
    ``text_to_image_tpu_torch.data.preprocess``).  No dataset is
    downloaded."""
    if cfg.data.dataset_name == "synthetic":
        return SyntheticDataset(
            num_examples=256,
            image_size=cfg.data.image_size,
            embed_dim=cfg.gan.embed_dim,
            seed=cfg.seed,
        )
    if cfg.data.dataset_name in ("natural", "natural16"):
        from text_to_image_tpu_torch.data.natural import (ANCHORS, ANCHORS16,
                                                          NaturalPhotoDataset)
        return NaturalPhotoDataset(
            image_size=cfg.data.image_size,
            embed_dim=cfg.gan.embed_dim,
            random_crop=cfg.data.random_crop,
            random_flip=cfg.data.random_flip,
            seed=cfg.seed,
            anchors=(ANCHORS16 if cfg.data.dataset_name == "natural16"
                     else ANCHORS),
        )
    return TextDataset(
        data_dir=cfg.data.data_dir,
        split=split,
        image_size=cfg.data.image_size,
        embed_dim=cfg.gan.embed_dim,
        random_crop=cfg.data.random_crop,
        random_flip=cfg.data.random_flip,
        seed=cfg.seed,
    )
