from text_to_image_tpu_torch.data.synthetic import SyntheticDataset  # noqa: F401


def get_dataset(cfg, split: str = "train"):
    """Dataset factory from a Config.  Only ``synthetic`` is ported; the
    Oxford-102 / CUB / natural-photo readers are ROADMAP.md 'Modules to
    port' item 3."""
    if cfg.data.dataset_name == "synthetic":
        return SyntheticDataset(
            num_examples=256,
            image_size=cfg.data.image_size,
            embed_dim=cfg.gan.embed_dim,
            seed=cfg.seed,
        )
    raise NotImplementedError(
        f"dataset {cfg.data.dataset_name!r} is not ported yet: ROADMAP.md, "
        "'Modules to port' item 3 (data)")
