"""Typed configuration system (a copy of ``text_to_image_tpu/config.py``;
the port keeps its own so that it never imports the JAX package).

``use_pallas`` is kept so that every YAML under ``configs/`` loads.  It has
no effect in the port yet: on CUDA every hand-written kernel always runs, on
the CPU every kernel's plain PyTorch version runs.

The reference uses a global easydict tree in ``utils/config.py`` with
recursive YAML override (``cfg_from_file``) and per-experiment YAMLs under
``models/*/cfg/`` (StackGAN lineage) — see SURVEY.md §5.6.  This rebuild keeps
the same knobs (Z_DIM, EMBED_DIM, COMPRESSED_EMBED_DIM, TRAIN.BATCH_SIZE,
TRAIN.COEFF.KL, GAN.GF_DIM/DF_DIM, ...) but as typed dataclasses, so configs
are pytree-friendly, validated at load time, and hashable for jit static args.

Reference-style UPPERCASE YAML files (e.g. ``TRAIN: {BATCH_SIZE: 64}``) load
directly: `load_config` understands both the reference key names and our
snake_case names, so a user of the reference can bring their YAMLs over 1:1.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional

import yaml


@dataclass(frozen=True)
class GanConfig:
    """Network width / conditioning dims (reference ``cfg.GAN`` + top level)."""

    gf_dim: int = 128              # generator base feature width (GAN.GF_DIM)
    df_dim: int = 64               # discriminator base feature width (GAN.DF_DIM)
    z_dim: int = 100               # latent dim (Z_DIM)
    embed_dim: int = 1024          # char-CNN-RNN sentence embedding dim (EMBED_DIM)
    compressed_embed_dim: int = 128  # FC-compressed text dim (COMPRESSED_EMBED_DIM)
    ca_dim: int = 128              # StackGAN conditioning-augmentation dim
    res_blocks: int = 2            # StackGAN Stage-II residual block count


@dataclass(frozen=True)
class CoeffConfig:
    """Loss-term coefficients (reference ``cfg.TRAIN.COEFF``)."""

    kl: float = 2.0                # CA KL-divergence weight (TRAIN.COEFF.KL)
    gp_lambda: float = 10.0        # WGAN gradient-penalty λ (arXiv:1704.00028)
    mismatch_alpha: float = 0.5    # weight on the wrong-caption (matching-aware) term
    interp_beta: float = 0.5       # GAN-INT embedding interpolation coefficient
    interp_weight: float = 0.5     # weight of the GAN-INT generator loss term
    drift_epsilon: float = 0.0     # optional ε·E[D(real)²] critic drift
    # penalty (PGGAN-style score anchoring; 0 = reference WGAN-CLS behavior)
    real_label_smooth: float = 1.0  # one-sided label smoothing: d_real's CE
    # target (Salimans et al. 2016; 1.0 = reference behavior).  <1 keeps the
    # CE discriminator off the saturation floor (round-4 Stage-II natural
    # diagnosis: d_loss ~1e-5 for thousands of steps)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64           # TRAIN.BATCH_SIZE (global; sharded over mesh 'data')
    max_epoch: int = 600           # TRAIN.MAX_EPOCH
    generator_lr: float = 2e-4     # TRAIN.GENERATOR_LR
    discriminator_lr: float = 2e-4 # TRAIN.DISCRIMINATOR_LR
    beta1: float = 0.5             # Adam β1 (DCGAN recipe; WGAN-GP uses 0.0)
    beta2: float = 0.9
    n_critic: int = 1              # D steps per G step (5 for WGAN-CLS)
    g_steps: int = 2               # G steps per schedule tick (GAN-CLS runs G twice)
    use_interpolation: bool = False  # GAN-INT extra generator term
    lr_decay_epoch: int = 100      # halve LRs every this many epochs (StackGAN recipe)
    lr_decay_factor: float = 0.5
    snapshot_interval: int = 500   # steps between checkpoints
    sample_interval: int = 200     # steps between sample grids
    summary_interval: int = 20     # steps between metric writes
    ema_decay: float = 0.0         # generator weight EMA for eval (Karras
    # PGGAN recipe; 0 = off, typical 0.999).  Training always uses the live
    # params; samplers/evaluators read aux['ema_g_params'] when present
    # (eval/sampler.py::eval_g_params)
    ema_rampup: float = 0.0        # fade-aware EMA: when > 0, the effective
    # decay ramps as min(ema_decay, (1+t)/(ema_rampup+t)) with t = steps
    # since the EMA anchor (PGGAN: the current stage's fade end; other
    # models: step 0).  Keeps the average horizon inside the post-fade tail
    # so during-fade weights never enter it (round-4 measured −1.69 IS from
    # exactly that).  Typical value 10 (Karras warmup constant); 0 = off
    coeff: CoeffConfig = field(default_factory=CoeffConfig)


@dataclass(frozen=True)
class DataConfig:
    dataset_name: str = "flowers"  # DATASET_NAME: flowers | birds |
    # synthetic | natural | natural16 (offline real-photo crops,
    # data/natural.py; natural16 = 16 classes from 11 source images)
    data_dir: str = "data/flowers"
    embedding_type: str = "cnn-rnn"  # EMBEDDING_TYPE
    image_size: int = 64           # training resolution of this stage
    caption_window: int = 4        # captions sampled+averaged per image (next_batch window)
    random_flip: bool = True
    random_crop: bool = True
    workers: int = 2               # host pipeline worker threads
    prefetch: int = 2              # batches kept in flight to HBM
    device_resident: str = "auto"  # keep the split in HBM and assemble
    # batches inside the compiled step (data/device.py): "on" (replicated
    # per device), "sharded" (example dim sharded over the batch axes —
    # covers datasets up to D× the per-chip budget, each device sampling
    # its own shard), "off", or "auto" = replicated when the split fits
    # resident_budget_mb per chip, sharded when it fits in aggregate,
    # else the host pipeline
    resident_budget_mb: int = 4096  # auto-mode HBM budget for the split


@dataclass(frozen=True)
class PgganConfig:
    """Conditional-PGGAN progression schedule (models/pggan.py).  Stage s
    trains at 4·2^(s-1) px; the whole progression is a sequence of
    fixed-shape compiled programs linked by ordinary checkpoint restores."""

    stage: int = 0              # 0 = run the full progression up to
    # data.image_size; s >= 1 = train exactly stage s
    steps_per_stage: int = 4000
    fade_fraction: float = 0.5  # fraction of a stage spent fading α 0→1
    start_step: int = -1        # global step at which this stage begins
    # (-1 = derive as (stage-1)·steps_per_stage; α ramps from there)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. data=-1 means 'all remaining devices'."""

    data: int = -1                 # data-parallel axis size
    model: int = 1                 # tensor-parallel axis (shards wide FC layers)
    slices: int = 1                # multi-slice pods: hierarchical-DP axis
    # whose cross-slice gradient reduction rides DCN (parallel/mesh.py)


@dataclass(frozen=True)
class Config:
    model: str = "gancls"          # gancls | wgancls | stackgan_stage1 |
    # stackgan_stage2 | pggan
    gan: GanConfig = field(default_factory=GanConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    pggan: PgganConfig = field(default_factory=PgganConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0
    dtype: str = "bfloat16"        # compute dtype (params stay float32)
    checkpoint_dir: str = "checkpoints"
    sample_dir: str = "samples"
    log_dir: str = "logs"
    stage1_checkpoint: str = ""    # StackGAN Stage-II restores Stage-I G from here
    inception_checkpoint: str = ""  # converted dataset-finetuned InceptionV3
    # (.npz from scripts/convert_inception.py) for absolute-parity IS eval;
    # empty → autodetect <data_dir>/inception.npz, else finetune the
    # self-contained eval classifier (offline fallback)
    use_pallas: str = "auto"       # fused Pallas kernels: "auto" dispatches
    # per shape by measurement (BASELINE.md "Pallas vs XLA"), "on"/"off"
    # (or YAML true/false) force the kernel / lax path everywhere
    async_checkpoint: bool = False  # background (Orbax async) snapshots —
    # the device keeps stepping during saves; restore/close always wait
    remat: bool = False            # rematerialize the Stage-II generator
    # (jax.checkpoint): trades ~1 extra G forward for activation memory —
    # headroom for >256px stages; 256px fits v5e HBM without it

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def compute_key(self) -> "Config":
        """This config with every field that does NOT affect compiled
        programs normalized away (paths, host-pipeline knobs, logging
        intervals, mesh layout — meshes enter via input shardings, not
        tracing).  Used as the cache key by the jitted-program factories
        (train.steps, eval.sampler) so e.g. two runs differing only in
        checkpoint_dir share one compilation."""
        return self.replace(
            checkpoint_dir="", sample_dir="", log_dir="",
            stage1_checkpoint="", inception_checkpoint="",
            async_checkpoint=False,
            mesh=MeshConfig(),
            data=dataclasses.replace(
                self.data, dataset_name="", data_dir="", embedding_type="",
                caption_window=0, random_flip=False, random_crop=False,
                workers=0, prefetch=0, device_resident="",
                resident_budget_mb=0),
            train=dataclasses.replace(
                self.train, max_epoch=0, snapshot_interval=0,
                sample_interval=0, summary_interval=0),
        )

    def resident_key(self) -> "Config":
        """compute_key plus the sampling knobs that shape the
        device-resident step's compiled program (the on-device batch
        assembly traces caption_window and the crop/flip switches, which the
        feed path receives as data)."""
        k = self.compute_key()
        return k.replace(data=dataclasses.replace(
            k.data, caption_window=self.data.caption_window,
            random_crop=self.data.random_crop,
            random_flip=self.data.random_flip))


# --- Reference-key → dataclass-path mapping -------------------------------
# Reference YAMLs (StackGAN-style) use nested UPPERCASE keys; map them onto
# the dataclass tree so `load_config` accepts both conventions.
_REF_KEY_MAP: Dict[str, str] = {
    "DATASET_NAME": "data.dataset_name",
    "EMBEDDING_TYPE": "data.embedding_type",
    "DATA_DIR": "data.data_dir",
    "IMSIZE": "data.image_size",
    "IMAGE_SIZE": "data.image_size",
    "Z_DIM": "gan.z_dim",
    "EMBED_DIM": "gan.embed_dim",
    "COMPRESSED_EMBED_DIM": "gan.compressed_embed_dim",
    "GPU_ID": None,  # meaningless on TPU; accepted and ignored
    "CONFIG_NAME": None,
    "MODEL": "model",
    "GAN.GF_DIM": "gan.gf_dim",
    "GAN.DF_DIM": "gan.df_dim",
    "GAN.EMBEDDING_DIM": "gan.ca_dim",
    "GAN.CONDITION_DIM": "gan.ca_dim",
    "GAN.R_NUM": "gan.res_blocks",
    "GAN.NETWORK_TYPE": None,
    "TRAIN.BATCH_SIZE": "train.batch_size",
    "TRAIN.MAX_EPOCH": "train.max_epoch",
    "TRAIN.GENERATOR_LR": "train.generator_lr",
    "TRAIN.DISCRIMINATOR_LR": "train.discriminator_lr",
    "TRAIN.LR_DECAY_EPOCH": "train.lr_decay_epoch",
    "TRAIN.SNAPSHOT_INTERVAL": "train.snapshot_interval",
    "TRAIN.N_CRITIC": "train.n_critic",
    "TRAIN.FLAG": None,  # reference train/eval switch — ours is a CLI flag
    "TRAIN.PRETRAINED_MODEL": "stage1_checkpoint",
    "TRAIN.COEFF.KL": "train.coeff.kl",
    "TRAIN.COEFF.GP": "train.coeff.gp_lambda",
    "TRAIN.COEFF.ALPHA": "train.coeff.mismatch_alpha",
    "TRAIN.COEFF.INTERP": "train.coeff.interp_weight",
}


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def _dataclass_paths(cls, prefix: str = "") -> Dict[str, Any]:
    """Map of dotted path → field type for every leaf field of a config tree."""
    out: Dict[str, Any] = {}
    for f in fields(cls):
        path = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.default_factory, type) and dataclasses.is_dataclass(f.default_factory)
        ):
            out.update(_dataclass_paths(f.default_factory, path + "."))
        else:
            out[path] = f.type
    return out


_LEAF_PATHS = _dataclass_paths(Config)


def _set_path(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _build(cls, overrides: Dict[str, Any]):
    kwargs = {}
    for f in fields(cls):
        if f.name in overrides:
            v = overrides[f.name]
            if isinstance(v, dict):
                kwargs[f.name] = _build(f.default_factory, v)
            else:
                kwargs[f.name] = _coerce(v, f.type, f.name)
        elif dataclasses.is_dataclass(getattr(f, "default_factory", None)) or (
            isinstance(f.default_factory, type) and dataclasses.is_dataclass(f.default_factory)
        ):
            pass  # default_factory handles it
    return cls(**kwargs)


def _coerce(value: Any, typ: Any, name: str = "") -> Any:
    if typ in ("int", int) and isinstance(value, float) and value.is_integer():
        return int(value)
    if typ in ("float", float) and isinstance(value, int):
        return float(value)
    if typ in ("str", str) and isinstance(value, bool):
        # only the tri-state dispatch knob accepts YAML/CLI booleans; for any
        # other str field (paths, names) a bool is a user error — surface it
        if name == "use_pallas":
            return "on" if value else "off"
        raise ValueError(
            f"boolean value {value!r} for string-typed config field {name!r}")
    return value


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Build a Config from a (possibly reference-style) nested dict."""
    flat = _flatten(raw)
    tree: Dict[str, Any] = {}
    unknown = []
    for key, value in flat.items():
        if key in _REF_KEY_MAP:
            target = _REF_KEY_MAP[key]
            if target is None:
                continue
        elif key.lower() in _LEAF_PATHS:
            target = key.lower()
        elif key in _LEAF_PATHS:
            target = key
        else:
            unknown.append(key)
            continue
        _set_path(tree, target, value)
    if unknown:
        raise ValueError(
            f"Unknown config keys: {unknown}. Known reference keys: "
            f"{sorted(k for k in _REF_KEY_MAP)}; known native keys: {sorted(_LEAF_PATHS)}"
        )
    return _build(Config, tree)


def load_config(path: str, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """Load a YAML config file (reference-style or native keys)."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if overrides:
        raw = {**raw, **overrides}
    return config_from_dict(raw)
