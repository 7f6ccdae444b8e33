"""Entry points of the port (counterpart of the root ``__graft_entry__.py``).

* `entry` — the flagship forward: the GAN-CLS 64 px generator in train
  mode, then the matching-aware discriminator's logits over the real, fake
  and wrong streams, bf16, at the config's full widths (gf 128, df 64,
  z 100, embed 1024), params from seed 0, batch 16.  It returns
  ``(fn, args)`` as JAX's does; ``fn(*args)`` gives ``(fake, logits)``.
  JAX compiles ``fn`` as its check; the port has nothing to compile, so its
  check is one call on the card, synchronised, with the shapes and
  finiteness held (`check_entry`).
* `dryrun_multichip` — JAX's multi-device dry run: a (data, model) mesh of
  n ranks with model 2 when n is even and ≥ 4, plus a (slice 2, data,
  model) mesh when n ≥ 8 and n % 4 == 0; on each mesh one host-fed and one
  device-resident WGAN-CLS tick (GP, GAN-INT, n_critic 2, g_steps 1, β1 0,
  f32, tiny widths) with the batch sharded over (slice, data) and the
  ``stem`` and ``embed`` ``w`` column-sharded over ``model``
  (``parallel/tensor.py``).  Every rank asserts step 1 and finite metrics.
  JAX respawns itself on n virtual CPU devices; the port runs n processes
  of ``tools/dp_ticks.py`` over gloo (on the CPU, or sharing the cards:
  ``cuda:RANK % device_count``), killed at a deadline.

    python -m text_to_image_tpu_torch.entry [--device cpu]

runs `entry` once, then ``dryrun_multichip(max(8, device_count))``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from text_to_image_tpu_torch.config import Config, config_from_dict
from text_to_image_tpu_torch.models.registry import get_model
from text_to_image_tpu_torch.ops import layers as L

ENTRY_BATCH = 16
DRYRUN_TIMEOUT_S = 300


def entry_config() -> Config:
    """GAN-CLS 64 px bf16 at the config's default (full) widths."""
    return config_from_dict({"model": "gancls", "dtype": "bfloat16",
                             "data.dataset_name": "synthetic",
                             "data.image_size": 64})


def entry_fn(cfg: Config):
    """``fn(g_params, g_state, d_params, d_state, z, emb, real, wrong) →
    (fake, logits[3, B])``: the generator in train mode, then D over the
    stacked real, fake and wrong streams with the caption on each, as
    JAX's ``entry`` computes; no gradient."""
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)

    @torch.no_grad()
    def fn(g_params, g_state, d_params, d_state, z, emb, real, wrong):
        fake, _, _ = bundle.gen_apply(g_params, g_state, {}, z, emb, None,
                                      True, policy)
        xs = torch.stack([policy.cast(v) for v in (real, fake, wrong)])
        logits, _ = bundle.disc_streams(d_params, d_state, {}, xs,
                                        emb.expand(3, *emb.shape), True,
                                        policy)
        return fake, logits

    return fn


def entry_args(cfg: Config, device="cuda", batch: int = ENTRY_BATCH,
               seed: int = 0) -> tuple:
    """Both nets from `seed` and z, emb ~ N(0, 1), real, wrong ~ U[-1, 1)
    from a generator seeded with it, on `device`."""
    gen = torch.Generator().manual_seed(seed)
    res, gan = cfg.data.image_size, cfg.gan
    z = torch.randn(batch, gan.z_dim, generator=gen)
    emb = torch.randn(batch, gan.embed_dim, generator=gen)
    real, wrong = (torch.rand(batch, res, res, 3, generator=gen) * 2 - 1
                   for _ in range(2))
    nets = get_model(cfg).init(seed, device)
    return (*nets, *(t.to(device) for t in (z, emb, real, wrong)))


def entry(device="cuda"):
    """``(fn, args)`` of the flagship forward at batch 16 on `device`."""
    cfg = entry_config()
    return entry_fn(cfg), entry_args(cfg, device)


def check_entry(fn, args) -> tuple:
    """One call, synchronised; raises unless fake has the real images'
    shape [B, r, r, 3] and logits [3, B], both finite.  Returns (fake,
    logits)."""
    fake, logits = fn(*args)
    if fake.is_cuda:
        torch.cuda.synchronize(fake.device)
    real = args[6]
    if (fake.shape != real.shape
            or tuple(logits.shape) != (3, real.shape[0])):
        raise AssertionError(f"entry shapes {tuple(fake.shape)}, "
                             f"{tuple(logits.shape)}")
    if not (torch.isfinite(fake.float()).all()
            and torch.isfinite(logits.float()).all()):
        raise AssertionError("entry outputs not finite")
    return fake, logits


# --- the multi-device dry run ------------------------------------------------

def dryrun_meshes(n: int):
    """JAX's meshes over n devices, as `create_mesh` keywords."""
    model = 2 if (n % 2 == 0 and n >= 4) else 1
    meshes = [dict(data=n // model, model=model)]
    if n >= 8 and n % 4 == 0:
        meshes.append(dict(slices=2, data=n // (2 * model), model=model))
    return meshes


def dryrun_config(env, overrides: Optional[Dict] = None) -> Config:
    """JAX's dry-run config on `env`'s mesh: WGAN-CLS (the n_critic loop
    and the GP's double backward), tiny widths, batch 2·slice·data, 16 px,
    f32; `overrides` as ``{"train.generator_lr": 0.0}``."""
    return config_from_dict({
        "model": "wgancls", "gan.gf_dim": 8, "gan.df_dim": 8, "gan.z_dim": 8,
        "gan.embed_dim": 32, "gan.compressed_embed_dim": 16, "gan.ca_dim": 16,
        "train.batch_size": 2 * env.slice_size * env.data_size,
        "train.n_critic": 2, "train.g_steps": 1, "train.beta1": 0.0,
        "train.use_interpolation": True, "data.dataset_name": "synthetic",
        "data.image_size": 16, "mesh.data": env.data_size,
        "mesh.model": env.model_size, "mesh.slices": env.slice_size,
        "dtype": "float32", **(overrides or {})})


def dryrun_data(cfg: Config):
    """The host-fed tick's global batch, then the resident tick's split (24
    examples of 20 px, 3 captions each, 4 classes), drawn from one
    ``default_rng(0)`` as JAX's dry run draws them."""
    from text_to_image_tpu_torch.data.textdataset import TextDataset
    k, b = cfg.train.n_critic, cfg.train.batch_size
    r, e = cfg.data.image_size, cfg.gan.embed_dim
    rng = np.random.default_rng(0)
    batch = {"real": rng.uniform(-1, 1, (k, b, r, r, 3)).astype(np.float32),
             "wrong": rng.uniform(-1, 1, (k, b, r, r, 3)).astype(np.float32),
             "emb": rng.normal(size=(k, b, e)).astype(np.float32)}
    n_ex, src = 24, 20
    imgs = rng.integers(0, 256, (n_ex, src, src, 3), dtype=np.uint8)
    embs = rng.normal(size=(n_ex, 3, e)).astype(np.float32)
    cls = (np.arange(n_ex) % 4).astype(np.int32)
    return batch, TextDataset.from_arrays(imgs, embs, cls, image_size=r)


def _finite(metrics: Dict[str, torch.Tensor], what: str) -> Dict[str, float]:
    host = {k: float(v) for k, v in metrics.items()}
    bad = [k for k, v in host.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"{what}{bad} not finite")
    return host


def dryrun_spec(cfg: Config, record_grads: bool = False) -> Dict:
    """A ``tools/dp_ticks`` spec of the host-fed tick: `cfg`, the global
    batch of `dryrun_data`, ``stem`` and ``embed`` column-sharded."""
    batch, _ = dryrun_data(cfg)
    return {"cfg": dataclasses.asdict(cfg), "steps_per_epoch": 10,
            "batches": [{k: torch.from_numpy(v) for k, v in batch.items()}],
            "shard_columns": True, "record_grads": record_grads}


def _dryrun_on_mesh(env, device="cuda", overrides: Optional[Dict] = None,
                    record_grads: bool = False) -> Dict:
    """One host-fed and one resident tick of `dryrun_config` on this rank
    of `env` (its batch group's rows; ``stem`` and ``embed`` column-sharded
    over its model group), each asserted at step 1 with finite metrics.
    Returns the host-fed tick's metrics, its state (params gathered), this
    rank's slices, the resident tick's metrics, the launches of each
    kernel over both ticks and JAX's "dryrun_multichip OK" line; with
    `record_grads` also the gradients each update handed Adam."""
    from text_to_image_tpu_torch.data import device as DD
    from text_to_image_tpu_torch.tools import dp_ticks
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     make_resident_step,
                                                     shard_state)
    cfg = dryrun_config(env, overrides)
    device = torch.device(device)
    spec = dryrun_spec(cfg, record_grads)
    out = dp_ticks.run(spec, device, env)      # counts its tick's launches
    launches = dict(out["launches"][0])
    if out["state"]["step"] != 1:
        raise AssertionError(f"step {out['state']['step']} after one tick")
    metrics = _finite(out["metrics"][0], "")

    data = DD.stage(dryrun_data(cfg)[1], device)
    rstep = make_resident_step(cfg, 10, device, env)
    rts = shard_state(init_train_state(1, cfg, 10, device), env)
    before = dp_ticks.counters()
    rts, rmetrics = rstep(rts, data)
    for k, n in dp_ticks.counted_since(before).items():
        launches[k] = launches.get(k, 0) + n
    if rts.step != 1:
        raise AssertionError(f"resident step {rts.step} after one tick")
    rmetrics = _finite(rmetrics, "resident ")
    axes = f"slice={env.slice_size} " if env.slice_size > 1 else ""
    line = (f"dryrun_multichip OK: mesh {axes}data={env.data_size} "
            f"model={env.model_size}, "
            f"metrics={ {k: round(v, 4) for k, v in metrics.items()} }, "
            f"resident metrics={ {k: round(v, 4) for k, v in rmetrics.items()} }")
    print(line, flush=True)
    return {**out, "metrics": metrics, "resident_metrics": rmetrics,
            "launches": launches, "line": line}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = DRYRUN_TIMEOUT_S) -> list:
    """`_dryrun_on_mesh` on each of JAX's meshes over `n_devices` gloo
    ranks (`tools.dp_ticks.launch`: one process a rank, on the CPU or on
    card RANK % device_count; all killed when one fails or `timeout_s`
    passes).  Prints rank 0's OK line of each mesh; returns every rank's
    outcomes (rank-major, one per mesh)."""
    from text_to_image_tpu_torch.tools import dp_ticks
    if torch.device(device).type == "cuda":
        from text_to_image_tpu_torch.ops.kernels import _build
        _build.build(_build.sources())     # once, before the ranks load them
    spec = {"world": n_devices, "backend": "gloo", "device": str(device),
            "dryrun": [{"mesh": m} for m in dryrun_meshes(n_devices)]}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        outs = dp_ticks.launch(spec, work, timeout_s)
    for mesh in outs[0]["dryrun"]:
        print(mesh["line"])
    return outs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions and "
                        "the dry run's ranks on the CPU")
    args = p.parse_args(argv)
    fn, fargs = entry(args.device)
    fake, logits = check_entry(fn, fargs)
    print(f"entry(): fake {tuple(fake.shape)} {fake.dtype}, logits "
          f"{tuple(logits.shape)}, finite")
    cards = torch.cuda.device_count() if args.device != "cpu" else 0
    dryrun_multichip(max(8, cards), args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
