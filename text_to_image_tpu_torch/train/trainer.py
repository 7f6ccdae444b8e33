"""Host training loop (counterpart of ``text_to_image_tpu/train/trainer.py``):
one tick per step, fed by the device-resident tier (the split staged on the
card, each tick's batch drawn there from (seed, step): ``data/device.py``)
or by the host tier (``data/pipeline.py``), as `Trainer._resident_tier`
chooses by the JAX package's rule; metrics every ``summary_interval`` steps
and after the last one (each read is also the NaN guard) to JSON lines,
TensorBoard and ``[step N]`` lines; sample grids every ``sample_interval``
steps; a checkpoint every ``snapshot_interval`` steps and at the end; the
latest checkpoint restored on start.  ``stackgan_stage2`` takes its frozen
Stage-I generator from a Stage-I run directory or an ``.npz``
(`stage1_source`), or draws it from the seed when ``stage1_checkpoint`` is
empty.  `train_progressive` runs the whole C-PGGAN progression, one
`Trainer` a stage, linked by the checkpoint each stage leaves.

Data parallel (a process group, ``parallel/mesh.py``): the mesh comes from
``cfg.mesh``; each rank runs the tick on its rows of the global batch
(``train/steps.py``); the tier rule takes D = slice·data as the JAX
trainer's does, the sharded resident tier included; rank 0 alone writes
checkpoints, metrics, TensorBoard and grids, with a barrier after each
save; every rank restores the same checkpoint and then checks that the
ranks' parameters agree (a checksum).  A group of one rank has no batch
group, so it runs the one-process tick.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import Config
from text_to_image_tpu_torch.data import TextDataset, get_dataset
from text_to_image_tpu_torch.data import device as device_data
from text_to_image_tpu_torch.data import native
from text_to_image_tpu_torch.data.pipeline import InputPipeline
from text_to_image_tpu_torch.eval.sampler import make_generator_fn, sample_grid
from text_to_image_tpu_torch.models import pggan as PG
from text_to_image_tpu_torch.parallel import mesh
from text_to_image_tpu_torch.parallel.mesh import MeshEnv, create_mesh
from text_to_image_tpu_torch.train import checkpoint as ckpt
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_resident_step,
                                                 make_train_step)
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.utils import prng
from text_to_image_tpu_torch.utils.images import (inverse_transform, merge,
                                                  save_images)
from text_to_image_tpu_torch.utils.metrics import (MetricWriter,
                                                   ThroughputMeter, hbm_stats)



class _Silent:
    """The metric writer of every rank but 0: it writes nothing."""

    def write(self, step, metrics) -> None:
        pass

    def write_image(self, step, tag, image) -> None:
        pass

    def close(self) -> None:
        pass


def run_dir(cfg: Config, root: str) -> str:
    """``<root>/<model>/<dataset>``: where a run's checkpoints, logs and
    grids go."""
    return os.path.join(root, cfg.model, cfg.data.dataset_name)


def stage1_source(cfg: Config) -> str:
    """Where Stage-II's frozen Stage-I comes from: ``stage1_checkpoint``
    when it names an ``.npz`` or a directory, else (for a path that does
    not exist, as the shipped YAML's before a Stage-I run) the Stage-I run
    directory ``<checkpoint_dir>/stackgan_stage1/<dataset>``, as the JAX
    trainer resolves it; empty (draw from the seed) when it is empty."""
    path = cfg.stage1_checkpoint
    if not path or path.endswith(".npz") or os.path.isdir(path):
        return path
    return os.path.join(cfg.checkpoint_dir, "stackgan_stage1",
                        cfg.data.dataset_name)


class Trainer:
    def __init__(self, cfg: Config, dataset=None, device="cuda",
                 restore: bool = True, env: Optional[MeshEnv] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.env = env or create_mesh(data=cfg.mesh.data,
                                      model=cfg.mesh.model,
                                      slices=cfg.mesh.slices)
        main = self.env.is_main
        self.dataset = dataset if dataset is not None else get_dataset(cfg)
        self.steps_per_epoch = max(
            1, self.dataset.num_examples // cfg.train.batch_size)
        stage1 = None
        if cfg.model == "stackgan_stage2":
            stage1 = convert.load_stage1_generator(stage1_source(cfg), device)
        ts = init_train_state(cfg.seed, cfg, self.steps_per_epoch, device,
                              stage1=stage1)
        self.ckpt = ckpt.CheckpointManager(run_dir(cfg, cfg.checkpoint_dir),
                                           async_save=cfg.async_checkpoint)
        if restore:
            ts, restored = self.ckpt.restore(ts)
            if restored is not None and main:
                print(f"restored checkpoint at step {restored} from "
                      f"{self.ckpt.directory}")
        mesh.check_replicated(self.env, [t for _, t in flatten(ts.g_params)]
                              + [t for _, t in flatten(ts.d_params)],
                              "the parameters")
        self.ts = ts

        self.device_data = None
        self.pipeline = None
        env, spe = self.env, self.steps_per_epoch
        dp = env.batch_group is not None
        tier = self._resident_tier()
        if tier == "sharded":
            self.device_data = device_data.stage_sharded(
                self.dataset, env.shard_index, env.shards, cfg.seed, device)
            self.step_fn = make_resident_step(cfg, spe, device, env)
            path = (f"sharded (shard {env.shard_index} of {env.shards} on "
                    f"{self.device}; each rank draws its rows of a tick's "
                    f"batch from its own shard)")
        elif tier == "replicated":
            self.device_data = device_data.stage(self.dataset, device)
            self.step_fn = make_resident_step(cfg, spe, device, env)
            mib = device_data.nbytes(self.dataset) / 2**20
            path = (f"replicated (the split on {self.device}, {mib:.1f} MiB; "
                    f"each tick's batch drawn and gathered there)")
        else:
            self.step_fn = make_train_step(cfg, spe, device, env)
            self.pipeline = InputPipeline(
                self.dataset, cfg.train.batch_size, device,
                window=cfg.data.caption_window,
                batches_per_step=cfg.train.n_critic,
                prefetch=cfg.data.prefetch,
                rows=env.rows(cfg.train.batch_size) if dp else None)
            helpers = ("native C++" if isinstance(self.dataset, TextDataset)
                       and native.available() else "numpy")
            path = (f"host-pipeline ({helpers} batch assembly, one worker "
                    f"thread)")
        if main:
            print(f"data path: {path}"
                  + (f"; data parallel over {env.shards} ranks "
                     f"(mesh {env.slice_size}x{env.data_size}x"
                     f"{env.model_size})" if dp else ""))
        self.metrics = (MetricWriter(run_dir(cfg, cfg.log_dir)) if main
                        else _Silent())
        # the global batch: the tick's images on every rank together
        self.meter = ThroughputMeter(
            cfg.train.batch_size * cfg.train.n_critic)
        self.history: list = []
        self._summaries = 0
        self._hbm: Dict[str, float] = {}

        # fixed inputs, so that the grids of a run are comparable
        self._gen = make_generator_fn(cfg, device=device)
        self._sample_emb = np.asarray(self.dataset.test_embeddings(
            min(64, cfg.train.batch_size)), np.float32)
        self._sample_key = prng.fold_in(cfg.seed, 2**30)

    def _resident_tier(self) -> Optional[str]:
        """'replicated' (the split staged on every card), 'sharded' (the
        examples spread over the D = slice·data batch-axis ranks) or None
        (host pipeline), by the JAX trainer's rule: ``off`` → None; ``on``
        → replicated; ``sharded`` → sharded (B divisible by D); ``auto`` →
        replicated when the dataset exposes images, embeddings and
        class_ids and fits ``resident_budget_mb``, else sharded when it
        fits D budgets and D divides B."""
        mode = self.cfg.data.device_resident
        if mode == "off":
            return None
        ds = self.dataset
        stageable = all(hasattr(ds, a)
                        for a in ("images", "embeddings", "class_ids"))
        d = self.env.slice_size * self.env.data_size
        if mode in ("on", "sharded"):
            if not stageable:
                raise ValueError(
                    f"device_resident={mode} but the dataset does not "
                    "expose in-memory images/embeddings/class_ids arrays")
            if mode == "sharded" and self.cfg.train.batch_size % d:
                raise ValueError(
                    f"device_resident=sharded needs batch_size divisible "
                    f"by the {d} batch-axis devices")
            return "sharded" if mode == "sharded" else "replicated"
        if not stageable:
            return None
        budget = self.cfg.data.resident_budget_mb * 2**20
        size = device_data.nbytes(ds)
        if size <= budget:
            return "replicated"
        if (d > 1 and size <= d * budget
                and self.cfg.train.batch_size % d == 0):
            return "sharded"
        return None

    def train(self, num_steps: Optional[int] = None, eval_fn=None,
              eval_interval: int = 0) -> None:
        """Run to ``num_steps`` (absolute; default max_epoch epochs).
        ``eval_fn(trainer, step)`` is called every ``eval_interval`` steps
        (never at step 0)."""
        tcfg = self.cfg.train
        total = (num_steps if num_steps is not None
                 else tcfg.max_epoch * self.steps_per_epoch)
        for i in range(self.ts.step, total):
            feed = (self.device_data if self.device_data is not None
                    else next(self.pipeline))
            self.ts, metrics = self.step_fn(self.ts, feed)
            ips = self.meter.tick()
            if (i + 1) % tcfg.summary_interval == 0 or i + 1 == total:
                self.summary(i + 1, metrics, ips)
            if (i + 1) % tcfg.sample_interval == 0:
                self.save_samples(i + 1)
            if (i + 1) % tcfg.snapshot_interval == 0:
                self.save_checkpoint()
            if eval_fn is not None and eval_interval > 0 \
                    and (i + 1) % eval_interval == 0:
                eval_fn(self, i + 1)
        self.save_checkpoint()
        if self.pipeline is not None:
            self.pipeline.close()

    def summary(self, step: int, metrics: Dict[str, torch.Tensor],
                ips: Optional[float]) -> Dict[str, float]:
        """Read the metrics (one device→host copy), stop on a non-finite
        one, and write them (JSON line, TensorBoard, ``[step N]``)."""
        names = sorted(metrics)
        vals = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
        host = dict(zip(names, vals))
        bad = [k for k, v in host.items() if not np.isfinite(v)]
        if bad:
            self.metrics.write(step, host)
            raise FloatingPointError(
                f"non-finite metrics {bad} at step {step}: diverged; restart "
                f"from the last checkpoint (consider a lower lr or another "
                f"n_critic)")
        if ips is not None:
            host["images_per_sec"] = ips
        host["epoch"] = (step - 1) // self.steps_per_epoch
        self._summaries += 1
        if self._summaries % 10 == 1:   # an allocator query: sparsely
            self._hbm = hbm_stats(self.device)
        host.update(self._hbm)
        self.metrics.write(step, host)
        self.history.append({"step": step, **host})
        return host

    def save_samples(self, step: int) -> Optional[str]:
        """The fixed-z grid of this step: a PNG under ``sample_dir`` and an
        image summary (rank 0 alone; its BN takes no collective)."""
        if not self.env.is_main:
            return None
        imgs = sample_grid(self._gen, self.ts, self.cfg, self._sample_emb,
                           generator=prng.generator(self._sample_key))
        out = save_images(imgs, os.path.join(
            run_dir(self.cfg, self.cfg.sample_dir), f"train_{step:08d}.png"))
        self.metrics.write_image(step, "samples",
                                 merge(inverse_transform(imgs)))
        return out

    def save_checkpoint(self) -> None:
        """Rank 0 snapshots the state; every rank waits for it."""
        if self.env.is_main:
            self.ckpt.save(self.ts.step, self.ts)
        self._barrier()

    def _barrier(self) -> None:
        if self.env.live and self.env.world > 1:
            dist.barrier()

    def close(self) -> None:
        if self.pipeline is not None:
            self.pipeline.close()
        self.metrics.close()
        self.ckpt.close()
        self._barrier()    # rank 0's files written before any rank reads


def train_progressive(cfg: Config, total_steps: Optional[int] = None,
                      device="cuda", env: Optional[MeshEnv] = None
                      ) -> List[Trainer]:
    """The C-PGGAN progression: one `Trainer` a stage (``pggan.stage``,
    ``steps_per_stage`` and ``start_step`` replaced), each restoring the
    checkpoint the stage before it left; the parameter trees are full-depth
    from init, so every stage takes the same state.  Stage s runs from
    global step (s − 1)·per_stage to s·per_stage, per_stage =
    ``total_steps // n_stages`` (at least 1) or ``steps_per_stage``; α
    ramps over the first ``fade_fraction`` of it.  Stages that the latest
    checkpoint already covers are skipped.  Returns the stages' trainers
    (closed).  Data parallel as `Trainer` (one mesh for every stage)."""
    env = env or create_mesh(data=cfg.mesh.data, model=cfg.mesh.model,
                             slices=cfg.mesh.slices)
    n = PG.num_stages(cfg.data.image_size)
    per_stage = (max(1, total_steps // n) if total_steps is not None
                 else cfg.pggan.steps_per_stage)
    mgr = ckpt.CheckpointManager(run_dir(cfg, cfg.checkpoint_dir))
    done = mgr.latest_step() or 0
    mgr.close()
    first = min(done // per_stage + 1, n)
    if first > 1 and env.is_main:
        print(f"[pggan] checkpoint at step {done} covers stages "
              f"1..{first - 1}: resuming at stage {first}/{n}")
    trainers = []
    for stage in range(first, n + 1):
        sub = dataclasses.replace(cfg, pggan=dataclasses.replace(
            cfg.pggan, stage=stage, steps_per_stage=per_stage,
            start_step=(stage - 1) * per_stage))
        if env.is_main:
            print(f"[pggan] stage {stage}/{n} ({PG.stage_resolution(stage)} "
                  f"px, steps {(stage - 1) * per_stage}→{stage * per_stage})")
        trainer = Trainer(sub, device=device, env=env)
        try:
            trainer.train(num_steps=stage * per_stage)
        finally:
            trainer.close()
        trainers.append(trainer)
    return trainers
