"""The port's training loop against the JAX package's on the CPU: the data
tier `auto` picks, the steps at which grids, snapshots and the eval hook
fire, a resumed run bit-identical to an uninterrupted one, and the metric
files (JSON lines and TensorBoard events) as the JAX writer writes them."""

import dataclasses
import glob
import io
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.helpers import tiny_config
from tests.test_torch_checkpoint import assert_same
from text_to_image_tpu.train.trainer import Trainer as JTrainer
from text_to_image_tpu.utils import metrics as jmetrics
from text_to_image_tpu.utils import tensorboard as jtb
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.train.trainer import Trainer
from text_to_image_tpu_torch.utils import metrics as pmetrics
from text_to_image_tpu_torch.utils import tensorboard as ptb


def run_cfg(tmp_path, model="gancls", **train):
    """A tiny port config whose checkpoints, logs and grids go under
    `tmp_path`."""
    jcfg = tiny_config(model, **train)
    return config_from_dict(dataclasses.asdict(jcfg.replace(
        checkpoint_dir=str(tmp_path / "ck"), log_dir=str(tmp_path / "logs"),
        sample_dir=str(tmp_path / "samples"))))


class _Arrays:
    """A dataset with in-memory arrays, or without (``stageable=False``)."""

    def __init__(self, stageable=True, mb=1):
        if stageable:
            self.images = np.zeros((mb * 2**20 // (76 * 76 * 3), 76, 76, 3),
                                   np.uint8)
            self.embeddings = np.zeros((len(self.images), 1, 1), np.float32)
            self.class_ids = np.arange(len(self.images)) % 2


@pytest.mark.parametrize("mode,stageable,mb,budget", [
    ("auto", True, 1, 4096), ("auto", True, 8, 4), ("auto", True, 4, 4),
    ("auto", False, 1, 4096), ("on", True, 8, 4), ("off", True, 1, 4096),
    ("on", False, 1, 4096)])
def test_resident_tier_is_jax_rule(mode, stageable, mb, budget):
    """`_resident_tier` against the JAX trainer's on one device, over
    `auto`, `on` and `off`, datasets with and without arrays, in and over
    the budget."""
    ds = _Arrays(stageable, mb)
    out = []
    for cls, cfg in ((JTrainer, tiny_config()),
                     (Trainer, config_from_dict(dataclasses.asdict(
                         tiny_config())))):
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, device_resident=mode, resident_budget_mb=budget))
        self = types.SimpleNamespace(
            cfg=cfg, dataset=ds, env=types.SimpleNamespace(slice_size=1,
                                                           data_size=1))
        try:
            out.append(cls._resident_tier(self))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def test_sharded_tier_names_its_roadmap_item():
    """The sharded tier is ported (it raised, naming ROADMAP item 9, until
    the data-parallel slice): on one device it is chosen on request, as the
    JAX trainer chooses it."""
    one = types.SimpleNamespace(slice_size=1, data_size=1)
    picks = []
    for cls, cfg in ((JTrainer, tiny_config()),
                     (Trainer, config_from_dict(dataclasses.asdict(
                         tiny_config())))):
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   device_resident="sharded"))
        picks.append(cls._resident_tier(types.SimpleNamespace(
            cfg=cfg, dataset=_Arrays(), env=one)))
    assert picks == ["sharded", "sharded"]


def stand_in(cls, cfg, start, log):
    """A `cls` whose `train` runs as written while its tick only counts
    and its grids and snapshots are logged (both loops read the same
    attributes)."""
    t = cls.__new__(cls)

    def tick(ts, feed):
        ts.step += 1
        return ts, {"d_loss": jnp.zeros(()) if cls is JTrainer
                    else torch.zeros(())}

    t.cfg, t.ts = cfg, types.SimpleNamespace(step=start)
    t.steps_per_epoch = 5
    t.device_data, t.pipeline = "resident", None
    t.step_fn = tick
    t.meter = pmetrics.ThroughputMeter(1)
    t.metrics = types.SimpleNamespace(write=lambda *a: None)
    t.history, t._summaries, t._hbm = [], 0, {}
    t.device = torch.device("cpu")
    t.save_samples = lambda step: log.append(("grid", step))
    t.save_checkpoint = lambda: log.append(("snapshot", t.ts.step))
    return t


@pytest.mark.parametrize("start,total", [(0, 7), (3, 10), (4, 4)])
def test_grids_snapshots_and_eval_fire_at_jax_steps(start, total):
    runs = []
    for cls, cfg in ((JTrainer, tiny_config()),
                     (Trainer, config_from_dict(dataclasses.asdict(
                         tiny_config())))):
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, summary_interval=2, sample_interval=3,
            snapshot_interval=2))
        log = []
        stand_in(cls, cfg, start, log).train(
            num_steps=total, eval_interval=4,
            eval_fn=lambda tr, step, log=log: log.append(("eval", step)))
        runs.append(log)
    assert runs[0] == runs[1]
    assert runs[1][-1] == ("snapshot", total)


def test_resumed_run_is_bit_identical(tmp_path):
    """4 f32 ticks in one run, and 2 ticks, a new Trainer restoring the
    step-2 snapshot, 2 more: the same state, bit for bit (params, BN
    states, Adam counts and moments, EMA, step); the resident tier's
    batches come from (seed, step), so the resumed run sees the same data."""
    def cfg_at(d):
        cfg = run_cfg(tmp_path / d, ema_decay=0.9, n_critic=2)
        return cfg.replace(train=dataclasses.replace(
            cfg.train, snapshot_interval=2, summary_interval=1))
    straight = Trainer(cfg_at("a"), device="cpu")
    assert straight.device_data is not None
    straight.train(num_steps=4)
    straight.close()
    first = Trainer(cfg_at("b"), device="cpu")
    first.train(num_steps=2)
    first.close()
    resumed = Trainer(cfg_at("b"), device="cpu")
    assert resumed.ts.step == 2
    resumed.train(num_steps=4)
    resumed.close()
    assert_same(resumed.ts, straight.ts)
    assert [h["d_loss"] for h in resumed.history] == [
        h["d_loss"] for h in straight.history[2:]]
    assert sorted(os.listdir(resumed.ckpt.directory)) == ["step_2.pt",
                                                          "step_4.pt"]


def test_cli_run_writes_grids_metrics_and_snapshots(tmp_path):
    """`main.py --train` on CPU: checkpoints at the snapshot steps and the
    end, a PNG grid at each sample step (the port's encoder, read by PIL),
    a JSON line a summary, TensorBoard events that JAX's reader reads; the
    second call continues from the last checkpoint."""
    from text_to_image_tpu_torch import main
    cfg = run_cfg(tmp_path)
    sets = ["--set", "data.dataset_name=synthetic", "data.image_size=16",
            "gan.gf_dim=8", "gan.df_dim=8", "gan.z_dim=8", "gan.embed_dim=32",
            "gan.compressed_embed_dim=16", "train.batch_size=8",
            "dtype=float32", "train.snapshot_interval=2",
            "train.sample_interval=3", "train.summary_interval=1",
            f"checkpoint_dir={cfg.checkpoint_dir}", f"log_dir={cfg.log_dir}",
            f"sample_dir={cfg.sample_dir}"]
    argv = ["--cfg", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "gancls_flowers.yml"),
        "--device", "cpu", "--train"]
    t = main.main(argv + ["--steps", "5"] + sets)
    run = "gancls/synthetic"
    assert sorted(os.listdir(os.path.join(cfg.checkpoint_dir, run))) == [
        "step_2.pt", "step_4.pt", "step_5.pt"]
    grid = os.path.join(cfg.sample_dir, run, "train_00000003.png")
    assert sorted(os.listdir(os.path.join(cfg.sample_dir, run))) == [
        "train_00000003.png"]
    assert np.asarray(Image.open(grid)).shape == (2 * 16, 4 * 16, 3)
    with open(os.path.join(cfg.log_dir, run, "train.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(r["g_loss"]) for r in recs)
    assert t.history[-1]["step"] == 5
    (events,) = glob.glob(os.path.join(cfg.log_dir, run, "events.out.*"))
    read = jtb.read_events(events)
    assert sorted({e["step"] for e in read if "g_loss" in e["scalars"]}) == [
        1, 2, 3, 4, 5]
    (png,) = [e["images"]["samples"] for e in read if e["images"]]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  np.asarray(Image.open(grid)))
    t2 = main.main(argv + ["--steps", "6"] + sets)
    assert t2.ts.step == 6 and [h["step"] for h in t2.history] == [6]


def test_metric_files_equal_jax_writer(tmp_path):
    """Same records: the same JSON lines; same scalars at a fixed wall
    time: the same event-file bytes; an image event decodes to the same
    pixels (the PNG encoders differ: the port's is zlib, JAX's PIL)."""
    recs = [(1, {"g_loss": 1.25, "d_loss": 0.5, "epoch": 0}),
            (2, {"g_loss": float("1e-7"), "images_per_sec": 123.456,
                 "note": "text"})]
    paths = []
    for mod, name in ((jmetrics, "jax"), (pmetrics, "port")):
        mw = mod.MetricWriter(str(tmp_path / name), also_print=False,
                              tensorboard=False)
        for step, m in recs:
            mw.write(step, m)
        mw.close()
        paths.append(tmp_path / name / "train.jsonl")
    assert paths[0].read_bytes() == paths[1].read_bytes()

    img = np.random.default_rng(0).integers(0, 256, (6, 10, 3), np.uint8)
    files = []
    for mod, name in ((jtb, "jtb"), (ptb, "ptb")):
        w = mod.TBEventWriter(str(tmp_path / name), wall_time=1700000000.5)
        w.add_scalar("g_loss", 0.75, 3, wall_time=1700000001.25)
        w.add_scalar("d_loss", -2.0, 2**40, wall_time=1700000002.0)
        w.close()
        files.append(w.path)
    assert os.path.basename(files[0]) == os.path.basename(files[1])
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    w = ptb.TBEventWriter(str(tmp_path / "img"), wall_time=1.0)
    w.add_image("grid", img, 4, wall_time=2.0)
    w.close()
    ev = jtb.read_events(w.path)
    assert ev[1]["step"] == 4
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(ev[1]["images"]["grid"]))), img)
    assert ptb.read_events(w.path)[1]["images"]["grid"] == ev[1]["images"][
        "grid"]


def test_hbm_stats_and_meter_off_the_card():
    assert pmetrics.hbm_stats("cpu") == {} and pmetrics.hbm_stats() == {}
    m = pmetrics.ThroughputMeter(8)
    assert m.tick() is None
    assert m.tick() > 0
