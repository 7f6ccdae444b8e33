"""Benchmark of the port (counterpart of the root ``bench.py``): the
north-star metric, images/s per card of GAN-CLS 64 px training, on one
card.

    python -m text_to_image_tpu_torch.bench [--device cpu]
        [--measure-steps N] [--set key=value ...]

The workload is the root's: GAN-CLS 64 px at gf 128, df 64, z 100,
embed 1024, batch 64, bf16, g_steps 2 (one D update and two G updates a
tick), weights from seed 0.  Each throughput takes 3 warm-up ticks, then
the median of 3 windows of ``MEASURE_STEPS`` ticks (50 for the host
pipeline, as the root takes), each window timed on the host clock and
ended by a ``.item()`` of the last tick's ``g_loss`` (of one pixel for
sampling).  It prints ONE JSON line with the root's keys:

* ``value`` — one staged batch on the card stepped repeatedly
  (`train.steps.make_train_step`);
* ``resident_value`` — the device-resident tier: a 512-example 76 px split
  (made as the root makes it) staged once (`data.device.stage`), every
  tick's batch drawn and gathered on the card (`make_resident_step`);
* ``sharded_resident_value`` — the sharded tier over the same split
  (`data.device.stage_sharded`, shard 0 of 1): at one card its difference
  from ``resident_value`` is the tier's overhead;
* ``pipeline_value`` — the host tier (`data.pipeline.InputPipeline`, one
  worker thread, pinned copies) feeding `make_train_step`;
* ``sampling_value`` — the serving path: the generator with eval-mode BN
  folded into its kernels (``gen_apply_inference``, weights cast once);
* ``vs_baseline`` — ``value`` over the larger of ``BASELINE_MEASURED.json``'s
  images/s and 25 img/s (the root's rule), with ``baseline_img_per_sec``
  and ``baseline_source``.

One process runs on one card; it divides by no card count.  Under
``torchrun`` each rank would be a card and the figures per card, as the
root divides by its chips.

Deviation from the root, by design: nothing is caught.  The root writes a
``"failed: …"`` string where a measurement raised; here a measurement that
fails raises, and the script exits non-zero, so no broken path hides
behind a number.  ``--measure-steps`` and ``--set`` (``main.py``'s
overrides) exist so that a CPU test can run it at tiny widths; everything
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from text_to_image_tpu_torch.config import Config, config_from_dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the root's estimate of a multi-core TF1-era CPU desktop, img/s: the floor
# under the measured one-thread proxy
TF1_CPU_BASELINE_IMG_PER_SEC = 25.0
WARMUP_STEPS = 3
MEASURE_STEPS = 100
WINDOWS = 3
SPLIT_EXAMPLES, SPLIT_CLASSES, SPLIT_SIZE = 512, 16, 76


def bench_config(overrides: Optional[Dict] = None) -> Config:
    """The root bench's workload, with `overrides` (dotted keys)."""
    return config_from_dict({"model": "gancls", "dtype": "bfloat16",
                             "data.dataset_name": "synthetic",
                             "data.image_size": 64, "train.batch_size": 64,
                             "train.g_steps": 2, **(overrides or {})})


def baseline() -> tuple:
    """(img/s, source): the larger of the measured torch-CPU proxy of
    ``BASELINE_MEASURED.json`` and the 25 img/s estimate."""
    path = os.path.join(ROOT, "BASELINE_MEASURED.json")
    measured = 0.0
    if os.path.exists(path):
        with open(path) as f:
            measured = float(json.load(f)["images_per_sec"])
    if measured >= TF1_CPU_BASELINE_IMG_PER_SEC:
        return measured, "measured torch-CPU proxy"
    return (TF1_CPU_BASELINE_IMG_PER_SEC,
            f"25 img/s multi-core TF1-era estimate "
            f"(measured 1-thread proxy: {measured or 'n/a'})")


def measure(run: Callable[[], torch.Tensor], batch: int, steps: int,
            windows: int = WINDOWS, warmup: int = WARMUP_STEPS) -> float:
    """Median images/s over `windows` windows of `steps` calls of `run`
    (each returns a tensor of the call; the window ends in its
    ``.item()``), after `warmup` calls."""
    for _ in range(warmup):
        last = run()
    last.item()
    rates: List[float] = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            last = run()
        last.item()
        rates.append(steps * batch / (time.perf_counter() - t0))
    return statistics.median(rates)


def bench_split(cfg: Config, rng: np.random.Generator):
    """The root's 512-example 76 px split: 16 classes, 5 captions each
    around its class's centre."""
    from text_to_image_tpu_torch.data.textdataset import TextDataset
    e = cfg.gan.embed_dim
    cls = rng.integers(0, SPLIT_CLASSES, SPLIT_EXAMPLES)
    cent = rng.normal(size=(SPLIT_CLASSES, e)).astype(np.float32)
    embs = (cent[cls][:, None, :] + 0.1 * rng.normal(
        size=(SPLIT_EXAMPLES, 5, e))).astype(np.float32)
    imgs = rng.integers(0, 256, (SPLIT_EXAMPLES, SPLIT_SIZE, SPLIT_SIZE, 3),
                        dtype=np.uint8)
    return TextDataset.from_arrays(imgs, embs, cls,
                                   image_size=cfg.data.image_size)


def run_bench(cfg: Config, device="cuda", steps: int = MEASURE_STEPS
              ) -> Dict:
    """Every throughput of the module docstring on `device`; the JSON
    object the script prints."""
    from text_to_image_tpu_torch.data import device as DD
    from text_to_image_tpu_torch.data.pipeline import InputPipeline
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     make_resident_step,
                                                     make_train_step)
    device = torch.device(device)
    b, k = cfg.train.batch_size, cfg.train.n_critic
    res, spe = cfg.data.image_size, 100
    rng = np.random.default_rng(0)
    host = {"real": rng.integers(0, 256, (k, b, res, res, 3), dtype=np.uint8),
            "wrong": rng.integers(0, 256, (k, b, res, res, 3),
                                  dtype=np.uint8),
            "emb": rng.normal(size=(k, b, cfg.gan.embed_dim)
                              ).astype(np.float32)}

    def ticks(step, feed, seed):
        """One tick's ``g_loss`` a call, from a state drawn from `seed`."""
        state = [init_train_state(seed, cfg, spe, device)]

        def run():
            state[0], metrics = step(state[0], feed())
            return metrics["g_loss"]
        return run

    staged = {key: torch.from_numpy(v).to(device) for key, v in host.items()}
    step = make_train_step(cfg, spe, device)
    out = {"value": measure(ticks(step, lambda: staged, 0), b, steps)}

    ds = bench_split(cfg, rng)
    data = DD.stage(ds, device)
    out["resident_value"] = measure(
        ticks(make_resident_step(cfg, spe, device), lambda: data, 1), b,
        steps)
    sharded = DD.stage_sharded(ds, 0, 1, cfg.seed, device)
    out["sharded_resident_value"] = measure(
        ticks(make_resident_step(cfg, spe, device), lambda: sharded, 2), b,
        steps)
    del data, sharded

    pipe = InputPipeline(ds, b, device, window=cfg.data.caption_window,
                         batches_per_step=k, prefetch=4)
    try:
        out["pipeline_value"] = measure(
            ticks(step, lambda: next(pipe), 0), b, max(1, steps // 2))
    finally:
        pipe.close()

    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    g_params, g_state = bundle.init(cfg.seed, device)[:2]
    g_params = L.cast_weights(g_params, policy)
    z = torch.from_numpy(rng.normal(size=(b, cfg.gan.z_dim)).astype(
        np.float32)).to(device)
    emb = staged["emb"][0]

    @torch.inference_mode()
    def sample():
        img = bundle.gen_apply_inference(g_params, g_state, z, emb, policy)
        return img[0, 0, 0, 0].float()
    out["sampling_value"] = measure(sample, b, steps)
    return out


def result_line(cfg: Config, rates: Dict) -> Dict:
    """The root's JSON object from the measured rates."""
    base, source = baseline()
    value = round(rates["value"], 2)
    return {"metric": "images_per_sec_per_chip", "value": value,
            "unit": f"img/s/chip (GAN-CLS {cfg.data.image_size}x"
                    f"{cfg.data.image_size} train, {cfg.dtype}, batch "
                    f"{cfg.train.batch_size}/chip)",
            "vs_baseline": round(value / base, 2),
            **{k: round(v, 2) for k, v in rates.items() if k != "value"},
            "baseline_img_per_sec": base, "baseline_source": source}


def main(argv=None) -> int:
    from text_to_image_tpu_torch.main import parse_overrides
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain versions")
    p.add_argument("--measure-steps", type=int, default=MEASURE_STEPS,
                   help="ticks a timed window (the pipeline takes half)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, as main.py's")
    args = p.parse_args(argv)
    cfg = bench_config(parse_overrides(args.set))
    rates = run_bench(cfg, args.device, args.measure_steps)
    print(json.dumps(result_line(cfg, rates)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
