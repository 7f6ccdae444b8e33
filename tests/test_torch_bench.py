"""The port's ``bench.py`` on the CPU at tiny widths: one JSON line with
the root ``bench.py``'s keys, every value a positive number, and the
root's baseline rule."""

import json
import math

import pytest
import torch

import bench as root_bench
from text_to_image_tpu_torch import bench

# the keys of the root bench.py's JSON line
ROOT_KEYS = ("metric", "value", "unit", "vs_baseline", "resident_value",
             "sharded_resident_value", "pipeline_value", "sampling_value",
             "baseline_img_per_sec", "baseline_source")
TINY = ["gan.gf_dim=8", "gan.df_dim=8", "gan.z_dim=8", "gan.embed_dim=32",
        "gan.compressed_embed_dim=16", "data.image_size=16",
        "train.batch_size=4"]


@pytest.fixture
def one_thread():
    """One intra-op thread: the tiny ticks are many small ops, which a
    thread pool per worker of a loaded test run slows several times."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_bench_prints_one_line_with_the_root_keys(capsys, one_thread):
    assert bench.main(["--device", "cpu", "--measure-steps", "2",
                       "--set", *TINY]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    got = json.loads(lines[0])
    assert tuple(got) == ROOT_KEYS
    assert got["metric"] == "images_per_sec_per_chip"
    assert got["unit"] == ("img/s/chip (GAN-CLS 16x16 train, bfloat16, "
                           "batch 4/chip)")
    for k in ROOT_KEYS[1:] + ("baseline_img_per_sec",):
        if k in ("unit", "baseline_source"):
            continue
        assert isinstance(got[k], float) and math.isfinite(got[k]), k
        assert got[k] > 0, k
    assert math.isclose(got["vs_baseline"], round(
        got["value"] / got["baseline_img_per_sec"], 2))


def test_bench_baseline_is_the_roots():
    assert bench.baseline() == root_bench._baseline()


def test_bench_workload_is_the_roots():
    cfg = bench.bench_config()
    assert (cfg.model, cfg.dtype, cfg.data.image_size, cfg.train.batch_size,
            cfg.train.g_steps, cfg.gan.gf_dim, cfg.gan.df_dim, cfg.gan.z_dim,
            cfg.gan.embed_dim) == ("gancls", "bfloat16", 64, 64, 2, 128, 64,
                                   100, 1024)
    assert (bench.WARMUP_STEPS, bench.MEASURE_STEPS) == (
        root_bench.WARMUP_STEPS, root_bench.MEASURE_STEPS)
