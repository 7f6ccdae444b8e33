"""The port's measurement tools on the CPU: the tick timing that
``chip_smoke.py`` and ``tools/tick_ab.py`` share (``tools/ticks.py``; its
config and kernel families), ``tick_ab``'s child taking it from the
checkout's package rather than from the root script, and
``dp_ticks.launch_many`` (several specs in one launch of gloo ranks, each
spec's outcome the one of a launch of its own)."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu_torch.tools import dp_ticks, tick_ab, ticks

LAUNCH_TIMEOUT_S = 120


def test_tick_ab_child_uses_the_package_timing():
    assert "chip_smoke" not in tick_ab._CHILD
    assert "ticks.tick_timing(" in tick_ab._CHILD
    assert "ticks.tick_profile(" in tick_ab._CHILD
    assert callable(ticks.tick_timing) and callable(ticks.tick_profile)


@pytest.mark.parametrize("model", ["gancls", "stackgan_stage2", "wgancls",
                                   "pggan"])
def test_tick_config_is_the_shipped_yaml_on_synthetic_data(model):
    cfg = ticks.train_config(model, dtype="float32")
    assert (cfg.model, cfg.data.dataset_name, cfg.stage1_checkpoint,
            cfg.train.summary_interval, cfg.dtype) == (
        model, "synthetic", "", 1, "float32")
    assert ticks.config_path(model).endswith(f"configs/{model}_flowers.yml")


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::deconv_wgmma<...>", "deconv5x5_s2 (CUDA)"),
    ("void (anonymous namespace)::upconv_grouped<...>", "upconv3x3 (CUDA)"),
    ("down0_mma_kernel", "conv5x5_s2_act (CUDA)"),
    ("join_text_kernel", "conditioning_join (CUDA)"),
    ("bn_dx_kernel<true>", "batch norm (CUDA)"),
    ("sm90_xmma_gemm_bf16bf16", "matmul (cuBLAS)"),
    ("cudnn::detail::dgrad_engine", "conv backward (cuDNN)"),
    ("void at::native::multi_tensor_apply_kernel", "Adam and EMA (foreach)"),
    ("elementwise_kernel<copy>", "casts, copies, concatenation"),
    ("vectorized_elementwise_kernel<mul>", "other torch elementwise")])
def test_kernel_families(name, family):
    assert ticks.kernel_family(name) == family


def _spec(seed, dtype):
    cfg = dataclasses.replace(tiny_config("gancls"), dtype=dtype)
    rng = np.random.default_rng(seed)
    b, r = cfg.train.batch_size, cfg.data.image_size
    batch = {"real": torch.from_numpy(rng.integers(0, 256, (1, b, r, r, 3),
                                                   dtype=np.uint8)),
             "wrong": torch.from_numpy(rng.integers(0, 256, (1, b, r, r, 3),
                                                    dtype=np.uint8)),
             "emb": torch.from_numpy(rng.normal(
                 size=(1, b, cfg.gan.embed_dim)).astype(np.float32))}
    return {"cfg": dataclasses.asdict(cfg), "mesh": {"data": -1},
            "world": 2, "backend": "gloo", "device": "cpu",
            "batches": [batch, batch]}


def test_launch_many_runs_each_spec_as_its_own_launch(tmp_path):
    specs = {"first": _spec(0, "float32"), "second": _spec(1, "float32")}
    many = dp_ticks.launch_many(specs, tmp_path / "many", LAUNCH_TIMEOUT_S)
    alone = dp_ticks.launch(specs["second"], tmp_path / "alone",
                            LAUNCH_TIMEOUT_S)
    assert list(many) == ["first", "second"]
    assert all(len(outs) == 2 for outs in many.values())
    for got, want in zip(many["second"], alone):
        assert got["metrics"] == want["metrics"]
        assert got["launches"] == want["launches"]
        for net in ("g_params", "d_params"):
            for k, v in want["state"][net].items():
                assert torch.equal(got["state"][net][k], v), k
    # two specs, two outcomes: the first spec's batches differ
    assert many["first"][0]["metrics"] != many["second"][0]["metrics"]


def test_launch_many_refuses_specs_of_another_group(tmp_path):
    other = dict(_spec(1, "float32"), world=1)
    with pytest.raises(ValueError, match="spec b"):
        dp_ticks.launch_many({"a": _spec(0, "float32"), "b": other},
                             tmp_path, LAUNCH_TIMEOUT_S)
    assert not any(tmp_path.iterdir())           # nothing launched
