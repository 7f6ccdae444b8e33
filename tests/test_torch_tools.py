"""The port's measurement tools on the CPU: the tick timing that
``chip_smoke.py`` and ``tools/tick_ab.py`` share (``tools/ticks.py``; its
config and kernel families), ``tick_ab``'s child taking it from the
checkout's package rather than from the root script, and
``dp_ticks.launch_many`` (several specs in one launch of gloo ranks, each
spec's outcome the one of a launch of its own)."""

import dataclasses
import types

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
    ("void igemm90::wgmma_kernel<(anonymous namespace)::UpconvDx, 128, 64>",
     "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dx_transpose_kernel<unsigned short>",
     "upconv3x3 backward (CUDA)"),
    ("void dx90::ring_kernel<256, 64>(dx90::Params, CUtensorMap_st, "
     "CUtensorMap_st)", "upconv3x3 backward (CUDA)"),
    ("void dx90::resident_kernel<true, 64>(dx90::Params, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st)", "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_wgmma_kernel<64, 64>",
     "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_reduce_kernel<unsigned short>",
     "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_wgmma_kernel<(anonymous namespace)::"
     "CDw, 128, 128>", "conv5x5_s2_dw (CUDA)"),
    ("void (anonymous namespace)::dw_reduce_kernel<(anonymous namespace)::"
     "CDw, unsigned short>", "conv5x5_s2_dw (CUDA)"),
    ("void (anonymous namespace)::dw_mma_kernel<(anonymous namespace)::CDw, "
     "true>", "conv5x5_s2_dw (CUDA)"),
    ("void (anonymous namespace)::dw_tile_kernel<(anonymous namespace)::Dw, "
     "float>", "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_fold_kernel<32>",
     "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_reduce_kernel<(anonymous namespace)::"
     "Plain<9>, (anonymous namespace)::Dw>", "upconv3x3 backward (CUDA)"),
    ("void (anonymous namespace)::dw_reduce_kernel<(anonymous namespace)::"
     "Plain<25>, (anonymous namespace)::CDw>", "conv5x5_s2_dw (CUDA)"),
    ("void (anonymous namespace)::dw_mma_kernel<(anonymous namespace)::CDw, "
     "true, true>", "conv5x5_s2_dw (CUDA)"),
    ("void (anonymous namespace)::bn_reduce_kernel<true>",
     "batch norm (CUDA)"),
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


def test_conv5x5_dw_launches_count_the_products_kernels():
    """A conv5x5_s2_dw call is one launch of its products' kernel (wgmma,
    mma or tile); its reduction runs only where the plan has a workspace
    and is not a call; the up-block's dw kernels and host ranges are not
    counted."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ns = "void (anonymous namespace)::"
    events = [
        types.SimpleNamespace(key=k, count=c, device_type=d) for k, c, d in (
            (ns + "dw_wgmma_kernel<(anonymous namespace)::CDw, 128, 128>",
             6, cuda),
            (ns + "dw_mma_kernel<(anonymous namespace)::CDw, true, true>",
             3, cuda),
            (ns + "dw_reduce_kernel<(anonymous namespace)::Plain<25>, "
             "(anonymous namespace)::CDw>", 3, cuda),
            (ns + "dw_fold_kernel<64>", 4, cuda),
            (ns + "dw_wgmma_kernel<(anonymous namespace)::Dw, 128, 128>",
             4, cuda),
            (ns + "dw_mma_kernel<(anonymous namespace)::CDw, true, true>",
             1, cpu))]
    assert ticks.conv5x5_dw_launches(events) == 9


def test_library_conv5x5_counts_the_5x5_library_convolutions():
    """A profile recorded with shapes: F.conv2d over a 5×5 filter and its
    backward count once each (aten::convolution, convolution_backward), a
    3×3 one not at all, the port's 5×5 conv and its backward (plain
    versions on the CPU) not at all."""
    from torch.profiler import ProfilerActivity, profile

    from text_to_image_tpu_torch.ops.kernels import conv
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w5 = torch.randn(4, 3, 5, 5, requires_grad=True)
    w3 = torch.randn(4, 3, 3, 3)
    xh = torch.randn(2, 8, 8, 3, requires_grad=True)
    wh = torch.randn(5, 5, 3, 4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        torch.nn.functional.conv2d(x, w5, stride=2).sum().backward()
        torch.nn.functional.conv2d(x.detach(), w3)
    assert ticks.library_conv5x5(prof) == 2
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        conv.conv5x5_s2_act(xh, wh, torch.zeros(4), "lrelu").sum().backward()
    assert ticks.library_conv5x5(prof) == 0


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
