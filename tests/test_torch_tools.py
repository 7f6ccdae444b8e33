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
from text_to_image_tpu_torch.ops.kernels import conv
from text_to_image_tpu_torch.tools import (conv_plan_sweep, dp_ticks, dx_ab,
                                          tick_ab, ticks)

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
    ("void dx90::ring_kernel<128, 256, 64, (anonymous namespace)::"
     "CDxRing<false> >(...)", "conv5x5_s2_dx (CUDA)"),
    ("void dx90::ring_kernel<256, 64, 64, (anonymous namespace)::"
     "CDxRing<true> >(...)", "conv5x5_s2_dx (CUDA)"),
    ("void (anonymous namespace)::cdxp::patch_kernel((anonymous namespace)"
     "::CDxParams, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
     "conv5x5_s2_dx (CUDA)"),
    ("void dx90::ring_kernel<128, 128, 64, dx90::UpconvRing>(...)",
     "upconv3x3 backward (CUDA)"),
    ("void up32::up32_kernel<false>(up32::Params, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st)", "upconv3x3 (CUDA)"),
    ("void (anonymous namespace)::thin::thin_kernel<64, 4>((anonymous "
     "namespace)::thin::P, CUtensorMap_st)", "deconv5x5_s2 (CUDA)"),
    ("void (anonymous namespace)::bn_reduce_kernel<true>",
     "batch norm (CUDA)"),
    ("down0_mma_kernel", "conv5x5_s2_act (CUDA)"),
    ("void down0::kernel<3, 64, (anonymous namespace)::Conv>(...)",
     "conv5x5_s2_act (CUDA)"),
    ("void down0::kernel<3, 128, (anonymous namespace)::DDxThin>(...)",
     "deconv5x5_s2_dx (CUDA)"),
    ("void dx90::ring_kernel<128, 64, (anonymous namespace)::DDxRing>(...)",
     "deconv5x5_s2_dx (CUDA)"),
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


def test_cdx_sweep_covers_every_deep_conv_dx_of_a_tick():
    """``conv_plan_sweep --ops cdx`` sweeps the conv's dx at every shape of
    the 64 px and 256 px D whose route is conv5x5_s2_dx (bf16, Cin and Co
    multiples of 64), at the D step's 3·64 rows and the G step's 64, and
    names each plan of `conv_dx_candidates` once."""
    shapes = conv_plan_sweep.cdx_shapes()
    assert len(shapes) == len(set(shapes)) == 16
    assert {s[0] for s, _ in shapes} == {192, 64}
    for (b, h, w, cin), co in shapes:
        assert conv.conv_dx_path(cin, co, torch.bfloat16) == "wgmma"
        keys = [conv_plan_sweep.cdx_key(p)
                for p in conv.conv_dx_candidates(b, h, w, cin, co)]
        assert len(keys) == len(set(keys))
        assert conv_plan_sweep.cdx_key(conv.conv_dx_plan(b, h, w, cin,
                                                         co)) in keys


def test_conv_plan_sweep_ddx_names_every_plan_once():
    """``conv_plan_sweep --ops ddx`` sweeps the deconv's dx at the
    generator's four calls and the gradient penalty's critic first layer
    (batch 64), every one on deconv5x5_s2_dx (the ring, the thin path),
    and names each plan of `deconv_dx_candidates` once."""
    shapes = conv_plan_sweep.ddx_shapes()
    assert len(shapes) == len(set(shapes)) == 5
    assert shapes == dx_ab.DDX_CALLS
    paths = []
    for (b, h, w, cin), co in shapes:
        paths.append(conv.deconv_dx_path(cin, co, torch.bfloat16))
        keys = [conv_plan_sweep.ddx_key(p)
                for p in conv.deconv_dx_candidates(b, h, w, cin, co)]
        assert len(keys) == len(set(keys))
        assert conv_plan_sweep.ddx_key(conv.deconv_dx_plan(b, h, w, cin,
                                                           co)) in keys
    assert paths == ["ring"] * 3 + ["thin"] * 2


def test_dx_ab_times_the_deconv_dx_of_every_generator_call():
    """``tools/dx_ab.py``: the deconv's dx through `conv.deconv_dx` where
    the checkout has it, else through the route it replaced (the conv of
    the flipped weight with a zero bias), that route's parts timed alone
    in every checkout."""
    assert [c for c in dx_ab.DDX_CALLS if c[0][1] == 32] == [
        ((64, 32, 32, 128), 3), ((64, 32, 32, 64), 3)]
    assert 'getattr(conv, "deconv_dx", old_deconv_dx)' in dx_ab._CHILD
    for part in ("flip copy", "zero bias", "conv5x5_s2_act alone"):
        assert f'"{part}"' in dx_ab._CHILD


def test_dx_ab_times_the_d_rgb_forward_and_bounds_every_row_alike():
    """``tools/dx_ab.py``: the 64 px discriminator's RGB forward at the D
    step's 3·64 rows and the G step's 64; every row's bound from this
    tree's work counts (the same for every checkout), the deconv's dx with
    no bias and only the taps that land in d."""
    from text_to_image_tpu_torch.tools import bench_kernels as bk
    assert dx_ab.D_RGB_CALLS == [((192, 64, 64, 3), 64), ((64, 64, 64, 3), 64)]
    assert '"conv5x5_s2_act (D RGB)"' in dx_ab._CHILD
    assert "bound" not in dx_ab._CHILD
    rows = [{"kernel": "deconv dx", "shape": [64, 4, 4, 1024], "co": 512},
            {"kernel": "conv5x5_s2_act (D RGB)", "shape": [192, 64, 64, 3],
             "co": 64}]
    dx_ab.with_bounds(bk, rows)
    assert rows[0]["bound_by"] == "operations" and rows[0]["bound_ms"] == (
        pytest.approx(2 * 64 * 17 * 17 * 1024 * 512 / 989e12 * 1e3))
    assert rows[1]["bound_by"] == "bytes" and rows[1]["bound_ms"] == (
        bk.bound(*bk.conv_work((192, 64, 64, 3), 64), torch.bfloat16)[0])


def test_dx_ab_times_every_conv_dx_of_a_tick_and_the_rgb_layer():
    """``tools/dx_ab.py``: the conv's dx of every D call (the RGB layer's at
    the G step's 64 rows only: the D step's images need no gradient), the
    GAN-CLS generator's RGB layer, each checkout in a child that takes the
    checkout's own package."""
    assert len(dx_ab.DX_CALLS) == len(set(dx_ab.DX_CALLS)) == 18
    assert [c for c in dx_ab.DX_CALLS if c[0][-1] == 3] == [
        ((64, 64, 64, 3), 64), ((64, 256, 256, 3), 64)]
    assert dx_ab.RGB_CALLS == [((64, 32, 32, 128), 3)]
    assert "sys.path.insert(0, root)" in dx_ab._CHILD
    assert "conv.conv_dx(gc, w, h, wd)" in dx_ab._CHILD
