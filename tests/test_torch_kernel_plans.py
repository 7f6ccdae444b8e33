"""What the port decides in Python around its two redesigned kernels,
``conv5x5_s2_act`` and ``conditioning_join``, on the CPU: the code path each
shape takes (the mirror of the rule in the CUDA entry points), the wgmma
plan (tile and split of K) at every main-path shape, and the arithmetic the
kernels' decompositions rest on (K split over whole taps and reduced in
order, the RGB layer's K padded to a multiple of 16, the text term folded
into the join's K) against the plain versions and the JAX package.  The
kernels themselves run on the card only (``chip_smoke.py``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import fused as jfused
from text_to_image_tpu_torch.ops.kernels import conv, fused

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BF16, F32 = torch.bfloat16, torch.float32


def _deep(shapes):
    return [(s, co) for s, co, _ in shapes if s[-1] >= 64]


MAIN_DEEP = (_deep(smoke.conv_shapes(192)) + _deep(smoke.conv_shapes(64))
             + _deep(smoke.conv_shapes_256(192))
             + _deep(smoke.conv_shapes_256(64)))
MAIN_DOWN0 = [(s, co) for b in (192, 64)
              for s, co, _ in (smoke.conv_shapes(b)[0],
                               smoke.conv_shapes_256(b)[0])]


def _gemm(shape, co):
    b, h, w, cin = shape
    return b * conv.same_pads(h)[0] * conv.same_pads(w)[0], co, 25 * cin


@pytest.mark.parametrize("shape,co", MAIN_DEEP)
def test_conv_plan_fills_the_card_at_main_path_shapes(shape, co):
    """At least one block per SM (or the largest split), a known tile that
    divides Co, a split over whole taps, a workspace under its cap."""
    m, n, k = _gemm(shape, co)
    tm, tn, split = conv.conv_plan(m, n, k)
    assert (tm, tn) in conv.CONV_TILES and n % tn == 0
    assert split in conv.CONV_SPLITS and 1 <= split <= 25
    blocks = -(-m // tm) * (n // tn) * split
    assert blocks >= conv.SM_COUNT or split == max(conv.CONV_SPLITS)
    # every part of K is a whole number of taps, none empty, all 25 covered
    parts = [(z + 1) * 25 // split - z * 25 // split for z in range(split)]
    assert sum(parts) == 25 and min(parts) >= 1
    assert k // 25 % 64 == 0          # a 64-channel slice never straddles a tap
    if split > 1:
        assert split * m * n * 4 <= conv.CONV_WS_CAP


def test_conv_plan_splits_only_the_calls_with_few_tiles():
    for shape, co in MAIN_DEEP:
        m, n, k = _gemm(shape, co)
        tm, tn, split = conv.conv_plan(m, n, k)
        if -(-m // 128) * (n // 128) >= 2 * conv.SM_COUNT:
            assert split == 1, (shape, co)
    # the 8x8 maps at batch 64: 32 tiles of 128x128 without a split
    assert conv.conv_plan(*_gemm((64, 8, 8, 256), 512))[2] > 1
    assert conv.conv_plan(*_gemm((64, 8, 8, 512), 512))[2] > 1


def test_conv_plan_refuses_a_width_no_tile_divides():
    with pytest.raises(ValueError):
        conv.conv_plan(1024, 96, 1600)


@pytest.mark.parametrize("shape,co", MAIN_DEEP)
def test_deep_main_path_calls_take_wgmma(shape, co):
    assert conv.conv_path(shape[-1], co, BF16) == "wgmma"
    assert conv.conv_path(shape[-1], co, F32) == "tile"
    assert conv.conv_path(shape[-1], co, BF16, aligned=False) == "tile"


@pytest.mark.parametrize("shape,co", MAIN_DOWN0)
def test_rgb_layer_takes_the_tensor_core_path(shape, co):
    assert conv.conv_path(shape[-1], co, BF16) == "down0_mma"
    assert conv.conv_path(shape[-1], co, F32) == "direct"


def _smoke_conv_cases():
    cases = [(s, co, None) for s, co, _ in smoke.ODD_CONV_SHAPES]
    for want, shapes in smoke.CONV_PATH_BF16.items():
        cases += [(s, co, want) for s, co, _ in shapes]
    cases += [(s, co, want) for (s, co, _), want in
              zip(smoke.NEAR_MISS_CONV_SHAPES, smoke.NEAR_MISS_PATHS_BF16)]
    return cases


@pytest.mark.parametrize("shape,co,want", _smoke_conv_cases())
def test_path_mirror_sends_each_smoke_shape_where_the_smoke_run_expects(
        shape, co, want):
    cin = shape[-1]
    for dtype in (BF16, F32):
        got = conv.conv_path(cin, co, dtype)
        assert got == smoke.expected_conv_path(cin, co, dtype)
        assert got in conv.CONV_PATHS
    if want is not None:
        assert conv.conv_path(cin, co, BF16) == want


@pytest.mark.parametrize("shape,e,co,want", (
    [(*smoke.join_shape(b), "wgmma") for b in (192, 64)]
    + [(s, e, co, "wgmma") for s, e, co, _ in smoke.WGMMA_JOIN_SHAPES]
    + [(s, e, co, "simple") for s, e, co, _ in
       smoke.ODD_JOIN_SHAPES + smoke.NEAR_MISS_JOIN_SHAPES]))
def test_join_path_mirror(shape, e, co, want):
    assert fused.join_path(shape[-1], e, co, BF16) == want
    assert fused.join_path(shape[-1], e, co, F32) == "simple"
    assert fused.join_path(shape[-1], e, co, BF16, aligned=False) == "simple"
    assert want in fused.JOIN_PATHS


def test_join_path_needs_both_channel_counts_in_whole_slices():
    assert fused.join_path(768, 128, 64, BF16) == "wgmma"
    assert fused.join_path(512, 96, 512, BF16) == "simple"
    assert fused.join_path(0, 128, 64, BF16) == "simple"


def _conv_inputs(shape, co, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(
        (rng.normal(size=(5, 5, shape[-1], co)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32))
    return x, w, b


def _taps(x):
    """The 25 tap views of the SAME-padded input, in the weights' order."""
    _, h, wd, _ = x.shape
    ho, pt, pb = conv.same_pads(h)
    wo, pl, pr = conv.same_pads(wd)
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    return [xp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2, :]
            for kh in range(5) for kw in range(5)]


@pytest.mark.parametrize("split", conv.CONV_SPLITS)
@pytest.mark.parametrize("shape,co,act", [((2, 9, 7, 8), 6, "lrelu"),
                                          ((1, 5, 5, 4), 3, "tanh"),
                                          ((3, 8, 6, 5), 7, "none")])
def test_split_k_over_whole_taps_reduced_in_order_is_the_plain_conv(
        shape, co, act, split):
    """The split-K decomposition in plain torch: part z sums taps
    [z·25/split, (z+1)·25/split) into its own f32 plane, the planes are
    added in the order 0..split-1, then bias and activation."""
    x, w, b = _conv_inputs(shape, co)
    taps, w2 = _taps(x), w.reshape(25, shape[-1], co)
    planes = []
    for z in range(split):
        lo, hi = z * 25 // split, (z + 1) * 25 // split
        plane = torch.zeros(*taps[0].shape[:3], co)
        for t in range(lo, hi):
            plane = plane + taps[t] @ w2[t]
        planes.append(plane)
    acc = torch.zeros_like(planes[0])
    for plane in planes:
        acc = acc + plane
    got = fused.apply_act(acc + b, act)
    ref = conv.conv5x5_s2_act_plain(x, w, b, act)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cin", [1, 2, 3, 4])
@pytest.mark.parametrize("hw", [(9, 7), (8, 8)])
def test_rgb_layer_as_one_gemm_with_k_padded_to_16(cin, hw):
    """The tensor-core down0 decomposition: im2col rows [pixels, 25·Cin] in
    (kh, kw, ci) order, K padded with zero columns (and zero weight rows) to
    a multiple of 16 (75 → 80 for RGB), one GEMM against [K, 64]."""
    x, w, b = _conv_inputs((2, *hw, cin), 64)
    k = 25 * cin
    kp = -(-k // 16) * 16
    cols = torch.cat(_taps(x), dim=-1)                       # [B,Ho,Wo,25·Cin]
    cols = torch.nn.functional.pad(cols, (0, kp - k))
    wmat = torch.nn.functional.pad(w.reshape(k, 64), (0, 0, 0, kp - k))
    assert cols.shape[-1] == wmat.shape[0] == kp and kp % 16 == 0
    if cin == 3:
        assert (k, kp) == (75, 80)
    got = fused.apply_act(cols @ wmat + b, "lrelu")
    ref = conv.conv5x5_s2_act_plain(x, w, b, "lrelu")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


def _join_inputs(shape, e, co, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    t = rng.normal(size=(shape[0], e)).astype(np.float32)
    wx = (rng.normal(size=(shape[-1], co)) * 0.1).astype(np.float32)
    wt = (rng.normal(size=(e, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    return x, t, wx, wt, b


@pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("shape,e,co", [((2, 4, 4, 16), 8, 16),
                                        ((5, 3, 3, 12), 7, 20),
                                        ((3, 2, 5, 64), 64, 64)])
def test_join_folded_into_one_gemm_matches_plain_and_jax(shape, e, co, act):
    """Row r of A is [x[r] ; t[r // HW]], B is [wx ; wt]: one GEMM over
    K = Cx + E, then bias and activation: the kernel's decomposition, held
    to the tolerances of ``tests/test_torch_kernels.py``."""
    x, t, wx, wt, b = _join_inputs(shape, e, co)
    bsz, h, w, cx = shape
    rows = torch.from_numpy(x).reshape(bsz * h * w, cx)
    text = torch.from_numpy(t)[torch.arange(bsz * h * w) // (h * w)]
    a = torch.cat([rows, text], dim=1)                       # [M, Cx + E]
    wcat = torch.cat([torch.from_numpy(wx), torch.from_numpy(wt)])
    got = fused.apply_act(a @ wcat + torch.from_numpy(b), act).reshape(
        bsz, h, w, co)
    plain = fused.conditioning_join_plain(
        *map(torch.from_numpy, (x, t, wx, wt, b)), act)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    ref = np.asarray(jfused.conditioning_join(x, t, wx, wt, b, act))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_text_join_passes_row_slices_without_copies():
    """`_text_join` hands the kernel the two row blocks of the 1×1 kernel as
    views of one cast matrix: both are contiguous as they are."""
    from text_to_image_tpu_torch.models import gancls
    seen = {}

    def spy(x, t, wx, wt, bias, act):
        seen.update(wx=wx, wt=wt)
        return fused.conditioning_join_plain(x, t, wx, wt, bias, act)

    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(
        rng.normal(size=(1, 1, 24, 16)).astype(np.float32)),
        "b": torch.zeros(16)}
    h = torch.from_numpy(rng.normal(size=(2, 4, 4, 16)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32))
    orig = gancls.conditioning_join
    gancls.conditioning_join = spy
    try:
        got = gancls._text_join(params, h, t)
    finally:
        gancls.conditioning_join = orig
    assert seen["wx"].is_contiguous() and seen["wt"].is_contiguous()
    assert seen["wx"].data_ptr() == params["w"].data_ptr()   # a view, no copy
    assert seen["wt"].data_ptr() == params["w"][0, 0, 16:].data_ptr()
    cat = torch.cat([h, t[:, None, None, :].expand(2, 4, 4, 8)], -1)
    np.testing.assert_allclose(got.numpy(), (cat @ params["w"][0, 0]).numpy(),
                               rtol=2e-5, atol=2e-5)


def test_libraries_bind_their_argument_types_once(monkeypatch):
    """`_build.bind` sets the C signatures when a library is first loaded
    and hands the same object back afterwards."""
    from text_to_image_tpu_torch.ops.kernels import _build

    class Fn:
        argtypes = restype = None

    class Lib:
        def __init__(self):
            self.t2i_fake = Fn()

    made = []

    def library(name):
        made.append(name)
        return Lib()

    monkeypatch.setattr(_build, "library", library)
    monkeypatch.setattr(_build, "_BOUND", {})
    first = _build.bind("fake", {"t2i_fake": [1, 2]})
    second = _build.bind("fake", {"t2i_fake": [3]})
    assert first is second and made == ["fake"]
    assert first.t2i_fake.argtypes == [1, 2]
