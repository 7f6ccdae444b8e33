"""What the port decides in Python around the two kernels it runs as four
output-parity GEMMs, ``deconv5x5_s2`` and ``upconv3x3``, on the CPU: the
grouped decompositions the wgmma path rests on (per-parity tap tables,
weight rows, gather bases, K split over whole taps per parity and reduced in
order, A slices as boxes of the image) written out in plain torch against
the plain versions and the JAX package's ops, the code path each shape
takes (the mirror of the rule in the CUDA entry points), the grouped plans
(tile, parts of K, the resident kernel) at every main-path shape, and the
combined upconv weights.  The kernels themselves run on the card only
(``chip_smoke.py``)."""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv, fused

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BF16, F32 = torch.bfloat16, torch.float32
# f32 sums of the same products in another grouping (1e-5), and against the
# JAX package's ops (the tolerance of tests/test_torch_kernels.py)
TOL, JAX_TOL = 1e-5, 2e-5
DECONV_CAPS = range(1, max(conv.DECONV_PARITY_TAPS) + 1)
UPCONV_CAPS = range(1, max(conv.UPCONV_PARITY_TAPS) + 1)
ODD_MAPS = [((2, 5, 7, 8), 6, "lrelu"), ((1, 4, 4, 4), 3, "tanh"),
            ((3, 3, 6, 5), 7, "relu")]


def _inputs(shape, co, k, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(k, k, shape[-1], co)) * 0.1).astype(np.float32)
    s = (rng.normal(size=(co,)) * 0.3 + 1.0).astype(np.float32)
    t = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, s, t


def _reduce_in_order(planes):
    acc = torch.zeros_like(planes[0])
    for plane in planes:
        acc = acc + plane
    return acc


def _deconv_by_groups(x, w, s, t, act, parts):
    """The wgmma path of csrc/deconv5x5_s2.cu in plain torch: parity g =
    (py, px) sums taps t = (th, tw), th = t // (2+px), each reading input
    pixel (m-1+th, n-1+tw) (zeros outside) against rows
    ((2th+1-py)·5 + 2tw+1-px)·Cin of the HWIO weights seen as one
    [25·Cin, Co] matrix; part z of parts[g] covers taps
    [z·T/parts, (z+1)·T/parts) in its own f32 plane, the planes are added
    in order, then scale, shift, act, and the interleaved store."""
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))        # pixel (m-1+th) at m+th
    wm = w.reshape(25 * cin, co)
    y = torch.empty(b, 2 * h, 2 * wd, co)
    for g in range(4):
        py, px = g >> 1, g & 1
        ntw = 2 + px
        taps = (2 + py) * ntw
        assert taps == conv.DECONV_PARITY_TAPS[g]
        planes = []
        for z in range(parts[g]):
            plane = torch.zeros(b, h, wd, co)
            for tap in range(z * taps // parts[g], (z + 1) * taps // parts[g]):
                th, tw = divmod(tap, ntw)
                row = ((2 * th + 1 - py) * 5 + 2 * tw + 1 - px) * cin
                plane = plane + xp[:, th:th + h, tw:tw + wd] @ wm[row:row + cin]
            planes.append(plane)
        y[:, py::2, px::2] = fused.apply_act(
            _reduce_in_order(planes) * s + t, act)
    return y


@pytest.mark.parametrize("cap", DECONV_CAPS)
@pytest.mark.parametrize("shape,co,act", ODD_MAPS)
def test_deconv_parity_groups_split_per_parity_are_the_plain_deconv(
        shape, co, act, cap):
    x, w, s, t = map(torch.from_numpy, _inputs(shape, co, 5))
    parts = conv._parts_for_cap(conv.DECONV_PARITY_TAPS, cap)
    got = _deconv_by_groups(x, w, s, t, act, parts)
    ref = conv.deconv5x5_s2_plain(x, w, s, t, act)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,act", ODD_MAPS)
def test_deconv_parity_groups_match_the_pallas_op(shape, co, act):
    x, w, s, t = _inputs(shape, co, 5)
    got = _deconv_by_groups(*map(torch.from_numpy, (x, w, s, t)), act,
                            (1, 2, 2, 3))
    ref = np.asarray(jconv.deconv5x5_s2(x, w, s, t, act))
    np.testing.assert_allclose(got.numpy(), ref, rtol=JAX_TOL, atol=JAX_TOL)


def test_deconv_tap_rows_are_the_jax_tap_table():
    """Tap (th, tw) of parity (py, px) reads kernel row 2th+1-py and column
    2tw+1-px: `_DECONV_TAPS` of the JAX package, padded-slice start th."""
    for p in (0, 1):
        assert [(th, 2 * th + 1 - p) for th in range(2 + p)] == \
            [tuple(e) for e in jconv._DECONV_TAPS[p]]
        assert conv.DECONV_TAPS[p] == tuple(map(tuple, jconv._DECONV_TAPS[p]))


def _upconv_by_groups(x, w, s, t, act, parts):
    """The wgmma path of csrc/upconv3x3.cu in plain torch: parity g =
    (py, px) gathers from base pixel (m+py-1, n+px-1) and tap t = (a, b)
    adds (a, b) to it; its weights are rows (4g + t)·Cin of the combined
    matrix wc [16·Cin, Co]; parts and reduce as for the deconv."""
    b, h, wd, cin = x.shape
    co = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))        # pixel (m-1+dy) at m+dy
    wc = conv.combine_upconv_weights(w).reshape(16 * cin, co)
    y = torch.empty(b, 2 * h, 2 * wd, co)
    for g in range(4):
        py, px = g >> 1, g & 1
        planes = []
        for z in range(parts[g]):
            plane = torch.zeros(b, h, wd, co)
            for tap in range(z * 4 // parts[g], (z + 1) * 4 // parts[g]):
                dy, dx = py + (tap >> 1), px + (tap & 1)
                row = (4 * g + tap) * cin
                plane = plane + xp[:, dy:dy + h, dx:dx + wd] @ wc[row:row + cin]
            planes.append(plane)
        y[:, py::2, px::2] = fused.apply_act(
            _reduce_in_order(planes) * s + t, act)
    return y


@pytest.mark.parametrize("cap", UPCONV_CAPS)
@pytest.mark.parametrize("shape,co,act", ODD_MAPS)
def test_upconv_parity_groups_are_the_plain_upconv(shape, co, act, cap):
    x, w, s, t = map(torch.from_numpy, _inputs(shape, co, 3))
    parts = conv._parts_for_cap(conv.UPCONV_PARITY_TAPS, cap)
    got = _upconv_by_groups(x, w, s, t, act, parts)
    ref = conv.upconv3x3_plain(x, w, s, t, act)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,act", ODD_MAPS)
def test_upconv_parity_groups_match_the_jax_op(shape, co, act):
    x, w, s, t = _inputs(shape, co, 3)
    got = _upconv_by_groups(*map(torch.from_numpy, (x, w, s, t)), act,
                            (2, 2, 2, 2))
    ref = np.asarray(jconv.upconv3x3(x, w, s, t, act))
    np.testing.assert_allclose(got.numpy(), ref, rtol=JAX_TOL, atol=JAX_TOL)


# ---- A slices as TMA boxes (csrc/igemm_sm90.cuh image_boxes / image_box)

def _gathered_rows(x, row0, rows, dy, dx):
    """Rows row0 .. row0+rows-1 of the GEMM gathered one by one: row
    (b, m, n) reads pixel (m+dy, n+dx), zeros outside the image or past M."""
    b, h, w, c = x.shape
    out = torch.zeros(rows, c)
    for i in range(rows):
        r = row0 + i
        bi, rem = divmod(r, h * w)
        m, n = divmod(rem, w)
        if bi < b and 0 <= m + dy < h and 0 <= n + dx < w:
            out[i] = x[bi, m + dy, n + dx]
    return out


def _box(x, row0, rows, dy, dx):
    """The TMA box: images [b0, b0+images), image rows [m0+dy, m0+dy+R),
    columns [dx, dx+W) of the zero-extended image, flattened in order."""
    b, h, w, c = x.shape
    n_rows, images = min(h, rows // w), max(1, rows // (h * w))
    b0, rem = divmod(row0, h * w)
    m0 = rem // w
    big = torch.zeros(b + images, h + 4, w + 4, c)
    big[:b, 2:2 + h, 2:2 + w] = x
    box = big[b0:b0 + images, 2 + m0 + dy:2 + m0 + dy + n_rows,
              2 + dx:2 + dx + w]
    return box.reshape(rows, c)


@pytest.mark.parametrize("tile_m", [64, 128])
@pytest.mark.parametrize("bhw", [(1, 4, 8), (3, 8, 4), (2, 16, 8),
                                 (1, 32, 16), (3, 4, 4), (2, 8, 16)])
def test_a_slice_as_an_image_box_is_the_row_gather(bhw, tile_m):
    """Where `a_by_tma` holds, every tile's A slice for every tap shift the
    two kernels use (dy, dx in -1..2) is one box of the image, zero-filled
    outside it and past the last image; elsewhere the rows are gathered."""
    b, h, w = bhw
    plan = conv.GroupedPlan(tile_m, 64, (1, 1, 1, 1))
    assert conv.a_by_tma(h, w, plan) == (tile_m % w == 0 and (
        (h * w) % tile_m == 0 or tile_m % (h * w) == 0))
    if not conv.a_by_tma(h, w, plan):
        return
    x = torch.randn(b, h, w, 3, generator=torch.Generator().manual_seed(0))
    for row0 in range(0, b * h * w, tile_m):
        for dy in range(-1, 3):
            for dx in range(-1, 3):
                assert torch.equal(_box(x, row0, tile_m, dy, dx),
                                   _gathered_rows(x, row0, tile_m, dy, dx))


@pytest.mark.parametrize("shape,co", [(s, co) for s, co, _ in
                                      smoke.DECONV_SHAPES[:3]]
                         + [(s, co) for st in smoke.UPCONV_SHAPES.values()
                            for s, co in st])
def test_main_path_tiles_bring_a_by_tma(shape, co):
    """Every main-path deconv and upconv call takes A as TMA boxes with the
    plan it is given (power-of-two maps)."""
    b, h, w, cin = shape
    plan = (conv.deconv_plan if len(shape) and co != 3 and
            (shape, co) in [(s, c) for s, c, _ in smoke.DECONV_SHAPES]
            else conv.upconv_plan)(b * h * w, co, cin)
    assert conv.a_by_tma(h, w, plan)


# ---- paths

@pytest.mark.parametrize("shape,co,act", smoke.DECONV_SHAPES
                         + smoke.ODD_DECONV_SHAPES
                         + smoke.WGMMA_DECONV_ODD_SHAPES)
def test_deconv_path_mirror_sends_each_shape_where_the_smoke_run_expects(
        shape, co, act):
    cin = shape[-1]
    for dtype in (BF16, F32):
        got = conv.deconv_path(cin, co, dtype)
        assert got == smoke.expected_deconv_path(cin, co, dtype)
        assert got in conv.DECONV_PATHS
    if (shape, co, act) in smoke.WGMMA_DECONV_ODD_SHAPES:
        assert conv.deconv_path(cin, co, BF16) == "wgmma"
    assert conv.deconv_path(cin, co, BF16, aligned=False) != "wgmma"


def test_deep_deconv_calls_take_wgmma_and_the_rgb_layer_direct():
    paths = [conv.deconv_path(s[-1], co, BF16)
             for s, co, _ in smoke.DECONV_SHAPES]
    assert paths == ["wgmma", "wgmma", "wgmma", "thin"]
    assert [conv.deconv_path(s[-1], co, F32)
            for s, co, _ in smoke.DECONV_SHAPES] == ["tile"] * 3 + ["direct"]
    # Co <= 4 up to Cin 512 (the direct kernel's 25·Cin float4 weight rows
    # in 200 KB): the thin wgmma path in bf16 with Cin a multiple of 16
    assert conv.deconv_path(512, 3, BF16) == "thin"
    assert conv.deconv_path(512, 3, BF16, aligned=False) == "direct"
    assert conv.deconv_path(520, 3, BF16) == "tile"


@pytest.mark.parametrize("shape,co", [(s, co) for st in
                                      smoke.UPCONV_SHAPES.values()
                                      for s, co in st]
                         + [(s, co) for s, co, _ in smoke.ODD_UPCONV_SHAPES
                            + smoke.WGMMA_UPCONV_ODD_SHAPES])
def test_upconv_path_mirror_sends_each_shape_where_the_smoke_run_expects(
        shape, co):
    cin, wd = shape[-1], shape[2]
    for dtype in (BF16, F32):
        got = conv.upconv_path(wd, cin, co, dtype)
        assert got == smoke.expected_upconv_path(cin, co, dtype, wd)
        assert got in conv.UPCONV_PATHS
    main = [(s, c) for st in smoke.UPCONV_SHAPES.values() for s, c in st]
    if (shape, co) in main or (shape, co) in [
            (s, c) for s, c, _ in smoke.WGMMA_UPCONV_ODD_SHAPES]:
        assert conv.upconv_path(wd, cin, co, BF16) == "wgmma"
    assert conv.upconv_path(wd, cin, co, BF16, aligned=False) != "wgmma"


# ---- plans

def _deconv_main():
    return [(s[0] * s[1] * s[2], co, s[-1]) for s, co, _ in
            smoke.DECONV_SHAPES if conv.deconv_path(s[-1], co, BF16) == "wgmma"]


def _upconv_main():
    return [(s[0] * s[1] * s[2], co, s[-1])
            for st in smoke.UPCONV_SHAPES.values() for s, co in st]


def _check_plan(m, n, cin, taps, plan):
    assert plan in conv.grouped_candidates(m, n, cin, taps)
    assert n % plan.tile_n == 0
    assert len(plan.parts) == len(taps)
    for t, p in zip(taps, plan.parts):
        assert 1 <= p <= min(t, max(conv.CONV_SPLITS))
        sizes = [(z + 1) * t // p - z * t // p for z in range(p)]
        assert sum(sizes) == t and min(sizes) >= 1     # whole taps, none empty
    assert conv.grouped_ws_elems(m, n, plan.parts) * 4 <= conv.CONV_WS_CAP
    assert conv.grouped_blocks(m, n, cin, taps, plan) >= conv.SM_COUNT


@pytest.mark.parametrize("m,n,cin", _deconv_main())
def test_deconv_plan_fills_the_card_and_evens_out_the_parities(m, n, cin):
    """At least one block per SM; where the tiles alone do not give one
    block per SM, the parities are split so that no block walks half of
    the 9-tap parity's taps."""
    taps = conv.DECONV_PARITY_TAPS
    plan = conv.deconv_plan(m, n, cin)
    _check_plan(m, n, cin, taps, plan)
    assert not plan.resident
    tiles = -(-m // plan.tile_m) * (n // plan.tile_n)
    if tiles * len(taps) < conv.SM_COUNT:
        longest = max(-(-t // p) for t, p in zip(taps, plan.parts))
        assert 2 * longest < max(taps)


def test_deconv_plan_of_the_first_layer():
    """64×4²×1024→512: 1024 rows per parity; without a split the four
    parities give 128 blocks of 128×128 (4 to 9 taps) for 132 SMs."""
    plan = conv.deconv_plan(1024, 512, 1024)
    blocks = conv.grouped_blocks(1024, 512, 1024, conv.DECONV_PARITY_TAPS,
                                 plan)
    assert blocks >= conv.SM_COUNT and max(plan.parts) > 1
    assert conv.grouped_blocks(1024, 512, 1024, conv.DECONV_PARITY_TAPS,
                               conv.GroupedPlan(128, 128, (1,) * 4)) == 128


@pytest.mark.parametrize("m,n,cin", _upconv_main())
def test_upconv_plan_fills_the_card(m, n, cin):
    taps = conv.UPCONV_PARITY_TAPS
    plan = conv.upconv_plan(m, n, cin)
    _check_plan(m, n, cin, taps, plan)
    if n == 64:
        assert plan.tile_n == 64     # no masked half of a 128-wide tile


def test_resident_kernel_is_a_candidate_for_shallow_k_at_n_64_only():
    taps = conv.UPCONV_PARITY_TAPS
    for (m, n, cin), want in (((65536, 64, 128), False),
                              ((262144, 64, 128), False),
                              ((1048576, 64, 64), True),
                              ((4096, 64, 64), True),
                              ((16384, 128, 256), False),
                              ((16384, 64, 256), False)):
        got = any(p.resident for p in conv.grouped_candidates(m, n, cin, taps))
        assert got == want, (m, n, cin)
    res = conv.GroupedPlan(128, 64, (1, 1, 1, 1), True)
    assert conv.grouped_blocks(1048576, 64, 64, taps, res) == \
        2 * conv.SM_COUNT // 4 * 4
    assert conv.grouped_ws_elems(1048576, 64, res.parts) == 0


@pytest.mark.parametrize("plan_fn", [conv.deconv_plan, conv.upconv_plan])
def test_grouped_plan_refuses_a_width_no_tile_divides(plan_fn):
    with pytest.raises(ValueError):
        plan_fn(1024, 96, 64)


def test_grouped_candidates_keep_the_workspace_under_its_cap():
    for m, n, cin in _deconv_main() + _upconv_main():
        for taps in (conv.DECONV_PARITY_TAPS, conv.UPCONV_PARITY_TAPS):
            for p in conv.grouped_candidates(m, n, cin, taps):
                assert conv.grouped_ws_elems(m, n, p.parts) * 4 <= \
                    conv.CONV_WS_CAP


def test_makespan_hands_blocks_to_the_first_free_slot():
    assert conv._makespan([3.0, 1.0, 1.0, 1.0], 2) == 3.0
    assert conv._makespan([1.0, 1.0, 1.0, 3.0], 2) == 4.0
    assert conv._makespan([2.0] * 5, 2) == 6.0


# ---- combined weights

@pytest.mark.parametrize("dtype", [BF16, F32])
def test_combined_weights_on_the_cpu_are_the_torch_and_jax_versions(dtype):
    """`combined_weights` (the combine kernel's wrapper) takes the torch
    version for a CPU tensor; that version is bit-equal to the JAX
    package's, double rounding of a corner tap under bf16 included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    w32 = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    w = torch.from_numpy(w32).to(dtype)
    got = conv.combined_weights(w)
    assert got.dtype == dtype and tuple(got.shape) == (2, 2, 2, 2, 5, 7)
    assert torch.equal(got, conv.combine_upconv_weights(w))
    jw = jnp.asarray(w32).astype(jnp.bfloat16 if dtype == BF16 else
                     jnp.float32)
    ref = np.asarray(jconv._combine_upconv_weights(jw).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), ref)
