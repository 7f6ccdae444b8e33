"""upconv3x3_dx's wgmma plans on the CPU: numpy replicas of what its TMA
kernels (``csrc/upconv_dx.cuh``) compute, held against the plain version
``upconv3x3_dx_plain`` and the JAX package's ``_parity_dx``:

* the ring kernel: each tap's A as one zero-filled box of g viewed as
  [B][H][2][W][2·Co], K-major B rows of the combined weights, the items of
  K cut into parts and the parts' f32 tiles added in rank order, rounded
  once;
* the transposed kernel's shared patch: dxᵀ = Wcᵀ·Aᵀ over tiles of two
  image rows of 128 pixels, one 3 × 129-pixel patch of a plane (at Co 64
  two of 2 rows, one a tap row a) shared by the four taps, each reading its
  pixels from row (w+1−a), column (1−c) on;

and the path rule, the plan (`dx_plan`) and the modes (`dx_modes`) that the
C entry points report on the card (``chip_smoke.py`` holds the kernels
against the plain version there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv

# f32: sums of up to 16·Co products a row in another order, of the largest
# element; bf16 inputs, f32 sums, one rounding: 1 ulp (2^-7) relative
F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2**-7, 1e-3


def _inputs(shape, co, seed=7):
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    w3 = (rng.normal(size=(3, 3, cin, co)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, 2 * h, 2 * w, co)).astype(np.float32)
    return w3, g


def _tma_box(t, coords, box):
    """A TMA box of the numpy array `t`: `coords` and `box` innermost
    first (as the tensor map lists them), elements outside `t` zero."""
    coords, box = coords[::-1], box[::-1]
    out = np.zeros(box, t.dtype)
    src, dst = [], []
    for c, n, size in zip(coords, box, t.shape):
        lo, hi = max(c, 0), min(c + n, size)
        if lo >= hi:
            return out
        src.append(slice(lo, hi))
        dst.append(slice(lo - c, hi - c))
    out[tuple(dst)] = t[tuple(src)]
    return out


def _planes(g):
    """g [B,2H,2W,Co] as the kernels' 5-D view [B][H][2][W][2·Co]."""
    b, h2, w2, co = g.shape
    return g.reshape(b, h2 // 2, 2, w2 // 2, 2 * co)


def _combined(w, dtype=torch.float32):
    """The combined weights as the kernel reads them, [16][Cin][Co] in
    w's type (bf16: combined in bf16), as f32."""
    wc = conv.combine_upconv_weights(torch.from_numpy(w.copy()).to(dtype))
    return wc.float().numpy().reshape(16, w.shape[2], w.shape[3])


def _pixel(r, h, w):
    b, rem = divmod(r, h * w)
    i, j = divmod(rem, w)
    return b, i, j


def _ring_replica(g, wc, plan):
    """dx as ring_kernel computes it: a 128 × tile_n tile over part z of
    the 16·Co/slice (tap, slice) items, A of item (t, k0) the box at (px·Co
    + k0, j+1−px−c, py, i+1−py−a, b) of the tile's first pixel (b, i, j),
    B rows t·Cin + n of wc, each item's products summed in f32; the parts'
    tiles added in rank order (from 0), as the cluster's epilogue does."""
    b, h2, w2, co = g.shape
    h, wd, cin = h2 // 2, w2 // 2, wc.shape[1]
    gv = _planes(g)
    bk = conv.dx_k_slice(co)
    s_per = co // bk
    items = 16 * s_per
    bm, tn = conv.DX_BM, plan.tile_n
    seg = min(wd, bm)
    rows = 1 if wd >= bm else min(bm // wd, h)
    imgs = bm // (h * wd) if h * wd < bm else 1
    assert seg * rows * imgs == bm
    m = b * h * wd
    dx = np.zeros((-(-m // bm) * bm, cin), np.float32)
    for row0 in range(0, m, bm):
        bb, i, j = _pixel(row0, h, wd)
        for n0 in range(0, cin, tn):
            tiles = []
            for z in range(plan.parts):
                acc = np.zeros((bm, tn), np.float32)
                for item in range(z * items // plan.parts,
                                  (z + 1) * items // plan.parts):
                    t, k0 = item // s_per, item % s_per * bk
                    py, px, a, c = conv.UPCONV_BWD_TAPS[t]
                    box = _tma_box(gv, (px * co + k0, j + 1 - px - c, py,
                                        i + 1 - py - a, bb),
                                   (bk, seg, 1, rows, imgs))
                    acc += box.reshape(bm, bk) @ wc[t, n0:n0 + tn,
                                                    k0:k0 + bk].T
                tiles.append(acc)
            total = np.zeros((bm, tn), np.float32)
            for part in tiles:          # rank order
                total = total + part
            dx[row0:row0 + bm, n0:n0 + tn] = total
    return dx[:m].reshape(b, h, wd, cin)


def _patch_replica(g, wc):
    """dx as transposed_kernel computes it: the block's tile is rows i0 and
    i0+1 (warpgroup w row i0+w) of the 128-pixel segment from j0 of image
    b; an item is a plane (py, px) with a box of 3 rows × 129 pixels at
    (px·Co, j0−px, py, i0−py, b), or at Co 64 a tap row a0 of it with a box
    of 2 rows at (…, i0−py+1−a0, …); tap (a, c) of warpgroup w reads its
    128 pixels from the box's row w+1−a (w), column 1−c on, and adds
    Wc[t][ci]·pixelsᵀ into the warpgroup's [64 ci × 128 pixels] f32 tile
    (64 input channels a block column), stored transposed."""
    b, h2, w2, co = g.shape
    h, wd, cin = h2 // 2, w2 // 2, wc.shape[1]
    assert conv.dx_patches(h, wd) and co in (32, 64)
    half = co == 64
    gv = _planes(g)
    dx = np.zeros((b, h, wd, cin), np.float32)
    for bb in range(b):
        for i0 in range(0, h, 2):
            for j0 in range(0, wd, 128):
                for n0 in range(0, cin, 64):
                    acc = np.zeros((2, 64, 128), np.float32)
                    for pl in range(4):
                        py, px = pl >> 1, pl & 1
                        for a0 in ((0, 1) if half else (None,)):
                            rows = 2 if half else 3
                            top = i0 - py + (1 - a0 if half else 0)
                            patch = _tma_box(gv, (px * co, j0 - px, py, top,
                                                  bb), (co, 129, 1, rows, 1))
                            patch = patch.reshape(rows * 129, co)
                            for wg in (0, 1):
                                for a in ((a0,) if half else (0, 1)):
                                    for c in (0, 1):
                                        t = ((py * 2 + px) * 2 + a) * 2 + c
                                        row = wg if half else wg + 1 - a
                                        start = row * 129 + 1 - c
                                        acc[wg] += (wc[t, n0:n0 + 64]
                                                    @ patch[start:start
                                                            + 128].T)
                    for wg in (0, 1):
                        dx[bb, i0 + wg, j0:j0 + 128, n0:n0 + 64] = acc[wg].T
    return dx


def _close(got, ref, what, rtol=0.0, atol=F32_TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


# (x shape, Co, ring plan): whole images a box, the last past the batch
# (4²), whole rows (8×16), a part of one row (W 128) with Co 96's three
# 32-channel slices a tap, Co 32, parts of K in a cluster of 2 to 8
RING_CASES = [
    ((2, 4, 4, 64), 64, conv.DxPlan("ring", 128, 64, 4)),
    ((3, 8, 16, 64), 32, conv.DxPlan("ring", 128, 64, 1)),
    ((1, 2, 128, 64), 96, conv.DxPlan("ring", 128, 64, 2)),
    ((2, 4, 8, 128), 64, conv.DxPlan("ring", 128, 128, 8)),
    ((1, 4, 32, 128), 32, conv.DxPlan("ring", 128, 64, 3)),
]


@pytest.mark.parametrize("shape,co,plan", RING_CASES)
def test_ring_box_replica_matches_plain_and_jax(shape, co, plan):
    """Each tap's A as one zero-filled box of the [B][H][2][W][2·Co] view
    and the parts summed in rank order give the plain version's and JAX
    `_parity_dx`'s dx (f32, within 1e-5 of the largest element)."""
    w, g = _inputs(shape, co)
    assert conv.dx_boxes(shape[1], shape[2])
    got = _ring_replica(g, _combined(w), plan)
    plain = conv.upconv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                    torch.float32).numpy()
    _close(got, plain, "ring replica vs plain")
    _close(got, jconv._parity_dx(g, w, jnp.float32), "ring replica vs jax")


@pytest.mark.parametrize("shape,co", [((1, 2, 128, 64), 64),
                                      ((2, 4, 128, 64), 32),
                                      ((1, 2, 256, 128), 64),
                                      ((1, 2, 384, 64), 32)])
def test_shared_patch_replica_matches_plain_and_jax(shape, co):
    """One patch a plane (a tap row of one at Co 64) and four shifted
    starts: the taps at the map's edges take the patch's zero-filled
    pixels, never the next row's or the next segment's."""
    w, g = _inputs(shape, co, seed=3)
    assert conv.dx_patches(shape[1], shape[2])
    got = _patch_replica(g, _combined(w))
    plain = conv.upconv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                    torch.float32).numpy()
    _close(got, plain, "patch replica vs plain")
    _close(got, jconv._parity_dx(g, w, jnp.float32), "patch replica vs jax")


@pytest.mark.parametrize("replica,shape,co", [
    ("ring", (2, 4, 4, 64), 64), ("ring", (1, 2, 128, 64), 96),
    ("patch", (1, 2, 128, 64), 64), ("patch", (1, 2, 128, 64), 32)])
def test_replicas_match_jax_in_bf16(replica, shape, co):
    """bf16 g and weights (combined in bf16 as the kernel's combine launch
    does), f32 sums rounded once: as the plain versions are held in bf16
    (tests/test_torch_upconv_bwd.py)."""
    w, g = _inputs(shape, co, seed=5)
    gb, wb = jnp.asarray(g, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    g32 = np.asarray(gb.astype(jnp.float32))
    wc = _combined(np.asarray(wb.astype(jnp.float32)), torch.bfloat16)
    got = (_ring_replica(g32, wc, RING_CASES[0][2]._replace(
        parts=2, tile_n=64)) if replica == "ring"
        else _patch_replica(g32, wc))
    got = torch.from_numpy(got).bfloat16().float().numpy()
    _close(got, jconv._parity_dx(gb, wb, jnp.bfloat16).astype(jnp.float32),
           f"{replica} bf16", BF16_RTOL, BF16_ATOL)
    plain = conv.upconv3x3_dx_plain(torch.from_numpy(g).bfloat16(),
                                    torch.from_numpy(w).bfloat16(),
                                    torch.bfloat16).float().numpy()
    _close(got, plain, f"{replica} bf16 vs plain", BF16_RTOL, BF16_ATOL)


def test_rank_order_sum_of_the_parts_rounds_once():
    """Eight parts of Stage-I-like K (4² maps, Co 128: 32 items), each an
    f32 tile, added in rank order and rounded once: within the bf16 test's
    tolerance of `_parity_dx`, and bit-equal to the one-part sum rounded
    where the f32 sums agree to the last bit of bf16."""
    shape, co = (2, 4, 4, 128), 128
    w, g = _inputs(shape, co, seed=9)
    wc = _combined(w)
    eight = _ring_replica(g, wc, conv.DxPlan("ring", 128, 128, 8))
    one = _ring_replica(g, wc, conv.DxPlan("ring", 128, 128, 1))
    _close(eight, jconv._parity_dx(g, w, jnp.float32), "8 parts vs jax")
    _close(eight, one, "8 parts vs 1")
    b8 = torch.from_numpy(eight).bfloat16().float().numpy()
    ref = np.asarray(jconv._parity_dx(g, w, jnp.float32))
    _close(b8, ref, "8 parts rounded once", BF16_RTOL, BF16_ATOL)


# --- the path rule, the plan, the modes ---------------------------------

@pytest.mark.parametrize("h,w,boxes,patches", [
    (4, 4, True, False), (8, 8, True, False), (16, 16, True, False),
    (32, 32, True, False), (64, 64, True, False), (128, 128, True, True),
    (2, 8, True, False), (8, 16, True, False), (3, 64, False, False),
    (2, 64, True, False), (1, 256, True, False), (2, 384, True, True),
    (5, 7, False, False), (6, 3, False, False), (4, 48, False, False),
    (1, 64, True, False), (4, 256, True, True)])
def test_tile_boxes_and_patches(h, w, boxes, patches):
    """A tile of 128 rows is a box where it is a part of one image row,
    whole rows or whole images (the ring kernel's maps); the transposed
    kernel's tiles of two rows of a 128-pixel segment cover the maps with
    128-pixel segments and an even number of rows.  The box enumerates the
    tile's rows in order."""
    assert conv.dx_boxes(h, w) == boxes
    assert conv.dx_patches(h, w) == patches
    if not boxes:
        return
    bm = conv.DX_BM
    seg = min(w, bm)
    rows = 1 if w >= bm else min(bm // w, h)
    imgs = bm // (h * w) if h * w < bm else 1
    assert seg * rows * imgs == bm
    batch = 3
    for r0 in range(0, batch * h * w, bm):
        b0, i0, j0 = _pixel(r0, h, w)
        boxed = [(b0 + n, i0 + r, j0 + c) for n in range(imgs)
                 for r in range(rows) for c in range(seg)]
        want = [_pixel(r, h, w) for r in range(r0, r0 + bm)]
        for got, ref in zip(boxed, want):
            assert got == ref or ref[0] >= batch and got[0] >= batch


@pytest.mark.parametrize("hw,cin,co,dtype,aligned,path", [
    ((4, 4), 64, 64, torch.bfloat16, True, "wgmma"),
    ((4, 4), 64, 32, torch.bfloat16, True, "wgmma"),
    ((4, 4), 128, 96, torch.bfloat16, True, "wgmma"),
    ((5, 7), 128, 64, torch.bfloat16, True, "wgmma"),
    ((5, 7), 64, 32, torch.bfloat16, True, "pipelined"),
    ((5, 7), 128, 96, torch.bfloat16, True, "pipelined"),
    ((4, 4), 96, 64, torch.bfloat16, True, "pipelined"),
    ((4, 4), 64, 16, torch.bfloat16, True, "pipelined"),
    ((4, 4), 64, 64, torch.bfloat16, False, "tile"),
    ((4, 4), 12, 20, torch.bfloat16, True, "tile"),
    ((128, 128), 64, 32, torch.float32, True, "tile")])
def test_dx_path_rule(hw, cin, co, dtype, aligned, path):
    """wgmma for bf16 with Cin a multiple of 64 and Co of 64 (any map: the
    gather loop takes the maps with no box) or of 32 on a map with a box;
    mma.sync for multiples of 8; else the FMA tile."""
    assert conv.dx_path(*hw, cin, co, dtype, aligned) == path


# (B, H = W, Cin, Co) of every up-block the training paths differentiate
MAIN_CALLS = [(64, 4, 1024, 512), (64, 8, 512, 256), (64, 16, 256, 128),
              (64, 32, 128, 64), (64, 16, 512, 256), (64, 32, 256, 128),
              (64, 64, 128, 64), (64, 128, 64, 64), (64, 4, 512, 512),
              (64, 8, 512, 512), (32, 64, 128, 64), (32, 128, 64, 32),
              (64, 128, 64, 32)]


@pytest.mark.parametrize("b,r,cin,co", MAIN_CALLS)
def test_dx_plan_takes_tma_at_every_main_call(b, r, cin, co):
    """Every main-path call runs a TMA kernel (A by TMA, a producer warp,
    no workspace): at Co 32 and 64 on the 128² maps the transposed kernel
    with the shared patch; else the ring kernel with a tile dividing Cin,
    at most max(DX_PARTS) parts of at least one item each, all in one
    cluster, and blocks for at least 90 % of the SMs where the parts
    allow."""
    plan = conv.dx_plan(b, r, r, cin, co)
    assert conv.dx_path(r, r, cin, co, torch.bfloat16) == "wgmma"
    items = 16 * co // conv.dx_k_slice(co)
    modes = conv.dx_modes("wgmma", plan, co)
    assert "tma_a" in modes and "workspace" not in modes
    assert ("k32" in modes) == (co % 64 != 0)
    if plan.kernel == "ring":
        assert plan.tile_m == 128 and plan.staging == "tap"
        assert cin % plan.tile_n == 0 and plan.tile_n in conv.DX_TILES_N
        assert 1 <= plan.parts <= min(max(conv.DX_PARTS), items)
        assert plan.cluster == plan.parts
        blocks = -(-b * r * r // 128) * (cin // plan.tile_n) * plan.parts
        assert blocks >= 0.9 * conv.SM_COUNT or plan.parts == min(
            max(conv.DX_PARTS), items)
        assert not (co in (32, 64) and conv.dx_patches(r, r))
    else:
        assert plan == conv.DxPlan("transposed", 256, 64, 1)
        assert co in (32, 64) and r == 128 and plan.cluster == 1
        assert "patch" in modes and plan.staging == "patch"


def test_dx_plan_keeps_the_gather_loop_where_no_box_fits():
    """A map with no box (odd, or rows that no 128-row tile covers) keeps
    the cp.async gather loop with `conv_plan`'s tile and split of the 16
    taps, its parts through a workspace."""
    plan = conv.dx_plan(2, 5, 7, 128, 64)
    tm, tn, split = conv.conv_plan(70, 128, 16 * 64, taps=16)
    assert plan == conv.DxPlan("cp_async", tm, tn, split)
    assert plan.cluster == 1
    assert conv.dx_modes("wgmma", plan, 64) == (
        {"cp_async", "workspace"} if split > 1 else {"cp_async"})


@pytest.mark.parametrize("b,h,w,cin,co,modes", [
    # Stage-I's first up-block: parts of K summed in a cluster
    (64, 4, 4, 1024, 512, {"tma_a", "cluster"}),
    # Stage-II's last: the transposed kernel, the shared patch
    (64, 128, 128, 64, 64, {"tma_a", "patch"}),
    # C-PGGAN's Co 32: the same with 64-byte K slices
    (32, 128, 128, 64, 32, {"tma_a", "patch", "k32"}),
    # Stage-II's 64²×128→64: the ring kernel, one part
    (64, 64, 64, 128, 64, {"tma_a"}),
    # Co 96 on a 4² map: 64-byte slices on the ring kernel
    (2, 4, 4, 128, 96, None),
    # no box: the gather loop
    (1, 5, 7, 64, 64, None)])
def test_dx_modes_mirror_the_plan(b, h, w, cin, co, modes):
    """What `dx_modes` says a launch does (the C entry point's Mode bits,
    read back on the card by chip_smoke.py); none on the mma.sync and FMA
    tiles."""
    plan = conv.dx_plan(b, h, w, cin, co)
    got = conv.dx_modes("wgmma", plan, co)
    if modes is not None:
        assert got == modes
    elif plan.kernel == "ring":
        assert {"tma_a", "k32"} <= got
        assert ("cluster" in got) == (plan.parts > 1)
    else:
        assert plan.kernel == "cp_async" and "cp_async" in got
    for path in ("pipelined", "tile"):
        assert conv.dx_modes(path, plan, co) == frozenset()


def test_dx_candidates_are_what_the_launcher_takes():
    """The sweep's plans: the ring kernel at every tile dividing Cin and 1,
    2, 4, 8 parts (at most the items), the transposed kernel only at Co 32
    and 64 on maps of 128-pixel segments and an even number of rows."""
    cands = conv.dx_candidates(64, 128, 128, 64, 64)
    assert cands[-1] == conv.DxPlan("transposed", 256, 64, 1)
    assert {p.tile_n for p in cands if p.kernel == "ring"} == {64}
    assert conv.dx_candidates(32, 128, 128, 64, 32)[-1].kernel == \
        "transposed"
    assert all(p.kernel == "ring" for p in
               conv.dx_candidates(64, 128, 128, 64, 128)
               + conv.dx_candidates(64, 64, 64, 128, 64)
               + conv.dx_candidates(1, 3, 128, 64, 64))
    # Co 32 has 16 items a tile: parts up to 8
    assert max(p.parts for p in conv.dx_candidates(2, 4, 4, 64, 32)) == 8
    assert conv.dx_plan(2, 4, 4, 64, 32).kernel == "ring"


def test_ring_cost_model_ranks_the_sweep():
    """The ring plan's cost model, fitted to tools/conv_plan_sweep.py --ops
    dx on the H100: where the tiles fill the card one part is cheapest;
    the 4² maps (8 row tiles, 128 items) take parts in a cluster."""
    assert conv.dx_plan(64, 16, 16, 256, 128)[1:4] == (128, 256, 1)
    assert conv.dx_plan(64, 64, 64, 128, 64)[1:4] == (128, 128, 1)
    assert conv.dx_plan(64, 4, 4, 1024, 512).parts > 1
    assert conv.dx_plan(64, 8, 8, 512, 256).parts > 1
