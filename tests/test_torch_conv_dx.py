"""The conv's input gradient on its own kernel (``conv5x5_s2_dx``) and the
thin transposed conv (``deconv5x5_s2`` at Co <= 4 on wgmma), on the CPU.

``conv5x5_s2_dx_plain`` (25 tap matmuls with w as it lies) against the JAX
package's ``_conv_bwd`` dx (``jax.vjp`` of ``_lax_conv_s2``) and against
the cropped transposed conv of the flipped weight, at even and odd maps, Cin
3 / 64 / 128, f32 and bf16; numpy replicas of the kernel's two loops (the
ring's box of gc a tap and a parity's rows written in place, over every plan
tile; the patch kernel's staged patch and descriptor starts) and of the thin
path's patch, nine descriptor starts and output rows, against the plain
versions; the route, path and plan mirrors; the autograd Function's first
and second order against autograd of the plain version.  The kernels run on
the card only (``chip_smoke.py`` phase 3c holds them against these plain
versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv

BF16, F32 = torch.bfloat16, torch.float32
# f32: the same products summed in another order, against each result's
# largest element
TOL = 1e-5
# bf16: both sum in f32 and round dx once; JAX's vjp of the bf16 lax conv
# rounds its cotangent product at other places: a rounding flip of 2^-8,
# held against the largest element
BF16_TOL = 2**-6
# f32 gradients of the Function against autograd of the plain version
GRAD_TOL = 1e-4

# (B, H, W, Cin) → Co: even and odd maps (SAME pads (1, 2) and (2, 2)),
# the RGB layer's Cin 3, the deep layers' Cin 64 and 128, non-square maps
SHAPES = [((2, 8, 8, 3), 8), ((1, 7, 9, 3), 4), ((2, 8, 6, 64), 16),
          ((1, 9, 7, 64), 8), ((1, 4, 4, 128), 64), ((1, 5, 6, 128), 32)]


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs(shape, co, seed=3):
    b, h, w, cin = shape
    rng = _rng(seed)
    gc = rng.normal(size=(b, (h + 1) // 2, (w + 1) // 2, co)).astype(
        np.float32)
    wt = (rng.normal(size=(5, 5, cin, co)) * 0.1).astype(np.float32)
    return gc, wt


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
        err_msg=what)


def _jax_dx(gc, wt, shape, jdtype):
    zero = np.zeros(wt.shape[-1], np.float32)
    x = jnp.zeros(shape, jdtype)
    _, vjp = jax.vjp(lambda x_: jconv._lax_conv_s2(
        x_, jnp.asarray(wt, jdtype), zero, "none"), x)
    return np.asarray(jnp.asarray(vjp(jnp.asarray(gc, jdtype))[0],
                                  jnp.float32))


# --- the plain version against the JAX package --------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_dx_matches_jax_conv_bwd(shape, co, dtype):
    gc, wt = _inputs(shape, co)
    jdtype = jnp.float32 if dtype == F32 else jnp.bfloat16
    ref = _jax_dx(gc, wt, shape, jdtype)
    got = conv.conv5x5_s2_dx_plain(torch.from_numpy(gc).to(dtype),
                                   torch.from_numpy(wt).to(dtype),
                                   shape[1], shape[2])
    assert got.dtype == dtype
    _close(got, ref, f"dx {shape}->{co} {dtype}",
           TOL if dtype == F32 else BF16_TOL)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_dx_is_the_cropped_deconv_of_the_flipped_weight(shape, co):
    """The route the other shapes keep: deconv5x5_s2 of gc with w flipped
    and transposed, rows and columns 1.. on odd maps."""
    b, h, w, cin = shape
    gc, wt = map(torch.from_numpy, _inputs(shape, co, seed=4))
    full = conv.deconv5x5_s2_plain(gc, conv.deconv_dx_weight(wt),
                                   torch.ones(cin), torch.zeros(cin))
    ot, ol = conv.same_pads(h)[1] - 1, conv.same_pads(w)[1] - 1
    _close(conv.conv5x5_s2_dx_plain(gc, wt, h, w),
           full[:, ot:ot + h, ol:ol + w].numpy(), f"{shape}->{co}")


# --- numpy replicas of the kernel's loops ---------------------------------------

def _box(a, b0, r0, c0, nb, nr, nc):
    """a[b0:b0+nb, r0:r0+nr, c0:c0+nc] with zeros past every edge (a TMA
    box of a [B, H, W, C] tensor map)."""
    out = np.zeros((nb, nr, nc, a.shape[-1]), a.dtype)
    for i in range(nb):
        for r in range(nr):
            for c in range(nc):
                bb, rr, cc = b0 + i, r0 + r, c0 + c
                if (0 <= bb < a.shape[0] and 0 <= rr < a.shape[1]
                        and 0 <= cc < a.shape[2]):
                    out[i, r, c] = a[bb, rr, cc]
    return out


def _ring_replica(gc, wt, h, w, bm):
    """csrc/conv5x5_s2_bwd.cu CDxRing over every tile of bm pixels: the
    parities heaviest first, a tap's A one box of gc at the tap's offset,
    w[kh, kw] as it lies, row r written to dx pixel (2m + py, 2n + px)."""
    b, ho, wo, _ = gc.shape
    cin = wt.shape[2]
    pt, pl = conv.same_pads(h)[1], conv.same_pads(w)[1]
    lw, lh, lb, tiles = conv.cdx_box(b, ho, wo, bm)
    nth, ntw = -(-ho // (1 << lh)), -(-wo // (1 << lw))
    assert tiles == -(-b // (1 << lb)) * nth * ntw
    dx = np.full((b, h, w, cin), np.nan, np.float32)
    for k, taps in enumerate(conv.CDX_PARITY_TAPS):
        qy, qx = k >> 1, k & 1
        py, px = (pt & 1) ^ qy, (pl & 1) ^ qx
        nh, nw = 3 - qy, 3 - qx
        assert nh * nw == taps
        for u in range(tiles):
            ib, rem = divmod(u, nth * ntw)
            ih, iw = divmod(rem, ntw)
            b0, m0, j0 = ib << lb, ih << lh, iw << lw
            acc = np.zeros((bm, cin), np.float32)
            for t in range(taps):
                th, tw = divmod(t, nw)
                kh, kw = ((py + pt) & 1) + 2 * th, ((px + pl) & 1) + 2 * tw
                a = _box(gc, b0, m0 + (py + pt - kh) // 2,
                         j0 + (px + pl - kw) // 2, 1 << lb, 1 << lh, 1 << lw)
                acc += a.reshape(bm, -1) @ wt[kh, kw].T
            for r in range(bm):
                bb = b0 + (r >> (lh + lw))
                i = 2 * (m0 + ((r >> lw) & ((1 << lh) - 1))) + py
                j = 2 * (j0 + (r & ((1 << lw) - 1))) + px
                if bb < b and i < h and j < w:
                    assert np.isnan(dx[bb, i, j]).all()
                    dx[bb, i, j] = acc[r]
    return dx


@pytest.mark.parametrize("shape,co", [
    ((2, 8, 8, 64), 64), ((3, 11, 9, 64), 64), ((1, 9, 7, 64), 64),
    ((2, 16, 4, 64), 64), ((1, 34, 6, 64), 64), ((1, 2, 300, 64), 64)])
def test_ring_replica_writes_every_pixel_once_as_the_plain_version(shape,
                                                                   co):
    """Even and odd maps, boxes of whole images (4² planes), of images
    past the batch, of rows past the map (Ho 17), of a part of a row
    (Wo 150)."""
    b, h, w, _ = shape
    gc, wt = _inputs(shape, co, seed=5)
    got = _ring_replica(gc, wt, h, w, conv.CDX_BM)
    assert not np.isnan(got).any()
    _close(got, conv.conv5x5_s2_dx_plain(torch.from_numpy(gc),
                                         torch.from_numpy(wt), h, w),
           f"ring replica {shape}->{co}")


def test_patch_replica_is_the_plain_version():
    """csrc/conv5x5_s2_bwd.cu cdxp: a tile of 8 plane rows × 64 pixels of
    one parity; every tap of it reads the staged patch of gc (rows m0 − 1
    .. m0 + 8, pixels j0 − 1 .. j0 + 64, zeros past the edges) from patch
    row r + di + 1, pixel dj + 1 on; dx written by parity plane."""
    h, w, b, cin, co = 16, 128, 1, 64, 64
    assert conv.cdx_patches(h, w)
    gc, wt = _inputs((b, h, w, cin), co, seed=6)
    ho, wo = h // 2, w // 2
    dx = np.zeros((b, h, w, cin), np.float32)
    for k in range(4):
        qy, qx = k >> 1, k & 1
        py, px = 1 ^ qy, 1 ^ qx         # even maps: pads (1, 2)
        nw = 3 - qx
        for m0 in range(0, ho, 8):
            for j0 in range(0, wo, 64):
                patch = _box(gc, 0, m0 - 1, j0 - 1, 1, 10, 66)[0]
                acc = np.zeros((8, 64, cin), np.float32)
                for t in range((3 - qy) * nw):
                    th, tw = divmod(t, nw)
                    kh, kw = ((py + 1) & 1) + 2 * th, ((px + 1) & 1) + 2 * tw
                    di, dj = (py + 1 - kh) // 2, (px + 1 - kw) // 2
                    for r in range(8):
                        acc[r] += patch[r + di + 1, dj + 1:dj + 65] @ \
                            wt[kh, kw].T
                dx[0, 2 * m0 + py:2 * m0 + py + 16:2,
                   2 * j0 + px:2 * j0 + px + 128:2] = acc
    _close(dx, conv.conv5x5_s2_dx_plain(torch.from_numpy(gc),
                                        torch.from_numpy(wt), h, w),
           "patch replica")


def _thin_replica(x, wt, scale, shift, act):
    """csrc/deconv5x5_s2.cu thin: the [9·Cin × 16] matrix (neighbour o =
    (dy+1)·3 + dx+1, column (py·2 + px)·4 + co, zero where a parity does
    not read a neighbour), a tile's patch of (TR+2) rows × PW pixels with
    its halo, GEMM rows the patch's pixels from PW + 1 on (NB·64 of them,
    the halo columns computed and dropped), neighbour o's A the same patch
    from dy·PW + dx rows on."""
    b, h, w, cin = x.shape
    co = wt.shape[-1]
    plan = conv.thin_plan(h, w, cin, co)
    wm = np.zeros((9, cin, 16), np.float32)
    for o in range(9):
        dy, dx_ = o // 3 - 1, o % 3 - 1
        for n in range(16):
            py, px, c = n >> 3, (n >> 2) & 1, n & 3
            if c < co and (py or dy <= 0) and (px or dx_ <= 0):
                kh = 2 * dy + 2 if py else 2 * dy + 3
                kw = 2 * dx_ + 2 if px else 2 * dx_ + 3
                wm[o, :, n] = wt[kh, kw, :, c]
    y = np.full((b, 2 * h, 2 * w, co), np.nan, np.float32)
    rows = 64 * plan.nb
    for bb in range(b):
        for row0 in range(0, h, plan.tr):
            for col0 in range(0, w, plan.tw):
                patch = _box(x, bb, row0 - 1, col0 - 1, 1, plan.tr + 2,
                             plan.pw)[0].reshape(-1, cin)
                # slack rows past the patch (garbage on the card)
                patch = np.concatenate([patch, np.full(
                    (rows + 2 * plan.pw + 2, cin), np.nan, np.float32)])
                acc = np.zeros((rows, 16), np.float32)
                for o in range(9):
                    start = plan.pw + 1 + (o // 3 - 1) * plan.pw + o % 3 - 1
                    acc += patch[start:start + rows] @ wm[o]
                for g in range(rows):
                    r, c = divmod(plan.pw + 1 + g, plan.pw)
                    i, j = row0 + r - 1, col0 + c - 1
                    if not (1 <= r <= plan.tr and 1 <= c <= plan.tw
                            and i < h and j < w):
                        continue
                    for n in range(16):
                        py, px, ch = n >> 3, (n >> 2) & 1, n & 3
                        if ch < co:
                            y[bb, 2 * i + py, 2 * j + px, ch] = acc[g, n]
    pre = torch.from_numpy(y) * scale + shift
    return conv.apply_act(pre, act).numpy()


@pytest.mark.parametrize("shape,co,act", [
    ((1, 9, 8, 16), 3, "tanh"), ((2, 5, 7, 32), 1, "relu"),
    ((1, 3, 70, 64), 4, "none"), ((1, 20, 6, 48), 2, "lrelu")])
def test_thin_replica_is_the_plain_deconv(shape, co, act):
    rng = _rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    wt = (rng.normal(size=(5, 5, shape[-1], co)) * 0.1).astype(np.float32)
    s = torch.from_numpy((rng.normal(size=co) * 0.2 + 1).astype(np.float32))
    t = torch.from_numpy((rng.normal(size=co) * 0.2).astype(np.float32))
    got = _thin_replica(x, wt, s, t, act)
    assert not np.isnan(got).any()
    _close(got, conv.deconv5x5_s2_plain(torch.from_numpy(x),
                                        torch.from_numpy(wt), s, t, act),
           f"thin replica {shape}->{co}")


@pytest.mark.parametrize("h,w,cin,co", [
    (32, 32, 128, 3), (32, 32, 64, 3), (128, 128, 64, 3), (4, 4, 512, 3),
    (5, 7, 16, 1), (9, 6, 48, 2)])
def test_thin_plan_fits_and_covers_its_tile(h, w, cin, co):
    """NB·64 GEMM rows from PW + 1 cover the tile's TR·PW − 2 pixels, and
    the plan fits the SM with a ring of patches for each of the two
    warpgroups."""
    p = conv.thin_plan(h, w, cin, co)
    assert p.pw == p.tw + 2 and p.tw == min(w, 64) and 1 <= p.tr <= h
    assert 64 * p.nb >= p.tr * p.pw - 2
    assert p.nb in (2, 4, 8) and 2 <= p.stages <= 8 and p.stages % 2 == 0
    assert cin % p.bk == 0 and p.bk in (16, 32, 64)


# --- routes, paths, plans ------------------------------------------------------

@pytest.mark.parametrize("cin,co,dtype,aligned,route", [
    (64, 128, BF16, True, "wgmma"), (512, 512, BF16, True, "wgmma"),
    (64, 192, BF16, True, "wgmma"), (3, 64, BF16, True, "deconv"),
    (64, 72, BF16, True, "deconv"), (72, 64, BF16, True, "deconv"),
    (64, 128, F32, True, "deconv"), (64, 128, BF16, False, "deconv")])
def test_conv_dx_path_mirrors_the_kernel(cin, co, dtype, aligned, route):
    """csrc/conv5x5_s2_bwd.cu cdx_applies: bf16 with Cin and Co multiples
    of 64 and 16-byte-aligned tensors, on any map; the rest keeps the
    transposed conv (a choice by shape, no fallback)."""
    assert conv.conv_dx_path(cin, co, dtype, aligned) == route
    assert route in conv.CDX_PATHS


# every deep conv dx of the 64 px and 256 px D at the D step's 3·64 rows
# and the G step's 64
DEEP_CALLS = [(b, r, r, cin, co) for b in (192, 64)
              for r, cin, co in ((32, 64, 128), (16, 128, 256), (8, 256, 512),
                                 (128, 64, 128), (64, 128, 256),
                                 (32, 256, 512), (16, 512, 512),
                                 (8, 512, 512))]


@pytest.mark.parametrize("b,h,w,cin,co", DEEP_CALLS)
def test_conv_dx_plan_fills_the_card_with_no_workspace(b, h, w, cin, co):
    """The plan is one of the candidates the launcher takes: its tile
    divides Cin, its parts (one cluster, summed on chip: no workspace) at
    most the lightest parity's items and the portable cluster, its grid
    within the launch's y extent; it gives every SM a CTA; the 128² maps
    at Cin 64 take the patch kernel."""
    plan = conv.conv_dx_plan(b, h, w, cin, co)
    assert plan in conv.conv_dx_candidates(b, h, w, cin, co)
    assert cin % plan.tile_n == 0 and plan.kernel in conv.CDX_KERNELS
    assert 1 <= plan.parts <= min(8, 4 * co // 64)
    assert conv.conv_dx_blocks(b, h, w, cin, plan) >= conv.SM_COUNT
    if plan.kernel != "patch":
        tiles = conv.cdx_box(b, h // 2, w // 2, plan.tile_m)[3]
        assert 4 * tiles * (cin // plan.tile_n) <= 65535
    assert (plan.kernel == "patch") == (cin == 64 and h == 128)


@pytest.mark.parametrize("b,h,w", [(1, 9, 7), (3, 11, 9), (2, 8, 8),
                                   (1, 1, 1), (192, 128, 128)])
def test_cdx_box_is_a_tile_of_whole_rows_or_images(b, h, w):
    """2^lw · 2^lh · 2^lb pixels a tile; a box spans rows or images only
    where it holds the plane's whole width or height (powers of two
    covering it)."""
    ho, wo = -(-h // 2), -(-w // 2)
    lw, lh, lb, tiles = conv.cdx_box(b, ho, wo, conv.CDX_BM)
    assert 1 << (lw + lh + lb) == conv.CDX_BM
    assert lh == 0 or (1 << lw) >= wo
    assert lb == 0 or ((1 << lw) >= wo and (1 << lh) >= ho)
    assert tiles * conv.CDX_BM >= b * ho * wo


@pytest.mark.parametrize("plan,modes", [
    (conv.CdxPlan("ring", 128, 256, 1), {"tma_a"}),
    (conv.CdxPlan("ring", 128, 128, 4), {"tma_a", "cluster"}),
    (conv.CdxPlan("patch", 512, 64, 1), {"tma_a", "patch"})])
def test_conv_dx_modes_mirror_the_launch(plan, modes):
    assert conv.conv_dx_modes(plan) == frozenset(modes)
    assert modes <= set(conv.CDX_MODES)


@pytest.mark.parametrize("cin,co,dtype,aligned,path", [
    (128, 3, BF16, True, "thin"), (64, 3, BF16, True, "thin"),
    (16, 1, BF16, True, "thin"), (512, 4, BF16, True, "thin"),
    (48, 2, BF16, True, "thin"), (24, 3, BF16, True, "direct"),
    (6, 3, BF16, True, "direct"), (128, 3, F32, True, "direct"),
    (128, 3, BF16, False, "direct"), (528, 3, BF16, True, "tile"),
    (128, 8, BF16, True, "pipelined")])
def test_thin_path_mirror(cin, co, dtype, aligned, path):
    """deconv_path at Co <= 4: thin for bf16 with Cin a multiple of 16 up
    to 512 and aligned tensors; the direct kernel keeps f32, ragged Cin and
    unaligned tensors; Cin past 512 and Co past 4 the other paths."""
    assert conv.deconv_path(cin, co, dtype, aligned) == path


# --- the wrapper and its autograd Function -------------------------------------

def test_wrapper_takes_the_plain_version_on_cpu():
    gc, wt = map(torch.from_numpy, _inputs((2, 8, 8, 64), 64, seed=8))
    before = conv.conv5x5_s2_dx.launches
    torch.testing.assert_close(conv.conv5x5_s2_dx(gc, wt, 8, 8),
                               conv.conv5x5_s2_dx_plain(gc, wt, 8, 8),
                               rtol=0, atol=0)
    assert conv.conv5x5_s2_dx(gc.bfloat16(), wt.bfloat16(), 8, 8).dtype == BF16
    assert conv.conv5x5_s2_dx.launches == before


@pytest.mark.parametrize("case", ["w taps", "gc map", "gc channels"])
def test_wrapper_rejects_wrong_shapes(case):
    gc, w = torch.zeros(2, 4, 4, 64), torch.zeros(5, 5, 64, 64)
    calls = {"w taps": lambda: conv.conv5x5_s2_dx(gc, w[:3], 8, 8),
             "gc map": lambda: conv.conv5x5_s2_dx(gc, w, 10, 8),
             "gc channels": lambda: conv.conv5x5_s2_dx(gc[..., :32], w, 8,
                                                       8)}
    with pytest.raises(ValueError):
        calls[case]()


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.conv5x5_s2_dx(torch.zeros(1, 2, 2, 64, device="meta"),
                           torch.zeros(5, 5, 64, 64, device="meta"), 4, 4)


@pytest.mark.parametrize("shape,co", [((2, 7, 6, 4), 5), ((1, 8, 8, 3), 6)])
def test_function_gradients_match_autograd_of_the_plain_version(
        monkeypatch, shape, co):
    """`_ConvDx` (what a CUDA call with gc or w requiring a gradient
    records), its launch swapped for the plain version: first order in gc
    and w, and second order (the gradient of a function of the first-order
    gradients, through the conv and the weight-gradient kernel), against
    autograd through the plain version; f32, GRAD_TOL."""
    monkeypatch.setattr(conv, "_conv_dx_forward",
                        lambda gc, w, h, wd: conv.conv5x5_s2_dx_plain(
                            gc, w, h, wd))
    b, h, wd, _ = shape
    gc0, w0 = map(torch.from_numpy, _inputs(shape, co, seed=9))
    c = torch.from_numpy(_rng(10).normal(size=shape).astype(np.float32))

    def grads(fn):
        gc = gc0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        first = torch.autograd.grad(fn(gc, w, h, wd), [gc, w], c,
                                    create_graph=True)
        second = torch.autograd.grad(sum((g**2).sum() for g in first),
                                     [gc, w])
        return [*first, *second]

    got = grads(conv._ConvDx.apply)
    want = grads(conv.conv5x5_s2_dx_plain)
    for name, u, v in zip(("d/dgc", "d/dw", "d2/dgc", "d2/dw"), got, want):
        _close(u, v.detach().numpy(), f"{name} {shape}", GRAD_TOL)
