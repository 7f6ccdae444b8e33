"""The up-block's backward on the CPU: the plain versions of the port's two
hand-written kernels, ``upconv3x3_dx`` and ``upconv3x3_dw``, against the JAX
package's ``_parity_dx`` / ``_parity_dw`` (plain lax) and against
``jax.vjp`` of the lax composition ``conv3x3(upsample2_nearest(x))``; a
numpy replica of the kernels' tap tables (the g offset each dx tap reads,
the x shift each dw product reads, the 16 → 9 recombination) and of the
dw kernel's division by a multiplication; the wrappers' CPU routing, their
argument checks, dw's plan and the backward's cotangent prologue.  The
kernels themselves run on the card only (``chip_smoke.py`` holds them
against these plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv

# f32: sums of up to 16·B·H·W products in another order (GRAD_TOL of
# tests/test_torch_upconv.py), held against the largest element
TOL = 1e-4
# bf16 inputs, f32 sums, one rounding of the output: the two packages'
# orders of summation can flip that rounding, 1 ulp = 2^-7 relative
BF16_RTOL, BF16_ATOL = 2**-7, 1e-3

# tests/test_torch_upconv.py's SHAPES (odd maps, ragged channels, B = 1),
# a narrowed StackGAN-proportioned shape (channels multiples of 64: the
# wgmma paths' shapes) and C-PGGAN's Co 32
SHAPES = [((2, 4, 4, 16), 8), ((1, 5, 7, 3), 5), ((3, 6, 3, 12), 20),
          ((2, 8, 8, 8), 3), ((1, 40, 32, 8), 8), ((2, 8, 8, 128), 64),
          ((2, 8, 8, 64), 32)]


def _inputs(shape, co, seed=7):
    rng = np.random.default_rng(seed)
    b, h, w, cin = shape
    x = rng.normal(size=shape).astype(np.float32)
    w3 = (rng.normal(size=(3, 3, cin, co)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, 2 * h, 2 * w, co)).astype(np.float32)
    return x, w3, g


def _close(got, ref, what, rtol=0.0, atol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(ref).max())),
                               err_msg=what)


@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_versions_match_the_jax_parity_adjoints(shape, co):
    x, w, g = _inputs(shape, co)
    dx = conv.upconv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                 torch.float32)
    dw = conv.upconv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.float32)
    assert dx.shape == x.shape and dx.dtype == torch.float32
    assert dw.shape == w.shape and dw.dtype == torch.float32
    _close(dx.numpy(), jconv._parity_dx(g, w, jnp.float32), "dx")
    _close(dw.numpy(), jconv._parity_dw(x, g, jnp.float32), "dw")


@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_versions_match_the_vjp_of_the_lax_composition(shape, co):
    x, w, g = _inputs(shape, co, seed=3)
    ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
    _, vjp = jax.vjp(lambda a, b: jconv._lax_upconv(a, b, ones, zeros, "none"),
                     x, w)
    ref_dx, ref_dw = vjp(jnp.asarray(g))
    dx = conv.upconv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                 torch.float32)
    dw = conv.upconv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 torch.float32)
    _close(dx.numpy(), ref_dx, "dx vs jax.vjp")
    _close(dw.numpy(), ref_dw, "dw vs jax.vjp")


@pytest.mark.parametrize("shape,co", [SHAPES[0], SHAPES[2], SHAPES[5],
                                      SHAPES[6]])
def test_bf16_plain_versions_match_jax_in_bf16(shape, co):
    """bf16 inputs: both packages combine the weights in bf16 (a corner tap
    rounded twice), multiply-add in f32 and round the result once."""
    x, w, g = _inputs(shape, co, seed=5)
    xb, wb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, w, g))
    tx, tw, tg = (torch.from_numpy(v).bfloat16() for v in (x, w, g))
    dx = conv.upconv3x3_dx_plain(tg, tw, torch.bfloat16)
    dw = conv.upconv3x3_dw_plain(tx, tg, torch.bfloat16)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close(dx.float().numpy(),
           jconv._parity_dx(gb, wb, jnp.bfloat16).astype(jnp.float32),
           "dx bf16", BF16_RTOL, BF16_ATOL)
    _close(dw.float().numpy(),
           jconv._parity_dw(xb, gb, jnp.bfloat16).astype(jnp.float32),
           "dw bf16", BF16_RTOL, BF16_ATOL)


# --- a numpy replica of the kernels' tables --------------------------------

def _combined(w):
    return conv.combine_upconv_weights(torch.from_numpy(w)).numpy()


def _dx_replica(g, w):
    """dx as csrc/upconv3x3_bwd.cu's UpconvDx gathers it: tap t of pixel
    (i, j) reads g at (2i, 2j) + DX_G_OFFSETS[t] where the tap's plane
    pixel (i+1−py−a, j+1−px−c) lies inside the map."""
    b, h2, w2, _ = g.shape
    h, wd = h2 // 2, w2 // 2
    wc = _combined(w)
    dx = np.zeros((b, h, wd, w.shape[2]), np.float64)
    for t, (py, px, a, c) in enumerate(conv.UPCONV_BWD_TAPS):
        oy, ox = conv.DX_G_OFFSETS[t]
        for i in range(h):
            for j in range(wd):
                m, n = i + 1 - py - a, j + 1 - px - c
                if not (0 <= m < h and 0 <= n < wd):
                    continue
                gy, gx = 2 * i + oy, 2 * j + ox
                assert (gy, gx) == (2 * m + py, 2 * n + px)
                dx[:, i, j] += g[:, gy, gx] @ wc[py, px, a, c].T
    return dx


def _dw_replica(x, g):
    """dw as the kernel computes it: product t over every pixel (b, m, n)
    of g's plane (py, px) against x at (m, n) + DW_X_SHIFTS[t] (zero
    outside), then RECOMBINE's sums in the order t = 0..15."""
    b, h, wd, ci = x.shape
    co = g.shape[-1]
    dcw = np.zeros((16, ci, co), np.float64)
    for t, (py, px, _, _) in enumerate(conv.UPCONV_BWD_TAPS):
        dy, dx = conv.DW_X_SHIFTS[t]
        for m in range(h):
            for n in range(wd):
                if 0 <= m + dy < h and 0 <= n + dx < wd:
                    dcw[t] += np.einsum("bi,bo->io", x[:, m + dy, n + dx],
                                        g[:, 2 * m + py, 2 * n + px])
    dw = np.zeros((3, 3, ci, co), np.float64)
    for t in range(16):
        for kh in range(3):
            for kw in range(3):
                if conv.RECOMBINE[t][kh][kw]:
                    dw[kh, kw] += dcw[t]
    return dw


@pytest.mark.parametrize("shape,co", [SHAPES[0], SHAPES[1], SHAPES[3],
                                      ((2, 3, 5, 4), 6)])
def test_tap_tables_replica_is_the_plain_versions(shape, co):
    x, w, g = _inputs(shape, co, seed=11)
    _close(conv.upconv3x3_dx_plain(torch.from_numpy(g), torch.from_numpy(w),
                                   torch.float32).numpy(),
           _dx_replica(g.astype(np.float64), w), "dx replica")
    _close(conv.upconv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.float32).numpy(),
           _dw_replica(x.astype(np.float64), g.astype(np.float64)),
           "dw replica")


def test_tap_tables_are_the_combined_taps():
    """The 16 taps in the combined weights' order; dx's g offset and dw's x
    shift of each; the recombination is UNCOMBINE ⊗ UNCOMBINE (the JAX
    package's `_UNCOMBINE`) and the adjoint of the forward's combination:
    <dW, W> = <dCw, Cw> for any W and dCw."""
    taps = conv.UPCONV_BWD_TAPS
    assert len(taps) == 16 and taps == tuple(sorted(taps))
    assert conv.UNCOMBINE == jconv._UNCOMBINE
    for t, (py, px, a, c) in enumerate(taps):
        assert t == ((py * 2 + px) * 2 + a) * 2 + c
        oy, ox = conv.DX_G_OFFSETS[t]
        assert (oy - py) % 2 == 0 and (oy - py) // 2 == 1 - py - a
        assert (ox - px) % 2 == 0 and (ox - px) // 2 == 1 - px - c
        # the forward reads x at (m + py + a − 1): the same shift
        assert conv.DW_X_SHIFTS[t] == (conv.UPCONV_TAPS[py][a] - 1,
                                       conv.UPCONV_TAPS[px][c] - 1)
    # each of the 4 parities reaches each of the 9 taps once: 36 terms
    rec = np.asarray(conv.RECOMBINE)
    assert rec.shape == (16, 3, 3) and set(np.unique(rec)) == {0.0, 1.0}
    assert rec.sum() == 36
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 1, 1))
    dcw = rng.normal(size=(16,))
    cw = _combined(w).reshape(16)
    dw = np.einsum("tkl,t->kl", rec, dcw)
    np.testing.assert_allclose((dw * w[..., 0, 0]).sum(), (dcw * cw).sum(),
                               rtol=1e-12)


def _fast_div(d):
    """csrc/upconv3x3_bwd.cu `fast_div` in Python integers."""
    if d == 1:
        return lambda n: n
    ell = (d - 1).bit_length()
    p = 31 + ell
    mul = ((1 << p) + d - 1) // d
    assert mul < 2**32
    return lambda n: ((n * mul) >> 32) >> (p - 32)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 16, 25, 64, 96, 1000, 16384,
                               65535, 2**20 + 1, 2**30, 2**30 + 3,
                               2**31 - 1])
def test_dw_kernels_division_by_a_multiplication(d):
    """The kernel finds a pixel's (b, m, n) by dividing by H·W and W with
    `fast_div`: exact for every n below 2^31."""
    div = _fast_div(d)
    rng = np.random.default_rng(d)
    ns = {0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31 - 2, (2**31 - 1) // d * d,
          (2**31 - 1) // d * d - 1}
    ns |= {int(v) for v in rng.integers(0, 2**31, 2000)}
    for n in ns:
        if 0 <= n < 2**31:
            assert div(n) == n // d, (n, d)


# --- the wrappers -----------------------------------------------------------

def test_wrappers_take_the_plain_versions_on_cpu():
    x, w, g = map(torch.from_numpy, _inputs((2, 4, 4, 16), 8))
    before = (conv.upconv3x3_dx.launches, conv.upconv3x3_dw.launches)
    torch.testing.assert_close(conv.upconv3x3_dx(g, w, torch.float32),
                               conv.upconv3x3_dx_plain(g, w, torch.float32),
                               rtol=0, atol=0)
    torch.testing.assert_close(conv.upconv3x3_dw(x, g, torch.float32),
                               conv.upconv3x3_dw_plain(x, g, torch.float32),
                               rtol=0, atol=0)
    gb, xb, wb = g.bfloat16(), x.bfloat16(), w.bfloat16()
    assert conv.upconv3x3_dx(gb, wb, torch.bfloat16).dtype == torch.bfloat16
    assert conv.upconv3x3_dw(xb, gb, torch.float32).dtype == torch.float32
    assert (conv.upconv3x3_dx.launches, conv.upconv3x3_dw.launches) == before


@pytest.mark.parametrize("case", [
    "dx f64", "dx out dtype", "dx odd map", "dx co", "dx w shape",
    "dx strided", "dw f64", "dw mixed", "dw map", "dw batch", "dw w dtype",
    "dw strided"])
def test_wrappers_reject_wrong_dtypes_and_shapes(case):
    x, w, g = map(torch.from_numpy, _inputs((2, 4, 4, 8), 6))
    calls = {
        "dx f64": (TypeError, lambda: conv.upconv3x3_dx(
            g.double(), w, torch.float64)),
        "dx out dtype": (TypeError, lambda: conv.upconv3x3_dx(
            g, w, torch.bfloat16)),
        "dx odd map": (ValueError, lambda: conv.upconv3x3_dx(
            g[:, :7], w, torch.float32)),
        "dx co": (ValueError, lambda: conv.upconv3x3_dx(
            g[..., :5].contiguous(), w, torch.float32)),
        "dx w shape": (ValueError, lambda: conv.upconv3x3_dx(
            g, torch.zeros(5, 5, 8, 6), torch.float32)),
        "dx strided": (ValueError, lambda: conv.upconv3x3_dx(
            g.transpose(1, 2), w, torch.float32)),
        "dw f64": (TypeError, lambda: conv.upconv3x3_dw(
            x.double(), g.double(), torch.float64)),
        "dw mixed": (TypeError, lambda: conv.upconv3x3_dw(
            x, g.bfloat16(), torch.float32)),
        "dw map": (ValueError, lambda: conv.upconv3x3_dw(
            x, g[:, :6, :6].contiguous(), torch.float32)),
        "dw batch": (ValueError, lambda: conv.upconv3x3_dw(
            x[:1], g, torch.float32)),
        "dw w dtype": (TypeError, lambda: conv.upconv3x3_dw(
            x, g, torch.float16)),
        "dw strided": (ValueError, lambda: conv.upconv3x3_dw(
            x.transpose(1, 2), g.transpose(1, 2), torch.float32)),
    }
    exc, call = calls[case]
    with pytest.raises(exc):
        call()


def test_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    g = torch.zeros(1, 4, 4, 64, **meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.upconv3x3_dx(g, torch.zeros(3, 3, 64, 64, **meta),
                          torch.float32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.upconv3x3_dw(torch.zeros(1, 2, 2, 64, **meta), g,
                          torch.float32)


# (B, H = W, Cin, Co) of every up-block the training paths differentiate:
# Stage-I and Stage-II at batch 64, C-PGGAN at 64 (32 from 64² up)
MAIN_CALLS = [(64, 4, 1024, 512), (64, 8, 512, 256), (64, 16, 256, 128),
              (64, 32, 128, 64), (64, 16, 512, 256), (64, 32, 256, 128),
              (64, 64, 128, 64), (64, 128, 64, 64), (64, 4, 512, 512),
              (64, 8, 512, 512), (32, 64, 128, 64), (32, 128, 64, 32)]


@pytest.mark.parametrize("b,r,cin,co", MAIN_CALLS)
def test_dw_plan_fills_the_card_within_the_workspace_cap(b, r, cin, co):
    """Every main-path up-block takes wgmma (Co 32 too).  K of at most
    DW_FOLD_SLICES slices or Co 32: the on-chip fold (64 × 64 or 64 × 32
    tiles, two CTAs a part, up to 4 parts a cluster, towards
    DW_TARGET_CTAS["fold"]); else the per-product blocks (tiles of 64 or
    128, towards DW_TARGET_CTAS["products"], every part through the
    workspace).  Each part at least DW_MIN_SLICES slices; the workspace
    under CONV_WS_CAP."""
    bf16 = torch.bfloat16
    k = b * r * r
    plan = conv.dw_plan(b, r, r, cin, co, bf16)
    path = conv.dw_path(r, r, cin, co, bf16)
    assert path == "wgmma"
    assert conv.dx_path(r, r, cin, co, bf16) == "wgmma"
    slices = -(-k // conv.DW_SLICE[path])
    assert plan.fold == (co % 64 != 0 or slices <= conv.DW_FOLD_SLICES)
    if plan.fold:
        assert plan.tile_m == 64 and plan.tile_n == (64 if co % 64 == 0
                                                     else 32)
        ctas = cin // 64 * (co // plan.tile_n) * 2
        assert plan.cluster <= conv.DW_MAX_CLUSTER // 2
        target = conv.DW_TARGET_CTAS["fold"]
    else:
        assert cin % plan.tile_m == 0 and co % plan.tile_n == 0
        ctas = cin // plan.tile_m * (co // plan.tile_n) * 16
        assert plan.cluster == 1
        target = conv.DW_TARGET_CTAS["products"]
    assert plan.parts % plan.cluster == 0
    assert plan.parts == 1 or ctas * plan.parts <= target
    assert plan.parts == 1 or slices // plan.parts >= conv.DW_MIN_SLICES
    ws = conv.plan_ws_elems(plan, co, 16)
    assert ws * 4 <= conv.CONV_WS_CAP
    assert (ws == 0) == (plan.fold and plan.groups == 1)
    assert conv.dw_plan(b, r, r, cin, co, torch.float32)[:2] == (64, 64)
    assert conv.dw_path(r, r, cin, co, torch.float32) == "tile"
    assert conv.dw_path(r, r, cin, co, bf16, aligned=False) == "tile"


@pytest.mark.parametrize("h,w,batch", [(4, 4, 64), (8, 8, 64), (16, 16, 64),
                                       (32, 32, 64), (64, 64, 64),
                                       (128, 128, 64), (128, 128, 32),
                                       (4, 4, 3), (2, 8, 5), (16, 4, 3),
                                       (3, 128, 2)])
def test_dw_tma_box_is_one_slice_of_64_pixels(h, w, batch):
    """Where `dw_box` gives a box, the box placed at a slice's first
    pixel (b0, m0, n0) enumerates, channel panel aside, exactly the
    slice's 64 pixels in order (n fastest, then m, then b): what the
    kernel's A and B rows are; pixels past the batch fall outside the
    tensor (zero-filled).  Every main-path map takes the box."""
    box = conv.dw_box(h, w)
    assert box is not None
    bw, rows, imgs = box
    assert bw * rows * imgs == 64
    k = batch * h * w
    for k0 in range(0, k, 64):
        b0, rem = divmod(k0, h * w)
        m0, n0 = divmod(rem, w)
        boxed = [(b0 + i, m0 + r, n0 + c) for i in range(imgs)
                 for r in range(rows) for c in range(bw)]
        want = [(kk // (h * w), kk % (h * w) // w, kk % w)
                for kk in range(k0, k0 + 64)]
        for got, ref in zip(boxed, want):
            if ref[0] < batch:
                assert got == ref
            else:
                assert got[0] >= batch


@pytest.mark.parametrize("h,w", [(5, 7), (6, 3), (8, 24), (3, 40)])
def test_dw_odd_maps_take_no_box(h, w):
    """A map with no box sends bf16 channels that are multiples of 64 to
    the mma path, not to wgmma."""
    assert conv.dw_box(h, w) is None
    assert conv.dw_path(h, w, 64, 128, torch.bfloat16) == "mma"
    assert conv.dw_plan(2, h, w, 64, 128, torch.bfloat16)[:2] == (64, 64)


@pytest.mark.parametrize("hw,cin,co,dtype,aligned,dx,dw", [
    ((4, 4), 64, 64, torch.bfloat16, True, "wgmma", "wgmma"),
    ((4, 4), 128, 192, torch.bfloat16, True, "wgmma", "wgmma"),
    ((5, 7), 128, 192, torch.bfloat16, True, "wgmma", "mma"),
    ((4, 4), 64, 32, torch.bfloat16, True, "wgmma", "wgmma"),
    ((5, 7), 64, 32, torch.bfloat16, True, "pipelined", "mma"),
    ((4, 4), 128, 96, torch.bfloat16, True, "wgmma", "wgmma"),
    ((5, 7), 128, 96, torch.bfloat16, True, "pipelined", "mma"),
    ((4, 4), 16, 8, torch.bfloat16, True, "pipelined", "mma"),
    ((4, 4), 64, 64, torch.bfloat16, False, "tile", "tile"),
    ((4, 4), 12, 20, torch.bfloat16, True, "tile", "tile"),
    ((4, 4), 64, 64, torch.float32, True, "tile", "tile")])
def test_path_rules_mirror_the_kernels(hw, cin, co, dtype, aligned, dx, dw):
    """dx: wgmma for bf16 with Cin a multiple of 64 and Co of 64 (any map)
    or of 32 on a map with a TMA box (Co 32, Co 96), mma.sync (pipelined)
    for multiples of 8, else the simple tile; dw: wgmma for
    bf16 with Cin a multiple of 64 and Co of 32 where the map also has a
    TMA box, then mma.sync for multiples of 8, else the FMA tile (f32
    always).  On wgmma the 4² maps at batch 64 (16 slices) and Co 32 fold
    on chip (64 × 64 or 64 × 32 tiles); the per-product blocks take the
    widest of 64 or 128 that divides Cin and Co."""
    h, w = hw
    assert conv.dx_path(h, w, cin, co, dtype, aligned) == dx
    assert conv.dw_path(h, w, cin, co, dtype, aligned) == dw
    plan = conv.dw_plan(64, h, w, cin, co, dtype, aligned)
    assert plan.fold == (dw == "wgmma")
    assert (plan.tile_m, plan.tile_n) == (
        (64, 64 if co % 64 == 0 else 32) if dw == "wgmma" else (64, 64))
    plan = conv.dw_plan(64, 2 * h, 2 * w, cin, co, dtype, aligned)
    if dw == "wgmma" and co % 64 == 0:
        assert not plan.fold and (plan.tile_m, plan.tile_n) == (
            128 if cin % 128 == 0 else 64, 128 if co % 128 == 0 else 64)


def test_dw_plan_refuses_a_workspace_over_the_cap():
    """Stage-I's first up-block at gf 256 (4²×2048→1024): bf16 folds on
    chip with every part in one cluster, so there is no workspace and one
    chunk of all 2048 input channels (one part of its 16 products over
    every Cin would be 128 MiB, over CONV_WS_CAP).  Its f32 plan (the FMA
    tile, every part's products in a workspace) walks Cin in chunks whose
    workspace stays within the cap; a chunk of one tile that does not fit
    still raises."""
    plan = conv.dw_plan(64, 4, 4, 2048, 1024, torch.bfloat16)
    assert conv.dw_ws_elems(2048, 1024, 1) * 4 > conv.CONV_WS_CAP
    assert plan.fold and plan.chunk == 2048
    assert conv.plan_ws_elems(plan, 1024, 16) == 0
    plan = conv.dw_plan(64, 4, 4, 2048, 1024, torch.float32)
    assert plan.chunk < 2048 and plan.chunk % plan.tile_m == 0
    assert plan.parts * conv.dw_ws_elems(plan.chunk, 1024, 1) * 4 \
        <= conv.CONV_WS_CAP
    # the widest chunk that fits: one more tile of rows would not
    assert conv.dw_ws_elems(plan.chunk + plan.tile_m, 1024, plan.parts) \
        * 4 > conv.CONV_WS_CAP
    with pytest.raises(ValueError, match="workspace"):
        conv.dw_plan(4, 4, 4, 64, 2**16, torch.float32)


# --- the on-chip fold's order, in numpy ---------------------------------------

def _fold_on_chip(x, g):
    """numpy replica of the wgmma path's on-chip fold for one part of K
    (csrc/upconv3x3_bwd.cu dw_fold_kernel): the 16 f32 products [Cin × Co];
    the CTA of row parity py takes, for tap (kh, kw), plane (py, 0)'s
    product a = (kh >= 1 + py), c = (kw >= 1) and adds plane (py, 1)'s,
    c = (kw >= 2); the epilogue adds the CTAs' partial taps in rank order
    (py 0, then py 1)."""
    b, h, w, ci = x.shape
    co = g.shape[-1]
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    gp = g.reshape(b, h, 2, w, 2, co)
    prod = {}
    for py, px, a, c in conv.UPCONV_BWD_TAPS:
        dy, dx = py + a - 1, px + c - 1
        xs = xp[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w].reshape(-1, ci)
        prod[py, px, a, c] = (xs.T @ gp[:, :, py, :, px].reshape(-1, co)
                              ).astype(np.float32)
    dw = np.zeros((3, 3, ci, co), np.float32)
    for kh in range(3):
        for kw in range(3):
            total = np.zeros((ci, co), np.float32)
            for py in (0, 1):
                a = int(kh >= 1 + py)
                total = total + (prod[py, 0, a, int(kw >= 1)]
                                 + prod[py, 1, a, int(kw >= 2)])
            dw[kh, kw] = total
    return dw


def test_on_chip_fold_takes_each_taps_four_products():
    """The fold's selection (one product of each plane a tap) is RECOMBINE:
    tap (kh, kw) sums exactly the four products RECOMBINE gives it."""
    for kh in range(3):
        for kw in range(3):
            picked = {(py, px, int(kh >= 1 + py), int(kw >= 1 + px))
                      for py in (0, 1) for px in (0, 1)}
            want = {t for i, t in enumerate(conv.UPCONV_BWD_TAPS)
                    if conv.RECOMBINE[i][kh][kw]}
            assert picked == want, (kh, kw)


@pytest.mark.parametrize("shape,co", [SHAPES[0], SHAPES[1], SHAPES[2],
                                      SHAPES[5], SHAPES[6]])
def test_on_chip_fold_order_matches_jax_parity_dw(shape, co):
    """The fold in the kernel's order of sums against the JAX package's
    `_parity_dw`: f32 within 1e-5 of the largest element; bf16 inputs (f32
    sums, one rounding) as the plain versions are held in bf16."""
    x, _, g = _inputs(shape, co, seed=11)
    np.testing.assert_allclose(
        _fold_on_chip(x, g), np.asarray(jconv._parity_dw(x, g, jnp.float32)),
        rtol=0, atol=1e-5 * float(np.abs(_fold_on_chip(x, g)).max()))
    xb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, g))
    got = torch.from_numpy(_fold_on_chip(
        np.asarray(xb.astype(jnp.float32)),
        np.asarray(gb.astype(jnp.float32)))).bfloat16().float().numpy()
    _close(got, jconv._parity_dw(xb, gb, jnp.bfloat16).astype(jnp.float32),
           "fold bf16", BF16_RTOL, BF16_ATOL)


@pytest.mark.parametrize("b,r,cin,co,dtype,modes", [
    # Stage-I's first up-block: the fold, its two parities one cluster
    (64, 4, 1024, 512, torch.bfloat16, {"direct", "cluster", "fold",
                                        "producer"}),
    # C-PGGAN's Co 32: the fold's 32-column tile, clusters of 4 parts,
    # their groups through the workspace
    (32, 128, 64, 32, torch.bfloat16, {"workspace", "cluster", "fold",
                                       "bn32", "producer"}),
    # Stage-II's 64²×128→64: the per-product blocks
    (64, 64, 128, 64, torch.bfloat16, {"workspace", "producer"}),
    # no box (mma) and f32 (tile): per-product blocks
    (2, 5, 64, 64, torch.bfloat16, {"workspace"}),
    (64, 4, 512, 512, torch.float32, {"workspace"})])
def test_dw_modes_mirror_the_launch(b, r, cin, co, dtype, modes):
    """What `dw_modes` says a launch does (the C entry point's Mode bits,
    read back on the card by chip_smoke.py)."""
    path = conv.dw_path(r, r + (r == 5) * 2, cin, co, dtype)
    plan = conv.dw_plan(b, r, r + (r == 5) * 2, cin, co, dtype)
    assert conv.dw_modes(path, plan, 16, cin, r, r) == modes


# --- the backward's prologue ------------------------------------------------

@pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
def test_act_backward_rounds_once_like_the_f32_product(act):
    """The conv's cotangent in g's dtype without an f32 copy of g: the
    same bits as the f32 product with act′ cast to bf16 (and the same
    values in f32)."""
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.normal(size=(2, 6, 6, 8)).astype(np.float32))
    y = conv.apply_act(y, act) if act != "none" else y
    g = torch.from_numpy(rng.normal(size=(2, 6, 6, 8)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        gd, yd = g.to(dt), y.to(dt)
        want = (gd.float() * conv.act_grad_from_output(act, yd)).to(dt)
        got = conv.act_backward(act, gd, yd)
        assert got.dtype == dt
        assert torch.equal(got, want), (act, dt)


@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
def test_bias_backward_reaches_no_library_convolution(act, monkeypatch):
    """`_UpconvBias.backward` goes through the two wrappers alone: with
    every cuDNN entry the old composition used made to raise, its
    gradients still match jax.vjp; db is the f32 sum of the unrounded
    products g·act′(y) in bf16 too (within the f32 sum's order)."""
    def refuse(*a, **k):
        raise AssertionError("a library convolution was called")
    monkeypatch.setattr(conv.F, "conv2d", refuse)
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight", refuse)
    monkeypatch.setattr(torch.nn.grad, "conv2d_input", refuse)
    x, w, g = _inputs((2, 5, 6, 8), 16, seed=9)
    b = (np.random.default_rng(2).normal(size=16) * 0.1).astype(np.float32)
    ones = np.ones(16, np.float32)
    _, vjp = jax.vjp(lambda x_, w_, b_: jconv._lax_upconv(x_, w_, ones, b_,
                                                          act), x, w, b)
    refs = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b)]
    y = conv.upconv3x3_bias(*ts, act)
    got = torch.autograd.grad(y, ts, torch.from_numpy(g))
    for name, u, r in zip(("dx", "dw", "db"), got, refs):
        _close(u.numpy(), r, f"{name} {act}")
    # bf16: db against the f32 sum of the unrounded products
    tb = [torch.from_numpy(x).bfloat16().requires_grad_(True),
          torch.from_numpy(w).bfloat16().requires_grad_(True),
          torch.from_numpy(b).requires_grad_(True)]
    yb = conv.upconv3x3_bias(*tb, act)
    gb = torch.from_numpy(g).bfloat16()
    db = torch.autograd.grad(yb, tb[2], gb)[0]
    terms = gb.float() * conv.act_grad_from_output(act, yb)
    want = terms.sum((0, 1, 2))
    bound = 2**-9 * terms.abs().sum((0, 1, 2)) + 1e-5
    assert db.dtype == torch.float32
    assert bool(((db - want).abs() <= bound).all())
    torch.testing.assert_close(db, want, rtol=1e-6, atol=1e-5)


# f32 sums of the same products in another order: 1e-5 of the sum of their
# magnitudes (bf16 rounding of the products, 2^-9 each, exceeds it)
DB_TOL = 1e-5


@pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_bias_grad_is_the_f32_sum_of_the_products(act, dt):
    """`bias_grad` against the f32 sum of g·act′(y), within DB_TOL of the
    sum of the terms' magnitudes (none and relu: the same terms; lrelu:
    0.2 applied to the negative side's sum)."""
    rng = np.random.default_rng(8)
    y = torch.from_numpy(rng.normal(size=(2, 6, 6, 8)).astype(np.float32))
    y = conv.apply_act(y, act) if act != "none" else y
    g = torch.from_numpy(rng.normal(size=(2, 6, 6, 8)).astype(np.float32))
    gd, yd = g.to(dt), y.to(dt)
    terms = gd.float() * conv.act_grad_from_output(act, yd)
    got = conv.bias_grad(act, gd, yd)
    assert got.dtype == torch.float32
    err = (got - terms.sum((0, 1, 2))).abs()
    assert bool((err <= DB_TOL * terms.abs().sum((0, 1, 2))).all()), act


@pytest.mark.parametrize("shape,co", [((2, 5, 6, 8), 16), ((2, 8, 8, 64), 32)])
def test_bias_backward_db_matches_jax_in_bf16_with_lrelu(shape, co):
    """bf16 with lrelu: db is JAX `_upconv_bias_bwd`'s f32 sum of g32 =
    g·act′(y), not a sum of the products rounded to bf16 (which misses it
    by up to 2^-9 of each term)."""
    x, w, g = _inputs(shape, co, seed=4)
    b = (np.random.default_rng(6).normal(size=co) * 0.1).astype(np.float32)
    xb, wb, gb = (jnp.asarray(v, jnp.bfloat16) for v in (x, w, g))
    y, vjp = jax.vjp(lambda b_: jconv.upconv3x3_bias(xb, wb, b_, "lrelu"),
                     jnp.asarray(b))
    ref, = vjp(gb)
    g32 = np.asarray(gb, np.float32) * np.where(
        np.asarray(y, np.float32) >= 0, 1.0, 0.2)
    scale = np.abs(g32).sum((0, 1, 2))
    tb = [torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
          torch.from_numpy(b).requires_grad_(True)]
    yt = conv.upconv3x3_bias(*tb, "lrelu")
    db, = torch.autograd.grad(yt, tb[2], torch.from_numpy(g).bfloat16())
    err = np.abs(db.numpy() - np.asarray(ref, np.float32))
    assert bool((err <= DB_TOL * scale).all()), float((err / scale).max())
