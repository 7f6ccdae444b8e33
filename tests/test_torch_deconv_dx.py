"""The transposed conv's input gradient on its own kernel
(``deconv5x5_s2_dx``), on the CPU.

``deconv5x5_s2_dx_plain`` (25 tap matmuls over the cotangent padded (1, 2)
with w flipped in the index, as it lies) against the JAX package's
``_deconv_bwd`` dx (``jax.vjp`` of ``deconv5x5_s2``, whose custom VJP runs
in interpret mode here) at even and odd x maps, Co 3 / 4 / 64, Cin 64 /
128, f32 and bf16, and against the route the other shapes keep (the conv of
d with w flipped and transposed, bias 0); numpy replicas of the kernel's
two paths (the ring's box of d's parity plane a tap over every tile, the
thin path's patch, im2col and weights built from w's taps) against the
plain version; the path, plan and mode mirrors; the autograd Function's
first and second order against autograd of the plain version.  The kernel
runs on the card only (``chip_smoke.py`` phase 3c holds it against this
plain version there)."""

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
# bf16: both sum in f32 and round dx once; JAX's linear transpose of the
# bf16 lax conv_transpose rounds at other places: a rounding flip of 2^-8,
# held against the largest element
BF16_TOL = 2**-6
# f32 gradients of the Function against autograd of the plain version
GRAD_TOL = 1e-4

# (B, H, W, Cin) of x → Co of the deconv: even and odd maps, the RGB
# layer's Co 3 (and 4) at Cin 64 and 128, the deep layers' Co 64
SHAPES = [((2, 4, 4, 64), 64), ((1, 5, 3, 64), 3), ((1, 3, 4, 128), 64),
          ((2, 4, 6, 128), 3), ((1, 5, 5, 64), 4)]


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs(shape, co, seed=3):
    b, h, w, cin = shape
    rng = _rng(seed)
    d = rng.normal(size=(b, 2 * h, 2 * w, co)).astype(np.float32)
    wt = (rng.normal(size=(5, 5, cin, co)) * 0.1).astype(np.float32)
    return d, wt


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30),
        err_msg=what)


def _jax_dx(d, wt, shape, jdtype):
    co = wt.shape[-1]
    ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
    x = jnp.zeros(shape, jdtype)
    _, vjp = jax.vjp(lambda x_: jconv.deconv5x5_s2(
        x_, jnp.asarray(wt, jdtype), ones, zeros, "none"), x)
    return np.asarray(jnp.asarray(vjp(jnp.asarray(d, jdtype))[0],
                                  jnp.float32))


# --- the plain version against the JAX package --------------------------------

@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape,co", SHAPES)
def test_plain_dx_matches_jax_deconv_bwd(shape, co, dtype):
    d, wt = _inputs(shape, co)
    jdtype = jnp.float32 if dtype == F32 else jnp.bfloat16
    ref = _jax_dx(d, wt, shape, jdtype)
    got = conv.deconv5x5_s2_dx_plain(torch.from_numpy(d).to(dtype),
                                     torch.from_numpy(wt).to(dtype))
    assert got.dtype == dtype
    _close(got, ref, f"dx {shape}->{co} {dtype}",
           TOL if dtype == F32 else BF16_TOL)


@pytest.mark.parametrize("shape,co", SHAPES + [((2, 3, 5, 6), 5),
                                               ((1, 1, 1, 8), 2)])
def test_plain_dx_is_the_conv_of_the_flipped_weight(shape, co):
    """The route the other shapes keep: conv5x5_s2_act of d with w flipped
    and transposed and a zero bias."""
    d, wt = map(torch.from_numpy, _inputs(shape, co, seed=4))
    _close(conv.deconv5x5_s2_dx_plain(d, wt),
           conv.conv5x5_s2_act_plain(d, conv.deconv_dx_weight(wt),
                                     torch.zeros(shape[-1]), "none").numpy(),
           f"{shape}->{co}")


# --- numpy replicas of the kernel's paths ---------------------------------------

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


@pytest.mark.parametrize("k", range(5))
def test_tap_reads_its_parity_plane_shifted(k):
    """csrc/conv5x5_s2_bwd.cu DDxRing: tap k reads d's row 2i + k − 1,
    which is plane (k + 1) % 2 at plane row i + (k − 1 − plane) / 2, a
    shift of −1, 0 or +1 (the box's zero fill gives the SAME pads)."""
    py = (k + 1) & 1
    sh = (k - 1 - py) // 2
    assert sh in (-1, 0, 1) and (k - 1 - py) % 2 == 0
    for i in range(4):
        assert 2 * (i + sh) + py == 2 * i + k - 1


def _ring_replica(d, wt, bm):
    """DDxRing over every tile of bm pixels of dx: the tile a box of
    2^lw × 2^lh × 2^lb pixels (`cdx_box` of dx's map), tap (kh, kw) one box
    of d's parity plane ((kh + 1) % 2, (kw + 1) % 2) shifted by ((kh − 1 −
    py) / 2, (kw − 1 − px) / 2), against w[4 − kh, 4 − kw] as it lies; row
    r written to dx pixel (b0 + r >> (lh + lw), i0 + ..., j0 + ...)."""
    b, h2, w2, _ = d.shape
    h, w = h2 // 2, w2 // 2
    cin = wt.shape[2]
    planes = {(py, px): d[:, py::2, px::2] for py in (0, 1) for px in (0, 1)}
    lw, lh, lb, tiles = conv.cdx_box(b, h, w, bm)
    nth, ntw = -(-h // (1 << lh)), -(-w // (1 << lw))
    assert tiles == -(-b // (1 << lb)) * nth * ntw
    dx = np.full((b, h, w, cin), np.nan, np.float32)
    for u in range(tiles):
        ib, rem = divmod(u, nth * ntw)
        ih, iw = divmod(rem, ntw)
        b0, i0, j0 = ib << lb, ih << lh, iw << lw
        acc = np.zeros((bm, cin), np.float32)
        for tap in range(25):
            kh, kw = divmod(tap, 5)
            py, px = (kh + 1) & 1, (kw + 1) & 1
            a = _box(planes[py, px], b0, i0 + (kh - 1 - py) // 2,
                     j0 + (kw - 1 - px) // 2, 1 << lb, 1 << lh, 1 << lw)
            acc += a.reshape(bm, -1) @ wt.reshape(25, cin, -1)[24 - tap].T
        for r in range(bm):
            bb = b0 + (r >> (lh + lw))
            i = i0 + ((r >> lw) & ((1 << lh) - 1))
            j = j0 + (r & ((1 << lw) - 1))
            if bb < b and i < h and j < w:
                assert np.isnan(dx[bb, i, j]).all()
                dx[bb, i, j] = acc[r]
    return dx


@pytest.mark.parametrize("shape,co", [
    ((2, 4, 4, 64), 64), ((3, 5, 7, 64), 64), ((1, 17, 6, 64), 64),
    ((1, 2, 150, 64), 64), ((2, 8, 8, 128), 64), ((1, 1, 1, 64), 128)])
def test_ring_replica_writes_every_pixel_once_as_the_plain_version(shape,
                                                                   co):
    """Boxes of whole images (the 4² map: M = 1024), of images past the
    batch, odd maps whose boxes run past the map, a part of a row (W
    150), one pixel."""
    d, wt = _inputs(shape, co, seed=5)
    got = _ring_replica(d, wt, conv.CDX_BM)
    assert not np.isnan(got).any()
    _close(got, conv.deconv5x5_s2_dx_plain(torch.from_numpy(d),
                                           torch.from_numpy(wt)),
           f"ring replica {shape}->{co}")


def _thin_replica(d, wt, nt):
    """csrc/down0.cuh with conv5x5_s2_bwd.cu's DDxThin: a tile of 8×16
    pixels of dx; its patch of d (rows 2·oy0 − 1 .. + 18, pixels 2·ox0 − 1
    .. + 34, zeros past the edges); the im2col row of pixel (ly, lx) K =
    (kh, kw, c) from patch pixel (2ly + kh, 2lx + kw), zero-padded to a
    multiple of 16; the weights of column tile n0 copied tap by tap as w
    lies ([25][nt][Co] from w[t][n0:n0 + nt]), B[(kh, kw, c)][n] the copy's
    tap 24 − (kh·5 + kw), column n, channel c."""
    b, h2, w2, co = d.shape
    h, w = h2 // 2, w2 // 2
    cin = wt.shape[2]
    k = 25 * co
    kp = -(-k // 16) * 16
    dx = np.full((b, h, w, cin), np.nan, np.float32)
    for n0 in range(0, cin, nt):
        scratch = wt.reshape(25, cin, co)[:, n0:n0 + nt]        # [25][nt][co]
        bmat = np.zeros((kp, nt), np.float32)
        for kr in range(k):
            tap, c = divmod(kr, co)
            bmat[kr] = scratch[24 - tap, :, c]
        for bb in range(b):
            for oy0 in range(0, h, 8):
                for ox0 in range(0, w, 16):
                    patch = _box(d, bb, 2 * oy0 - 1, 2 * ox0 - 1, 1, 19, 35)[0]
                    a = np.zeros((128, kp), np.float32)
                    for px in range(128):
                        ly, lx = divmod(px, 16)
                        for kr in range(k):
                            tap, c = divmod(kr, co)
                            kh, kw = divmod(tap, 5)
                            a[px, kr] = patch[2 * ly + kh, 2 * lx + kw, c]
                    acc = a @ bmat
                    for px in range(128):
                        oy, ox = oy0 + px // 16, ox0 + px % 16
                        if oy < h and ox < w:
                            assert np.isnan(dx[bb, oy, ox, n0:n0 + nt]).all()
                            dx[bb, oy, ox, n0:n0 + nt] = acc[px]
    return dx


@pytest.mark.parametrize("shape,co", [
    ((1, 9, 20, 64), 3), ((2, 8, 16, 128), 3), ((1, 5, 7, 192), 4),
    ((1, 4, 4, 256), 1)])
def test_thin_replica_is_the_plain_version(shape, co):
    """Tiles past the map (9×20), the RGB layer's Cin 128 at N = 128, Cin
    192 in three 64-column tiles, Cin 256 in two 128-column tiles."""
    plan = conv.deconv_dx_plan(*shape, co)
    assert plan.kernel == "thin" and plan.tile_n == (
        128 if shape[-1] % 128 == 0 else 64)
    d, wt = _inputs(shape, co, seed=6)
    got = _thin_replica(d, wt, plan.tile_n)
    assert not np.isnan(got).any()
    _close(got, conv.deconv5x5_s2_dx_plain(torch.from_numpy(d),
                                           torch.from_numpy(wt)),
           f"thin replica {shape}->{co}")


# --- paths, plans, modes --------------------------------------------------------

@pytest.mark.parametrize("cin,co,dtype,aligned,path", [
    (1024, 512, BF16, True, "ring"), (64, 64, BF16, True, "ring"),
    (128, 192, BF16, True, "ring"), (128, 3, BF16, True, "thin"),
    (64, 3, BF16, True, "thin"), (192, 4, BF16, True, "thin"),
    (64, 1, BF16, True, "thin"), (48, 3, BF16, True, "conv"),
    (64, 8, BF16, True, "conv"), (64, 72, BF16, True, "conv"),
    (72, 64, BF16, True, "conv"), (128, 64, F32, True, "conv"),
    (128, 3, F32, True, "conv"), (128, 64, BF16, False, "conv")])
def test_deconv_dx_path_mirrors_the_kernel(cin, co, dtype, aligned, path):
    """csrc/conv5x5_s2_bwd.cu ddx_path: bf16, 16-byte-aligned tensors and
    Cin a multiple of 64; the ring where Co is a multiple of 64, thin
    where Co <= 4; the rest keeps the conv of the flipped weight (a choice
    by shape, no fallback)."""
    assert conv.deconv_dx_path(cin, co, dtype, aligned) == path
    assert path in conv.DDX_PATHS


# every deep deconv dx of the generators (GAN-CLS, GAN-INT and WGAN-CLS at
# batch 64), then chip_smoke.py's odd deep shapes
DEEP_CALLS = [(64, 4, 4, 1024, 512), (64, 8, 8, 512, 256),
              (64, 16, 16, 256, 128), (1, 5, 7, 64, 64), (3, 5, 3, 128, 192),
              (2, 7, 9, 64, 256), (2, 6, 5, 64, 192), (1, 4, 8, 64, 128),
              (3, 8, 4, 128, 192), (1, 1, 1, 64, 64)]


@pytest.mark.parametrize("b,h,w,cin,co", DEEP_CALLS)
def test_deconv_dx_plan_is_a_candidate_with_no_workspace(b, h, w, cin, co):
    """The plan is one of the candidates the launcher takes: the ring, its
    tile dividing Cin, its parts (one cluster, summed on chip: no
    workspace) at most the portable cluster, its grid within the launch's
    y extent, the cheapest by the cost model."""
    plan = conv.deconv_dx_plan(b, h, w, cin, co)
    cands = conv.deconv_dx_candidates(b, h, w, cin, co)
    assert plan in cands
    assert plan.kernel == "ring" and plan.tile_m == conv.CDX_BM
    assert cin % plan.tile_n == 0 and plan.parts in conv.DDX_PARTS
    tiles = conv.cdx_box(b, h, w, plan.tile_m)[3]
    assert tiles * (cin // plan.tile_n) <= 65535
    cost = conv.deconv_dx_cost(b, h, w, cin, co, plan)
    assert all(cost <= conv.deconv_dx_cost(b, h, w, cin, co, p)
               for p in cands)


# the generator's deep calls on the H100: the ring's fastest plans
# (tools/conv_plan_sweep.py --ops ddx)
@pytest.mark.parametrize("b,h,w,cin,co,tile_n,parts", [
    (64, 4, 4, 1024, 512, 128, 2), (64, 8, 8, 512, 256, 256, 2),
    (64, 16, 16, 256, 128, 256, 1)])
def test_deconv_dx_plan_picks_the_swept_plan(b, h, w, cin, co, tile_n,
                                             parts):
    assert conv.deconv_dx_plan(b, h, w, cin, co) == conv.DdxPlan(
        "ring", 128, tile_n, parts)


def test_deconv_dx_plan_splits_the_4x4_output_in_a_cluster():
    """M = 1024 rows at the 4² output: 8 row tiles, so K (12 800) is split
    into parts summed on chip."""
    plan = conv.deconv_dx_plan(64, 4, 4, 1024, 512)
    assert plan.kernel == "ring" and plan.parts > 1
    assert conv.deconv_dx_blocks(64, 4, 4, 1024, plan) == (
        8 * (1024 // plan.tile_n) * plan.parts)


@pytest.mark.parametrize("b,h,w,cin,co,widths", [
    (64, 4, 4, 1024, 512, (256, 128, 64)), (1, 5, 7, 64, 64, (64,)),
    (3, 5, 3, 128, 192, (128, 64))])
def test_deconv_dx_candidates_offer_each_width_and_part(b, h, w, cin, co,
                                                        widths):
    """The ring's candidates: every tile width dividing Cin, each with 1
    and 2 parts (more lost at every generator call of the sweep), no two
    alike; the thin path has its one tile."""
    cands = conv.deconv_dx_candidates(b, h, w, cin, co)
    assert cands == [conv.DdxPlan("ring", conv.CDX_BM, tn, parts)
                     for tn in widths for parts in (1, 2)]
    assert conv.DDX_PARTS == (1, 2)
    assert conv.deconv_dx_candidates(b, 2 * h, 2 * w, cin, 3) == [
        conv.DdxPlan("thin", 128, 128 if cin % 128 == 0 else 64, 1)]


@pytest.mark.parametrize("args,tag", [
    ((64, 32, 32, 128, 3, BF16), "deconv5x5_s2_dx thin 128x128 parts 1"),
    ((64, 32, 32, 64, 3, BF16), "deconv5x5_s2_dx thin 128x64 parts 1"),
    ((64, 32, 32, 128, 3, F32), "conv5x5_s2_act direct"),
    ((2, 4, 4, 16, 8, BF16), "conv5x5_s2_act pipelined")])
def test_deconv_dx_route_tags(args, tag):
    assert conv.deconv_dx_route(*args) == tag


# --- the wrapper, the route and the autograd Function ---------------------------

def test_wrapper_takes_the_plain_version_on_cpu():
    d, wt = map(torch.from_numpy, _inputs((2, 4, 4, 64), 64, seed=8))
    before = conv.deconv5x5_s2_dx.launches
    torch.testing.assert_close(conv.deconv5x5_s2_dx(d, wt),
                               conv.deconv5x5_s2_dx_plain(d, wt),
                               rtol=0, atol=0)
    assert conv.deconv5x5_s2_dx(d.bfloat16(), wt.bfloat16()).dtype == BF16
    assert conv.deconv5x5_s2_dx.launches == before


@pytest.mark.parametrize("case", ["w taps", "odd d map", "d channels"])
def test_wrapper_rejects_wrong_shapes(case):
    d, w = torch.zeros(2, 8, 8, 64), torch.zeros(5, 5, 64, 64)
    calls = {"w taps": lambda: conv.deconv5x5_s2_dx(d, w[:3]),
             "odd d map": lambda: conv.deconv5x5_s2_dx(d[:, :7], w),
             "d channels": lambda: conv.deconv5x5_s2_dx(d[..., :32]
                                                        .contiguous(), w)}
    with pytest.raises(ValueError):
        calls[case]()


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.deconv5x5_s2_dx(torch.zeros(1, 4, 4, 64, device="meta"),
                             torch.zeros(5, 5, 64, 64, device="meta"))


@pytest.mark.parametrize("dtype,shape,co,kernel", [
    (BF16, (1, 3, 4, 64), 64, True), (BF16, (1, 3, 4, 64), 3, True),
    (F32, (1, 3, 4, 64), 64, False), (BF16, (1, 3, 4, 16), 8, False)])
def test_deconv_dx_route_by_shape(monkeypatch, dtype, shape, co, kernel):
    """`deconv_dx` (what `_Deconv.backward` calls) takes deconv5x5_s2_dx
    where `deconv_dx_path` says so, else the conv of the flipped weight:
    both give the plain version."""
    calls = []
    plain = conv.deconv5x5_s2_dx_plain
    monkeypatch.setattr(conv, "deconv5x5_s2_dx_plain",
                        lambda *a: calls.append(1) or plain(*a))
    d, wt = (t.to(dtype) for t in map(torch.from_numpy,
                                      _inputs(shape, co, seed=11)))
    got = conv.deconv_dx(d, wt)
    assert bool(calls) == kernel
    _close(got, plain(d, wt).float(), f"{shape}->{co}",
           TOL if dtype == F32 else BF16_TOL)


@pytest.mark.parametrize("shape,co", [((2, 3, 4, 6), 5), ((1, 4, 4, 8), 3)])
def test_function_gradients_match_autograd_of_the_plain_version(
        monkeypatch, shape, co):
    """`_DeconvDx` (what a CUDA call with d or w requiring a gradient
    records), its launch swapped for the plain version: first order in d
    and w (the transposed conv; the conv's weight gradient in the deconv's
    layout), and second order, against autograd through the plain version;
    f32, GRAD_TOL."""
    monkeypatch.setattr(conv, "_deconv_dx_forward",
                        lambda d, w: conv.deconv5x5_s2_dx_plain(d, w))
    d0, w0 = map(torch.from_numpy, _inputs(shape, co, seed=9))
    c = torch.from_numpy(_rng(10).normal(size=shape).astype(np.float32))

    def grads(fn):
        d = d0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        first = torch.autograd.grad(fn(d, w), [d, w], c, create_graph=True)
        second = torch.autograd.grad(sum((g**2).sum() for g in first),
                                     [d, w])
        return [*first, *second]

    got = grads(conv._DeconvDx.apply)
    want = grads(conv.deconv5x5_s2_dx_plain)
    for name, u, v in zip(("d/dd", "d/dw", "d2/dd", "d2/dw"), got, want):
        _close(u, v.detach().numpy(), f"{name} {shape}", GRAD_TOL)
