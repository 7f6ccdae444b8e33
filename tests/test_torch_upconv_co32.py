"""upconv3x3's ``co32`` kernel on the CPU (``csrc/upconv_co32.cuh``: bf16,
Cin 64, Co a multiple of 32 but not of 64, maps of 128-pixel row
segments; C-PGGAN 256 px's 128²×64→32 up-block): a numpy replica of its
decomposition held against the plain version ``upconv3x3_plain`` and the
JAX package's ``upconv3x3`` / ``upconv3x3_bias`` (Pallas, interpret mode)
and lax composition:

* a block's run of tiles, one input row of a 128-pixel segment each, the
  ring of staged rows (row r, pixels j0−1 .. j0+128, zero off the map:
  three loads where a run starts, one after), each row freed once by
  each consumer warpgroup;
* the 16 (parity, tap) products in shift-major order, each reading its 64
  pixels from staged row i+dy at column dx+1 on (a descriptor start
  shifted by whole rows), one m64n32k16 a product;
* the weights as the kernel stages them: wc [16][Cin][Co] as it lies, a
  64 ci × 32 co box a product in the 64-byte swizzle, read back through
  the N-major descriptor's strides;
* the epilogue's quads: parity (py, px)'s pixel m at row py, pixel 2m+px
  of the swizzled staging tile, one TMA store an output row;

and the path rule's mirror and the Functions' first-order
backward at Co 32.  The kernel itself runs on the card only
(``chip_smoke.py`` phase 9b and ``tools/conv_plan_sweep.py --ops up32``
hold it against the plain version there)."""

import collections
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BF16, F32 = torch.bfloat16, torch.float32
# f32: the two packages sum the same K = 16·Cin products in another order
F32_TOL = 1e-5
# bf16 (test_upconv_plain_bf16_matches_pallas): the same bf16 combined
# taps, f32 sums, one rounding of the output: 1 ulp = 2^-7 relative
BF16_RTOL, BF16_ATOL = 2**-7, 1e-3
SEG = conv.CO32_SEG
W_TILE = 64 * 64          # a product's staged weights, bytes
ACTS = {"none": lambda v: v, "relu": lambda v: np.maximum(v, 0),
        "lrelu": lambda v: np.where(v >= 0, v, 0.2 * v), "tanh": np.tanh}


def _inputs(shape, co, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], co))
         * np.sqrt(2.0 / (9 * shape[-1]))).astype(np.float32)
    s = (rng.normal(size=(co,)) * 0.1 + 1.0).astype(np.float32)
    t = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    return x, w, s, t


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


def _tap(py, px, a, c):
    """The combined tap's row block of wc [16][Cin][Co]."""
    return ((py * 2 + px) * 2 + a) * 2 + c


def _swz64(r, c):
    """Element slot of (row r, bf16 column c < 32) in a 64-byte-row tile in
    the 64-byte swizzle: 16-byte chunk q of row r at q ^ ((r >> 1) & 3)."""
    return r * 32 + (((c >> 3) ^ ((r >> 1) & 3)) << 3) + (c & 7)


def _shifts():
    """The products grouped by shift, in the kernel's order: (dy, dx) →
    indices into CO32_PRODUCTS."""
    groups = collections.OrderedDict()
    for j, (dy, dx, *_rest) in enumerate(conv.CO32_PRODUCTS):
        groups.setdefault((dy, dx), []).append(j)
    return groups


def _runs(tiles, per_col):
    """Block k's run of tiles [t0, t1), as the kernel splits them."""
    return [(tiles * k // per_col, tiles * (k + 1) // per_col)
            for k in range(per_col)]


def _co32_replica(x, wc, scale, shift, act, sms=132, slots=conv.CO32_RING):
    """What the co32 kernel computes, in f64 from x's and wc's values:
    x [B,H,W,64], wc [2,2,2,2,64,Co]; returns y [B,2H,2W,Co] (NaN where no
    store landed)."""
    b, h, w, cin = x.shape
    co = wc.shape[-1]
    wc16 = wc.reshape(16 * cin, co)
    segs, n_col = w // SEG, co // 32
    tiles = b * h * segs
    per_col = min(tiles, max(sms // n_col, 1))
    y = np.full((b * 4 * h * w, co), np.nan)
    m = np.arange(64)
    c = np.arange(32)
    for col in range(n_col):
        n0 = col * 32
        # the resident weights: product j's 64 ci × 32 co, as TMA boxes
        staged = [_tma_box(wc16, (n0, _tap(py, px, a, cc) * cin), (32, 64))
                  for _, _, py, px, a, cc in conv.CO32_PRODUCTS]
        for t0, t1 in _runs(tiles, per_col):
            ring, n = {}, 0
            for t in range(t0, t1):
                i, rest = t % h, t // h
                j0, bi = rest % segs * SEG, rest // segs
                restart = t == t0 or i == 0
                for r in (range(i - 1, i + 2) if restart else [i + 1]):
                    ring[n % slots] = (n, _tma_box(
                        x, (0, j0 - 1, r, bi), (64, SEG + 2, 1, 1))[0, 0])
                    n += 1
                rows = []
                for d, load in enumerate((n - 3, n - 2, n - 1)):
                    got_load, row = ring[load % slots]
                    assert got_load == load, "a needed row was overwritten"
                    rows.append(row)
                acc = np.zeros((2, 4, 64, 32))
                for hh in (0, 1):
                    for (dy, dx), js in _shifts().items():
                        # the shift's 64 pixels: a start shifted by rows
                        a_op = rows[dy + 1][64 * hh + dx + 1 + m]
                        for j in js:
                            py, px = conv.CO32_PRODUCTS[j][2:4]
                            acc[hh, py * 2 + px] += a_op @ staged[j]
                out = ACTS[act](acc * scale[n0:n0 + 32] + shift[n0:n0 + 32])
                # the quads: parity (py, px)'s pixel m of half hh at staging
                # row py*256 + 128hh + 2m + px
                stage = np.full(2 * 256 * 32, np.nan)
                hh_, par_, m_ = np.meshgrid(np.arange(2), np.arange(4), m,
                                            indexing="ij")
                r = (par_ >> 1) * 256 + 128 * hh_ + 2 * m_ + (par_ & 1)
                stage[_swz64(r[..., None], c)] = out
                # one TMA store an output row: 256 pixels from 2·j0
                pix = (bi * 2 * h + 2 * i) * 2 * w + 2 * j0
                for py in (0, 1):
                    rr = py * 256 + np.arange(256)
                    y[pix + py * 2 * w + np.arange(256), n0:n0 + 32] = \
                        stage[_swz64(rr[:, None], c)]
    return y.reshape(b, 2 * h, 2 * w, co)


def _arrivals(b, h, w, sms, n_col=1):
    """The ring's loads and a consumer warpgroup's arrivals that free them
    (after each tile its row i-1, at the end of a run all three), as the
    producer and the consumers count them: {load: arrivals}, a run each."""
    segs = w // SEG
    tiles = b * h * segs
    per_col = min(tiles, max(sms // n_col, 1))
    freed = []
    for t0, t1 in _runs(tiles, per_col):
        got, n = collections.Counter(), 0
        for t in range(t0, t1):
            i = t % h
            restart, last = t == t0 or i == 0, t + 1 == t1 or i + 1 == h
            n += 3 if restart else 1
            for d in range(3 if last else 1):
                got[n - 3 + d] += 1
        assert sorted(got) == list(range(n)), "every load is freed"
        freed.append(got)
    return freed


# ---- the product table and the staged weights

def test_products_are_the_sixteen_combined_taps_in_shift_major_order():
    prods = conv.CO32_PRODUCTS
    assert len(prods) == 16
    assert sorted(_tap(py, px, a, c) for _, _, py, px, a, c in prods) == \
        list(range(16))
    for dy, dx, py, px, a, c in prods:
        assert (dy, dx) == (py + a - 1, px + c - 1)
    # the C tables: count, first and parity of shift s = (dy+1)*3 + (dx+1)
    lo, hi = (lambda d: max(d, 0)), (lambda d: min(d + 1, 1))
    first = 0
    for s, ((dy, dx), js) in enumerate(_shifts().items()):
        assert s == (dy + 1) * 3 + (dx + 1)
        nx = hi(dx) - lo(dx) + 1
        assert len(js) == (hi(dy) - lo(dy) + 1) * nx
        assert js == list(range(first, first + len(js)))
        for k, j in enumerate(js):
            py, px = conv.CO32_PRODUCTS[j][2:4]
            assert py * 2 + px == (lo(dy) + k // nx) * 2 + lo(dx) + k % nx
        first += len(js)
    # shift (0, 0) reads every parity: the kernel issues it first, and its
    # products start the tile's sums (scale-d 0)
    assert sorted(conv.CO32_PRODUCTS[j][2] * 2 + conv.CO32_PRODUCTS[j][3]
                  for j in _shifts()[(0, 0)]) == [0, 1, 2, 3]
    assert [len(js) for js in _shifts().values()] == [1, 2, 1, 2, 4, 2, 1,
                                                      2, 1]


@pytest.mark.parametrize("co", [32, 96])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_staged_weights_are_the_combined_weights_as_they_lie(co, dtype):
    """wc [16][Cin][Co] as the combine kernel leaves it, read by the
    kernel's TMA boxes (64 ci × 32 co at column n0, product j's row block)
    and laid out in the 64-byte swizzle, then read back through the
    N-major descriptor (8 k-rows 512 bytes apart, k16 steps 1024 bytes
    on): combine_upconv_weights' block of each (parity, tap) and column,
    for every wgmma."""
    _, w, _, _ = _inputs((1, 1, 1, 64), co)
    wt = torch.from_numpy(w).to(dtype)
    wc = conv.combine_upconv_weights(wt).float().numpy()
    rows = wc.reshape(16 * 64, co)
    shifts = _shifts()
    for n0 in range(0, co, 32):
        # shared memory as bf16 slots: product j's tile at j * W_TILE bytes
        smem = np.full(16 * W_TILE // 2, np.nan)
        k_, n_ = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
        for j, (_, _, py, px, a, c) in enumerate(conv.CO32_PRODUCTS):
            box = _tma_box(rows, (n0, _tap(py, px, a, c) * 64), (32, 64))
            smem[j * W_TILE // 2 + _swz64(k_, n_)] = box
            np.testing.assert_array_equal(box,
                                          wc[py, px, a, c][:, n0:n0 + 32])
        for js in shifts.values():
            for k16 in range(4):
                for j in js:
                    # the descriptor of product j's B at this k16 step
                    start = j * W_TILE + k16 * 1024
                    kk, nn = np.meshgrid(np.arange(16), np.arange(32),
                                         indexing="ij")
                    lin = start + (kk // 8) * 512 + (kk % 8) * 64
                    # the swizzle follows the address bits: row kk of the
                    # panel sits at `lin`, chunk (nn >> 3) ^ ((lin >> 7) & 3)
                    phys = lin + ((((nn >> 3) ^ ((lin >> 7) & 3)) << 4)
                                  + (nn & 7) * 2)
                    got = smem[phys // 2]
                    _, _, py, px, a, c = conv.CO32_PRODUCTS[j]
                    np.testing.assert_array_equal(
                        got, wc[py, px, a, c][16 * k16:16 * k16 + 16,
                                              n0:n0 + 32])


# ---- the replica against the plain version and the JAX package

# maps the tiles cover: one segment and a few rows at small B, two and
# three segments, one row (every tile starts and ends a run), odd H
COVERED = [((1, 3, 128, 64), 32), ((2, 2, 256, 64), 96),
           ((1, 1, 384, 64), 32), ((2, 5, 128, 64), 32)]


@pytest.mark.parametrize("shape,co", COVERED)
@pytest.mark.parametrize("slots", [conv.CO32_RING, 3])
@pytest.mark.parametrize("sms", [132, 2, 3])
def test_replica_matches_plain_and_jax(shape, co, slots, sms):
    """f32, lrelu with a scale and a shift: the replica (132 blocks: every
    tile its own run on these small maps; 2 and 3: runs of rows across
    image and segment edges; the kernel's ring and the least one its three
    rows a tile need) against the plain version, the Pallas op and the lax
    composition."""
    x, w, s, t = _inputs(shape, co)
    assert conv.co32_covers(shape[-1], co, shape[2])
    wc = conv.combine_upconv_weights(torch.from_numpy(w)).numpy()
    got = _co32_replica(x, wc, s, t, "lrelu", sms, slots)
    assert not np.isnan(got).any(), "every output stored once"
    plain = conv.upconv3x3_plain(*map(torch.from_numpy, (x, w, s, t)),
                                 "lrelu").numpy()
    pallas = np.asarray(jconv.upconv3x3(x, w, s, t, "lrelu"))
    lax = np.asarray(jconv._lax_upconv(x, w, s, t, "lrelu"))
    for ref in (plain, pallas, lax):
        np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape,co", COVERED[:2])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu", "tanh"])
def test_replica_bias_form_matches_jax_bias(shape, co, act):
    """The training path's form: scale 1, the bias as the shift."""
    x, w, _, b = _inputs(shape, co)
    wc = conv.combine_upconv_weights(torch.from_numpy(w)).numpy()
    got = _co32_replica(x, wc, np.ones_like(b), b, act, sms=3)
    ref = np.asarray(jconv.upconv3x3_bias(x, w, b, act))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)
    plain = conv.upconv3x3_bias(*map(torch.from_numpy, (x, w, b)), act)
    np.testing.assert_allclose(got, plain.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("shape,co", COVERED[:2])
@pytest.mark.parametrize("sms", [132, 2])
def test_replica_matches_jax_in_bf16(shape, co, sms):
    """bf16 x and w (the combined taps summed in bf16 as both packages sum
    them), f32 sums, one rounding: against the Pallas op in bf16 and the
    plain version."""
    x, w, s, t = _inputs(shape, co)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    wc = conv.combine_upconv_weights(wb).float().numpy()
    got = torch.from_numpy(_co32_replica(
        xb.float().numpy(), wc, s, t, "lrelu", sms)).float()
    got = got.bfloat16().float().numpy()
    ref = np.asarray(jconv.upconv3x3(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), s, t,
        "lrelu").astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=BF16_ATOL)
    plain = conv.upconv3x3_plain(xb, wb, torch.from_numpy(s),
                                 torch.from_numpy(t), "lrelu")
    np.testing.assert_allclose(got, plain.float().numpy(), rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("b,h,w,sms", [(32, 128, 128, 132), (1, 1, 128, 132),
                                       (2, 5, 256, 3), (3, 7, 128, 4),
                                       (1, 2, 384, 1), (64, 128, 128, 132)])
def test_every_staged_row_is_freed_once_by_each_warpgroup(b, h, w, sms):
    """Each row of the ring is read by up to three tiles of its run; a
    warpgroup frees a row once the last tile that reads it is done, so
    each load gets exactly one arrival from each of the two warpgroups
    (the two its empty barrier counts): the producer never waits on a row
    that no tile frees, nor reuses one a tile still reads."""
    for got in _arrivals(b, h, w, sms):
        assert set(got.values()) == {1}


def test_run_split_takes_every_tile_once_and_fills_the_card():
    """C-PGGAN 256 px at B 32: 4096 tiles over 132 blocks, 31 or 32 rows a
    block; Co 96 takes 44 blocks a column."""
    runs = _runs(32 * 128, 132)
    assert runs[0][0] == 0 and runs[-1][1] == 32 * 128
    assert all(a[1] == b_[0] for a, b_ in zip(runs, runs[1:]))
    assert {t1 - t0 for t0, t1 in runs} == {31, 32}
    assert conv.SM_COUNT // (96 // 32) == 44


# ---- maps the tiles do not cover, the path rule, the plans

UNCOVERED = [((1, 4, 64, 64), 32), ((2, 3, 100, 64), 96),
             ((1, 2, 192, 64), 32), ((1, 2, 128, 128), 32)]


@pytest.mark.parametrize("shape,co", UNCOVERED)
def test_uncovered_maps_keep_pipelined_and_match_jax(shape, co):
    """W not a multiple of 128 (or Cin 128): the mma.sync tile, and on the
    CPU the plain version, against the Pallas op."""
    b, h, w, cin = shape
    assert not conv.co32_covers(cin, co, w)
    assert conv.upconv_path(w, cin, co, BF16) == "pipelined"
    assert smoke.expected_upconv_path(cin, co, BF16, w) == "pipelined"
    x, wt, s, t = _inputs(shape, co)
    got = conv.upconv3x3(*map(torch.from_numpy, (x, wt, s, t)), "relu")
    ref = np.asarray(jconv.upconv3x3(x, wt, s, t, "relu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


RULE = [(co, width, cin) for co in (8, 16, 32, 64, 96, 128)
        for width in (128, 256, 64, 100) for cin in (64, 128)]


@pytest.mark.parametrize("co,width,cin", RULE)
def test_path_rule_mirror(co, width, cin):
    """The Python mirror of csrc/upconv3x3.cu upconv_path: wgmma where Cin
    and Co are multiples of 64; co32 for Cin 64, Co a multiple of 32 but
    not of 64, on maps of whole 128-pixel segments; pipelined for other
    multiples of 8; the FMA tile for f32 and for misaligned tensors."""
    got = conv.upconv_path(width, cin, co, BF16)
    if cin % 64 == 0 and co % 64 == 0:
        want = "wgmma"
    elif cin == 64 and co % 32 == 0 and width % 128 == 0:
        want = "co32"
    else:
        want = "pipelined"
    assert got == want
    assert got == smoke.expected_upconv_path(cin, co, BF16, width)
    assert conv.upconv_path(width, cin, co, BF16, aligned=False) == "tile"
    assert conv.upconv_path(width, cin, co, F32) == "tile"
    assert smoke.expected_upconv_path(cin, co, F32, width) == "tile"
    assert got in conv.UPCONV_PATHS


def test_c_pggan_256_call_takes_co32():
    """The one main-path call of the path: stage 7's 128²×64→32 (lrelu);
    its backward's kernels keep their Hopper paths."""
    assert conv.upconv_path(128, 64, 32, BF16) == "co32"
    assert conv.dx_path(128, 128, 64, 32, BF16) == "wgmma"
    assert conv.dw_path(128, 128, 64, 32, BF16) == "wgmma"
    assert ((32, 128, 128, 64), 32) in smoke.PGGAN_UPCONV_SHAPES


def test_staging_swizzle_is_a_permutation_of_each_512_byte_group():
    """The 64-byte swizzle moves a 16-byte chunk only within its row, and
    rows 2k, 2k+1 of a warp's eight (m, 2m+px) write distinct bank
    groups."""
    r, c = np.meshgrid(np.arange(256), np.arange(32), indexing="ij")
    slots = _swz64(r, c)
    assert sorted(slots.ravel()) == list(range(256 * 32))
    assert (slots // 32 == r).all()


# ---- the Functions' backward at Co 32

@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("bias", [True, False])
def test_function_backward_at_co32_matches_autograd_of_plain(act, bias):
    """upconv3x3_bias / upconv3x3 with gradients (`_UpconvBias` /
    `_Upconv`: the activation's derivative from the saved output, then
    upconv3x3_dx and upconv3x3_dw, their plain versions on the CPU) at a
    map the co32 kernel covers, against autograd through the plain
    version."""
    x, w, s, t = _inputs((1, 2, 128, 64), 32, seed=11)
    g = np.random.default_rng(5).normal(size=(1, 4, 256, 32)).astype(
        np.float32)

    def grads(fn):
        ins = [torch.from_numpy(v).requires_grad_(True)
               for v in ((x, w, t) if bias else (x, w, s, t))]
        out = fn(*ins)
        return [v.numpy() for v in torch.autograd.grad(
            out, ins, torch.from_numpy(g))]
    if bias:
        got = grads(lambda *v: conv.upconv3x3_bias(*v, act))
        ref = grads(lambda x_, w_, t_: conv.upconv3x3_plain(
            x_, w_, torch.ones_like(t_), t_, act))
    else:
        got = grads(lambda *v: conv.upconv3x3(*v, act))
        ref = grads(lambda *v: conv.upconv3x3_plain(*v, act))
    for name, u, v in zip("xwst" if not bias else "xwt", got, ref):
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(u, v, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=f"d/d{name}")
