"""The port's ``upconv3x3`` / ``upconv3x3_bias`` on the CPU: the plain
version (the parity/tap table the CUDA kernel is written from) against the
JAX package's Pallas op in interpret mode — both bodies: whole-image blocks
up to 32×32 and the halo-tiled rows above — and against the lax composition
``conv3x3(upsample2_nearest(x))``; both backwards against ``jax.vjp`` of
that composition; the combined weights; the wrappers' CPU routing and
argument checks.  The CUDA kernel itself is held against the plain version
on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch.ops.kernels import conv

ACTS = ["none", "relu", "lrelu", "tanh"]
# f32: the two packages differ in summation order only (K = 4·Cin ≤ 64)
TOL = 1e-5
# gradients: sums of up to 16·B·H·W products
GRAD_TOL = 1e-4


def _inputs(shape, co, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    s = (rng.normal(size=(co,)) * 0.3 + 1.0).astype(np.float32)
    t = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, s, t


# square and non-square maps, odd H/W, channels off every multiple of 8,
# B = 1; the last has H·W > 1024 (the Pallas halo body)
SHAPES = [((2, 4, 4, 16), 8), ((1, 5, 7, 3), 5), ((3, 6, 3, 12), 20),
          ((2, 8, 8, 8), 3), ((1, 40, 32, 8), 8)]


@pytest.mark.parametrize("shape,co", SHAPES)
@pytest.mark.parametrize("act", ACTS)
def test_upconv_plain_matches_pallas_and_lax(shape, co, act):
    x, w, s, t = _inputs(shape, co)
    got = conv.upconv3x3_plain(*map(torch.from_numpy, (x, w, s, t)), act)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], co)
    pallas = np.asarray(jconv.upconv3x3(x, w, s, t, act))
    lax = np.asarray(jconv._lax_upconv(x, w, s, t, act))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), lax, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co", SHAPES[:3])
@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_upconv_bias_matches_pallas(shape, co, act):
    x, w, _, b = _inputs(shape, co)
    ref = np.asarray(jconv.upconv3x3_bias(x, w, b, act))
    got = conv.upconv3x3_bias(*map(torch.from_numpy, (x, w, b)), act)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_upconv_plain_bf16_matches_pallas():
    """bf16: the combined taps W1+W2 are summed in bf16 in both packages
    (a corner tap is rounded twice), products accumulate in f32 and the
    output is rounded once; what is left is the f32 summation order, which
    can flip one bf16 rounding: 1 ulp = 2^-7 relative."""
    x, w, s, t = _inputs((2, 6, 6, 16), 8)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = np.asarray(jconv.upconv3x3(xb, wb, s, t, "lrelu").astype(jnp.float32))
    got = conv.upconv3x3_plain(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(w).bfloat16(),
                               torch.from_numpy(s), torch.from_numpy(t),
                               "lrelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2**-7, atol=1e-3)
    wc = conv.combine_upconv_weights(torch.from_numpy(w).bfloat16())
    np.testing.assert_array_equal(
        wc.float().numpy(),
        np.asarray(jconv._combine_upconv_weights(wb).astype(jnp.float32)))


def test_combined_weights_match_jax_and_the_tap_table():
    _, w, _, _ = _inputs((1, 2, 2, 5), 7)
    wc = conv.combine_upconv_weights(torch.from_numpy(w))
    assert wc.shape == (2, 2, 2, 2, 5, 7) and wc.is_contiguous()
    np.testing.assert_allclose(
        wc.numpy(), np.asarray(jconv._combine_upconv_weights(w)), rtol=1e-7)
    assert conv.UPCONV_TAPS == jconv._UPCONV_TAPS
    assert conv.UNCOMBINE == jconv._UNCOMBINE
    up = conv.upsample_nearest(torch.arange(12.).reshape(1, 2, 3, 2))
    np.testing.assert_array_equal(
        up.numpy(),
        np.asarray(JL.upsample_nearest(np.arange(12.).reshape(1, 2, 3, 2))))


def _vjp_check(jax_fn, torch_fn, args, seed=0):
    out, vjp = jax.vjp(jax_fn, *args)
    g = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = torch_fn(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               rtol=TOL, atol=TOL)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g))
    for i, (got, ref) in enumerate(zip(grads, ref_grads)):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"grad of argument {i}")


@pytest.mark.parametrize("shape,co", SHAPES[:4])
@pytest.mark.parametrize("act", ACTS)
def test_upconv_backward_matches_jax_vjp(shape, co, act):
    """dx, dw, dscale, dshift against the VJP of the lax composition (the
    parity adjoints materialise no upsampled tensor; tanh recomputes)."""
    x, w, s, t = _inputs(shape, co)
    _vjp_check(lambda *a: jconv._lax_upconv(*a, act),
               lambda *a: conv.upconv3x3(*a, act), (x, w, s, t))


@pytest.mark.parametrize("shape,co", SHAPES[:4])
@pytest.mark.parametrize("act", ["none", "relu"])
def test_upconv_bias_backward_matches_jax_vjp(shape, co, act):
    x, w, _, b = _inputs(shape, co)
    ones = np.ones(co, np.float32)
    _vjp_check(lambda x_, w_, b_: jconv._lax_upconv(x_, w_, ones, b_, act),
               lambda *a: conv.upconv3x3_bias(*a, act), (x, w, b))


def test_upconv_backward_matches_the_pallas_ops_own_vjp():
    """And against the custom VJP the JAX package ships (`_upconv_bwd`)."""
    x, w, s, t = _inputs((2, 4, 6, 8), 8)
    _vjp_check(lambda *a: jconv.upconv3x3(*a, "lrelu"),
               lambda *a: conv.upconv3x3(*a, "lrelu"), (x, w, s, t))


def test_upconv_wrappers_take_plain_version_on_cpu_and_check():
    x, w, s, t = map(torch.from_numpy, _inputs((2, 4, 4, 8), 6))
    before = conv.upconv3x3.launches
    torch.testing.assert_close(conv.upconv3x3(x, w, s, t, "tanh"),
                               conv.upconv3x3_plain(x, w, s, t, "tanh"),
                               rtol=0, atol=0)
    torch.testing.assert_close(conv.upconv3x3_bias(x, w, t, "relu"),
                               conv.upconv3x3_plain(x, w, torch.ones(6), t,
                                                    "relu"), rtol=0, atol=0)
    assert conv.upconv3x3.launches == before
    conv._upconv_check(x, w, s, t, "relu")
    with pytest.raises(ValueError):                       # a 5×5 kernel
        conv._upconv_check(x, torch.zeros(5, 5, 8, 6), s, t, "relu")
    with pytest.raises(TypeError):
        conv._upconv_check(x, w.bfloat16(), s, t, "relu")
    with pytest.raises(ValueError):
        conv._upconv_check(x.transpose(1, 2), w, s, t, "relu")
    with pytest.raises(ValueError):
        conv._upconv_check(x, w, s[:3], t, "relu")
    with pytest.raises(ValueError):
        conv._upconv_check(x, w, s, t, "gelu")
    # the kernels' only 32-bit extent is the GEMM's row count: the largest
    # main-path calls fit (Stage-II's last up-block, the 256 px D's first
    # down-block over three streams of 64), 2^31 rows do not
    meta = dict(device="meta")
    v64 = torch.zeros(64, **meta)
    conv._upconv_check(torch.zeros(64, 128, 128, 64, **meta),
                       torch.zeros(3, 3, 64, 64, **meta), v64, v64, "none")
    conv._conv_check(torch.zeros(192, 256, 256, 3, **meta),
                     torch.zeros(5, 5, 3, 64, **meta), v64, "lrelu")
    v1 = torch.zeros(1, **meta)
    with pytest.raises(ValueError, match="int32"):
        conv._upconv_check(torch.zeros(2**15, 256, 256, 1, **meta),
                           torch.zeros(3, 3, 1, 1, **meta), v1, v1, "none")
    with pytest.raises(ValueError, match="int32"):
        conv._conv_check(torch.zeros(2**15, 512, 512, 1, **meta),
                         torch.zeros(5, 5, 1, 1, **meta), v1, "none")
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.upconv3x3(torch.zeros(1, 2, 2, 64, **meta),
                       torch.zeros(3, 3, 64, 64, **meta), v64, v64)


# --- the space-to-depth form (plain torch on both sides, no kernel) --------

S2D_SHAPES = [((2, 4, 4, 16), 8), ((3, 8, 8, 8), 16), ((2, 5, 7, 4), 8)]


@pytest.mark.parametrize("shape,co", S2D_SHAPES)
@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
def test_upconv_s2d_matches_jax_and_the_plain_upconv(shape, co, act):
    """`upconv3x3_s2d` against JAX's `upconv3x3_s2d` and against the
    port's plain `upconv3x3` (the forms of tests/test_pallas_conv.py)."""
    x, w, s, t = _inputs(shape, co)
    got = conv.upconv3x3_s2d(*map(torch.from_numpy, (x, w, s, t)), act)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], co)
    ref = np.asarray(jconv.upconv3x3_s2d(x, w, s, t, act))
    plain = conv.upconv3x3_plain(*map(torch.from_numpy, (x, w, s, t)), act)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_upconv_s2d_weights_match_jax():
    _, w, _, _ = _inputs((1, 2, 2, 5), 3)
    np.testing.assert_allclose(
        conv.s2d_upconv_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jconv._s2d_upconv_weights(w)), rtol=0, atol=1e-7)


def test_upconv_s2d_gradients_match_jax_and_the_plain_upconv():
    """Every gradient (x, w, scale, shift) through the space-to-depth
    weights against ``jax.grad`` of JAX's `upconv3x3_s2d` and against
    autograd through the port's plain `upconv3x3`."""
    x, w, s, t = _inputs((2, 4, 4, 8), 8)
    ct = np.random.default_rng(2).normal(size=(2, 8, 8, 8)).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(jconv.upconv3x3_s2d(*a, "relu") * ct),
                   argnums=(0, 1, 2, 3))(x, w, s, t)
    grads = []
    for fn in (conv.upconv3x3_s2d, conv.upconv3x3_plain):
        args = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, s, t)]
        (fn(*args, "relu") * torch.from_numpy(ct)).sum().backward()
        grads.append([a.grad.numpy() for a in args])
    for name, got, plain, want in zip("xwst", *grads, ref):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d/d{name} vs JAX")
        np.testing.assert_allclose(got, plain, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d/d{name} vs plain")


def test_upconv_s2d_bias_matches_jax():
    x, w, _, b = _inputs((2, 6, 6, 8), 8)
    got = conv.upconv3x3_s2d_bias(*map(torch.from_numpy, (x, w, b)), "lrelu")
    ref = np.asarray(jconv.upconv3x3_s2d_bias(x, w, b, "lrelu"))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
