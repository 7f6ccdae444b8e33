"""The backward of the two 5×5 stride-2 ops on the CPU: the plain version of
the weight-gradient kernel ``conv5x5_s2_dw`` and the input-gradient
formulas (the conv's dx through the transposed conv, the transposed conv's
through the conv) against the JAX package's ``_conv_bwd`` (``jax.vjp`` of
``_lax_conv_s2``) and ``_deconv_bwd`` (``jax.vjp`` of ``deconv5x5_s2``,
whose custom VJP runs in interpret mode here); both autograd Functions'
backwards against the same at even and odd maps, 3-channel layers and every
activation; the WGAN-CLS gradient penalty's parameter gradient against the
JAX package's with every library convolution made to raise; a numpy replica
of the wgmma path's parity planes; the path, plan and chunk mirrors; the
wrapper's routing and checks.  The kernel itself runs on the card only
(``chip_smoke.py`` phase 3c holds it against this plain version there)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.models import losses as jlosses
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.models import gancls as tgancls
from text_to_image_tpu_torch.models import losses as tlosses
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.ops.kernels import conv
from text_to_image_tpu_torch.train.optim import flatten

ACTS = ["none", "relu", "lrelu", "tanh"]
# f32: the same products summed in another order, held against each
# gradient's largest element
TOL = 1e-5
# bf16 inputs: both packages sum in f32 and round each gradient once, but
# JAX's vjp of the bf16 lax conv rounds the conv output and its cotangent at
# other places than the port (which rounds g·act′ once): a rounding flip of
# 2^-8 of an element, held against the largest
BF16_TOL = 2**-6

# (B, H, W, Cin) → Co: even and odd maps, a 3-channel input (the RGB
# layer) and output, ragged channels, B = 1
CONV_SHAPES = [((2, 8, 8, 3), 8), ((2, 6, 10, 5), 12), ((1, 5, 7, 4), 6),
               ((2, 9, 6, 8), 3), ((3, 4, 4, 16), 16)]
DECONV_SHAPES = [((2, 4, 4, 16), 8), ((2, 5, 7, 4), 8), ((2, 8, 8, 8), 3),
                 ((1, 3, 5, 3), 6)]


def _rng(seed):
    return np.random.default_rng(seed)


def _conv_inputs(shape, co, seed=7):
    rng = _rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, shape[-1], co)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, b


def _deconv_inputs(shape, co, seed=7):
    rng = _rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, shape[-1], co)) * 0.1).astype(np.float32)
    s = (rng.normal(size=(co,)) * 0.3 + 1.0).astype(np.float32)
    t = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, s, t


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


def _even(shape):
    return shape[1] % 2 == 0 and shape[2] % 2 == 0


def _jax_conv(act, shape):
    """The JAX conv whose backward is `_conv_bwd`: the Pallas op (interpret
    mode) on even maps; on odd maps, which the Pallas body does not take,
    `_lax_conv_s2`, the function `_conv_bwd` differentiates."""
    if _even(shape):
        return lambda x, w, b: jconv.conv5x5_s2_act(x, w, b, act)
    return lambda x, w, b: jconv._lax_conv_s2(x, w, b, act)


# --- the formulas: dx through the other op, dw through the plain kernel ------

@pytest.mark.parametrize("shape,co", CONV_SHAPES)
def test_conv_dx_and_dw_formulas_match_jax_conv_bwd(shape, co):
    """For the conv's cotangent gc: dx = the transposed conv of gc with w
    flipped and transposed (rows 1..H on odd maps), dw = conv5x5_s2_dw."""
    x, w, _ = _conv_inputs(shape, co)
    zero = np.zeros(co, np.float32)
    y, vjp = jax.vjp(lambda x_, w_: jconv._lax_conv_s2(x_, w_, zero, "none"),
                     x, w)
    gc = _rng(1).normal(size=y.shape).astype(np.float32)
    ref_dx, ref_dw = vjp(jnp.asarray(gc))
    tx, tw, tg = map(torch.from_numpy, (x, w, gc))
    _close(conv.conv_dx(tg, tw, shape[1], shape[2]), ref_dx, f"dx {shape}")
    _close(conv.conv5x5_s2_dw_plain(tx, tg, torch.float32), ref_dw,
           f"dw {shape}")


@pytest.mark.parametrize("shape,co", DECONV_SHAPES)
def test_deconv_dx_and_dw_formulas_match_jax_deconv_bwd(shape, co):
    """For the transposed conv's cotangent d: dx = conv5x5_s2 of d with w
    flipped and transposed, dw = conv5x5_s2_dw with d as its map and x as
    its cotangent, flipped and transposed back."""
    x, w, _, _ = _deconv_inputs(shape, co)
    ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
    y, vjp = jax.vjp(lambda x_, w_: jconv.deconv5x5_s2(x_, w_, ones, zeros,
                                                       "none"), x, w)
    d = _rng(2).normal(size=y.shape).astype(np.float32)
    ref_dx, ref_dw = vjp(jnp.asarray(d))
    tx, tw, td = map(torch.from_numpy, (x, w, d))
    wc = conv.deconv_dx_weight(tw)
    dx = conv.conv5x5_s2_act_plain(td, wc, torch.zeros(shape[-1]), "none")
    _close(dx, ref_dx, f"dx {shape}")
    dw = conv.deconv_dx_weight(conv.conv5x5_s2_dw_plain(td, tx,
                                                        torch.float32))
    _close(dw, ref_dw, f"dw {shape}")


def test_deconv_dx_weight_is_the_flip_of_conv_transpose():
    """Wc[kh, kw, co, ci] = w[4−kh, 4−kw, ci, co], and applying it twice
    gives w back."""
    w = torch.from_numpy(_rng(3).normal(size=(5, 5, 3, 4)).astype(np.float32))
    wc = conv.deconv_dx_weight(w)
    assert wc.shape == (5, 5, 4, 3) and wc.is_contiguous()
    for kh, kw, ci, co in [(0, 0, 0, 0), (1, 3, 2, 1), (4, 2, 1, 3)]:
        assert wc[kh, kw, co, ci] == w[4 - kh, 4 - kw, ci, co]
    assert torch.equal(conv.deconv_dx_weight(wc), w)


@pytest.mark.parametrize("shape,co", DECONV_SHAPES)
def test_plain_dw_in_the_deconv_layout(shape, co):
    """`flip`: the weight-gradient's plain version writes the transposed
    conv's own layout, bit for bit `deconv_dx_weight` of the conv layout,
    and within 1e-5 of the largest element of JAX `_deconv_bwd`'s dw (even
    and odd maps, 3-channel inputs and outputs)."""
    x, w, _, _ = _deconv_inputs(shape, co, seed=31)
    ones, zeros = np.ones(co, np.float32), np.zeros(co, np.float32)
    y, vjp = jax.vjp(lambda w_: jconv.deconv5x5_s2(x, w_, ones, zeros,
                                                   "none"), w)
    d = _rng(32).normal(size=y.shape).astype(np.float32)
    ref_dw, = vjp(jnp.asarray(d))
    tx, td = torch.from_numpy(x), torch.from_numpy(d)
    got = conv.conv5x5_s2_dw_plain(td, tx, torch.float32, flip=True)
    assert got.shape == (5, 5, shape[-1], co) and got.is_contiguous()
    assert torch.equal(got, conv.deconv_dx_weight(
        conv.conv5x5_s2_dw_plain(td, tx, torch.float32)))
    _close(got, ref_dw, f"flipped dw {shape}")
    assert torch.equal(conv.conv5x5_s2_dw(td, tx, torch.float32, True), got)


def test_deconv_backward_asks_for_dw_in_its_own_layout(monkeypatch):
    """`_Deconv.backward` has the weight-gradient kernel write dw flipped
    and returns it as it comes: no copy of dw (the copy of w for dx
    stays)."""
    seen = []
    real = conv.conv5x5_s2_dw

    def spy(x, g, w_dtype, flip=False):
        out = real(x, g, w_dtype, flip)
        seen.append((flip, out.data_ptr()))
        return out
    monkeypatch.setattr(conv, "conv5x5_s2_dw", spy)
    x, w, s_, t = map(torch.from_numpy, _deconv_inputs((2, 4, 4, 8), 6,
                                                       seed=33))
    w.requires_grad_(True)
    y = conv.deconv5x5_s2(x, w, s_, t, "relu")
    gw, = torch.autograd.grad(y.sum(), w)
    assert [f for f, _ in seen] == [True]
    assert gw.data_ptr() == seen[0][1]


def test_dw_function_backward_in_the_deconv_layout(monkeypatch):
    """`_ConvDw` with `flip` (the transposed conv's dw on the card, which
    WGAN-CLS's gradient penalty differentiates again), its launch swapped
    for the plain version: its backward turns the cotangent back to the
    conv's layout, against autograd through the plain flipped version."""
    monkeypatch.setattr(conv, "_conv_dw_forward", conv.conv5x5_s2_dw_plain)
    for seed, shape, co in ((34, (2, 7, 6, 4), 5), (35, (2, 8, 8, 3), 6)):
        x, _, _ = map(torch.from_numpy, _conv_inputs(shape, co, seed=seed))
        ho, wo = conv.same_pads(shape[1])[0], conv.same_pads(shape[2])[0]
        g = torch.from_numpy(_rng(seed).normal(
            size=(shape[0], ho, wo, co)).astype(np.float32))
        c = torch.from_numpy(_rng(seed + 1).normal(
            size=(5, 5, co, shape[-1])).astype(np.float32))
        ins = [x.requires_grad_(True), g.requires_grad_(True)]
        got = torch.autograd.grad(
            conv._ConvDw.apply(*ins, torch.float32, True), ins, c)
        want = torch.autograd.grad(
            conv.conv5x5_s2_dw_plain(*ins, torch.float32, True), ins, c)
        for name, u, v in zip(("d/dx", "d/dg"), got, want):
            _close(u, v.numpy(), f"flipped {name} {shape}")


# --- the two Functions' backwards against jax.vjp ----------------------------

def _vjp_check(jax_fn, torch_fn, args, what, seed=0, dtype=torch.float32,
               tol=TOL):
    out, vjp = jax.vjp(jax_fn, *args)
    g = _rng(seed).normal(size=out.shape).astype(np.float32)
    jg = jnp.asarray(g, out.dtype)
    refs = vjp(jg)
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(
        dtype if i < 2 else torch.float32).requires_grad_(True)
        for i, a in enumerate(args)]
    y = torch_fn(*targs)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g).to(y.dtype))
    for i, (got, ref) in enumerate(zip(grads, refs)):
        _close(got, np.asarray(jnp.asarray(ref, jnp.float32)),
               f"{what} d/d arg{i}", tol)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,co", CONV_SHAPES)
def test_conv_backward_matches_jax(shape, co, act):
    x, w, b = _conv_inputs(shape, co, seed=11)
    _vjp_check(_jax_conv(act, shape),
               lambda *a: conv.conv5x5_s2_act(*a, act), (x, w, b),
               f"conv {shape}->{co} {act}")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,co", DECONV_SHAPES)
def test_deconv_backward_matches_jax(shape, co, act):
    x, w, s, t = _deconv_inputs(shape, co, seed=12)
    _vjp_check(lambda *a: jconv.deconv5x5_s2(*a, act),
               lambda *a: conv.deconv5x5_s2(*a, act), (x, w, s, t),
               f"deconv {shape}->{co} {act}")


@pytest.mark.parametrize("op", ["conv", "deconv"])
def test_bf16_backwards_match_jax_in_bf16(op):
    """bf16 inputs and cotangent: f32 sums in both, each gradient rounded
    once (BF16_TOL)."""
    if op == "conv":
        shape, co = (2, 8, 8, 16), 8
        x, w, b = _conv_inputs(shape, co, seed=13)
        args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                b)
        _vjp_check(lambda *a: jconv.conv5x5_s2_act(*a, "lrelu"),
                   lambda *a: conv.conv5x5_s2_act(*a, "lrelu"), args,
                   "conv bf16", dtype=torch.bfloat16, tol=BF16_TOL)
    else:
        shape, co = (2, 4, 4, 16), 8
        x, w, s, t = _deconv_inputs(shape, co, seed=14)
        args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                s, t)
        _vjp_check(lambda *a: jconv.deconv5x5_s2(*a, "relu"),
                   lambda *a: conv.deconv5x5_s2(*a, "relu"), args,
                   "deconv bf16", dtype=torch.bfloat16, tol=BF16_TOL)


@pytest.fixture
def no_library_convolution(monkeypatch):
    """Every library convolution the old backwards called made to raise."""
    def refuse(*a, **k):
        raise AssertionError("a library convolution was called")
    for mod, name in ((conv.F, "conv2d"), (conv.F, "conv_transpose2d"),
                      (torch.nn.grad, "conv2d_input"),
                      (torch.nn.grad, "conv2d_weight")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_backwards_reach_no_library_convolution(act, no_library_convolution):
    """Both Functions' backwards, first and second order, go through the
    port's three kernels' wrappers alone (their plain versions here)."""
    x, w, b = map(torch.from_numpy, _conv_inputs((2, 7, 6, 4), 5, seed=15))
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = conv.conv5x5_s2_act(x, w, b, act)
    gx, = torch.autograd.grad(y.sum(), x, create_graph=True)
    assert all(v is not None for v in torch.autograd.grad(
        (gx**2).sum(), [w], allow_unused=True))
    xd, wd, s, t = map(torch.from_numpy, _deconv_inputs((2, 3, 5, 4), 6))
    xd.requires_grad_(True)
    wd.requires_grad_(True)
    yd = conv.deconv5x5_s2(xd, wd, s, t, act)
    gxd, = torch.autograd.grad(yd.sum(), xd, create_graph=True)
    assert torch.autograd.grad((gxd**2).sum(), wd)[0].abs().sum() > 0


@pytest.fixture
def counted_dx(monkeypatch):
    """Calls of conv5x5_s2_dx's plain version (what its wrapper and its
    Function run on the CPU), counted."""
    calls = []
    plain = conv.conv5x5_s2_dx_plain

    def counted(*a):
        calls.append(tuple(a[0].shape))
        return plain(*a)
    monkeypatch.setattr(conv, "conv5x5_s2_dx_plain", counted)
    return calls


def _deep(seed, shape=(1, 8, 6, 64), co=64):
    """A deep bf16 conv (Cin and Co multiples of 64): conv_dx's route is
    conv5x5_s2_dx there."""
    x, w, b = map(torch.from_numpy, _conv_inputs(shape, co, seed=seed))
    assert conv.conv_dx_path(shape[-1], co, torch.bfloat16) == "wgmma"
    return x.bfloat16(), w.bfloat16(), b


def test_conv_backward_sends_the_deep_dx_through_its_kernel(
        counted_dx, no_library_convolution):
    """`_Conv.backward` at a deep bf16 shape: dx through conv5x5_s2_dx
    (no flipped copy, no deconv), at first order and, through `_ConvDx`,
    at second order, with no library convolution anywhere."""
    x, w, b = _deep(31)
    x.requires_grad_(True)
    w.requires_grad_(True)
    before = conv.deconv5x5_s2.launches
    y = conv.conv5x5_s2_act(x, w, b, "lrelu")
    gx, = torch.autograd.grad(y.float().sum(), x, create_graph=True)
    assert counted_dx == [(1, 4, 3, 64)]
    gw, = torch.autograd.grad((gx.float()**2).sum(), w)
    assert gw.abs().sum() > 0
    assert counted_dx == [(1, 4, 3, 64)]      # its backward: conv and dw
    assert conv.deconv5x5_s2.launches == before
    # without a graph the Function is not recorded: the wrapper alone
    x2 = x.detach().requires_grad_(True)
    torch.autograd.grad(conv.conv5x5_s2_act(x2, w.detach(), b, "none").sum(),
                        x2)
    assert len(counted_dx) == 2


def test_dw_backward_sends_the_deep_dx_through_its_kernel(
        monkeypatch, counted_dx, no_library_convolution):
    """`_ConvDw.backward` (the GP's second order; what a CUDA call records,
    its launch swapped for the plain version): the conv's dx of g with the
    cotangent as its weight on conv5x5_s2_dx at a deep bf16 shape, and its
    own second order through `_ConvDx`."""
    monkeypatch.setattr(conv, "_conv_dw_forward", conv.conv5x5_s2_dw_plain)
    x, _, _ = _deep(32)
    g = torch.from_numpy(_rng(33).normal(size=(1, 4, 3, 64)).astype(
        np.float32)).bfloat16()
    x.requires_grad_(True)
    g.requires_grad_(True)
    dw = conv._ConvDw.apply(x, g, torch.bfloat16)
    c = torch.from_numpy(_rng(34).normal(size=dw.shape).astype(
        np.float32)).bfloat16()
    gx, gg = torch.autograd.grad(dw, [x, g], c, create_graph=True)
    assert counted_dx == [(1, 4, 3, 64)]
    second = torch.autograd.grad((gx.float()**2).sum(), [g])
    assert second[0].abs().sum() > 0
    assert len(counted_dx) == 1               # its backward: conv and dw
    _close(gx, conv.conv5x5_s2_dx_plain(g.detach(), c, 8, 6).float(),
           "d/dx", BF16_TOL)


@pytest.fixture
def counted_ddx(monkeypatch):
    """Calls of deconv5x5_s2_dx's plain version (what its wrapper and its
    Function run on the CPU) and of the conv's (the old route of the
    deconv's dx), counted."""
    calls = {"deconv5x5_s2_dx": [], "conv5x5_s2_act": []}
    for name, key in (("deconv5x5_s2_dx_plain", "deconv5x5_s2_dx"),
                      ("conv5x5_s2_act_plain", "conv5x5_s2_act")):
        plain = getattr(conv, name)

        def counted(*a, plain=plain, key=key):
            calls[key].append(tuple(a[0].shape))
            return plain(*a)
        monkeypatch.setattr(conv, name, counted)
    return calls


@pytest.mark.parametrize("co,act", [(64, "relu"), (3, "tanh")])
def test_deconv_backward_sends_the_bf16_dx_through_its_kernel(
        counted_ddx, no_library_convolution, co, act):
    """`_Deconv.backward` at a deep bf16 shape (Cin and Co multiples of
    64: the ring) and at the RGB layer's Co 3 (the thin path): dx through
    deconv5x5_s2_dx (no flipped copy, no zero bias, no conv), at first
    order and, through `_DeconvDx`, at second order (the transposed conv
    and conv5x5_s2_dw), with no library convolution anywhere."""
    x, w, s, t = map(torch.from_numpy, _deconv_inputs((1, 4, 3, 64), co,
                                                      seed=35))
    assert conv.deconv_dx_path(64, co, torch.bfloat16) == (
        "ring" if co == 64 else "thin")
    x = x.bfloat16().requires_grad_(True)
    w = w.bfloat16().requires_grad_(True)
    y = conv.deconv5x5_s2(x, w, s, t, act)
    gx, = torch.autograd.grad(y.float().sum(), x, create_graph=True)
    assert counted_ddx["deconv5x5_s2_dx"] == [(1, 8, 6, co)]
    gw, = torch.autograd.grad((gx.float()**2).sum(), w)
    assert gw.abs().sum() > 0
    # tanh's derivative depends on y: the second order runs the deconv's
    # backward once more, its dx on the kernel again
    assert set(counted_ddx["deconv5x5_s2_dx"]) == {(1, 8, 6, co)}
    assert counted_ddx["conv5x5_s2_act"] == []
    _close(gx, conv.deconv5x5_s2_dx_plain(
        (conv.act_grad_from_output(act, y.detach()) * s).bfloat16(),
        w.detach()).float(), "d/dx", BF16_TOL)


# --- the WGAN-CLS gradient penalty ---------------------------------------------

RES = 16
GAN = tiny_config("wgancls").gan


@pytest.fixture(scope="module")
def critic():
    params, _ = jax.device_get(jgancls.discriminator_init(
        jax.random.PRNGKey(5), GAN, RES, norm="layer"))
    rng = _rng(9)
    xs = rng.uniform(-1, 1, (2, 3, RES, RES, 3)).astype(np.float32)
    emb = rng.normal(size=(3, GAN.embed_dim)).astype(np.float32)
    eps = rng.uniform(size=(3, 1, 1, 1)).astype(np.float32)
    return types.SimpleNamespace(params=params, xs=xs, emb=emb, eps=eps)


def test_gradient_penalty_gradient_matches_jax(critic, no_library_convolution):
    """The penalty's gradient in every critic parameter: its inner gradient
    through the conv's backward (dx by the transposed conv), then that
    backward differentiated (the transposed conv's backward: the conv and
    the weight-gradient kernel), no library convolution anywhere; 1e-4 of
    the JAX package's largest element of each leaf (tests/test_torch_wgan's
    TOL: the layer norm's sums too)."""
    real, fake = critic.xs

    def jgp(params):
        def on_images(x):
            return jgancls.discriminator_apply(
                params, {}, x, critic.emb, True, JL.FP32, RES,
                norm="layer")[0]
        return jlosses.gradient_penalty(on_images, real, fake, critic.eps)

    ref, ref_grads = jax.value_and_grad(jgp)(critic.params)
    p, _ = convert.from_jax_discriminator(critic.params, {}, "cpu")
    names = [n for n, _ in flatten(p)]
    leaves = [v.requires_grad_(True) for _, v in flatten(p)]

    def on_images(x):
        return tgancls.discriminator_apply(p, {}, x, torch.from_numpy(
            critic.emb), True, TL.FP32, RES, norm="layer")[0]

    got = tlosses.gradient_penalty(on_images, torch.from_numpy(real),
                                   torch.from_numpy(fake),
                                   torch.from_numpy(critic.eps))
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    want = dict(flatten(jax.device_get(ref_grads)))
    for name, leaf, g in zip(names, leaves, grads):
        g = torch.zeros_like(leaf) if g is None else g
        _close(g, want[name], f"d gp / d {name}", 1e-4)


# --- the wgmma path's parity planes, in numpy ---------------------------------

@pytest.mark.parametrize("h,w", [(8, 8), (4, 12), (6, 2)])
def test_parity_plane_view_is_the_padded_tap(h, w):
    """csrc/conv5x5_s2_bwd.cu's wgmma path on an even map: tap (kh, kw)
    reads x viewed as [B][H/2][2][W/2][2·Cin] at plane (rh, rw), shifted by
    (qh, qw), with kh − pt = 2·qh + rh, zeros outside (the tensor map's
    fill): the same pixels as the SAME-padded tap view.  The taps fall in
    parity groups of 9, 6, 6 and 4."""
    b, ci = 2, 3
    x = _rng(16).normal(size=(b, h, w, ci))
    ho, pt, pb = conv.same_pads(h)
    wo, pl, pr = conv.same_pads(w)
    assert (pt, pl) == (1, 1)
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    view = x.reshape(b, h // 2, 2, w // 2, 2 * ci)
    groups = {}
    for kh in range(5):
        for kw in range(5):
            eh, ew = kh - pt, kw - pl
            rh, rw = eh % 2, ew % 2
            qh, qw = (eh - rh) // 2, (ew - rw) // 2
            groups.setdefault((rh, rw), []).append((kh, kw))
            got = np.zeros((b, ho, wo, ci))
            for m in range(ho):
                for n in range(wo):
                    if 0 <= m + qh < h // 2 and 0 <= n + qw < w // 2:
                        got[:, m, n] = view[:, m + qh, rh, n + qw,
                                            rw * ci:(rw + 1) * ci]
            want = xp[:, kh:kh + 2 * ho - 1:2, kw:kw + 2 * wo - 1:2]
            np.testing.assert_array_equal(got, want)
    assert sorted(len(v) for v in groups.values()) == [4, 6, 6, 9]
    assert len(groups[(1, 1)]) == 9


# --- the path, plan and chunk mirrors -----------------------------------------

@pytest.mark.parametrize("hw,cin,co,dtype,aligned,path", [
    ((32, 32), 64, 128, torch.bfloat16, True, "wgmma"),
    ((8, 8), 512, 1024, torch.bfloat16, True, "wgmma"),
    ((256, 256), 3, 64, torch.bfloat16, True, "mma"),
    ((64, 64), 3, 128, torch.bfloat16, True, "mma"),
    ((9, 7), 4, 64, torch.bfloat16, True, "mma"),
    ((8, 8), 5, 64, torch.bfloat16, True, "tile"),
    ((8, 8), 3, 12, torch.bfloat16, True, "tile"),
    ((9, 7), 64, 64, torch.bfloat16, True, "mma"),
    ((10, 6), 128, 192, torch.bfloat16, True, "mma"),
    ((8, 48), 64, 64, torch.bfloat16, True, "mma"),
    ((8, 8), 16, 8, torch.bfloat16, True, "mma"),
    ((8, 8), 12, 20, torch.bfloat16, True, "tile"),
    ((8, 8), 64, 64, torch.bfloat16, False, "tile"),
    ((8, 8), 64, 64, torch.float32, True, "tile")])
def test_conv_dw_path_mirrors_the_kernel(hw, cin, co, dtype, aligned, path):
    """wgmma: bf16, Cin and Co multiples of 64, an even map whose half has
    a TMA box; mma.sync: bf16, Co a multiple of 8 and Cin one too or at
    most 4 (the RGB layers); else the FMA tile (f32, ragged channels)."""
    h, w = hw
    assert conv.conv_dw_path(h, w, cin, co, dtype, aligned) == path
    plan = conv.conv_dw_plan(8, h, w, cin, co, dtype, aligned)
    assert (plan.tile_m, plan.tile_n) == (
        (128 if cin % 128 == 0 else 64, 128 if co % 128 == 0 else 64)
        if path == "wgmma" else (64, 64))
    assert plan.chunk == cin


# (B, H, W, Cin, Co) of every conv5x5_s2_dw call on the training paths: the
# 64 px D at 3·64 and 64 rows (the conv's own), the 256 px D, the GAN-CLS
# generator's deconvs (their d as the map, x's channels as Co)
MAIN_CALLS = ([(b, 64, 64, 3, 64) for b in (192, 64)]
              + [(b, r, r, c, 2 * c) for b in (192, 64)
                 for r, c in ((32, 64), (16, 128), (8, 256))]
              + [(b, 256, 256, 3, 64) for b in (192, 64)]
              + [(b, r, r, cin, co) for b in (192, 64)
                 for r, cin, co in ((128, 64, 128), (64, 128, 256),
                                    (32, 256, 512), (16, 512, 512),
                                    (8, 512, 512))]
              + [(64, 8, 8, 512, 1024), (64, 16, 16, 256, 512),
                 (64, 32, 32, 128, 256), (64, 64, 64, 3, 128)])


@pytest.mark.parametrize("b,h,w,cin,co", MAIN_CALLS)
def test_conv_dw_plan_fills_the_card_within_the_cap(b, h, w, cin, co):
    """The wgmma kernel: at K of at least DW_LONG_SLICES slices where
    DW_WS_PARTS parts make at most DW_TARGET_CTAS["apart"] CTAs, that many
    parts apart (no cluster) through a workspace under CONV_WS_CAP; else a
    power of two of parts of at least DW_MIN_SLICES slices each, all in one
    cluster (no workspace), the most whose CTAs stay within
    DW_TARGET_CTAS["conv"].  The RGB layers' mma path: towards
    DW_TARGET_CTAS["latency"], clusters of 8, the clusters' sums through a
    workspace under CONV_WS_CAP."""
    bf16 = torch.bfloat16
    plan = conv.conv_dw_plan(b, h, w, cin, co, bf16)
    path = conv.conv_dw_path(h, w, cin, co, bf16)
    assert path == ("mma" if cin == 3 else "wgmma")
    k = b * (h // 2) * (w // 2)
    slices = -(-k // conv.DW_SLICE[path])
    ctas = -(-25 * cin // plan.tile_m) * -(-co // plan.tile_n)
    assert plan.chunk == cin and plan.parts % plan.cluster == 0
    assert plan.cluster <= conv.DW_MAX_CLUSTER and not plan.fold
    assert plan.parts == 1 or slices // plan.parts >= conv.DW_MIN_SLICES
    apart = (slices >= conv.DW_LONG_SLICES
             and slices // conv.DW_MIN_SLICES >= conv.DW_WS_PARTS
             and ctas * conv.DW_WS_PARTS <= conv.DW_TARGET_CTAS["apart"])
    if path == "wgmma" and apart:
        assert (plan.parts, plan.cluster) == (conv.DW_WS_PARTS, 1)
        ws = conv.plan_ws_elems(plan, co, 25)
        assert ws == conv.DW_WS_PARTS * 25 * cin * co
        assert ws * 4 <= conv.CONV_WS_CAP
    elif path == "wgmma":
        top = conv.DW_MAX_CLUSTER
        assert plan.parts == plan.cluster <= top
        assert plan.parts & (plan.parts - 1) == 0
        assert plan.parts == 1 or (ctas * plan.parts
                                   <= conv.DW_TARGET_CTAS["conv"])
        assert (2 * plan.parts > min(top, slices // conv.DW_MIN_SLICES)
                or 2 * ctas * plan.parts > conv.DW_TARGET_CTAS["conv"])
        assert conv.plan_ws_elems(plan, co, 25) == 0
    else:
        assert plan.cluster == conv.DW_MAX_CLUSTER
        assert ctas * plan.parts <= conv.DW_TARGET_CTAS["latency"]
        assert ctas * (plan.parts + plan.cluster) > conv.DW_TARGET_CTAS[
            "latency"]
        ws = conv.plan_ws_elems(plan, co, 25)
        assert ws == plan.groups * 25 * cin * co and ws * 4 <= \
            conv.CONV_WS_CAP


@pytest.mark.parametrize("what,b,h,w,cin,co,products", [
    # GAN-CLS G's first deconv at gf 256: its dw is conv5x5_s2_dw over d
    # [64,8,8,1024] against x's 2048 channels (one part: 200 MiB)
    ("conv5x5_s2_dw", 64, 8, 8, 1024, 2048, 25),
    # a conv with Cin·Co = 4 M (df 2048 at 4² out)
    ("conv5x5_s2_dw", 64, 8, 8, 2048, 2048, 25),
    # Stage-I's first up-block at gf 256 and at gf 192
    ("upconv3x3_dw", 64, 4, 4, 2048, 1024, 16),
    ("upconv3x3_dw", 64, 4, 4, 1536, 768, 16)])
def test_wgrad_plans_chunk_within_the_cap(what, b, h, w, cin, co, products):
    """Over 1 M Cin·Co one part of every product would be over CONV_WS_CAP
    in a workspace, but these plans sum every part on chip (the conv in one
    cluster, bf16 and f32; the up-block's bf16 fold at these 4² maps): one
    chunk, no workspace.  The up-block's f32 plan (the FMA tile: every
    part's products in a workspace) walks Cin in chunks, each a multiple of
    the tile's rows whose workspace fits, the widest such."""
    plan_of = conv.conv_dw_plan if products == 25 else conv.dw_plan
    assert conv.dw_ws_elems(cin, co, 1, products) * 4 > conv.CONV_WS_CAP
    for dtype in ((torch.bfloat16, torch.float32) if products == 25
                  else (torch.bfloat16,)):
        plan = plan_of(b, h, w, cin, co, dtype)
        assert plan.chunk == cin, dtype
        assert conv.plan_ws_elems(plan, co, products) == 0, dtype
    assert plan_of(b, h, w, cin, co, torch.bfloat16).fold == (products == 16)
    if products == 25:
        return
    plan = plan_of(b, h, w, cin, co, torch.float32)
    planes = plan.groups * products
    assert plan.chunk < cin and plan.chunk % plan.tile_m == 0
    assert cin % plan.tile_m == 0
    ws = conv.plan_ws_elems(plan, co, products)
    assert 0 < ws * 4 <= conv.CONV_WS_CAP
    assert ws == conv.dw_ws_elems(plan.chunk, co, 1, planes)
    assert (conv.dw_ws_elems(plan.chunk + plan.tile_m, co, 1, planes) * 4
            > conv.CONV_WS_CAP)
    assert plan.chunk == conv.wgrad_chunk(cin, co, planes, plan.tile_m)


def test_wgrad_chunk_is_cin_below_the_cap():
    assert conv.wgrad_chunk(512, 1024, 25, 128) == 512
    assert conv.wgrad_chunk(1024, 512, 16, 128) == 1024
    with pytest.raises(ValueError, match="workspace"):
        conv.wgrad_chunk(64, 2**15, 25, 64)


# every up-block call of the training paths (tests/test_torch_upconv_bwd.py
# MAIN_CALLS) as (B, H = W, Cin, Co)
UPCONV_CALLS = [(64, 4, 1024, 512), (64, 8, 512, 256), (64, 16, 256, 128),
                (64, 32, 128, 64), (64, 16, 512, 256), (64, 32, 256, 128),
                (64, 64, 128, 64), (64, 128, 64, 64), (64, 4, 512, 512),
                (64, 8, 512, 512), (32, 64, 128, 64), (32, 128, 64, 32)]
# the main-path calls that keep a workspace: the RGB layers' conv dw (the
# mma path: more parts than a cluster holds, their clusters' taps summed
# by a second launch), the conv dw at long K with few tiles (10 parts
# apart), C-PGGAN's Co 32 up-blocks (the fold's clusters of 4 parts in
# groups) and every up-block on the per-product blocks
CONV_WS_CALLS = [c for c in MAIN_CALLS
                 if c[3] == 3 or (c[0] * c[1] * c[2] // 4 >= 512 * 64
                                  and c[3] <= 128)]
UPCONV_WS_CALLS = [c for c in UPCONV_CALLS if c[1] > 4 or c[0] != 64]


@pytest.mark.parametrize("op,call", [("conv", c) for c in MAIN_CALLS]
                         + [("upconv", c) for c in UPCONV_CALLS])
def test_no_workspace_where_the_parts_fit_a_cluster(op, call):
    """A plan whose parts one cluster holds (at most 8 CTAs: the conv's
    parts, the up-block fold's parts times its two parities) allocates no
    workspace; one that needs more sums each cluster on chip and only the
    clusters through the workspace (the conv's 10 parts apart: clusters of
    one).  Only the up-block's per-product blocks keep a workspace of
    every part whatever their number."""
    bf16 = torch.bfloat16
    if op == "conv":
        plan = conv.conv_dw_plan(*call, bf16)
        ws = conv.plan_ws_elems(plan, call[-1], 25)
        split = 1
    else:
        b, r, cin, co = call
        plan = conv.dw_plan(b, r, r, cin, co, bf16)
        ws = conv.plan_ws_elems(plan, co, 16)
        split = 2 if plan.fold else 1
    assert plan.cluster * split <= conv.DW_MAX_CLUSTER
    if op == "conv" or plan.fold:
        assert (ws == 0) == (plan.groups == 1)
    else:
        assert plan.cluster == 1 and ws > 0
    assert (ws > 0) == (call in (CONV_WS_CALLS if op == "conv"
                                 else UPCONV_WS_CALLS))


def test_workspace_only_at_the_listed_shapes():
    """The calls that keep a workspace, as `CONV_WS_CALLS` and
    `UPCONV_WS_CALLS` list them: the four RGB conv calls of the two
    discriminators, the GAN-CLS generator's RGB deconv, the long-K convs
    of few tiles (the 64 px D's 32² layer at 3·64, the 256 px D's 128² and
    64² layers), and the up-blocks past the 4² maps."""
    assert CONV_WS_CALLS == [(192, 64, 64, 3, 64), (64, 64, 64, 3, 64),
                             (192, 32, 32, 64, 128),
                             (192, 256, 256, 3, 64), (64, 256, 256, 3, 64),
                             (192, 128, 128, 64, 128),
                             (192, 64, 64, 128, 256),
                             (64, 128, 128, 64, 128),
                             (64, 64, 64, 128, 256), (64, 64, 64, 3, 128)]
    assert [c for c in UPCONV_CALLS if c not in UPCONV_WS_CALLS] == [
        (64, 4, 1024, 512), (64, 4, 512, 512)]


@pytest.mark.parametrize("call,dtype,modes", [
    # the D's 8² layer: one part, dw straight from the kernel
    ((192, 8, 8, 256, 512), torch.bfloat16, {"direct", "producer"}),
    # its 16² layer: 4 parts summed across a cluster
    ((192, 16, 16, 128, 256), torch.bfloat16, {"direct", "cluster",
                                               "producer"}),
    # the RGB layer: staged rows, clusters of 8 and their workspace
    ((192, 64, 64, 3, 64), torch.bfloat16, {"workspace", "cluster",
                                            "staged"}),
    # an odd RGB map (no slice is one row of g's map): the gather
    ((2, 9, 7, 3, 64), torch.bfloat16, {"direct"}),
    # f32: the FMA tile, one part
    ((2, 8, 8, 64, 64), torch.float32, {"direct"})])
def test_dw_modes_mirror_the_launch(call, dtype, modes):
    """What `dw_modes` says a conv5x5_s2_dw launch does (the C entry
    point's Mode bits, read back on the card by chip_smoke.py)."""
    b, h, w, cin, co = call
    path = conv.conv_dw_path(h, w, cin, co, dtype)
    plan = conv.conv_dw_plan(b, h, w, cin, co, dtype)
    assert conv.dw_modes(path, plan, 25, cin, conv.same_pads(h)[0],
                         conv.same_pads(w)[0]) == modes


# --- the wrapper ----------------------------------------------------------------

def test_dw_wrapper_takes_the_plain_version_on_cpu():
    x, w, _ = map(torch.from_numpy, _conv_inputs((2, 7, 6, 4), 5))
    g = torch.from_numpy(_rng(4).normal(size=(2, 4, 3, 5)).astype(np.float32))
    before = conv.conv5x5_s2_dw.launches
    torch.testing.assert_close(conv.conv5x5_s2_dw(x, g, torch.float32),
                               conv.conv5x5_s2_dw_plain(x, g, torch.float32),
                               rtol=0, atol=0)
    assert conv.conv5x5_s2_dw(x.bfloat16(), g.bfloat16(),
                              torch.bfloat16).dtype == torch.bfloat16
    assert conv.conv5x5_s2_dw.launches == before


@pytest.mark.parametrize("case", ["x rank", "g map", "g batch"])
def test_dw_wrapper_rejects_wrong_shapes(case):
    x = torch.zeros(2, 8, 8, 4)
    g = torch.zeros(2, 4, 4, 6)
    calls = {"x rank": lambda: conv.conv5x5_s2_dw(x[0], g, torch.float32),
             "g map": lambda: conv.conv5x5_s2_dw(x, g[:, :3], torch.float32),
             "g batch": lambda: conv.conv5x5_s2_dw(x, g[:1], torch.float32)}
    with pytest.raises(ValueError):
        calls[case]()


def test_dw_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv.conv5x5_s2_dw(torch.zeros(1, 4, 4, 64, device="meta"),
                           torch.zeros(1, 2, 2, 64, device="meta"),
                           torch.float32)


def test_dw_function_backward_matches_autograd_of_the_plain_version(
        monkeypatch):
    """`_ConvDw` (what a CUDA call with x or g requiring a gradient
    records), its launch swapped for the plain version: its backward
    against autograd through the plain version."""
    monkeypatch.setattr(conv, "_conv_dw_forward", conv.conv5x5_s2_dw_plain)
    for seed, shape, co in ((24, (2, 7, 6, 4), 5), (25, (2, 8, 8, 3), 6)):
        x, _, _ = map(torch.from_numpy, _conv_inputs(shape, co, seed=seed))
        ho, wo = conv.same_pads(shape[1])[0], conv.same_pads(shape[2])[0]
        g = torch.from_numpy(_rng(seed).normal(
            size=(shape[0], ho, wo, co)).astype(np.float32))
        c = torch.from_numpy(_rng(seed + 1).normal(
            size=(5, 5, shape[-1], co)).astype(np.float32))
        ins = [x.requires_grad_(True), g.requires_grad_(True)]
        got = torch.autograd.grad(conv._ConvDw.apply(*ins, torch.float32),
                                  ins, c)
        want = torch.autograd.grad(
            conv.conv5x5_s2_dw_plain(*ins, torch.float32), ins, c)
        for name, u, v in zip(("d/dx", "d/dg"), got, want):
            _close(u, v.numpy(), f"{name} {shape}")


def test_dw_is_bilinear_and_its_adjoints_are_the_conv():
    """The weight gradient's own backward (`_ConvDw`, on the card): the
    conv's dx of g with the cotangent as weight, and the conv of x with it;
    here through autograd of the plain version, against those formulas."""
    x, _, _ = map(torch.from_numpy, _conv_inputs((2, 7, 6, 4), 5, seed=21))
    g = torch.from_numpy(_rng(22).normal(size=(2, 4, 3, 5)).astype(np.float32))
    c = torch.from_numpy(_rng(23).normal(size=(5, 5, 4, 5)).astype(np.float32))
    x.requires_grad_(True)
    g.requires_grad_(True)
    dw = conv.conv5x5_s2_dw(x, g, torch.float32)
    gx, gg = torch.autograd.grad(dw, [x, g], c)
    _close(gx, conv.conv_dx(g.detach(), c, 7, 6), "d/dx")
    _close(gg, conv.conv5x5_s2_act_plain(x.detach(), c, torch.zeros(5),
                                         "none"), "d/dg")
