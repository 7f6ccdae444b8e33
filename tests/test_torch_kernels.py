"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's Pallas kernel in interpret mode (same numpy inputs), each
autograd.Function's backward against ``jax.vjp`` of the JAX op, the
wrappers' CPU routing and their argument checks.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops.pallas import conv as jconv
from text_to_image_tpu.ops.pallas import fused as jfused
from text_to_image_tpu_torch.ops.kernels import conv, fused

ACTS = ["none", "relu", "lrelu", "tanh"]


def _deconv_inputs(shape, co, seed=7):
    rng = np.random.default_rng(seed)
    cin = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, cin, co)) * 0.1).astype(np.float32)
    s = (rng.normal(size=(co,)) * 0.3 + 1.0).astype(np.float32)
    t = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, s, t


@pytest.mark.parametrize("shape,co", [((2, 4, 4, 16), 8),
                                      ((3, 8, 8, 8), 16),
                                      ((2, 5, 7, 4), 8),   # odd spatial
                                      ((2, 8, 8, 8), 3)])  # RGB output
@pytest.mark.parametrize("act", ACTS)
def test_deconv_plain_matches_pallas(shape, co, act):
    x, w, s, t = _deconv_inputs(shape, co)
    ref = np.asarray(jconv.deconv5x5_s2(x, w, s, t, act))
    got = conv.deconv5x5_s2_plain(*map(torch.from_numpy, (x, w, s, t)), act)
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(8, 8, 8, 128), (4, 4, 4, 256)])
@pytest.mark.parametrize("act", ACTS)
def test_bn_act_plain_matches_pallas(shape, act):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    a = (rng.normal(size=(c,)) + 1.0).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    rows = x.size // c
    ref = np.asarray(jfused._bn_act_core(x.reshape(rows, c), a.reshape(1, -1),
                                         b.reshape(1, -1), act, min(128, rows)))
    got = fused.bn_act_plain(*map(torch.from_numpy, (x, a, b)), act)
    np.testing.assert_allclose(got.numpy().reshape(-1, c), ref, rtol=1e-6,
                               atol=1e-6)


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    x, w, s, t = map(torch.from_numpy, _deconv_inputs((2, 4, 4, 8), 3))
    before = (conv.deconv5x5_s2.launches, fused.bn_act.launches)
    torch.testing.assert_close(conv.deconv5x5_s2(x, w, s, t, "tanh"),
                               conv.deconv5x5_s2_plain(x, w, s, t, "tanh"),
                               rtol=0, atol=0)
    a = torch.linspace(0.5, 1.5, 8)
    torch.testing.assert_close(fused.bn_act(x, a, -a, "lrelu"),
                               fused.bn_act_plain(x, a, -a, "lrelu"),
                               rtol=0, atol=0)
    assert (conv.deconv5x5_s2.launches, fused.bn_act.launches) == before


@pytest.mark.parametrize("bad", ["w_shape", "dtype", "scale_dtype",
                                 "noncontig", "act"])
def test_deconv_check_rejects(bad):
    """The checks the CUDA wrapper makes before it launches."""
    x, w, s, t = map(torch.from_numpy, _deconv_inputs((2, 4, 4, 8), 16))
    act = "relu"
    if bad == "w_shape":
        w = w[:3]
    elif bad == "dtype":
        w = w.to(torch.bfloat16)
    elif bad == "scale_dtype":
        s = s.double()
    elif bad == "noncontig":
        x = x.transpose(1, 2)
    else:
        act = "gelu"
    with pytest.raises((ValueError, TypeError)):
        conv._check(x, w, s, t, act)


def test_bn_act_check_rejects():
    x = torch.zeros(2, 3, 3, 5)
    with pytest.raises(ValueError):
        fused._check(x, torch.ones(4), torch.zeros(4), "relu")
    with pytest.raises(ValueError):
        fused._check(x.transpose(1, 2), torch.ones(5), torch.zeros(5), "relu")
    fused._check(x, torch.ones(5), torch.zeros(5), "relu")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 2, 2, 4, device="meta")
    with pytest.raises(ValueError):
        fused.bn_act(x, torch.ones(4, device="meta"),
                     torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        conv.deconv5x5_s2(x, torch.zeros(5, 5, 4, 3, device="meta"),
                          torch.ones(3, device="meta"),
                          torch.zeros(3, device="meta"))


# --- conv5x5_s2_act, conditioning_join and the backward passes ---------------
# Forward tolerances as above (f32, sums in another order); gradients 1e-4
# absolute + relative: each is a sum of up to 25·C·B·H·W products.
GRAD_TOL = 1e-4


def _conv_inputs(shape, co, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, shape[-1], co)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, w, b


def _join_inputs(shape, e, co, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    t = rng.normal(size=(shape[0], e)).astype(np.float32)
    wx = (rng.normal(size=(shape[-1], co)) * 0.2).astype(np.float32)
    wt = (rng.normal(size=(e, co)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.2).astype(np.float32)
    return x, t, wx, wt, b


@pytest.mark.parametrize("shape,co", [((2, 8, 8, 3), 8),     # RGB input
                                      ((3, 4, 4, 16), 8),
                                      ((2, 6, 10, 5), 12)])  # ragged
@pytest.mark.parametrize("act", ACTS)
def test_conv_plain_matches_pallas(shape, co, act):
    x, w, b = _conv_inputs(shape, co)
    ref = np.asarray(jconv.conv5x5_s2_act(x, w, b, act))
    got = conv.conv5x5_s2_act_plain(*map(torch.from_numpy, (x, w, b)), act)
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 5, 7, 4), (1, 3, 3, 2), (2, 9, 6, 3)])
def test_conv_plain_odd_maps_match_lax_same(shape):
    """Odd maps (the TPU kernel takes even ones only): TF SAME pads (2, 2)
    and gives ⌈H/2⌉ rows, as ``lax.conv`` SAME does."""
    x, w, b = _conv_inputs(shape, 6)
    ref = np.asarray(jconv._lax_conv_s2(x, w, b, "lrelu"))
    got = conv.conv5x5_s2_act_plain(*map(torch.from_numpy, (x, w, b)), "lrelu")
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_same_padding_is_one_before_two_after():
    """An even map pads (1, 2), not (2, 2): F.conv2d(padding=2) would shift
    every output by a pixel."""
    assert conv.same_pads(64) == (32, 1, 2)
    assert conv.same_pads(7) == (4, 2, 2)
    x, w, b = map(torch.from_numpy, _conv_inputs((1, 8, 8, 2), 3))
    sym = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                     w.permute(3, 2, 0, 1), b, stride=2,
                                     padding=2).permute(0, 2, 3, 1)
    got = conv.conv5x5_s2_act_plain(x, w, b, "none")
    assert not torch.allclose(got, sym[:, :4, :4], atol=1e-3)


@pytest.mark.parametrize("shape,e,co", [((2, 4, 4, 16), 8, 16),
                                        ((3, 3, 5, 12), 7, 20)])
@pytest.mark.parametrize("act", ACTS)
def test_join_plain_matches_pallas(shape, e, co, act):
    x, t, wx, wt, b = _join_inputs(shape, e, co)
    ref = np.asarray(jfused.conditioning_join(x, t, wx, wt, b, act))
    got = fused.conditioning_join_plain(*map(torch.from_numpy,
                                             (x, t, wx, wt, b)), act)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    # and the reference's own composition: conv1x1(concat(x, tile(t)))
    from text_to_image_tpu_torch.ops import layers as TL
    w = torch.from_numpy(np.concatenate([wx, wt])[None, None])
    cat = TL.tile_and_concat(torch.from_numpy(x), torch.from_numpy(t))
    plain = fused.apply_act(TL.conv2d({"w": w, "b": torch.from_numpy(b)}, cat,
                                      stride=1), act)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=2e-5, atol=2e-5)


def _vjp_check(jax_fn, torch_fn, args, seed=0):
    """Forward and every input gradient of torch_fn (the port's
    autograd.Function on CPU tensors) against jax.vjp of jax_fn, for one
    random cotangent."""
    out, vjp = jax.vjp(jax_fn, *args)
    g = np.random.default_rng(seed).normal(size=out.shape).astype(np.float32)
    ref_grads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = torch_fn(*targs)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out),
                               rtol=2e-5, atol=2e-5)
    grads = torch.autograd.grad(y, targs, torch.from_numpy(g))
    for i, (got, ref) in enumerate(zip(grads, ref_grads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"grad of argument {i}")


@pytest.mark.parametrize("shape,co", [((2, 8, 8, 3), 8), ((2, 6, 10, 5), 12)])
@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_conv_backward_matches_jax_vjp(shape, co, act):
    x, w, b = _conv_inputs(shape, co)
    _vjp_check(lambda *a: jconv.conv5x5_s2_act(*a, act),
               lambda *a: conv.conv5x5_s2_act(*a, act), (x, w, b))


def test_conv_backward_odd_map_matches_lax_vjp():
    x, w, b = _conv_inputs((2, 5, 7, 4), 6)
    _vjp_check(lambda *a: jconv._lax_conv_s2(*a, "lrelu"),
               lambda *a: conv.conv5x5_s2_act(*a, "lrelu"), (x, w, b))


@pytest.mark.parametrize("shape,co", [((2, 4, 4, 16), 8),
                                      ((2, 5, 7, 4), 8),    # odd spatial
                                      ((2, 8, 8, 8), 3)])   # RGB output
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_deconv_backward_matches_jax_vjp(shape, co, act):
    """dx is the adjoint of ``lax.conv_transpose(…, "SAME")`` with no kernel
    flip; tanh's derivative comes from the saved output as 1 − y²."""
    x, w, s, t = _deconv_inputs(shape, co)
    _vjp_check(lambda *a: jconv.deconv5x5_s2(*a, act),
               lambda *a: conv.deconv5x5_s2(*a, act), (x, w, s, t))


@pytest.mark.parametrize("act", ACTS)
def test_bn_act_backward_matches_jax_vjp(act):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 4, 128)).astype(np.float32)
    a = (rng.normal(size=(128,)) + 1.0).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)

    def jax_fn(x_, a_, b_):
        y = jfused._bn_act_core(x_.reshape(-1, 128), a_.reshape(1, -1),
                                b_.reshape(1, -1), act, 16)
        return y.reshape(x_.shape)

    _vjp_check(jax_fn, lambda *v: fused.bn_act(*v, act), (x, a, b))


@pytest.mark.parametrize("act", ["none", "lrelu", "tanh"])
def test_join_backward_matches_jax_vjp(act):
    args = _join_inputs((3, 3, 5, 12), 7, 20)
    _vjp_check(lambda *a: jfused.conditioning_join(*a, act),
               lambda *a: fused.conditioning_join(*a, act), args)


def test_new_wrappers_take_plain_version_on_cpu_and_check():
    x, w, b = map(torch.from_numpy, _conv_inputs((2, 8, 8, 3), 8))
    jx = list(map(torch.from_numpy, _join_inputs((2, 4, 4, 16), 8, 16)))
    before = (conv.conv5x5_s2_act.launches, fused.conditioning_join.launches)
    torch.testing.assert_close(conv.conv5x5_s2_act(x, w, b, "lrelu"),
                               conv.conv5x5_s2_act_plain(x, w, b, "lrelu"),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused.conditioning_join(*jx, "none"),
                               fused.conditioning_join_plain(*jx, "none"),
                               rtol=0, atol=0)
    assert (conv.conv5x5_s2_act.launches,
            fused.conditioning_join.launches) == before
    with pytest.raises(ValueError):
        conv._conv_check(x, w, b[:3], "lrelu")
    with pytest.raises(TypeError):
        fused._join_check(jx[0], jx[1].double(), *jx[2:], "none")
    with pytest.raises(ValueError):
        fused._join_check(jx[0].transpose(1, 2), *jx[1:], "none")
    fused._join_check(*jx, "none")
    meta = torch.zeros(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError):
        conv.conv5x5_s2_act(meta, torch.zeros(5, 5, 3, 4, device="meta"),
                            torch.zeros(4, device="meta"))
