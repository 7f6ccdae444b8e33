"""The port's kernel modules on the CPU: each plain PyTorch version against
the JAX package's Pallas kernel in interpret mode (same numpy inputs), the
wrappers' CPU routing and their argument checks.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``."""

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
