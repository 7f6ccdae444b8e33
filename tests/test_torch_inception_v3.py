"""The port's InceptionV3 (``eval/inception_v3.py``) against the JAX
package's on the CPU, in f32: the stem and each block kind a–e from the same
params at small maps, the whole network through the 299 resize from a
``.npz`` that the real ``scripts/convert_inception.py`` wrote from the
port's exported state dict (JAX's whole network is compiled once for the
file), the state-dict round trip, `convert.from_jax_classifier`'s checks,
and one Adam step of `train_classifier` through the whole network.

Params are the port's `init` with the BN buffers moved off identity, so
that every term of a unit counts."""

import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.eval import classifier as jclassifier
from text_to_image_tpu.eval import inception as jinception
from text_to_image_tpu.eval import inception_v3 as jiv3
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.eval import classifier as tclassifier
from text_to_image_tpu_torch.eval import inception as tinception
from text_to_image_tpu_torch.eval import inception_v3 as tiv3
from text_to_image_tpu_torch.train.optim import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 5
# f32 on the CPU: the packages differ in the convolutions' summation order;
# over ~47 units the logits agree to ~1e-6 of their largest magnitude
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
# elements of one Adam step allowed outside the tolerance (relu kinks)
KINK_SHARE = 2e-3


def _host(tree):
    return {k: _host(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _perturb_bn(tree, rng):
    """BN buffers off identity: scale 1 ± 0.1, bias ± 0.1, mean ± 0.1,
    var in [0.5, 1.5]."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng)
        elif k in ("bn_scale", "bn_bias", "bn_mean", "bn_var", "b"):
            lo, hi = {"bn_scale": (0.9, 1.1), "bn_var": (0.5, 1.5)}.get(
                k, (-0.1, 0.1))
            out[k] = rng.uniform(lo, hi, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """The port's init (BN perturbed) as numpy, a ``.npz`` written from it by
    ``scripts/convert_inception.py``, two 64 px images and the JAX
    `load_classifier`'s logits on them (JAX's one whole-network compile)."""
    params = _perturb_bn(_host(tiv3.init(0, CLASSES)),
                         np.random.default_rng(1))
    tmp = tmp_path_factory.mktemp("iv3")
    pth, npz = tmp / "finetuned.pth", tmp / "inception.npz"
    torch.save({"state_dict": tiv3.export_torchvision_state_dict(params)},
               str(pth))
    argv = sys.argv
    sys.argv = ["convert_inception.py", "--pth", str(pth), "--out", str(npz)]
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "convert_inception.py"),
                       run_name="__main__")
    finally:
        sys.argv = argv
    images = np.random.default_rng(2).uniform(
        -1, 1, (2, 64, 64, 3)).astype(np.float32)
    logits = np.asarray(jinception.load_classifier(str(npz))(images))
    return params, str(npz), images, logits


def _close(got, ref, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol}·{scale:.3e}"


def test_param_tree_and_init_match_jax(net):
    """Same names and shapes as the JAX init; He-scaled truncated normal
    within ±2σ, identity BN buffers, fc std 0.01."""
    params, _, _, _ = net
    ref = jax.eval_shape(lambda: jiv3.init(jax.random.PRNGKey(0), CLASSES))
    want = {k: v.shape for k, v in flatten(ref)}
    assert {k: v.shape for k, v in flatten(params)} == want
    assert dict(flatten(tiv3.param_shapes(CLASSES))) == want
    fresh = tiv3.init(0, CLASSES)
    w = fresh["mixed_7c"]["d2"]["w"]
    std = np.sqrt(2.0 / (3 * 3 * 448))
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) / std - 0.88) < 0.02   # truncated at ±2σ
    assert torch.equal(fresh["conv_1a"]["bn_var"], torch.ones(32))
    assert abs(float(fresh["fc"]["w"].std()) - 0.01) < 1e-3
    assert torch.equal(tiv3.init(0, CLASSES)["conv_1a"]["w"],
                       fresh["conv_1a"]["w"])
    assert not torch.equal(tiv3.init(1, CLASSES)["conv_1a"]["w"],
                           fresh["conv_1a"]["w"])


def test_stem_matches_jax(net):
    params = net[0]
    x = np.random.default_rng(3).uniform(-1, 1, (2, 75, 75, 3)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    h = jiv3._unit(jp["conv_1a"], jnp.asarray(x), stride=2, padding="VALID")
    h = jiv3._unit(jp["conv_2a"], h, padding="VALID")
    h = jiv3._unit(jp["conv_2b"], h, padding=jiv3._pad(1, 1))
    h = jiv3._maxpool3s2(h)
    h = jiv3._unit(jp["conv_3b"], h, padding="VALID")
    h = jiv3._unit(jp["conv_4a"], h, padding="VALID")
    ref = np.asarray(jiv3._maxpool3s2(h))
    tp = convert.from_jax_classifier(params, "cpu")
    got = tiv3.stem(tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1), ref, BLOCK_TOL, "stem")


@pytest.mark.parametrize("name,kind,cin,hw", [
    ("5b", "a", 192, 7), ("6a", "b", 288, 9), ("6b", "c", 768, 9),
    ("7a", "d", 768, 9), ("7b", "e", 1280, 5)])
def test_block_matches_jax(net, name, kind, cin, hw):
    """Each block kind from its params of the net, at 2×hw×hw×cin."""
    p = net[0][f"mixed_{name}"]
    x = np.random.default_rng(4).uniform(0, 1, (2, hw, hw, cin)).astype(
        np.float32)
    ref = np.asarray(jiv3._BLOCK_APPLY[kind](jax.tree.map(jnp.asarray, p),
                                             jnp.asarray(x)))
    tp = convert.from_jax_classifier(net[0], "cpu")[f"mixed_{name}"]
    got = tiv3.block(kind, tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, ref.shape[3], ref.shape[1], ref.shape[2])
    _close(got.permute(0, 2, 3, 1), ref, BLOCK_TOL, f"block {kind}")


def test_converted_npz_classifies_like_jax(net):
    """The ``.npz`` of the real converter script, loaded by the port's
    `load_classifier` (InceptionV3 detected), and the port's `apply` over
    the same params: the JAX logits to 1e-4 of their largest magnitude,
    through the 64 → 299 resize."""
    params, npz, images, ref = net
    assert ref.shape == (2, CLASSES)
    got = tinception.load_classifier(npz, "cpu")(images)
    _close(got, ref, LOGIT_TOL, "load_classifier")
    tp = tiv3.load_npz(npz, "cpu")
    _close(tiv3.apply(tp, torch.from_numpy(images)), ref, LOGIT_TOL,
           "apply")
    _close(tiv3.make_classifier(tp)(torch.from_numpy(images)), ref,
           LOGIT_TOL, "make_classifier")


def test_resize_matches_jax():
    """The 299 resize (bilinear, no antialiasing) against
    ``jax.image.resize`` for every generator resolution below 299."""
    for r in (64, 76, 128, 256):
        x = np.random.default_rng(r).uniform(-1, 1, (1, r, r, 3)).astype(
            np.float32)
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3),
                                          "bilinear"))
        got = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299),
            mode="bilinear", align_corners=False, antialias=False)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-6, rtol=0)


def test_state_dict_round_trip_and_jax_export(net, tmp_path):
    """port export → port import is the identity; the port's export of a
    JAX tree equals the JAX exporter's, key for key; the ``.npz`` of
    `convert.save_classifier_npz` is the tree the JAX `load_npz` reads."""
    params = net[0]
    path = str(tmp_path / "iv3.npz")
    convert.save_classifier_npz(path, convert.from_jax_classifier(params,
                                                                  "cpu"))
    back = dict(flatten(jax.device_get(jiv3.load_npz(path))))
    assert back.keys() == dict(flatten(params)).keys()
    for k, v in flatten(params):
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    sd = tiv3.export_torchvision_state_dict(params)
    back = tiv3.params_from_torch_state_dict(sd)
    flat = dict(flatten(params))
    assert {k for k, _ in flatten(back)} == flat.keys()
    for k, v in flatten(back):
        np.testing.assert_array_equal(v.numpy(), flat[k], err_msg=k)
    jsd = jiv3.export_torchvision_state_dict(params)
    assert jsd.keys() == sd.keys()
    for k in sd:
        assert torch.equal(sd[k], jsd[k]), k


def test_from_jax_classifier_checks_names_and_shapes(net):
    params = net[0]
    bad = {**params, "mixed_5b": {**params["mixed_5b"]}}
    del bad["mixed_5b"]["p"]
    with pytest.raises(ValueError, match="mixed_5b"):
        convert.from_jax_classifier(bad, "cpu")
    bad = {**params, "conv_1a": {**params["conv_1a"],
                                 "w": np.zeros((3, 3, 32, 3), np.float32)}}
    with pytest.raises(ValueError, match="conv_1a/w"):
        convert.from_jax_classifier(bad, "cpu")
    with pytest.raises(ValueError, match="not a classifier"):
        convert.from_jax_classifier({"up0": {"w": np.zeros(1)}}, "cpu")


def test_train_classifier_step_matches_jax():
    """One Adam step of `train_classifier(apply_fn=iv3.apply)` at batch 2
    from the JAX init (carried), on the same numpy-drawn batch: the
    accuracy equal; every param after the step within 1e-4 relative + 1e-2
    of the LR of JAX's, except a share of at most `KINK_SHARE` of the
    elements, and the fc (no relu after it) with none.

    Adam's first step is lr·g/(|g| + 1e-8): it carries a gradient's sign
    whatever its size, so round-off-sized gradients (a relu input within
    round-off of 0 gives another act′ in each package: ROADMAP §3) become
    steps of up to ±lr.  Measured: 7.1e-4 of the 21.8 M elements outside
    the tolerance, 3.7e-5 further than lr/2."""
    imgs = np.random.default_rng(5).integers(0, 256, (6, 64, 64, 3),
                                             dtype=np.uint8)
    cls = np.arange(6) % CLASSES
    lr = 3e-4

    def jinit(k):
        return jiv3.init(k, CLASSES)

    kw = dict(steps=1, batch_size=2, lr=lr, init_fn=jinit,
              apply_fn=jiv3.apply)
    init, _ = jclassifier.train_classifier(imgs, cls, CLASSES,
                                           **{**kw, "steps": 0})
    ref, ref_acc = jclassifier.train_classifier(imgs, cls, CLASSES, **kw)
    init, ref = jax.device_get((init, ref))
    got, acc = tclassifier.train_classifier(
        imgs, cls, CLASSES, steps=1, batch_size=2, lr=lr,
        init_fn=lambda k: convert.from_jax_classifier(init, "cpu"),
        apply_fn=tiv3.apply, device="cpu")
    assert acc == ref_acc
    ref_flat, init_flat = dict(flatten(ref)), dict(flatten(init))
    outside = total = moved = 0
    for k, v in flatten(got):
        r = ref_flat[k]
        err = np.abs(v.numpy() - r)
        out = err > 1e-4 * np.abs(r) + 1e-2 * lr
        assert not (k.startswith("fc/") and out.any()), k
        assert np.all(err <= 2 * lr + 1e-4 * np.abs(r)), k
        outside, total = outside + int(out.sum()), total + r.size
        moved += int((r != init_flat[k]).sum())
    assert outside <= KINK_SHARE * total, (outside, total)
    assert moved > total // 2      # the step reached the whole network
