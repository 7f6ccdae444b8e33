"""The port's Inception-score path against the JAX package on the CPU, in
f32: the IS maths, `compute_inception_score` fed JAX's own z (and ε) with
stub and real generators and classifiers, the SimpleCNN and its finetune,
`load_classifier` and `convert.from_jax_classifier`, the synthetic-quality
protocol through its parts with JAX's noise, each end to end on the port,
``main.py --eval-is`` with and without ``<data_dir>/inception.npz``, and the
profiling helpers."""

import dataclasses
import functools
import os
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.data.synthetic import SyntheticDataset as JSynthetic
from text_to_image_tpu.eval import classifier as jclassifier
from text_to_image_tpu.eval import inception as jinception
from text_to_image_tpu.eval import inception_v3 as jiv3
from text_to_image_tpu.eval import sampler as jsampler
from text_to_image_tpu.eval import synthetic_quality as jquality
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.models import stackgan as jstackgan
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert, main
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.eval import classifier as tclassifier
from text_to_image_tpu_torch.eval import inception as tinception
from text_to_image_tpu_torch.eval import inception_v3 as tiv3
from text_to_image_tpu_torch.eval import sampler as tsampler
from text_to_image_tpu_torch.eval import synthetic_quality as tquality
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.utils import prng, profiling

# IS of the same probabilities: float64 maths, the same order of sums
MATH_TOL = 1e-12
# stub generator and classifier: the same f32 ops in both packages
STUB_TOL = 1e-6
# a real generator and SimpleCNN: f32 summation order across ~6 layers
NET_TOL = 1e-4
# SimpleCNN forward and finetune (3 convs, Adam over 5 steps)
CLF_TOL = 1e-5


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _jax_z(key, n, z_dim):
    """JAX's (kz, kg) split of `key` and its z [n, z_dim], as numpy."""
    kz, kg = jax.random.split(key)
    return np.array(jax.random.normal(kz, (n, z_dim))), kg


# --- the IS maths ------------------------------------------------------------

@pytest.mark.parametrize("splits", [1, 4, 10])
def test_inception_score_matches_jax(splits):
    probs = np.random.default_rng(splits).dirichlet(np.full(7, 0.3), 203)
    got = tinception.inception_score(probs, splits)
    ref = jinception.inception_score(probs, splits)
    np.testing.assert_allclose(got, ref, rtol=MATH_TOL, atol=0)


@pytest.mark.parametrize("case", ["uniform", "one-hot"])
def test_inception_score_bounds(case):
    """Uniform posteriors give 1; confident and diverse ones give C."""
    c = 4
    probs = (np.full((100, c), 1 / c) if case == "uniform"
             else np.eye(c)[np.arange(100) % c])
    mean, std = tinception.inception_score(probs, splits=5)
    np.testing.assert_allclose(mean, 1.0 if case == "uniform" else c,
                               rtol=1e-6)
    assert std < 1e-8


# --- compute_inception_score --------------------------------------------------

W_IMG = np.random.default_rng(0).normal(size=(8 + 6, 4 * 4 * 3)).astype(
    np.float32)
W_CLF = np.random.default_rng(1).normal(size=(3, 5)).astype(np.float32)


def _stub_gen(xp, z, emb):
    """A deterministic 'generator': tanh of [z, emb] @ W, 4×4×3 images."""
    h = xp.concatenate([z, emb], axis=1) if xp is jnp else torch.cat(
        [z, emb], 1)
    w = jnp.asarray(W_IMG) if xp is jnp else torch.from_numpy(W_IMG)
    return xp.tanh(h @ w).reshape(-1, 4, 4, 3)


def _stub_clf(xp, imgs):
    w = jnp.asarray(W_CLF) if xp is jnp else torch.from_numpy(W_CLF)
    return 4.0 * (imgs.mean(axis=(1, 2)) if xp is jnp
                  else imgs.mean(dim=(1, 2))) @ w


@pytest.mark.parametrize("num_images", [64, 50])
def test_compute_inception_score_matches_jax(num_images):
    """The port fed JAX's z (``normal(split(fold_in(base_key(s), b))[0])``)
    and the same stubs: the JAX score to 1e-6, a last batch cut short
    included (50 of 64)."""
    emb = np.random.default_rng(2).normal(size=(21, 6)).astype(np.float32)
    seed, bs, zd = 3, 16, 8
    ref = jinception.compute_inception_score(
        lambda z, e, k: _stub_gen(jnp, z, e), lambda x: _stub_clf(jnp, x),
        emb, num_images=num_images, batch_size=bs, z_dim=zd, splits=5,
        seed=seed)

    def noise(b):
        z, _ = _jax_z(jax.random.fold_in(jprng.base_key(seed), b), bs, zd)
        return torch.from_numpy(z), None

    got = tinception.compute_inception_score(
        lambda z, e, eps: _stub_gen(torch, z, torch.from_numpy(e)),
        lambda x: _stub_clf(torch, x), emb, num_images=num_images,
        batch_size=bs, z_dim=zd, splits=5, seed=seed, noise=noise)
    np.testing.assert_allclose(got, ref, rtol=STUB_TOL, atol=STUB_TOL)


def test_compute_inception_score_default_noise():
    """Without ``noise`` batch b draws z, then ε of ``eps_shape(B)``, from
    ``fold_in(seed, b)``; the embeddings cycle through the pool."""
    seen = []

    def gen(z, emb, eps):
        seen.append((z, emb, eps))
        return torch.zeros(len(z), 4, 4, 3)

    emb = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    mean, _ = tinception.compute_inception_score(
        gen, lambda x: torch.zeros(len(x), 3), emb, num_images=7,
        batch_size=4, z_dim=3, splits=1, seed=9,
        eps_shape=lambda b: (2, b, 6))
    assert mean == pytest.approx(1.0)
    assert len(seen) == 2
    for b, (z, e, eps) in enumerate(seen):
        want_z, want_eps = tinception.batch_noise(
            prng.fold_in(9, b), 4, 3, lambda n: (2, n, 6))
        assert torch.equal(z, want_z) and torch.equal(eps, want_eps)
        np.testing.assert_array_equal(e, emb[(np.arange(4) + 4 * b) % 5])
    assert tinception.batch_noise(1, 4, 3)[1] is None


def _simple_cnn(classes=5, width=8, key=0):
    return jax.device_get(jinception.simple_classifier_init(
        jax.random.PRNGKey(key), classes, width))


def test_compute_inception_score_stackgan_matches_jax():
    """A small StackGAN Stage-I (``eps_shape`` not None) and a SimpleCNN,
    both carried from JAX; the port fed JAX's z and the ε its key gives:
    the JAX score to 1e-4 (two f32 networks)."""
    jcfg = tiny_config("stackgan_stage1")
    gp, gs = jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(3), jcfg.gan, 16))
    clf = _simple_cnn(key=4)
    emb = np.random.default_rng(5).normal(
        size=(40, jcfg.gan.embed_dim)).astype(np.float32)
    bs, zd, ca = 8, jcfg.gan.z_dim, jcfg.gan.ca_dim
    jgen = jsampler.make_generator_fn(jcfg)
    ref = jinception.compute_inception_score(
        lambda z, e, k: jgen(gp, gs, {}, z, e, k),
        jclassifier.make_classifier_fn(clf), emb, num_images=20,
        batch_size=bs, z_dim=zd, splits=2, seed=1)

    def noise(b):
        z, kg = _jax_z(jax.random.fold_in(jprng.base_key(1), b), bs, zd)
        eps = np.array(jax.random.normal(kg, (bs, ca), jnp.float32))
        return torch.from_numpy(z), torch.from_numpy(eps)

    tgen = tsampler.make_generator_fn(_port_cfg(jcfg), device="cpu")
    assert tgen.eps_shape(bs) == (bs, ca)
    tp, ts = convert.from_jax_generator(gp, gs, "cpu")
    got = tinception.compute_inception_score(
        lambda z, e, eps: tgen(tp, ts, {}, z, e, eps),
        tclassifier.make_classifier_fn(convert.from_jax_classifier(clf, "cpu")),
        emb, num_images=20, batch_size=bs, z_dim=zd, splits=2, seed=1,
        eps_shape=tgen.eps_shape, noise=noise)
    np.testing.assert_allclose(got, ref, rtol=NET_TOL, atol=NET_TOL)


# --- the SimpleCNN ---------------------------------------------------------------

@pytest.mark.parametrize("res", [64, 76])
def test_simple_classifier_matches_jax(res):
    params = _simple_cnn(classes=7, width=16)
    x = np.random.default_rng(res).uniform(-1, 1, (3, res, res, 3)).astype(
        np.float32)
    ref = np.asarray(jinception.simple_classifier_apply(params, x))
    got = tinception.simple_classifier_apply(
        convert.from_jax_classifier(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=CLF_TOL, atol=CLF_TOL)
    init = tinception.simple_classifier_init(0, 7, 16)
    assert {k: tuple(v.shape) for k, v in flatten(init)} == \
        {k: v.shape for k, v in flatten(params)} == \
        dict(flatten(tinception.simple_classifier_shapes(7, 16)))


def test_train_classifier_matches_jax():
    """5 Adam steps from the JAX init (carried) on the same numpy-drawn
    batches: params to 1e-5 relative (+1e-5 of each leaf's largest), the
    last batch's accuracy equal; then the classifier closure."""
    ds = JSynthetic(num_examples=40, image_size=16, embed_dim=8,
                    num_classes=4, seed=0)
    kw = dict(steps=5, batch_size=16, width=8, seed=2)
    init = jax.device_get(jinception.simple_classifier_init(
        jprng.base_key(2), 4, 8))
    ref, ref_acc = jclassifier.train_classifier(ds.images, ds.class_ids, 4,
                                                **kw)
    got, acc = tclassifier.train_classifier(
        ds.images, ds.class_ids, 4, **kw, device="cpu",
        init_fn=lambda k: convert.from_jax_classifier(init, "cpu"))
    assert acc == pytest.approx(ref_acc, abs=1e-6)
    ref_flat = dict(flatten(jax.device_get(ref)))
    for k, v in flatten(got):
        assert not v.requires_grad, k
        np.testing.assert_allclose(
            v.numpy(), ref_flat[k], rtol=CLF_TOL,
            atol=CLF_TOL * float(np.abs(ref_flat[k]).max()), err_msg=k)
    x = ds.images[:5].astype(np.float32) / 127.5 - 1
    np.testing.assert_allclose(
        tclassifier.make_classifier_fn(got)(x).numpy(),
        np.asarray(jclassifier.make_classifier_fn(ref)(x)),
        rtol=NET_TOL, atol=NET_TOL)


def test_exact_f32_restores_the_flags():
    cudnn, cublas = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, cublas.allow_tf32
    with tclassifier.exact_f32():
        assert not cudnn.allow_tf32 and not cublas.allow_tf32
    assert (cudnn.allow_tf32, cublas.allow_tf32) == before


# --- load_classifier and convert ------------------------------------------------------

def test_load_classifier_simple_cnn_and_missing(tmp_path):
    """A SimpleCNN ``.npz`` in the JAX layout (`save_classifier_npz`) is
    detected as one and classifies like the JAX `load_classifier`; a missing path raises
    `FileNotFoundError` in both packages; a tree of neither kind is
    refused."""
    tree = _simple_cnn(classes=6, width=8, key=7)
    path = str(tmp_path / "simple.npz")
    convert.save_classifier_npz(path, tree)
    x = np.random.default_rng(8).uniform(-1, 1, (4, 16, 16, 3)).astype(
        np.float32)
    ref = np.asarray(jinception.load_classifier(path)(x))
    got = tinception.load_classifier(path, "cpu")(x)
    np.testing.assert_allclose(got.numpy(), ref, rtol=CLF_TOL, atol=CLF_TOL)
    for load in (jinception.load_classifier,
                 functools.partial(tinception.load_classifier, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "none.npz"))
    bad = {**tree, "fc": {"w": tree["fc"]["w"][:5], "b": tree["fc"]["b"]}}
    with pytest.raises(ValueError, match="fc/w"):
        convert.from_jax_classifier(bad, "cpu")
    with pytest.raises(ValueError, match="entries"):
        convert.from_jax_classifier({**tree, "c4": tree["c3"]}, "cpu")
    assert "mixed_5b" in tiv3.param_shapes(3)


# --- the synthetic-quality protocol ------------------------------------------------

@pytest.fixture(scope="module")
def quality():
    """A tiny GAN-CLS generator and SimpleCNN from JAX, carried; both
    packages' synthetic datasets (equal arrays); JAX's noise as the port's
    ``noise(part, i, n)``."""
    jcfg = tiny_config()
    gp, gs = jax.device_get(
        jgancls.generator_init(jax.random.PRNGKey(1), jcfg.gan, 16))
    clf = _simple_cnn(classes=8, width=8, key=5)
    zd = jcfg.gan.z_dim

    def noise(part, i, n):
        if part == "fixed":
            z = np.broadcast_to(np.array(jax.random.normal(
                jax.random.PRNGKey(0), (zd,))), (n, zd)).copy()
        else:
            key = (jax.random.fold_in(jprng.base_key(0), i) if part == "score"
                   else jax.random.fold_in(jax.random.PRNGKey(2), i))
            z, _ = _jax_z(key, n, zd)
        return torch.from_numpy(z), None

    tcfg = _port_cfg(jcfg)
    tp, ts = convert.from_jax_generator(gp, gs, "cpu")
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=tcfg, noise=noise, clf=clf,
        jts=types.SimpleNamespace(g_params=gp, g_state=gs, aux={}),
        tts=tsampler.GeneratorState(tp, ts, {}),
        jgen=jsampler.make_generator_fn(jcfg),
        tgen=tsampler.make_generator_fn(tcfg, device="cpu"),
        jds=JSynthetic(num_examples=96, image_size=16, embed_dim=32, seed=0),
        tds=SyntheticDataset(num_examples=96, image_size=16, embed_dim=32,
                             seed=0))


def _dicts_close(got, ref):
    """The two result dicts within one unit of their rounding."""
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        unit = 0.01 if k.endswith(("is_mean", "is_std")) else 0.001
        assert abs(got[k] - v) <= unit + 1e-9, (k, got[k], v)


def test_evaluate_matches_jax(quality):
    """`evaluate` with the same classifier in ``clf_cache`` and JAX's noise:
    the JAX result (r, cond_acc, IS); the parts unrounded: r to 1e-5 and
    the conditional accuracy equal."""
    q = quality
    ref = jquality.evaluate(q.jgen, q.jts, q.jcfg, q.jds, num_images=128,
                            clf_cache={16: (q.clf, 0.5)})
    got = tquality.evaluate(
        q.tgen, q.tts, q.tcfg, q.tds, num_images=128, noise=q.noise,
        clf_cache={16: (convert.from_jax_classifier(q.clf, "cpu"), 0.5)},
        device="cpu")
    _dicts_close(got, ref)
    assert got["clf_acc"] == 0.5

    # the parts: the colour sweep and the conditional accuracy
    z, _ = q.noise("fixed", 0, 8)
    embs = np.stack([q.tds.embeddings[np.where(q.tds.class_ids == c)[0][0], 0]
                     for c in range(8)])
    imgs = q.tgen(q.tts.g_params, q.tts.g_state, {}, z, embs).numpy()
    jimgs = np.asarray(q.jgen(q.jts.g_params, q.jts.g_state, {},
                              jnp.asarray(z.numpy()), jnp.asarray(embs),
                              jax.random.PRNGKey(1)))
    jr = float(np.corrcoef(((jimgs + 1) / 2).mean(axis=(1, 2)).ravel(),
                           np.stack([(q.jds.images[q.jds.class_ids == c]
                                      .astype(np.float32) / 255)
                                     .mean(axis=(0, 1, 2))
                                     for c in range(8)]).ravel())[0, 1])
    assert tquality.color_correlation(imgs, q.tds, 8) == pytest.approx(
        jr, abs=1e-5)
    tclf = tclassifier.make_classifier_fn(
        convert.from_jax_classifier(q.clf, "cpu"))
    assert tquality.cond_accuracy(q.tgen, q.tts, q.tds, tclf, q.noise) == \
        jquality._cond_accuracy(q.jgen, q.jts, q.jcfg, q.jds,
                                jclassifier.make_classifier_fn(q.clf))


def test_evaluate_iv3_matches_jax_through_its_parts(quality, monkeypatch):
    """`evaluate_iv3` with the InceptionV3 of both packages replaced by the
    same SimpleCNN (its finetune replaced by the carried params, so the
    packages' inits need not agree) and JAX's noise: the JAX result; the
    finetune asked for the same steps, lr and crop in both."""
    q = quality
    asked = {}

    def fake_train(params, tag):
        def train(images, class_ids, num_classes, **kw):
            asked[tag] = (images.shape, num_classes, kw["steps"], kw["lr"])
            return params, 0.25
        return train

    monkeypatch.setattr(jiv3, "apply", jinception.simple_classifier_apply)
    monkeypatch.setattr(tiv3, "apply", tinception.simple_classifier_apply)
    monkeypatch.setattr(jquality, "train_classifier", fake_train(q.clf, "j"))
    monkeypatch.setattr(tquality, "train_classifier", fake_train(
        convert.from_jax_classifier(q.clf, "cpu"), "t"))
    ref = jquality.evaluate_iv3(q.jgen, q.jts, q.jcfg, q.jds, num_images=64)
    got = tquality.evaluate_iv3(q.tgen, q.tts, q.tcfg, q.tds, num_images=64,
                                noise=q.noise, device="cpu")
    _dicts_close(got, ref)
    assert asked["t"] == asked["j"] == ((96, 16, 16, 3), 8, 600, 3e-4)


def test_center_crop_matches_jax_crop():
    imgs = np.arange(2 * 76 * 76 * 3, dtype=np.uint8).reshape(2, 76, 76, 3)
    for out in (64, 75, 76):
        o = (76 - out) // 2
        np.testing.assert_array_equal(tquality.center_crop(imgs, out),
                                      imgs[:, o:o + out, o:o + out])


def test_evaluate_end_to_end_finetunes_once(quality, monkeypatch):
    """The port alone at its test size: the five keys in range, and one
    ``clf_cache`` across two calls finetunes once."""
    q = quality
    calls = []
    real = tquality.train_classifier
    monkeypatch.setattr(tquality, "train_classifier",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cache = {}
    for _ in range(2):
        got = tquality.evaluate(q.tgen, q.tts, q.tcfg, q.tds, num_images=64,
                                clf_cache=cache, device="cpu")
    assert len(calls) == 1 and list(cache) == [16]
    assert set(got) == {"r", "clf_acc", "cond_acc", "is_mean", "is_std"}
    assert -1 <= got["r"] <= 1 and 0 <= got["cond_acc"] <= 1
    assert got["clf_acc"] > 0.9          # the synthetic classes are easy
    assert 1 <= got["is_mean"] <= 8 and got["is_std"] >= 0


def test_evaluate_iv3_end_to_end(quality, monkeypatch):
    """The whole InceptionV3 on the CPU: 1 finetune step (at batch 8 here,
    for time), 64 images, a 16-image dataset: the four keys in range."""
    q = quality
    monkeypatch.setattr(tquality, "train_classifier", functools.partial(
        tquality.train_classifier, batch_size=8))
    ds = SyntheticDataset(num_examples=16, image_size=16, embed_dim=32,
                          seed=1)
    got = tquality.evaluate_iv3(q.tgen, q.tts, q.tcfg, ds, num_images=64,
                                clf_steps=1, device="cpu")
    assert set(got) == {"iv3_clf_acc", "iv3_cond_acc", "iv3_is_mean",
                        "iv3_is_std"}
    assert 0 <= got["iv3_clf_acc"] <= 1 and 0 <= got["iv3_cond_acc"] <= 1
    assert 1 <= got["iv3_is_mean"] <= 8 and got["iv3_is_std"] >= 0


# --- main.py --eval-is ------------------------------------------------------------

def _tiny_yaml(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(textwrap.dedent(f"""
        model: gancls
        data: {{dataset_name: synthetic, image_size: 16,
                data_dir: {tmp_path / "data"}}}
        gan: {{gf_dim: 8, df_dim: 8, z_dim: 8, embed_dim: 32,
               compressed_embed_dim: 16}}
        dtype: float32
        sample_dir: {tmp_path / "samples"}
        checkpoint_dir: {tmp_path / "ck"}
        log_dir: {tmp_path / "logs"}
    """))
    return str(path)


@pytest.mark.parametrize("npz", [False, True])
def test_cli_eval_is(tmp_path, capsys, npz):
    """``--eval-is --is-images 64 --device cpu``: the grids, then the score
    line of the root ``main.py``; `evaluate` returns the same (mean, std).
    With ``<data_dir>/inception.npz`` that classifier is used; without it
    the SimpleCNN is finetuned on the train split."""
    os.makedirs(tmp_path / "data")
    if npz:
        convert.save_classifier_npz(str(tmp_path / "data" / "inception.npz"),
                   _simple_cnn(classes=8, width=8, key=3))
    out, (mean, std) = main.main(["--cfg", _tiny_yaml(tmp_path), "--device",
                                  "cpu", "--eval-is", "--is-images", "64"])
    said = capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "eval_grid.png"))
    if npz:
        assert "using converted classifier checkpoint" in said
        assert "finetuning" not in said
    else:
        assert "finetuning eval classifier (8 classes)…" in said
        assert "classifier train accuracy" in said
    line = [ln for ln in said.splitlines() if ln.startswith("Inception")]
    assert line == [f"Inception score: {mean:.3f} ± {std:.3f} "
                    "(64 images, 10 splits)"]
    assert 1.0 <= mean <= 8.0 and np.isfinite(std)
    assert main.parse_args(["--cfg", "x"]).is_images == 3000


def test_cli_is_scores_live_params_and_grids_the_ema(tmp_path, monkeypatch):
    """As the root ``main.py``: the grids come from the EMA weights
    (`sampler.eval_g_params`), the IS from the live ``g_params``."""
    argv = ["--cfg", _tiny_yaml(tmp_path), "--device", "cpu", "--set",
            "train.ema_decay=0.5", "train.batch_size=8"]
    main.main(argv + ["--train", "--steps", "2"])
    snap = torch.load(tmp_path / "ck" / "gancls" / "synthetic" / "step_2.pt",
                      weights_only=True)
    live = snap["g_params"]["up0/w"]
    ema = snap["aux"]["ema_g_params"]["up0/w"]
    assert not torch.equal(live, ema)
    seen = []
    real = tsampler.make_generator_fn

    def spy(cfg, train_mode=True, device="cuda"):
        gen = real(cfg, train_mode, device)

        def wrapped(g_params, *rest):
            seen.append(g_params["up0"]["w"])
            return gen(g_params, *rest)
        wrapped.eps_shape = gen.eps_shape
        return wrapped

    monkeypatch.setattr(tsampler, "make_generator_fn", spy)
    main.main(argv + ["--eval-is", "--is-images", "16"])
    assert len(seen) == 3 + 1           # three grids, one IS batch
    for w in seen[:3]:
        assert torch.equal(w, ema)
    assert torch.equal(seen[3], live)


# --- profiling ----------------------------------------------------------------------

def test_time_step_and_trace(tmp_path):
    def step(state, x):
        return state + x, {"loss": (state * x).sum()}

    got = profiling.time_step(step, torch.zeros(3), torch.ones(3), iters=4,
                              warmup=1)
    assert set(got) == {"ms_per_iter", "iters_per_sec"}
    assert got["ms_per_iter"] > 0 and got["iters_per_sec"] > 0
    with profiling.trace(str(tmp_path)):      # CPU activity only here
        torch.ones(8).cumsum(0)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(tmp_path / files[0]) > 0
