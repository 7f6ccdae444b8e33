"""The port's StackGAN path against the JAX package on the CPU, in f32 at
gf/df 8, ca 16, embed 32 (Stage-I at 16 px; Stage-II at 32 px over an 8 px
Stage-I): the layers StackGAN adds, conditioning augmentation, the residual
block, both generators, the Stage-II bundle with its frozen Stage-I, the KL
loss, one whole training tick of each stage against the JAX step body,
`remat`, `convert` and the sampler.  Weights are the JAX package's (carried
by `convert`), perturbed so that biases and BN statistics count; z and the
conditioning-augmentation ε are the JAX package's own draws, replayed with
``jax.random`` and handed to the port."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.eval import sampler as jsampler
from text_to_image_tpu.models import losses as jlosses
from text_to_image_tpu.models import registry as jregistry
from text_to_image_tpu.models import stackgan as jstackgan
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.eval import sampler as tsampler
from text_to_image_tpu_torch.models import losses as tlosses
from text_to_image_tpu_torch.models import registry as tregistry
from text_to_image_tpu_torch.models import stackgan as tstackgan
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train.optim import flatten

# f32: the two packages differ in summation order only; train-mode BN over
# 4-6 examples divides by small standard deviations, hence 1e-4
TOL = 1e-4
GAN = tiny_config("stackgan_stage1").gan
B = 6


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _perturb(tree, rng):
    """JAX init leaves biases at 0 and BN state at (0, 1); give them values
    so that the bias and running-statistics paths are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("b", "bias", "mean"):
            out[k] = (np.asarray(v) + rng.normal(size=v.shape) * 0.1
                      ).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _close(got, ref, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _tree_close(got, ref, tol, what):
    ref_flat, got_flat = dict(flatten(ref)), dict(flatten(got))
    assert got_flat.keys() == ref_flat.keys(), what
    for k, v in ref_flat.items():
        _close(got_flat[k], v, tol, f"{what} {k}")


def _normal(key, *shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


# --- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("k,stride", [(3, 1), (4, 2)])
@pytest.mark.parametrize("hw", [(8, 8), (7, 5), (6, 9)])
def test_conv2d_same_matches_jax(k, stride, hw):
    """3×3 stride 1 and 4×4 stride 2 SAME on even and odd maps: 4×4 s2 pads
    (1, 1) on an even map and (1, 2) on an odd one."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    p = {"w": (rng.normal(size=(k, k, 5, 7)) * 0.1).astype(np.float32),
         "b": rng.normal(size=7).astype(np.float32)}
    ref = np.asarray(JL.conv2d(p, x, stride=stride))
    got = TL.conv2d({n: torch.from_numpy(v) for n, v in p.items()},
                    torch.from_numpy(x), stride=stride)
    assert got.shape == ref.shape and got.is_contiguous()
    _close(got, ref, 1e-5, f"conv {k}x{k} s{stride} {hw}")


def test_same_pads_of_the_4x4_stride_2_conv():
    assert TL._same_pads(64, 4, 2) == (1, 1)
    assert TL._same_pads(7, 4, 2) == (1, 2)
    assert TL._same_pads(9, 3, 1) == (1, 1)


# --- conditioning augmentation, residual block ----------------------------------

def test_ca_apply_matches_jax():
    """lrelu comes before the split (μ and logσ² both pass through it),
    σ = exp(½·logvar), c = μ + σ·ε with the JAX draw of ε."""
    rng = np.random.default_rng(0)
    params = _perturb(jax.device_get(
        jstackgan.ca_init(jax.random.PRNGKey(1), GAN.embed_dim, GAN.ca_dim)),
        rng)
    params["fc"]["w"] = params["fc"]["w"] * 20   # reach both sides of lrelu
    emb = rng.normal(size=(B, GAN.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = jstackgan.ca_apply(params, emb, key)
    tp = convert._to_torch(params, "cpu")
    got = tstackgan.ca_apply(tp, torch.from_numpy(emb),
                             torch.from_numpy(_normal(key, B, GAN.ca_dim)))
    for name, g, r in zip(("c", "mu", "logvar"), got, ref):
        assert g.shape == (B, GAN.ca_dim)
        _close(g, r, 1e-5, name)
    assert float(got[1].min()) < 0 < float(got[1].max())


@pytest.mark.parametrize("train", [True, False])
def test_res_block_matches_jax(train):
    rng = np.random.default_rng(2)
    params, state = jax.device_get(
        jstackgan._res_block_init(jax.random.PRNGKey(2), 12))
    params, state = _perturb(params, rng), _perturb(state, rng)
    x = rng.normal(size=(B, 5, 4, 12)).astype(np.float32)
    ref, ref_s = jstackgan._res_block(params, state, x, train)
    got, got_s = tstackgan._res_block(convert._to_torch(params, "cpu"),
                                      convert._to_torch(state, "cpu"),
                                      torch.from_numpy(x), train)
    _close(got, ref, TOL, "res block")
    _tree_close(got_s, jax.device_get(ref_s), 1e-5, "res block state")


# --- the generators ---------------------------------------------------------------

@pytest.fixture(scope="module")
def gens():
    rng = np.random.default_rng(11)
    s1 = jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(3), GAN, 16))
    s2 = jax.device_get(
        jstackgan.stage2_generator_init(jax.random.PRNGKey(4), GAN, 8))
    return types.SimpleNamespace(
        s1=tuple(_perturb(t, rng) for t in s1),
        s2=tuple(_perturb(t, rng) for t in s2),
        z=rng.normal(size=(B, GAN.z_dim)).astype(np.float32),
        emb=rng.normal(size=(B, GAN.embed_dim)).astype(np.float32),
        lr=rng.uniform(-1, 1, (B, 8, 8, 3)).astype(np.float32),
        key=jax.random.PRNGKey(7))


def test_generator_layers_and_init_match_jax(gens):
    """Same tree of names and shapes; the channel schedule bottoms out at
    gf/2 (the last Stage-II up-block keeps its width)."""
    for (jp, js), (tp, ts) in (
            (gens.s1, tstackgan.stage1_generator_init(0, GAN, 16)),
            (gens.s2, tstackgan.stage2_generator_init(0, GAN, 8))):
        for got, ref in ((tp, jp), (ts, js)):
            assert {k: tuple(v.shape) for k, v in flatten(got)} == \
                   {k: v.shape for k, v in flatten(ref)}
    tp, _ = tstackgan.stage2_generator_init(0, GAN, 8)
    gf = GAN.gf_dim
    assert tuple(tp["up3"]["conv"]["w"].shape) == (3, 3, gf // 2, gf // 2)
    assert abs(float(tp["join"]["w"].std()) - 0.02) < 0.004
    with pytest.raises(ValueError):
        tstackgan.stage1_generator_init(0, GAN, 48)


@pytest.mark.parametrize("train", [True, False])
def test_stage1_generator_matches_jax(gens, train):
    ref = jstackgan.stage1_generator_apply(*gens.s1, gens.z, gens.emb,
                                           gens.key, train, JL.FP32, 16)
    tp, ts = convert.from_jax_generator(*gens.s1, "cpu")
    eps = torch.from_numpy(_normal(gens.key, B, GAN.ca_dim))
    got = tstackgan.stage1_generator_apply(
        tp, ts, torch.from_numpy(gens.z), torch.from_numpy(gens.emb), eps,
        train, TL.FP32, 16)
    assert got[0].shape == (B, 16, 16, 3)
    _close(got[0], ref[0], TOL, "images")
    _tree_close(got[1], jax.device_get(ref[1]), 1e-5, "state")
    assert got[2].keys() == ref[2].keys()
    for k in ref[2]:
        _close(got[2][k], ref[2][k], 1e-5, k)


@pytest.mark.parametrize("train", [True, False])
def test_stage2_generator_matches_jax(gens, train):
    ref = jstackgan.stage2_generator_apply(*gens.s2, gens.lr, gens.emb,
                                           gens.key, train, JL.FP32)
    tp, ts = convert.from_jax_generator(*gens.s2, "cpu")
    eps = torch.from_numpy(_normal(gens.key, B, GAN.ca_dim))
    got = tstackgan.stage2_generator_apply(
        tp, ts, torch.from_numpy(gens.lr), torch.from_numpy(gens.emb), eps,
        train, TL.FP32)
    assert got[0].shape == (B, 32, 32, 3)
    _close(got[0], ref[0], TOL, "images")
    _tree_close(got[1], jax.device_get(ref[1]), 1e-5, "state")
    for k in ("mu", "logvar", "c"):
        _close(got[2][k], ref[2][k], 1e-5, k)


# --- the Stage-II bundle with its frozen Stage-I ----------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_stage2_bundle_matches_jax_and_freezes_stage1(gens, train):
    """Stage-I runs with batch statistics whatever `train` says, from the
    first half of the split key; its state is not returned and no gradient
    reaches it."""
    jcfg = tiny_config("stackgan_stage2")
    s1 = tuple(_perturb(t, np.random.default_rng(3)) for t in jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(6), GAN, 8)))
    jaux = {"stage1_g_params": s1[0], "stage1_g_state": s1[1]}
    ref = jregistry.get_model(jcfg).gen_apply(
        *gens.s2, jaux, gens.z, gens.emb, gens.key, train, JL.FP32)
    k1, k2 = jax.random.split(gens.key)
    eps = torch.from_numpy(np.stack([_normal(k1, B, GAN.ca_dim),
                                     _normal(k2, B, GAN.ca_dim)]))
    bundle = tregistry.get_model(_port_cfg(jcfg))
    assert bundle.needs_stage1 and bundle.has_ca and not bundle.is_wgan
    assert bundle.eps_shape(B) == (2, B, GAN.ca_dim)
    tp, ts = convert.from_jax_generator(*gens.s2, "cpu")
    aux = dict(zip(("stage1_g_params", "stage1_g_state"),
                   convert.from_jax_generator(*s1, "cpu")))
    s1_leaves = [v.requires_grad_(True)
                 for _, v in flatten(aux["stage1_g_params"])]
    leaves = [v.requires_grad_(True) for _, v in flatten(tp)]
    before = {k: v.clone() for k, v in flatten(aux["stage1_g_state"])}
    img, new_gs, gen_aux = bundle.gen_apply(
        tp, ts, aux, torch.from_numpy(gens.z), torch.from_numpy(gens.emb),
        eps, train, TL.FP32)
    _close(img, ref[0], TOL, "images")
    _tree_close(new_gs, jax.device_get(ref[1]), 1e-5, "state")
    for k in ("mu", "logvar"):
        _close(gen_aux[k], ref[2][k], 1e-5, k)
    assert set(new_gs) == set(ts)            # Stage-II's own layers only
    for k, v in flatten(aux["stage1_g_state"]):
        assert torch.equal(v, before[k]), k
    grads = torch.autograd.grad(img.sum(), [*leaves, *s1_leaves],
                                allow_unused=True)
    assert all(g is not None for g in grads[:len(leaves)])
    assert all(g is None for g in grads[len(leaves):])


def test_stage1_bundle_and_the_models_left_to_port():
    bundle = tregistry.get_model(_port_cfg(tiny_config("stackgan_stage1")))
    assert bundle.has_ca and not bundle.needs_stage1
    assert bundle.eps_shape(5) == (5, GAN.ca_dim)
    assert bundle.gen_apply_inference is None
    gp, gs, dp, ds = bundle.init(3, "cpu")
    # the D compresses the text to ca_dim, not compressed_embed_dim
    assert tuple(dp["embed"]["w"].shape) == (GAN.embed_dim, GAN.ca_dim)
    assert tregistry.get_model(_port_cfg(tiny_config())).eps_shape(5) is None


# --- losses ----------------------------------------------------------------------

def test_ca_kl_loss_matches_jax():
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(B, 16)).astype(np.float32)
    logvar = rng.normal(size=(B, 16)).astype(np.float32)
    got = tlosses.ca_kl_loss(torch.from_numpy(mu), torch.from_numpy(logvar))
    _close(got, jlosses.ca_kl_loss(mu, logvar), 1e-6, "kl")
    assert float(tlosses.ca_kl_loss(torch.zeros(3, 4), torch.zeros(3, 4))) == 0


# --- one whole tick of each stage against the JAX step ----------------------------

def _jax_draws(jcfg, step, batch):
    """z and ε as the JAX step draws them at `step`: per D update
    ``kz, kg, _ = split(k, 3)``, for the G step ``kz, kg, _, _ =
    split(g_key, 4)``; Stage-I's CA draws ε from kg, Stage-II splits kg
    once more (first half to the frozen Stage-I, second to its own CA)."""
    key = jprng.step_key(jprng.base_key(jcfg.seed), step)
    zd, ca = jcfg.gan.z_dim, jcfg.gan.ca_dim

    def eps(kg):
        if jcfg.model == "stackgan_stage1":
            return _normal(kg, batch, ca)
        return np.stack([_normal(k, batch, ca) for k in jax.random.split(kg)])

    d_keys = [jax.random.split(k, 3) for k in jax.random.split(
        jax.random.fold_in(key, 0), jcfg.train.n_critic)]
    kz, kg, _, _ = jax.random.split(jax.random.fold_in(key, 1), 4)
    return {"d": np.stack([_normal(k[0], batch, zd) for k in d_keys]),
            "d_eps": np.stack([eps(k[1]) for k in d_keys]),
            "g": _normal(kz, batch, zd), "g_eps": eps(kg)}


TICK_CONFIGS = {
    "stackgan_stage1": dict(g_steps=1),
    # the EMA rides in aux beside the frozen Stage-I generator
    "stackgan_stage2": dict(g_steps=1, ema_decay=0.9),
}


@functools.lru_cache(maxsize=None)
def _jax_tick(model):
    """One JAX tick from perturbed weights (one compiled step body)."""
    jcfg = tiny_config(model, **TICK_CONFIGS[model])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=B))
    spe = 3
    ts0 = jsteps.init_train_state(jprng.base_key(1), jcfg, spe)
    rng = np.random.default_rng(12)
    ts0 = ts0.replace(**{k: _perturb(jax.device_get(getattr(ts0, k)), rng)
                         for k in ("g_params", "g_state", "d_params",
                                   "d_state", "aux")})
    res = jcfg.data.image_size
    batch = {"real": rng.integers(0, 256, (1, B, res, res, 3), np.uint8),
             "wrong": rng.integers(0, 256, (1, B, res, res, 3), np.uint8),
             "emb": rng.normal(size=(1, B, jcfg.gan.embed_dim)
                               ).astype(np.float32)}
    ts0 = jax.device_get(ts0)
    ts1, metrics = jax.jit(jsteps._make_step_body(jcfg.compute_key(), spe))(
        ts0, batch)
    return types.SimpleNamespace(
        model=model, jcfg=jcfg, cfg=_port_cfg(jcfg), spe=spe, ts0=ts0,
        ts1=jax.device_get(ts1), metrics=jax.device_get(metrics), batch=batch,
        noise=_jax_draws(jcfg, 0, B))


@pytest.fixture(params=sorted(TICK_CONFIGS))
def tick(request):
    return _jax_tick(request.param)


def _port_tick(tick, cfg=None, grads=None):
    cfg = cfg or tick.cfg
    ts = convert.from_jax_train_state(tick.ts0, cfg, tick.spe, "cpu")
    if grads is not None:
        for net in ("g", "d"):
            opt = getattr(ts, f"{net}_opt")

            def update(gs, opt=opt, net=net, apply=opt.update):
                grads[net] = dict(zip(opt.names, (g.clone() for g in gs)))
                apply(gs)
            opt.update = update
    step = tsteps.make_train_step(cfg, tick.spe, device="cpu")
    return step(ts, tick.batch, noise=tick.noise)


def test_tick_matches_jax_step(tick):
    """Losses (with ``kl``), BN states, Adam moments (the gradients), params
    after Adam and the EMA; Stage-II's frozen Stage-I untouched."""
    grads = {}
    ts, metrics = _port_tick(tick, grads=grads)
    ref = tick.ts1
    assert ts.step == int(ref.step) == 1
    assert ts.aux.keys() == ref.aux.keys()
    assert metrics.keys() == tick.metrics.keys() and "kl" in metrics
    for k, v in tick.metrics.items():
        _close(metrics[k], v, TOL, k)
    _tree_close(ts.g_state, ref.g_state, TOL, "g_state")
    _tree_close(ts.d_state, ref.d_state, TOL, "d_state")
    for name, opt, jopt in (("g", ts.g_opt, ref.g_opt),
                            ("d", ts.d_opt, ref.d_opt)):
        assert opt.count == int(jopt[0].count) == 1
        mu, nu = opt.moments()
        _tree_close(mu, jopt[0].mu, TOL, f"{name} mu")
        _tree_close(nu, jopt[0].nu, 1e-6, f"{name} nu")
    # params after Adam: the first update moves by ≈ lr·sign(g), so an
    # element whose gradient is round-off moves by a different ±lr in each
    # package: every bias in front of a train-mode BN (stem, up*/conv,
    # enc1-2, join, res*/conv1-2, down1+) has a true gradient of 0.  Compare
    # where |g| is clear of 0 (> 2e-4), within 1 % of a step (lr 2e-4).
    ema = dict(flatten(ref.aux.get("ema_g_params", {})))
    for name, params, jparams in (("g", ts.g_params, ref.g_params),
                                  ("d", ts.d_params, ref.d_params)):
        ref_flat = dict(flatten(jparams))
        for leaf, v in flatten(params):
            keep = grads[name][leaf].abs().numpy() > 2e-4
            assert keep.mean() > 0.5 or leaf.endswith("/b"), leaf
            _close(v.detach().numpy()[keep], ref_flat[leaf][keep], 2e-6,
                   f"{name} {leaf}")
            if name == "g" and ema:
                got_ema = dict(flatten(ts.aux["ema_g_params"]))[leaf]
                _close(got_ema.numpy()[keep], ema[leaf][keep], 2e-6,
                       f"ema {leaf}")
    if tick.model == "stackgan_stage2":
        assert "ema_g_params" in ts.aux
        for key in ("stage1_g_params", "stage1_g_state"):
            before = dict(flatten(tick.ts0.aux[key]))
            for leaf, v in flatten(ts.aux[key]):
                assert not v.requires_grad
                np.testing.assert_array_equal(v.numpy(), before[leaf], leaf)
        # Stage-I is in neither the optimizer nor the EMA
        assert not any("stage1" in n for n in ts.g_opt.names)


def test_tick_moves_every_tree_and_kl_weighs_in(tick):
    ts, metrics = _port_tick(tick)
    for tree in ("g_params", "d_params", "g_state", "d_state"):
        got = dict(flatten(getattr(ts, tree)))
        ref = dict(flatten(getattr(tick.ts0, tree)))
        assert any(not np.allclose(got[k].detach().numpy(), ref[k])
                   for k in ref), tree
    kl_w = tick.cfg.train.coeff.kl
    _close(metrics["g_loss"], metrics["g_fake"] + kl_w * metrics["kl"], 1e-6,
           "g_loss = g_fake + w·kl")


def test_remat_gives_the_same_tick():
    """``remat`` recomputes the Stage-II generator in the backward pass
    (torch.utils.checkpoint): same losses, same gradients."""
    tick = _jax_tick("stackgan_stage2")
    plain, remat = {}, {}
    _, m0 = _port_tick(tick, grads=plain)
    _, m1 = _port_tick(tick, dataclasses.replace(tick.cfg, remat=True),
                       grads=remat)
    for k in m0:
        _close(m1[k], m0[k].numpy(), 1e-6, k)
    for net in ("g", "d"):
        for leaf, g in plain[net].items():
            _close(remat[net][leaf], g.numpy(), 1e-6, f"{net} {leaf}")


def test_noise_includes_the_ca_draws():
    for model, shape in (("stackgan_stage1", (4, 16)),
                         ("stackgan_stage2", (2, 4, 16))):
        cfg = _port_cfg(tiny_config(model, n_critic=2,
                                    use_interpolation=True))
        a, b = tsteps.draw_noise(cfg, 5, 4), tsteps.draw_noise(cfg, 5, 4)
        assert a["d_eps"].shape == (2, *shape)
        assert a["g_eps"].shape == a["g2_eps"].shape == shape
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert not torch.equal(a["g_eps"], a["g2_eps"])
        assert not torch.equal(a["d_eps"][0], a["d_eps"][1])
        assert not torch.equal(a["g_eps"], tsteps.draw_noise(cfg, 6, 4)["g_eps"])
    assert "g_eps" not in tsteps.draw_noise(_port_cfg(tiny_config()), 0, 4)


def test_init_train_state_carries_stage1(gens):
    """From a seed, and from a given (params, state); beside the EMA."""
    cfg = _port_cfg(tiny_config("stackgan_stage2", ema_decay=0.9))
    ts = tsteps.init_train_state(3, cfg, 5, "cpu")
    assert set(ts.aux) == {"ema_g_params", "stage1_g_params", "stage1_g_state"}
    res = cfg.data.image_size // 4
    ref, _ = tstackgan.stage1_generator_init(0, cfg.gan, res)
    assert {k: v.shape for k, v in flatten(ts.aux["stage1_g_params"])} == \
           {k: v.shape for k, v in flatten(ref)}
    given = convert.from_jax_generator(*jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(0), cfg.gan, res)),
        "cpu")
    ts = tsteps.init_train_state(3, cfg, 5, "cpu", stage1=given)
    assert torch.equal(ts.aux["stage1_g_params"]["stem"]["w"],
                       given[0]["stem"]["w"])
    assert "stage1_g_params" not in tsteps.init_train_state(
        3, _port_cfg(tiny_config("stackgan_stage1")), 5, "cpu").aux


# --- sampler ----------------------------------------------------------------------

@pytest.mark.parametrize("model", ["stackgan_stage1", "stackgan_stage2"])
def test_sampler_grid_matches_jax(model):
    """The sample grid through both samplers: z and ε are the JAX draws
    (``fold_in(key, 0)`` for z, ``fold_in(key, 1)`` for the generator)."""
    jcfg = tiny_config(model)
    tcfg = _port_cfg(jcfg)
    jts = jsteps.init_train_state(jprng.base_key(2), jcfg, 3)
    tts = convert.from_jax_train_state(jax.device_get(jts), tcfg, 3, "cpu")
    gen_state = tsampler.GeneratorState(tts.g_params, tts.g_state, tts.aux)
    emb = np.random.default_rng(2).normal(
        size=(B, jcfg.gan.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref = jsampler.sample_grid(jsampler.make_generator_fn(jcfg), jts, jcfg,
                               emb, key)
    z = _normal(jax.random.fold_in(key, 0), B, jcfg.gan.z_dim)
    kg = jax.random.fold_in(key, 1)
    eps = (_normal(kg, B, GAN.ca_dim) if model == "stackgan_stage1" else
           np.stack([_normal(k, B, GAN.ca_dim) for k in jax.random.split(kg)]))
    tgen = tsampler.make_generator_fn(tcfg, device="cpu")
    got = tsampler.sample_grid(tgen, gen_state, tcfg, emb, z=z, eps=eps)
    assert got.shape == ref.shape == (B, jcfg.data.image_size,
                                      jcfg.data.image_size, 3)
    _close(got, ref, TOL, "sample grid")
    # without ε the sampler draws it from the generator it is given
    g = torch.Generator().manual_seed(1)
    a = tsampler.sample_grid(tgen, gen_state, tcfg, emb, z=z, generator=g)
    assert a.shape == got.shape and not np.allclose(a, got)
    imgs, shape = tsampler.latent_interpolation_grid(
        tgen, gen_state, tcfg, emb[:2], 3, generator=g)
    assert shape == (2, 3) and imgs.shape[0] == 6 and np.isfinite(imgs).all()
    imgs, shape = tsampler.text_interpolation_grid(
        tgen, gen_state, tcfg, emb[:2], emb[2:4], 3, generator=g)
    assert shape == (2, 3) and imgs.shape[0] == 6 and np.isfinite(imgs).all()
