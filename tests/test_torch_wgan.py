"""The port's WGAN-CLS path against the JAX package on the CPU, in f32 at
res 16, gf/df 8, embed 32: the Wasserstein losses and the gradient penalty
(with its gradient in the critic's parameters), the second derivative that
the penalty takes through the `conv5x5_s2_act` and `conditioning_join`
autograd Functions, the layer norm and the layer-norm critic, two whole
ticks against the JAX step body (z and the GP's ε replayed from JAX's own
keys), the bundle, `convert` and the CLI."""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.helpers import tiny_config
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.models import losses as jlosses
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert, main
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.models import gancls as tgancls
from text_to_image_tpu_torch.models import losses as tlosses
from text_to_image_tpu_torch.models import registry as tregistry
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.ops.kernels.conv import conv5x5_s2_act, same_pads
from text_to_image_tpu_torch.ops.kernels.fused import conditioning_join
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.utils import prng as tprng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
GAN = tiny_config("wgancls").gan
# f32: the packages differ in summation order only (the layer norm has no
# small-batch division, unlike the batch norm of the GAN-CLS tests)
TOL = 1e-4


def _port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _close(got, ref, tol, what):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _tree_close(got, ref, tol, what):
    ref_flat, got_flat = dict(flatten(ref)), dict(flatten(got))
    assert got_flat.keys() == ref_flat.keys(), what
    for k, v in ref_flat.items():
        _close(got_flat[k], v, tol, f"{what} {k}")


def _perturb(tree, rng):
    """Biases and layer-norm affines off their init values, so that their
    paths count."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("b", "bias", "scale"):
            out[k] = (np.asarray(v) + rng.normal(size=v.shape) * 0.1
                      ).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


# --- losses ----------------------------------------------------------------------

@pytest.mark.parametrize("drift", [0.0, 1e-3])
def test_wgan_losses_match_jax(drift):
    rng = np.random.default_rng(3)
    real, fake, wrong = (rng.normal(size=8).astype(np.float32) * 3
                         for _ in range(3))
    gp = np.float32(0.37)
    ref = jlosses.wgan_cls_d_loss(real, fake, wrong, gp, 0.5, 10.0, drift)
    got = tlosses.wgan_cls_d_loss(_t(real), _t(fake), _t(wrong), _t(gp), 0.5,
                                  10.0, drift)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k], ref[k], 1e-6, k)
    _close(tlosses.wgan_cls_g_loss(_t(fake))["g_loss"],
           jlosses.wgan_cls_g_loss(fake)["g_loss"], 1e-6, "g_loss")


@pytest.fixture(scope="module")
def critic():
    """A JAX layer-norm critic at res 16 (perturbed), a batch of images,
    embeddings and the GP's ε."""
    params, _ = jax.device_get(jgancls.discriminator_init(
        jax.random.PRNGKey(2), GAN, RES, norm="layer"))
    rng = np.random.default_rng(6)
    params = _perturb(params, rng)
    xs = rng.uniform(-1, 1, (3, 4, RES, RES, 3)).astype(np.float32)
    embs = rng.normal(size=(3, 4, GAN.embed_dim)).astype(np.float32)
    eps = rng.uniform(size=(4, 1, 1, 1)).astype(np.float32)
    return types.SimpleNamespace(params=params, xs=xs, embs=embs, eps=eps)


def test_gradient_penalty_and_its_gradient_match_jax(critic):
    """The penalty over the layer-norm critic at x̂ between real and fake,
    and its gradient in every critic parameter (the second derivative
    through the conv and join Functions)."""
    real, fake, emb = critic.xs[0], critic.xs[1], critic.embs[0]

    def jgp(params):
        def on_images(x):
            return jgancls.discriminator_apply(params, {}, x, emb, True,
                                               JL.FP32, RES, norm="layer")[0]
        return jlosses.gradient_penalty(on_images, real, fake, critic.eps)

    ref, ref_grads = jax.value_and_grad(jgp)(critic.params)
    p, _ = convert.from_jax_discriminator(critic.params, {}, "cpu")
    leaves = [v.requires_grad_(True) for _, v in flatten(p)]

    def on_images(x):
        return tgancls.discriminator_apply(p, {}, x, _t(emb), True, TL.FP32,
                                           RES, norm="layer")[0]

    got = tlosses.gradient_penalty(on_images, _t(real), _t(fake),
                                   _t(critic.eps))
    _close(got, ref, TOL, "gp")
    assert float(got.detach()) > 0
    # the logit's bias leaves no trace on ∂D/∂x̂: JAX gives it a 0
    grads = [torch.zeros_like(v) if g is None else g for v, g in zip(
        leaves, torch.autograd.grad(got, leaves, allow_unused=True))]
    _tree_close(dict(zip((n for n, _ in flatten(p)), grads)),
                dict(flatten(jax.device_get(ref_grads))), TOL, "d gp / d θ")


# --- the second derivative through the kernels' autograd Functions -------------

def _conv_ref(x, w, b, act):
    """act(conv5x5 s2 SAME(x) + b) by F.conv2d, in x's dtype."""
    _, pt, pb = same_pads(x.shape[1])
    _, pl, pr = same_pads(x.shape[2])
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb)),
                 w.permute(3, 2, 0, 1), b, stride=2).permute(0, 2, 3, 1)
    return F.leaky_relu(y, 0.2) if act == "lrelu" else y


def _join_ref(x, t, wx, wt, b, act):
    y = x @ wx + (t @ wt + b)[:, None, None, :]
    return F.leaky_relu(y, 0.2) if act == "lrelu" else y


def _penalty_grads(fn, inputs, params, v):
    """∂‖∂(Σ fn·v)/∂inputs‖² / ∂params, the shape of the GP's gradient."""
    ins = [i.detach().requires_grad_(True) for i in inputs]
    ps = [p.detach().requires_grad_(True) for p in params]
    y = fn(*ins, *ps)
    inner = torch.autograd.grad((y * v).sum(), ins, create_graph=True)
    s = sum((g**2).sum() for g in inner)
    return torch.autograd.grad(s, ps, allow_unused=True)


# the kernels' plain versions and backwards compute in f32 whatever their
# input type: f32 inputs agree with the f32 reference to f32 rounding, f64
# inputs with the f64 reference to f32 rounding of the products
SECOND_TOL = {torch.float32: 2e-5, torch.float64: 2e-5}


def _check_second(got, want, params, names, dtype):
    """Each parameter's second-order gradient within SECOND_TOL of the
    reference's largest element; the bias, which leaves no trace on ∂y/∂x
    (act'' = 0 a.e.), exactly 0 in both."""
    for name, p, g, r in zip(names, params, got, want):
        g = torch.zeros_like(p) if g is None else g.to(p.dtype)
        r = torch.zeros_like(p) if r is None else r
        scale = float(r.abs().max())
        if name == "b":
            assert scale == 0 and float(g.abs().max()) == 0, name
            continue
        assert scale > 0, name
        torch.testing.assert_close(g, r, rtol=0,
                                   atol=SECOND_TOL[dtype] * scale,
                                   msg=f"d/d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_conv_second_derivative_matches_f_conv2d(act, dtype):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 9, 8, 5, generator=gen, dtype=dtype)
    w = torch.randn(5, 5, 5, 6, generator=gen, dtype=dtype) * 0.3
    b = torch.randn(6, generator=gen, dtype=torch.float32)
    v = torch.randn(3, 5, 4, 6, generator=gen, dtype=dtype)

    def kernel(x, w, b):
        return conv5x5_s2_act(x, w, b, act)

    def ref(x, w, b):
        return _conv_ref(x, w, b.to(dtype), act)

    _check_second(_penalty_grads(kernel, [x], [w, b], v),
                  _penalty_grads(ref, [x], [w, b], v), [w, b], ("w", "b"),
                  dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("act", ["none", "lrelu"])
def test_join_second_derivative_matches_matmul(act, dtype):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 4, 4, 6, generator=gen, dtype=dtype)
    t = torch.randn(3, 5, generator=gen, dtype=dtype)
    wx = torch.randn(6, 7, generator=gen, dtype=dtype) * 0.3
    wt = torch.randn(5, 7, generator=gen, dtype=dtype) * 0.3
    b = torch.randn(7, generator=gen, dtype=torch.float32)
    v = torch.randn(3, 4, 4, 7, generator=gen, dtype=dtype)

    def kernel(x, t, wx, wt, b):
        return conditioning_join(x, t, wx, wt, b, act)

    def ref(x, t, wx, wt, b):
        return _join_ref(x, t, wx, wt, b.to(dtype), act)

    _check_second(_penalty_grads(kernel, [x, t], [wx, wt, b], v),
                  _penalty_grads(ref, [x, t], [wx, wt, b], v),
                  [wx, wt, b], ("wx", "wt", "b"), dtype)


# --- layer norm and the layer-norm critic -----------------------------------------

def test_layer_norm_matches_jax():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(3, 4, 5, 6)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=6).astype(np.float32),
         "bias": rng.normal(size=6).astype(np.float32)}
    got = TL.layer_norm({k: _t(v) for k, v in p.items()}, _t(x))
    _close(got, JL.layer_norm(p, x), 1e-5, "layer_norm")
    init = TL.layer_norm_init(6)
    _tree_close(init, jax.device_get(JL.layer_norm_init(6)), 0, "init")
    got16 = TL.layer_norm(init, _t(x).to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16


def test_layer_critic_init_has_the_jax_layers():
    tp, ts = tgancls.discriminator_init(0, GAN, RES, norm="layer")
    jp, js = jax.device_get(jgancls.discriminator_init(
        jax.random.PRNGKey(0), GAN, RES, norm="layer"))
    assert ts == {} and js == {}
    assert {k: v.shape for k, v in flatten(tp)} == {
        k: tuple(v.shape) for k, v in flatten(jp)}
    with pytest.raises(ValueError, match="norm"):
        tgancls.discriminator_init(0, GAN, RES, norm="group")


def test_layer_critic_matches_jax(critic):
    p, s = convert.from_jax_discriminator(critic.params, {}, "cpu")
    for i in range(3):
        ref, ref_s = jgancls.discriminator_apply(
            critic.params, {}, critic.xs[i], critic.embs[i], True, JL.FP32,
            RES, norm="layer")
        got, got_s = tgancls.discriminator_apply(
            p, s, _t(critic.xs[i]), _t(critic.embs[i]), True, TL.FP32, RES,
            norm="layer")
        _close(got, ref, TOL, f"stream {i}")
        assert got_s == {} and ref_s == {}
    ref, _ = jgancls.discriminator_apply_streams(
        critic.params, {}, critic.xs, critic.embs, True, JL.FP32, RES,
        norm="layer")
    got, got_s = tgancls.discriminator_apply_streams(
        p, s, _t(critic.xs), _t(critic.embs), True, TL.FP32, RES,
        norm="layer")
    assert tuple(got.shape) == (3, 4) and got_s == {}
    _close(got, ref, TOL, "streams")


# --- two whole ticks against the JAX step -------------------------------------------

def jax_draws(jcfg, step, batch):
    """What the JAX step draws at `step`: per critic update ``kz, kg, keps =
    split(k, 3)`` (z from kz, the CA ε from kg, the GP's ε
    ``uniform_eps(keps)``), for the G step ``kz, kg, kz2, kg2 =
    split(g_key, 4)``."""
    key = jprng.step_key(jprng.base_key(jcfg.seed), step)
    zd, ca = jcfg.gan.z_dim, jcfg.gan.ca_dim

    def normal(k, *shape):
        return np.array(jax.random.normal(k, shape, jnp.float32))

    d_keys = [jax.random.split(k, 3) for k in jax.random.split(
        jax.random.fold_in(key, 0), jcfg.train.n_critic)]
    kz, kg, kz2, kg2 = jax.random.split(jax.random.fold_in(key, 1), 4)
    noise = {"d": np.stack([normal(k[0], batch, zd) for k in d_keys]),
             "gp_eps": np.stack([np.array(jprng.uniform_eps(k[2], batch))
                                 for k in d_keys]),
             "g": normal(kz, batch, zd), "g2": normal(kz2, batch, zd)}
    if jcfg.model == "pggan":
        noise["d_eps"] = np.stack([normal(k[1], batch, ca) for k in d_keys])
        noise["g_eps"] = normal(kg, batch, ca)
        noise["g2_eps"] = normal(kg2, batch, ca)
    return noise


def jax_ticks(jcfg, n_ticks=2, batch_size=6, seed=12):
    """JAX ticks from perturbed weights (one compiled step body): states,
    batches (uint8 images) and metrics."""
    spe = 3
    ts0 = jsteps.init_train_state(jprng.base_key(1), jcfg, spe)
    rng = np.random.default_rng(seed)
    ts0 = ts0.replace(**{k: _perturb(jax.device_get(getattr(ts0, k)), rng)
                         for k in ("g_params", "d_params")})
    body = jax.jit(jsteps._make_step_body(jcfg.compute_key(), spe))
    k, res = jcfg.train.n_critic, jcfg.data.image_size
    batches = [{"real": rng.integers(0, 256, (k, batch_size, res, res, 3),
                                     np.uint8),
                "wrong": rng.integers(0, 256, (k, batch_size, res, res, 3),
                                      np.uint8),
                "emb": rng.normal(size=(k, batch_size, jcfg.gan.embed_dim)
                                  ).astype(np.float32)}
               for _ in range(n_ticks)]
    states, metrics = [jax.device_get(ts0)], []
    for batch in batches:
        ts, m = body(states[-1], batch)
        states.append(jax.device_get(ts))
        metrics.append(jax.device_get(m))
    return types.SimpleNamespace(jcfg=jcfg, cfg=_port_cfg(jcfg), spe=spe,
                                 states=states, metrics=metrics,
                                 batches=batches, batch_size=batch_size)


def port_tick(ticks, i, grads=None, state=None):
    """The port's tick i from the converted JAX state i (or `state`); with
    `grads` (a dict), every update's gradients are recorded under "g" and
    "d"."""
    ts = state or convert.from_jax_train_state(ticks.states[i], ticks.cfg,
                                               ticks.spe, "cpu")
    if grads is not None:
        for net in ("g", "d"):
            opt = getattr(ts, f"{net}_opt")
            grads[net] = []

            def update(gs, opt=opt, out=grads[net], apply=opt.update):
                out.append(dict(zip(opt.names, (g.clone() for g in gs))))
                apply(gs)
            opt.update = update
    step = tsteps.make_train_step(ticks.cfg, ticks.spe, device="cpu")
    return step(ts, ticks.batches[i], noise=jax_draws(
        ticks.jcfg, getattr(ticks, "step0", 0) + i, ticks.batch_size))


# A pre-activation within round-off of an lrelu's kink takes act′ from
# opposite sides in the two packages (ROADMAP.md §3): the gradient of the
# few weights that see it then differs (measured: one of the 3·6 slices'
# down0 maps holds a pre-activation of 7.5e-9, and 3 of down0's 600 weight
# elements move).  At most KINK_SHARE of a net's moment elements may lie
# outside TOL; the rest are held at TOL.
KINK_SHARE = 1e-3


def _share_close(pairs, tol, what):
    """(got, ref) element arrays, each held at `tol` (absolute + relative
    to ref), at most KINK_SHARE of all of them outside it."""
    far = total = 0
    for g, v in pairs:
        bad = np.abs(g - v) > tol + tol * np.abs(v)
        far, total = far + int(bad.sum()), total + bad.size
    assert far <= KINK_SHARE * total, f"{what}: {far} of {total} apart"


def _moments_close(got, ref, what):
    """An Adam moment tree (the second as its square root, on the
    gradients' scale) against JAX's at TOL, with the kink allowance."""
    ref = dict(flatten(ref))
    assert got.keys() == ref.keys(), what
    _share_close([(got[k].detach().numpy(), v) for k, v in ref.items()], TOL,
                 what)


def check_tick(ticks, i, ts, metrics, grads):
    """Metrics, Adam counts and moments, params after Adam (where every
    update's gradient is clear of 0, within 1 % of an lr step: a round-off
    gradient moves by a different ±lr in each package) and the EMA,
    against JAX's state i + 1."""
    ref, ref_m = ticks.states[i + 1], ticks.metrics[i]
    assert ts.step == int(ref.step) == getattr(ticks, "step0", 0) + i + 1
    assert metrics.keys() == ref_m.keys()
    for k in ref_m:
        _close(metrics[k], ref_m[k], TOL, k)
    for name, opt, jopt in (("g", ts.g_opt, ref.g_opt),
                            ("d", ts.d_opt, ref.d_opt)):
        assert opt.count == int(jopt[0].count)
        assert {float(opt.opt.state[p]["step"]) for p in opt.leaves} == {
            float(opt.count)}
        mu, nu = opt.moments()
        _moments_close(mu, jopt[0].mu, f"{name} mu")
        _moments_close({k: v.sqrt() for k, v in nu.items()},
                       {k: np.sqrt(v) for k, v in flatten(jopt[0].nu)},
                       f"{name} √nu")
    lr = ticks.cfg.train.generator_lr
    ema = dict(flatten(ref.aux.get("ema_g_params", {})))
    got_ema = dict(flatten(ts.aux.get("ema_g_params", {})))
    for name, params, jparams in (("g", ts.g_params, ref.g_params),
                                  ("d", ts.d_params, ref.d_params)):
        ref_flat, pairs = dict(flatten(jparams)), []
        for leaf, v in flatten(params):
            keep = np.all([g[leaf].abs().numpy() > 2e-4
                           for g in grads[name]], axis=0)
            pairs.append((v.detach().numpy()[keep], ref_flat[leaf][keep]))
            if name == "g" and ema:
                pairs.append((got_ema[leaf].numpy()[keep], ema[leaf][keep]))
        # the relative part of the tolerance is 1 % of lr·|param|: f32
        # rounding of the update
        _share_close(pairs, 0.01 * lr, f"{name} params after Adam")


TICK_CONFIGS = {
    # the shipped recipe's optimizer and drift term, two critic updates
    "plain": dict(),
    # GAN-INT's G term and the ramped EMA
    "int_ema": dict(use_interpolation=True, ema_decay=0.9, ema_rampup=2.0),
}


@functools.lru_cache(maxsize=None)
def _wgan_ticks(name):
    jcfg = tiny_config("wgancls", n_critic=2, g_steps=1, beta1=0.0,
                       generator_lr=1e-4, discriminator_lr=1e-4,
                       **TICK_CONFIGS[name])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, coeff=dataclasses.replace(jcfg.train.coeff,
                                              drift_epsilon=1e-3)))
    return jax_ticks(jcfg)


@pytest.fixture(params=sorted(TICK_CONFIGS))
def wticks(request):
    return _wgan_ticks(request.param)


@pytest.mark.parametrize("i", [0, 1])
def test_wgan_tick_matches_jax_step(wticks, i):
    """Tick i from the converted JAX state i (tick 1 carries the Adam
    moments and counts across): d_loss, w_dist, d_wrong, gp, g_loss (and
    g_interp), Adam moments (the gradients, GP included), params and the
    EMA."""
    grads = {}
    ts, metrics = port_tick(wticks, i, grads)
    assert (len(grads["g"]), len(grads["d"])) == (1, 2)
    assert {"gp", "w_dist", "d_wrong"} <= metrics.keys()
    check_tick(wticks, i, ts, metrics, grads)


def test_wgan_tick_semantics(wticks):
    """The critic has no state; every param tree moves; the GP's ε is the
    tick's own: another ε gives another gp and other critic params."""
    ts, m = port_tick(wticks, 0)
    before = wticks.states[0]
    assert ts.d_state == {}
    for tree in ("g_params", "d_params"):
        got = dict(flatten(getattr(ts, tree)))
        ref = dict(flatten(getattr(before, tree)))
        assert any(not np.allclose(got[k].detach().numpy(), ref[k])
                   for k in ref), tree
    ts2 = convert.from_jax_train_state(before, wticks.cfg, wticks.spe, "cpu")
    noise = jax_draws(wticks.jcfg, 0, wticks.batch_size)
    noise["gp_eps"] = 1.0 - noise["gp_eps"]
    _, m2 = tsteps.make_train_step(wticks.cfg, wticks.spe, "cpu")(
        ts2, wticks.batches[0], noise=noise)
    assert float(m2["gp"]) != float(m["gp"])
    assert not torch.allclose(ts2.d_params["down1"]["w"],
                              ts.d_params["down1"]["w"])


def test_gp_noise_is_drawn_per_critic_update():
    cfg = _port_cfg(tiny_config("wgancls", n_critic=3))
    a, b = tsteps.draw_noise(cfg, 5, 4), tsteps.draw_noise(cfg, 5, 4)
    assert a["gp_eps"].shape == (3, 4, 1, 1, 1)
    torch.testing.assert_close(a["gp_eps"], b["gp_eps"], rtol=0, atol=0)
    assert not torch.equal(a["gp_eps"][0], a["gp_eps"][1])
    assert float(a["gp_eps"].min()) >= 0 and float(a["gp_eps"].max()) < 1
    assert "gp_eps" not in tsteps.draw_noise(
        _port_cfg(tiny_config("gancls")), 5, 4)
    eps = tprng.uniform_eps(7, 5)
    assert eps.shape == (5, 1, 1, 1) and eps.dtype == torch.float32


# --- bundle, convert and the CLI ---------------------------------------------------

def test_wgancls_bundle():
    bundle = tregistry.get_model(_port_cfg(tiny_config("wgancls")))
    assert bundle.is_wgan and not bundle.has_ca and not bundle.needs_stage1
    assert bundle.step_aux is None and bundle.prep_images is None
    assert bundle.ema_anchor == 0 and bundle.eps_shape(4) is None
    gp, gs, dp, ds = bundle.init(3, "cpu")
    assert ds == {} and "down1_ln" in dp and "join_ln" in dp
    assert "down1_bn" not in dp and "stem_bn" in gp


def test_convert_carries_a_wgancls_train_state(wticks, tmp_path):
    """A JAX WGAN-CLS TrainState carried whole (both nets, Adam counts and
    moments, the EMA), and its generator through an ``.npz``."""
    ref = wticks.states[1]
    ts = convert.from_jax_train_state(ref, wticks.cfg, wticks.spe, "cpu")
    _tree_close(ts.d_params, ref.d_params, 0, "d_params")
    _tree_close(ts.g_params, ref.g_params, 0, "g_params")
    mu, nu = ts.d_opt.moments()
    _tree_close(mu, ref.d_opt[0].mu, 0, "d mu")
    assert ts.d_opt.count == int(ref.d_opt[0].count) == 2
    path = str(tmp_path / "g.npz")
    convert.save_npz(path, ref.g_params, ref.g_state)
    p, s = convert.load_npz(path, "cpu")
    _tree_close(p, ref.g_params, 0, "npz params")
    _tree_close(s, ref.g_state, 0, "npz state")


def test_wgancls_cli_trains_and_samples(tmp_path, capsys):
    """The shipped config at tiny widths: two ticks with finite critic
    metrics, then the three grids from the checkpoint."""
    argv = ["--cfg", os.path.join(ROOT, "configs", "wgancls_flowers.yml"),
            "--device", "cpu", "--set", "data.dataset_name=synthetic",
            "data.image_size=16", "gan.gf_dim=8", "gan.df_dim=8",
            "gan.z_dim=8", "gan.embed_dim=32", "train.batch_size=4",
            "train.n_critic=2", "dtype=float32", "train.summary_interval=1",
            *[f"{k}={tmp_path / k}" for k in ("checkpoint_dir", "log_dir",
                                              "sample_dir")]]
    main.main(argv[:4] + ["--train", "--steps", "2"] + argv[4:])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step 2]")]
    assert len(lines) == 1, lines
    fields = dict(kv.split("=") for kv in lines[0].split()[2:])
    for k in ("d_loss", "w_dist", "d_wrong", "gp", "g_loss"):
        assert np.isfinite(float(fields[k])), k
    main.main(argv)
    assert "sampling from the step-2 checkpoint" in capsys.readouterr().out
    out = tmp_path / "sample_dir" / "wgancls" / "synthetic"
    for name in ("eval_grid", "z_interp", "t_interp"):
        assert (out / f"{name}_2.png").exists(), name
