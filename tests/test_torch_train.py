"""The port's GAN-CLS training tick against the JAX package on the CPU, in
f32 at res 16, gf/df 8, embed 32: the discriminator (forward, BN state,
gradients), the losses, Adam with the staircase schedule against
``optax.adam``, and one whole tick against the JAX package's own step body
on the same converted weights, data and z."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.models import losses as jlosses
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.train import optim as joptim
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.models import gancls as tgancls
from text_to_image_tpu_torch.models import losses as tlosses
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.train import optim as toptim
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train.optim import flatten

RES = 16
# f32 forward: the two packages differ only in summation order; train-mode
# BN over 4-8 examples divides by small standard deviations, so D logits
# and gradients get 1e-4 (absolute + relative)
TOL = 1e-4


def _port_cfg(jcfg):
    """The port's Config with the same values as a JAX Config."""
    return config_from_dict(dataclasses.asdict(jcfg))


def _perturb(tree, rng):
    """JAX init leaves biases at 0 and BN state at (0, 1); give them values
    so that bias and running-statistics paths are exercised."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("b", "bias", "mean"):
            out[k] = (np.asarray(v) + rng.normal(size=v.shape) * 0.1).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, size=v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def _close(got, ref, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _tree_close(got, ref, tol, what):
    ref_flat = dict(flatten(ref))
    got_flat = dict(flatten(got))
    assert got_flat.keys() == ref_flat.keys(), what
    for k, v in ref_flat.items():
        _close(got_flat[k].detach().cpu().numpy(), v, tol, f"{what} {k}")


# --- discriminator -------------------------------------------------------------

@pytest.fixture(scope="module")
def disc():
    gan = tiny_config().gan
    params, state = jax.device_get(
        jgancls.discriminator_init(jax.random.PRNGKey(2), gan, RES))
    rng = np.random.default_rng(6)
    params, state = _perturb(params, rng), _perturb(state, rng)
    xs = rng.uniform(-1, 1, (3, 4, RES, RES, 3)).astype(np.float32)
    embs = rng.normal(size=(3, 4, gan.embed_dim)).astype(np.float32)
    return types.SimpleNamespace(params=params, state=state, xs=xs, embs=embs)


def test_discriminator_layers_and_init_match_jax(disc):
    tp, ts = tgancls.discriminator_init(0, tiny_config().gan, RES)
    for got, ref in ((tp, disc.params), (ts, disc.state)):
        assert {k: {n: tuple(v.shape) for n, v in d.items()}
                for k, d in got.items()} == \
               {k: {n: v.shape for n, v in d.items()} for k, d in ref.items()}
    assert abs(float(tp["down1"]["w"].std()) - 0.02) < 0.004


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_apply_matches_jax(disc, train):
    ref, ref_state = jgancls.discriminator_apply(
        disc.params, disc.state, disc.xs[0], disc.embs[0], train, JL.FP32, RES)
    p, s = convert.from_jax_discriminator(disc.params, disc.state, "cpu")
    got, got_state = tgancls.discriminator_apply(
        p, s, torch.from_numpy(disc.xs[0]), torch.from_numpy(disc.embs[0]),
        train, TL.FP32, RES)
    assert got.shape == (4,)
    _close(got.numpy(), ref, TOL, "logits")
    _tree_close(got_state, jax.device_get(ref_state), 1e-5, "state")


def test_discriminator_streams_match_jax(disc):
    """Three streams in one pass: per-stream BN statistics, and the running
    state is the mean over streams of 0.9·old + 0.1·batch_s."""
    ref, ref_state = jgancls.discriminator_apply_streams(
        disc.params, disc.state, disc.xs, disc.embs, True, JL.FP32, RES)
    p, s = convert.from_jax_discriminator(disc.params, disc.state, "cpu")
    got, got_state = tgancls.discriminator_apply_streams(
        p, s, torch.from_numpy(disc.xs), torch.from_numpy(disc.embs), True,
        TL.FP32, RES)
    assert got.shape == (3, 4)
    _close(got.numpy(), ref, TOL, "logits")
    _tree_close(got_state, jax.device_get(ref_state), 1e-5, "state")
    # one pass over the stacked batch would differ: statistics are per stream
    pooled, _ = tgancls.discriminator_apply(
        p, s, torch.from_numpy(disc.xs.reshape(12, RES, RES, 3)),
        torch.from_numpy(disc.embs.reshape(12, -1)), True, TL.FP32, RES)
    assert not np.allclose(pooled.numpy(), got.numpy().reshape(-1), atol=1e-3)


def test_discriminator_grads_match_jax(disc):
    """Gradients of Σ c·logits over the three streams, with respect to every
    D parameter and to the images."""
    c = np.random.default_rng(8).normal(size=(3, 4)).astype(np.float32)

    def jax_obj(params, xs):
        logits, _ = jgancls.discriminator_apply_streams(
            params, disc.state, xs, disc.embs, True, JL.FP32, RES)
        return jnp.sum(logits * c)

    ref_gp, ref_gx = jax.grad(jax_obj, argnums=(0, 1))(disc.params, disc.xs)
    p, s = convert.from_jax_discriminator(disc.params, disc.state, "cpu")
    leaves = [v.requires_grad_(True) for _, v in flatten(p)]
    xs = torch.from_numpy(disc.xs).requires_grad_(True)
    logits, _ = tgancls.discriminator_apply_streams(
        p, s, xs, torch.from_numpy(disc.embs), True, TL.FP32, RES)
    grads = torch.autograd.grad((logits * torch.from_numpy(c)).sum(),
                                [*leaves, xs])
    ref_flat = dict(flatten(jax.device_get(ref_gp)))
    for (name, _), g in zip(flatten(p), grads):
        _close(g.numpy(), ref_flat[name], TOL, f"d/d {name}")
    _close(grads[-1].numpy(), ref_gx, TOL, "d/d images")


# --- losses --------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(9)
    r, f, w, i = (np.concatenate([rng.normal(size=6) * 3,
                                  [40.0, -40.0]]).astype(np.float32)
                  for _ in range(4))
    for label in (1.0, 0.9, 0.0):
        _close(tlosses.sigmoid_ce(torch.from_numpy(r), label).numpy(),
               jlosses.sigmoid_ce(r, label), 1e-6, f"sigmoid_ce {label}")
    ref = jlosses.gan_cls_d_loss(r, f, w, 0.9)
    got = tlosses.gan_cls_d_loss(*map(torch.from_numpy, (r, f, w)), 0.9)
    for k in ref:
        _close(got[k].numpy(), ref[k], 1e-6, k)
    ref = jlosses.gan_cls_g_loss(f, i, 0.5)
    got = tlosses.gan_cls_g_loss(torch.from_numpy(f), torch.from_numpy(i), 0.5)
    assert got.keys() == ref.keys()
    for k in ref:
        _close(got[k].numpy(), ref[k], 1e-6, k)
    emb = rng.normal(size=(5, 7)).astype(np.float32)
    _close(tlosses.interpolate_embeddings(torch.from_numpy(emb), 0.3).numpy(),
           jlosses.interpolate_embeddings(emb, 0.3), 1e-7, "interp")


# --- Adam + staircase schedule ----------------------------------------------------

def test_adam_with_staircase_matches_optax():
    """Six updates with a decay period of 2 (three LR levels): the LR of an
    update is the schedule at the count before it."""
    tcfg = tiny_config(lr_decay_epoch=1, generator_lr=1e-2).train
    spe = 2
    rng = np.random.default_rng(4)
    params = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "b": {"b": rng.normal(size=(4,)).astype(np.float32)}}
    tx = joptim.generator_optimizer(tcfg, spe)
    jp, jstate = jax.tree.map(jnp.asarray, params), None
    jstate = tx.init(jp)
    tp = {k: {n: torch.from_numpy(v.copy()).requires_grad_(True)
              for n, v in d.items()} for k, d in params.items()}
    opt = toptim.generator_optimizer(tp, _port_cfg(tiny_config(
        lr_decay_epoch=1, generator_lr=1e-2)).train, spe)
    sched = joptim.make_schedule(1e-2, tcfg, spe)
    for n in range(6):
        assert abs(opt.schedule(n) - float(sched(n))) < 1e-9
        grads = jax.tree.map(
            lambda v: rng.normal(size=v.shape).astype(np.float32), params)
        updates, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(g) for _, g in flatten(grads)])
    assert opt.count == 6
    _tree_close(tp, jax.device_get(jp), 1e-6, "params")
    mu, nu = opt.moments()
    _tree_close(mu, jax.device_get(jstate[0].mu), 1e-6, "mu")
    _tree_close(nu, jax.device_get(jstate[0].nu), 1e-6, "nu")


def test_schedule_clamps_the_decay_period():
    tcfg = _port_cfg(tiny_config(lr_decay_epoch=10**9)).train
    sched = toptim.make_schedule(2e-4, tcfg, 10**6)
    assert sched(2**31 - 2) == 2e-4 and sched(2**31 - 1) == 1e-4


# --- one whole tick against the JAX step -----------------------------------------

def _jax_draws(jcfg, step, batch):
    """The z the JAX step draws at `step` (steps.py: the per-critic keys
    from fold_in(key, 0), the G key fold_in(key, 1), each split)."""
    key = jprng.step_key(jprng.base_key(jcfg.seed), step)
    zd = jcfg.gan.z_dim

    def normal(k):
        return np.array(jax.random.normal(k, (batch, zd), jnp.float32))

    d_keys = jax.random.split(jax.random.fold_in(key, 0), jcfg.train.n_critic)
    kz, _, kz2, _ = jax.random.split(jax.random.fold_in(key, 1), 4)
    return {"d": np.stack([normal(jax.random.split(k, 3)[0]) for k in d_keys]),
            "g": normal(kz), "g2": normal(kz2)}


TICK_CONFIGS = {
    # GAN-CLS with the EMA (ramped) and one-sided label smoothing
    "ema": dict(ema_decay=0.9, ema_rampup=2.0),
    # two D updates per tick on their own slices, and the GAN-INT G term
    "ncritic2_int": dict(n_critic=2, use_interpolation=True),
}


@pytest.fixture(scope="module", params=sorted(TICK_CONFIGS))
def ticks(request):
    """Two JAX ticks from perturbed weights (one compiled step body): states
    ts0 → ts1 → ts2, the batches and the metrics."""
    jcfg = tiny_config(**TICK_CONFIGS[request.param])
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, batch_size=6, coeff=dataclasses.replace(
            jcfg.train.coeff, real_label_smooth=0.9)))
    spe = 3
    ts0 = jsteps.init_train_state(jprng.base_key(1), jcfg, spe)
    rng = np.random.default_rng(12)
    ts0 = ts0.replace(**{k: _perturb(jax.device_get(getattr(ts0, k)), rng)
                         for k in ("g_params", "g_state", "d_params",
                                   "d_state")})
    body = jax.jit(jsteps._make_step_body(jcfg.compute_key(), spe))
    b, k = jcfg.train.batch_size, jcfg.train.n_critic
    batches = [{"real": rng.integers(0, 256, (k, b, RES, RES, 3), np.uint8),
                "wrong": rng.integers(0, 256, (k, b, RES, RES, 3), np.uint8),
                "emb": rng.normal(size=(k, b, jcfg.gan.embed_dim)
                                  ).astype(np.float32)} for _ in range(2)]
    states, metrics = [jax.device_get(ts0)], []
    for batch in batches:
        ts, m = body(states[-1], batch)
        states.append(jax.device_get(ts))
        metrics.append(jax.device_get(m))
    return types.SimpleNamespace(jcfg=jcfg, cfg=_port_cfg(jcfg), spe=spe,
                                 states=states, metrics=metrics,
                                 batches=batches)


def _port_tick(ticks, i, grads=None):
    """The port's tick i from the converted JAX state i; with `grads` (a
    dict), every update's gradients are recorded under "g" and "d"."""
    ts = convert.from_jax_train_state(ticks.states[i], ticks.cfg, ticks.spe,
                                      "cpu")
    if grads is not None:
        for net in ("g", "d"):
            opt = getattr(ts, f"{net}_opt")
            grads[net] = []

            def update(gs, opt=opt, out=grads[net], apply=opt.update):
                out.append(dict(zip(opt.names, (g.clone() for g in gs))))
                apply(gs)
            opt.update = update
    step = tsteps.make_train_step(ticks.cfg, ticks.spe, device="cpu")
    noise = _jax_draws(ticks.jcfg, i, ticks.jcfg.train.batch_size)
    return step(ts, ticks.batches[i], noise=noise)


@pytest.mark.parametrize("i", [0, 1])
def test_tick_matches_jax_step(ticks, i):
    """Tick i from the converted JAX state i (tick 1 carries Adam moments
    and counts across): losses, BN states, Adam moments (the gradients: with
    one D update the D moment is (1 − β1)·grad), params after Adam and the
    EMA."""
    grads = {}
    ts, metrics = _port_tick(ticks, i, grads)
    ref, ref_m = ticks.states[i + 1], ticks.metrics[i]
    assert ts.step == int(ref.step) == i + 1
    assert ts.aux.keys() == ref.aux.keys()
    tcfg = ticks.cfg.train
    assert (len(grads["g"]), len(grads["d"])) == (tcfg.g_steps, tcfg.n_critic)
    assert metrics.keys() == ref_m.keys()
    for k in ref_m:
        _close(metrics[k].numpy(), ref_m[k], TOL, k)
    # a second update of a net (the second G step; the second D step when
    # n_critic is 2) runs on params after a first Adam update, where a
    # near-zero gradient's sign may differ (a 2·lr step): 1e-4 on BN states
    _tree_close(ts.g_state, ref.g_state, TOL, "g_state")
    _tree_close(ts.d_state, ref.d_state, TOL, "d_state")
    for name, opt, jopt in (("g", ts.g_opt, ref.g_opt),
                            ("d", ts.d_opt, ref.d_opt)):
        assert opt.count == int(jopt[0].count)
        mu, nu = opt.moments()
        _tree_close(mu, jopt[0].mu, TOL, f"{name} mu")
        _tree_close(nu, jopt[0].nu, 1e-6, f"{name} nu")
    # params after Adam: an update moves by ≈ lr·g/|g|, so an element whose
    # gradient is round-off in any update (a bias in front of a BN, or one
    # whose shift the next BN removes, has a true gradient of 0) moves by a
    # different ±lr in each package.  Compare where every update's |g| is
    # clear of 0 (> 2e-4, i.e. (1 − β1)·|g| > 1e-4), within 1 % of a step
    # (lr 2e-4): the moments of two updates differ by sum order.
    ema = dict(flatten(ref.aux.get("ema_g_params", {})))
    for name, params, jparams in (("g", ts.g_params, ref.g_params),
                                  ("d", ts.d_params, ref.d_params)):
        ref_flat = dict(flatten(jparams))
        for leaf, v in flatten(params):
            keep = np.all([g[leaf].abs().numpy() > 2e-4
                           for g in grads[name]], axis=0)
            assert keep.mean() > 0.5 or leaf.endswith("/b"), leaf
            _close(v.detach().numpy()[keep], ref_flat[leaf][keep], 2e-6,
                   f"{name} {leaf}")
            if name == "g" and ema:
                got_ema = dict(flatten(ts.aux["ema_g_params"]))[leaf]
                _close(got_ema.numpy()[keep], ema[leaf][keep], 2e-6,
                       f"ema {leaf}")


def test_tick_semantics(ticks):
    """Every param and BN-state tree changes in a tick; the G steps' z is
    theirs alone: a tick with another G z gives other G params and the same
    D params."""
    ts, _ = _port_tick(ticks, 0)
    before = ticks.states[0]
    for tree in ("g_params", "d_params", "g_state", "d_state"):
        got, ref = dict(flatten(getattr(ts, tree))), dict(flatten(getattr(before, tree)))
        assert any(not np.allclose(got[k].detach().numpy(), ref[k]) for k in ref), tree
    ts2 = convert.from_jax_train_state(before, ticks.cfg, ticks.spe, "cpu")
    noise = _jax_draws(ticks.jcfg, 0, ticks.jcfg.train.batch_size)
    noise["g"] = noise["g"][::-1].copy()
    tsteps.make_train_step(ticks.cfg, ticks.spe, "cpu")(ts2, ticks.batches[0],
                                                        noise=noise)
    assert not torch.allclose(ts2.g_params["up0"]["w"], ts.g_params["up0"]["w"])
    torch.testing.assert_close(ts2.d_params["down1"]["w"],
                               ts.d_params["down1"]["w"], rtol=0, atol=0)


def test_noise_is_a_function_of_seed_and_step():
    cfg = _port_cfg(tiny_config(n_critic=2, use_interpolation=True))
    a, b = tsteps.draw_noise(cfg, 5, 4), tsteps.draw_noise(cfg, 5, 4)
    c = tsteps.draw_noise(cfg, 6, 4)
    assert a["d"].shape == (2, 4, cfg.gan.z_dim) and a["g"].shape == (4, 8)
    for k in ("d", "g", "g2"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert not torch.equal(a[k], c[k])
    assert not torch.equal(a["d"][0], a["d"][1])
