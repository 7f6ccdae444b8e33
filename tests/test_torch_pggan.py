"""The port's C-PGGAN path against the JAX package on the CPU, in f32 at a
16 px config (3 stages, gf 8, ca 16, embed 32): the stage schedule, the
generator and the critic at every stage and α, the per-stream minibatch
stddev, the downsample, the bundle's hooks (α, the EMA anchor, the image
prep), a tick during a fade against the JAX step body, Adam over leaves a
stage does not reach across a stage change, the progression through
`main.py` with its checkpoints, and `convert`."""

import dataclasses
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from tests.test_torch_wgan import (_perturb, _port_cfg, _t, _tree_close,
                                   check_tick, jax_draws, port_tick)
from text_to_image_tpu.models import pggan as JPG
from text_to_image_tpu.models import registry as jregistry
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert, main
from text_to_image_tpu_torch.models import pggan as TPG
from text_to_image_tpu_torch.models import registry as tregistry
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.train import checkpoint as tckpt
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train import trainer as ttrainer
from text_to_image_tpu_torch.train.optim import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 16
B = 4
# f32: summation order only; the equalized-LR weights are N(0, 1), so the
# activations are O(1) and 1e-4 (absolute + relative) holds them
TOL = 1e-4


def pg_config(stage=0, image_size=RES, steps_per_stage=4, **train_kw):
    cfg = tiny_config("pggan", image_size=image_size, **train_kw)
    return dataclasses.replace(cfg, pggan=dataclasses.replace(
        cfg.pggan, stage=stage, steps_per_stage=steps_per_stage,
        fade_fraction=0.5))


GAN = pg_config().gan


def _normal(key, *shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def test_stage_math_matches_jax():
    for res in (4, 8, 16, 64, 256):
        assert TPG.num_stages(res) == JPG.num_stages(res)
    for s in range(1, 8):
        assert TPG.stage_resolution(s) == JPG.stage_resolution(s)
        for gan in (GAN, dataclasses.replace(GAN, gf_dim=128)):
            assert TPG.stage_channels(s, gan) == JPG.stage_channels(s, gan)
    assert [TPG.stage_channels(s, dataclasses.replace(GAN, gf_dim=128))
            for s in range(1, 8)] == [512, 512, 512, 256, 128, 64, 32]
    with pytest.raises(ValueError):
        TPG.num_stages(48)


@functools.lru_cache(maxsize=None)
def _nets():
    """JAX full-depth G and D at 16 px (biases perturbed) and inputs."""
    kg, kd = jax.random.split(jax.random.PRNGKey(3))
    rng = np.random.default_rng(9)
    gp = _perturb(jax.device_get(JPG.generator_init(kg, GAN, RES)[0]), rng)
    dp = _perturb(jax.device_get(JPG.discriminator_init(kd, GAN, RES)[0]),
                  rng)
    z = rng.normal(size=(B, GAN.z_dim)).astype(np.float32)
    emb = rng.normal(size=(B, GAN.embed_dim)).astype(np.float32)
    return gp, dp, z, emb


def test_init_has_the_jax_layers():
    tg, tgs = TPG.generator_init(0, GAN, RES)
    td, tds = TPG.discriminator_init(1, GAN, RES)
    gp, dp, _, _ = _nets()
    assert tgs == {} and tds == {}
    for got, ref in ((tg, gp), (td, dp)):
        assert {k: tuple(v.shape) for k, v in flatten(got)} == {
            k: tuple(v.shape) for k, v in flatten(ref)}
    # equalized LR: weights N(0, 1), scaled at use
    assert 0.8 < float(tg["up3a"]["w"].std()) < 1.2


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_generator_matches_jax(stage, alpha):
    """The image at the stage's resolution (the fade blend of the new block
    and the upsampled block below) and the CA's μ, log σ²; the CA noise is
    JAX's own draw."""
    gp, _, z, emb = _nets()
    key = jax.random.PRNGKey(stage)
    ref, ref_ca = JPG.generator_apply(gp, z, emb, key, stage, alpha, GAN)
    eps = _normal(key, B, GAN.ca_dim)
    p, _ = convert.from_jax_generator(gp, {}, "cpu")
    got, ca = TPG.generator_apply(p, _t(z), _t(emb), _t(eps), stage, alpha,
                                  GAN, TL.FP32)
    r = TPG.stage_resolution(stage)
    assert tuple(got.shape) == (B, r, r, 3)
    _tree_close(ca, jax.device_get(ref_ca), TOL, "ca")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_critic_matches_jax(stage, alpha):
    _, dp, _, emb = _nets()
    r = TPG.stage_resolution(stage)
    x = np.random.default_rng(stage).uniform(-1, 1, (B, r, r, 3)
                                             ).astype(np.float32)
    ref = JPG.discriminator_apply(dp, x, emb, stage, alpha, GAN)
    p, _ = convert.from_jax_discriminator(dp, {}, "cpu")
    got = TPG.discriminator_apply(p, _t(x), _t(emb), stage, alpha, GAN,
                                  TL.FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_streams_keep_the_minibatch_stddev_per_stream():
    """Three stacked streams give JAX's vmapped scores and each stream's
    own single call, not the scores of one batch of 3·B (whose stddev would
    mix the streams)."""
    _, dp, _, _ = _nets()
    rng = np.random.default_rng(4)
    # streams of different spreads, so a pooled stddev shows
    xs = (rng.uniform(-1, 1, (3, B, RES, RES, 3))
          * np.array([0.2, 1.0, 0.5])[:, None, None, None, None]
          ).astype(np.float32)
    embs = rng.normal(size=(3, B, GAN.embed_dim)).astype(np.float32)
    ref = JPG.discriminator_apply_streams(dp, xs, embs, 3, 0.5, GAN)
    p, _ = convert.from_jax_discriminator(dp, {}, "cpu")
    got = TPG.discriminator_apply_streams(p, _t(xs), _t(embs), 3, 0.5, GAN,
                                          TL.FP32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)
    for s in range(3):
        one = TPG.discriminator_apply(p, _t(xs[s]), _t(embs[s]), 3, 0.5, GAN,
                                      TL.FP32)
        torch.testing.assert_close(got[s], one, rtol=1e-5, atol=1e-5)
    pooled = TPG.discriminator_apply(p, _t(xs).flatten(0, 1),
                                     _t(embs).flatten(0, 1), 3, 0.5, GAN,
                                     TL.FP32)
    assert not torch.allclose(pooled.reshape(3, B), got, atol=1e-3)


def test_layers_match_jax():
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(6, 4, 4, 8)) * 3 + 1).astype(np.float32)
    for got, ref in ((TPG.pixel_norm(_t(x)), JPG.pixel_norm(x)),
                     (TPG.minibatch_stddev(_t(x)), JPG.minibatch_stddev(x))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    two = TPG.minibatch_stddev(_t(x), streams=2)
    for s in range(2):
        np.testing.assert_allclose(
            two[3 * s:3 * s + 3].numpy(),
            np.asarray(JPG.minibatch_stddev(x[3 * s:3 * s + 3])), rtol=1e-5,
            atol=1e-5)
    img = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    for res in (16, 8, 4):
        np.testing.assert_allclose(
            TPG.downsample_to(_t(img), res).numpy(),
            np.asarray(JPG.downsample_to(jnp.asarray(img), res)), rtol=1e-6,
            atol=1e-6)


# --- the bundle -------------------------------------------------------------------

@pytest.mark.parametrize("stage,start", [(1, -1), (2, -1), (3, -1), (3, 5),
                                         (0, -1)])
def test_bundle_hooks_match_jax(stage, start):
    jcfg = pg_config(stage=stage)
    jcfg = dataclasses.replace(jcfg, pggan=dataclasses.replace(
        jcfg.pggan, start_step=start))
    jb, tb = jregistry.get_model(jcfg), tregistry.get_model(_port_cfg(jcfg))
    assert tb.resolution == jb.resolution and tb.ema_anchor == jb.ema_anchor
    assert tb.is_wgan and tb.has_ca and not tb.needs_stage1
    assert tb.eps_shape(5) == (5, GAN.ca_dim)
    for step in range(0, 14):
        got = tb.step_aux(step)["alpha"]
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == float(jb.step_aux(jnp.int32(step))["alpha"]), \
            step
    x = np.random.default_rng(0).uniform(-1, 1, (2, RES, RES, 3)
                                         ).astype(np.float32)
    np.testing.assert_allclose(tb.prep_images(_t(x)).numpy(),
                               np.asarray(jb.prep_images(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_bundle_refuses_a_stage_past_the_resolution():
    with pytest.raises(ValueError, match="exceeds"):
        tregistry.get_model(_port_cfg(pg_config(stage=4)))


# --- ticks --------------------------------------------------------------------------

def _jax_ticks(jcfg, step0, seed=12, moments=False):
    """One JAX tick of `jcfg` from a perturbed state at step `step0` (with
    `moments`, the Adam moments perturbed too); batches are uint8 at the
    full resolution, downsampled inside the step."""
    spe = 3
    ts0 = jsteps.init_train_state(jprng.base_key(1), jcfg, spe)
    rng = np.random.default_rng(seed)
    ts0 = ts0.replace(step=jnp.int32(step0),
                      **{k: _perturb(jax.device_get(getattr(ts0, k)), rng)
                         for k in ("g_params", "d_params")})
    if moments:
        ts0 = ts0.replace(**{k: _perturbed_adam(getattr(ts0, k), rng)
                             for k in ("g_opt", "d_opt")})
    k, res = jcfg.train.n_critic, jcfg.data.image_size
    batch = {"real": rng.integers(0, 256, (k, B, res, res, 3), np.uint8),
             "wrong": rng.integers(0, 256, (k, B, res, res, 3), np.uint8),
             "emb": rng.normal(size=(k, B, jcfg.gan.embed_dim)
                               ).astype(np.float32)}
    ts0 = jax.device_get(ts0)
    ts1, m = jax.jit(jsteps._make_step_body(jcfg.compute_key(), spe))(
        ts0, batch)
    return types.SimpleNamespace(
        jcfg=jcfg, cfg=_port_cfg(jcfg), spe=spe, states=[ts0,
                                                         jax.device_get(ts1)],
        metrics=[jax.device_get(m)], batches=[batch], batch_size=B,
        step0=step0)


def _perturbed_adam(opt_state, rng):
    """An optax Adam state with random moments (ν > 0), so that a zero
    gradient still moves a leaf."""
    adam = opt_state[0]
    mu = jax.tree.map(lambda v: rng.normal(size=v.shape).astype(np.float32)
                      * 0.01, jax.device_get(adam.mu))
    nu = jax.tree.map(lambda v: rng.uniform(1e-5, 1e-4, v.shape
                                            ).astype(np.float32),
                      jax.device_get(adam.nu))
    return (adam._replace(mu=mu, nu=nu), *opt_state[1:])


@functools.lru_cache(maxsize=None)
def _fade_tick():
    """Stage 2 of 3 at step 5: α = 0.5 (the stage starts at 4 and fades
    over 2 steps); the EMA ramp counts from the anchor 6."""
    jcfg = pg_config(stage=2, n_critic=2, g_steps=1, beta1=0.0,
                     generator_lr=1e-4, discriminator_lr=1e-4,
                     use_interpolation=True, ema_decay=0.9, ema_rampup=2.0)
    return _jax_ticks(jcfg, step0=5)


def test_pggan_tick_during_a_fade_matches_jax():
    """d_loss, w_dist, d_wrong, gp, g_loss, g_interp and kl, the Adam
    moments of every leaf (the deeper stage's as zero-gradient updates),
    params and the EMA."""
    ticks = _fade_tick()
    assert float(tregistry.get_model(ticks.cfg).step_aux(5)["alpha"]) == 0.5
    grads = {}
    ts = convert.from_jax_train_state(ticks.states[0], ticks.cfg, ticks.spe,
                                      "cpu")
    assert ts.step == 5
    ts, metrics = port_tick(ticks, 0, grads, state=ts)
    assert {"gp", "kl", "g_interp"} <= metrics.keys()
    # the stage-3 layers take zero gradients
    assert all(float(g["up3a/w"].abs().max()) == 0 for g in grads["g"])
    assert all(float(g["down3a/w"].abs().max()) == 0 for g in grads["d"])
    check_tick(ticks, 0, ts, metrics, grads)


def test_adam_over_unreached_leaves_matches_optax_across_a_stage_change():
    """Stage 1 at step 0, then stage 2 at step 1 from what stage 1 left, in
    both packages, with β1 = 0.5 and perturbed moments: every leaf the
    stage does not reach takes a zero-gradient update (its moments decay,
    its params move by the momentum), and each leaf's step count stays the
    one optax count."""
    kw = dict(n_critic=1, g_steps=1, beta1=0.5, generator_lr=1e-4,
              discriminator_lr=1e-4)
    cfg1 = pg_config(stage=1, steps_per_stage=1, **kw)
    cfg2 = pg_config(stage=2, steps_per_stage=1, **kw)
    t1 = _jax_ticks(cfg1, step0=0, moments=True)
    body2 = jax.jit(jsteps._make_step_body(cfg2.compute_key(), t1.spe))
    rng = np.random.default_rng(21)
    batch2 = {"real": rng.integers(0, 256, (1, B, RES, RES, 3), np.uint8),
              "wrong": rng.integers(0, 256, (1, B, RES, RES, 3), np.uint8),
              "emb": rng.normal(size=(1, B, GAN.embed_dim)).astype(np.float32)}
    ref2, _ = body2(t1.states[1], batch2)
    ref2 = jax.device_get(ref2)

    ts = convert.from_jax_train_state(t1.states[0], t1.cfg, t1.spe, "cpu")
    ts, _ = tsteps.make_train_step(t1.cfg, t1.spe, "cpu")(
        ts, t1.batches[0], noise=jax_draws(cfg1, 0, B))
    ts, _ = tsteps.make_train_step(_port_cfg(cfg2), t1.spe, "cpu")(
        ts, batch2, noise=jax_draws(cfg2, 1, B))
    assert ts.step == int(ref2.step) == 2
    for name, ref_state in (("g", ref2), ("d", ref2)):
        opt = getattr(ts, f"{name}_opt")
        jopt = getattr(ref_state, f"{name}_opt")[0]
        assert opt.count == int(jopt.count) == 2
        assert {float(opt.opt.state[p]["step"]) for p in opt.leaves} == {2.0}
        mu, nu = opt.moments()
        deep = [k for k in mu if k[-3:-2] == "3" or "3a" in k or "3b" in k]
        assert deep, name
        for k in deep:   # untouched by both stages: pure decay
            np.testing.assert_allclose(mu[k].numpy(),
                                       dict(flatten(jopt.mu))[k],
                                       rtol=1e-6, atol=1e-9, err_msg=k)
            np.testing.assert_allclose(nu[k].numpy(),
                                       dict(flatten(jopt.nu))[k],
                                       rtol=1e-6, atol=1e-12, err_msg=k)
            np.testing.assert_allclose(
                dict(flatten(getattr(ts, f"{name}_params")))[k].detach()
                .numpy(), dict(flatten(getattr(ref_state,
                                               f"{name}_params")))[k],
                rtol=1e-6, atol=1e-7, err_msg=k)
            start = dict(flatten(getattr(t1.states[0], f"{name}_params")))[k]
            assert not np.allclose(start, dict(flatten(getattr(
                ref_state, f"{name}_params")))[k]), k


# --- the progression, the CLI and convert ---------------------------------------------

def _pg_argv(tmp_path):
    return ["--cfg", os.path.join(ROOT, "configs", "pggan_flowers.yml"),
            "--device", "cpu", "--set", "data.dataset_name=synthetic",
            "data.image_size=8", "gan.gf_dim=8", "gan.z_dim=8",
            "gan.embed_dim=32", "gan.compressed_embed_dim=16",
            "gan.ca_dim=8", "train.batch_size=4", "dtype=float32",
            "train.summary_interval=1", "train.sample_interval=2",
            *[f"{k}={tmp_path / k}" for k in ("checkpoint_dir", "log_dir",
                                              "sample_dir")]]


def test_progression_carries_checkpoints_and_skips_covered_stages(
        tmp_path, capsys, monkeypatch):
    """``main.py --train`` with ``pggan.stage: 0`` runs both stages of an
    8 px config (2 steps each): stage 2 restores stage 1's checkpoint, each
    stage writes its grid at its resolution, and a second call over the
    finished run builds a trainer for the last stage alone, which trains 0
    ticks."""
    argv = _pg_argv(tmp_path)
    trainers = main.main(argv[:4] + ["--train", "--steps", "4"] + argv[4:])
    out = capsys.readouterr().out
    assert [t.cfg.pggan.stage for t in trainers] == [1, 2]
    assert [t.ts.step for t in trainers] == [2, 4]
    assert "restored checkpoint at step 2" in out
    run = os.path.join("pggan", "synthetic")
    mgr = tckpt.CheckpointManager(str(tmp_path / "checkpoint_dir" / run))
    assert mgr.all_steps() == [2, 4]
    grids = tmp_path / "sample_dir" / run
    assert sorted(os.listdir(grids)) == ["train_00000002.png",
                                         "train_00000004.png"]
    steps = [int(ln.split("]")[0][6:]) for ln in out.splitlines()
             if ln.startswith("[step ")]
    assert steps == [1, 2, 3, 4]

    built = []
    real = ttrainer.Trainer

    class Counting(real):
        def __init__(self, sub, *a, **k):
            built.append(sub.pggan.stage)
            super().__init__(sub, *a, **k)

    monkeypatch.setattr(ttrainer, "Trainer", Counting)
    main.main(argv[:4] + ["--train", "--steps", "4"] + argv[4:])
    assert built == [2]
    assert "covers stages 1..1" in capsys.readouterr().out
    # sampling takes the last stage's generator from the checkpoint (α = 1)
    main.main(argv)
    assert "sampling from the step-4 checkpoint" in capsys.readouterr().out
    assert (grids / "eval_grid_4.png").exists()


def test_progression_grids_are_sampled_at_alpha_one(monkeypatch, tmp_path):
    """The sample grids of a stage run the generator with α = 1; the ticks
    of stage 2 with α from its schedule (0, 0.5 over its 4 steps: fade 2)."""
    seen = []
    real = TPG.generator_apply

    def spy(params, z, emb, eps, stage, alpha, gan, policy=TL.FP32):
        # the sampler runs under inference mode, the ticks do not
        seen.append((stage, float(torch.as_tensor(alpha)),
                     torch.is_inference_mode_enabled()))
        return real(params, z, emb, eps, stage, alpha, gan, policy)

    monkeypatch.setattr(TPG, "generator_apply", spy)
    argv = _pg_argv(tmp_path)
    main.main(argv[:4] + ["--train", "--steps", "8"] + argv[4:]
              + ["train.sample_interval=4", "train.n_critic=1"])
    grids = [a for s, a, grid in seen if s == 2 and grid]
    ticks = [a for s, a, grid in seen if s == 2 and not grid]
    assert grids and set(grids) == {1.0}
    # per tick: one G forward in the D update, one in the G update
    assert ticks == [0.0, 0.0, 0.5, 0.5, 1.0, 1.0, 1.0, 1.0]


def test_convert_carries_a_pggan_train_state(tmp_path):
    ticks = _fade_tick()
    ref = ticks.states[1]
    ts = convert.from_jax_train_state(ref, ticks.cfg, ticks.spe, "cpu")
    _tree_close(ts.g_params, ref.g_params, 0, "g_params")
    _tree_close(ts.d_params, ref.d_params, 0, "d_params")
    _tree_close(ts.aux["ema_g_params"], ref.aux["ema_g_params"], 0, "ema")
    assert ts.step == 6 and ts.g_state == {} and ts.d_state == {}
    path = str(tmp_path / "g.npz")
    convert.save_npz(path, ts.g_params, ts.g_state)
    p, s = convert.load_npz(path, "cpu")
    _tree_close(p, ref.g_params, 0, "npz")
    assert s == {} and "ca" in p and set(p["ca"]) == {"w", "b"}
    with pytest.raises(ValueError, match="rgbx"):
        convert.from_jax_generator({"rgbx": {"w": np.zeros(1)}}, {}, "cpu")
