"""The port's GAN-CLS generator and sampler against the JAX package on the
CPU: the same JAX-initialised weights (carried by
`convert.from_jax_generator`), the same numpy z and embeddings, compared in
f32 at tiny and flagship widths and in bf16 at flagship widths."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.config import GanConfig
from text_to_image_tpu.eval import sampler as jsampler
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import Config as TConfig
from text_to_image_tpu_torch.eval import sampler as tsampler
from text_to_image_tpu_torch.models import gancls as tgancls
from text_to_image_tpu_torch.ops import layers as TL

FLAGSHIP = GanConfig()   # gf 128, z 100, embed 1024, compressed 128
TINY = tiny_config().gan
BATCH = {"tiny": 8, "flagship": 2}
# f32: the two packages differ only in summation order;
# bf16: JAX rounds each conv output and bias add to bf16, the port's kernel
# epilogue rounds once, and train-mode BN at batch 2 amplifies the gap
ATOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _perturb(tree, rng):
    """JAX init leaves biases at 0 and BN state at (0, 1); give them values
    so that bias, shift and running-statistics paths are exercised."""
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


@pytest.fixture(scope="module", params=["tiny", "flagship"])
def generator(request):
    gan = TINY if request.param == "tiny" else FLAGSHIP
    res = 16 if request.param == "tiny" else 64
    params, state = jax.device_get(
        jgancls.generator_init(jax.random.PRNGKey(3), gan, res))
    rng = np.random.default_rng(11)
    params, state = _perturb(params, rng), _perturb(state, rng)
    b = BATCH[request.param]
    z = rng.normal(size=(b, gan.z_dim)).astype(np.float32)
    emb = rng.normal(size=(b, gan.embed_dim)).astype(np.float32)
    return types.SimpleNamespace(name=request.param, res=res, params=params,
                                 state=state, z=z, emb=emb)


def _jax_run(g, mode, dtype):
    policy = JL.Policy(compute_dtype=jnp.dtype(dtype))
    if mode == "folded":
        img = jgancls.generator_apply_inference(g.params, g.state, g.z, g.emb,
                                                policy, g.res)
        return np.asarray(img.astype(jnp.float32)), None
    img, new_state = jgancls.generator_apply(g.params, g.state, g.z, g.emb,
                                             mode == "train", policy, g.res)
    return np.asarray(img.astype(jnp.float32)), jax.device_get(new_state)


def _torch_run(g, mode, dtype):
    params, state = convert.from_jax_generator(g.params, g.state, "cpu")
    policy = TL.Policy.from_str(dtype)
    params = TL.cast_weights(params, policy)
    z, emb = torch.from_numpy(g.z), torch.from_numpy(g.emb)
    if mode == "folded":
        img = tgancls.generator_apply_inference(params, state, z, emb, policy,
                                                g.res)
        return img.float().numpy(), None
    img, new_state = tgancls.generator_apply(params, state, z, emb,
                                             mode == "train", policy, g.res)
    return img.float().numpy(), new_state


# tiny widths in f32; flagship widths in f32 and bf16
CASES = [(size, mode, dtype)
         for size, dtypes in (("tiny", ("float32",)),
                              ("flagship", ("float32", "bfloat16")))
         for dtype in dtypes for mode in ("train", "eval", "folded")]


@pytest.mark.parametrize("generator,mode,dtype", CASES,
                         indirect=["generator"])
def test_generator_matches_jax(generator, mode, dtype):
    ref, _ = _jax_run(generator, mode, dtype)
    got, _ = _torch_run(generator, mode, dtype)
    assert got.shape == ref.shape == (len(generator.z), generator.res,
                                      generator.res, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL[dtype])


def test_generator_bn_state_update_matches(generator):
    """Running statistics: new = 0.9·old + 0.1·batch with the biased
    variance, for every BN of the generator."""
    _, ref = _jax_run(generator, "train", "float32")
    _, got = _torch_run(generator, "train", "float32")
    assert set(got) == set(ref)
    for layer in ref:
        for stat in ("mean", "var"):
            np.testing.assert_allclose(got[layer][stat].numpy(),
                                       ref[layer][stat], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{layer}/{stat}")


def test_eval_mode_keeps_state_and_folded_matches_eval(generator):
    """Eval mode returns the running state unchanged, and the BN-folded
    serving generator equals eval mode."""
    got_eval, state = _torch_run(generator, "eval", "float32")
    got_fold, _ = _torch_run(generator, "folded", "float32")
    for layer, s in state.items():
        np.testing.assert_array_equal(s["mean"].numpy(),
                                      generator.state[layer]["mean"])
    np.testing.assert_allclose(got_fold, got_eval, rtol=0, atol=1e-5)


def _tiny_cfgs():
    jcfg = tiny_config()
    tcfg = TConfig(model="gancls",
                   gan=dataclasses.replace(TConfig().gan,
                                           **dataclasses.asdict(jcfg.gan)),
                   data=dataclasses.replace(TConfig().data,
                                            dataset_name="synthetic",
                                            image_size=jcfg.data.image_size),
                   dtype="float32")
    return jcfg, tcfg


@pytest.mark.parametrize("grid", ["sample", "latent", "text"])
def test_sampler_grids_match_jax(grid):
    """The sampler's three grids, with the z each JAX grid draws handed to
    the port: same batch grouping (train-mode BN), same images."""
    jcfg, tcfg = _tiny_cfgs()
    params, state = jax.device_get(
        jgancls.generator_init(jax.random.PRNGKey(5), jcfg.gan, 16))
    jts = types.SimpleNamespace(g_params=params, g_state=state, aux={})
    tts = tsampler.GeneratorState(*convert.from_jax_generator(params, state,
                                                              "cpu"))
    jgen = jsampler.make_generator_fn(jcfg)
    tgen = tsampler.make_generator_fn(tcfg, device="cpu")
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(6, jcfg.gan.embed_dim)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    zd = jcfg.gan.z_dim
    if grid == "sample":
        ref = jsampler.sample_grid(jgen, jts, jcfg, emb, key)
        z = jax.random.normal(jax.random.fold_in(key, 0), (6, zd))
        got = tsampler.sample_grid(tgen, tts, tcfg, emb, z=np.array(z))
    elif grid == "latent":
        ref, rshape = jsampler.latent_interpolation_grid(jgen, jts, jcfg,
                                                         emb[:3], 4, key)
        kz1, kz2, _ = jax.random.split(key, 3)
        z1 = np.array(jax.random.normal(kz1, (3, 1, zd)))[:, 0]
        z2 = np.array(jax.random.normal(kz2, (3, 1, zd)))[:, 0]
        got, gshape = tsampler.latent_interpolation_grid(
            tgen, tts, tcfg, emb[:3], 4, z1=z1, z2=z2)
        assert gshape == rshape == (3, 4)
    else:
        ref, rshape = jsampler.text_interpolation_grid(jgen, jts, jcfg,
                                                       emb[:3], emb[3:], 4, key)
        kz, _ = jax.random.split(key)
        z = np.array(jax.random.normal(kz, (3, 1, zd)))[:, 0]
        got, gshape = tsampler.text_interpolation_grid(
            tgen, tts, tcfg, emb[:3], emb[3:], 4, z=z)
        assert gshape == rshape == (3, 4)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_eval_g_params_prefers_ema():
    ts = tsampler.GeneratorState({"w": 1}, {}, aux={"ema_g_params": {"w": 2}})
    assert tsampler.eval_g_params(ts) == {"w": 2}
    assert tsampler.eval_g_params(tsampler.GeneratorState({"w": 1}, {})) == {"w": 1}


@pytest.mark.parametrize("act", ["relu", "lrelu"])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_layers_match_jax(train, act):
    """`batch_norm` and `batch_norm_act` (the folded bn_act epilogue) against
    the JAX layers: output and running-state update."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(4, 5, 3, 24)) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 24).astype(np.float32),
         "bias": rng.normal(size=24).astype(np.float32)}
    s = {"mean": rng.normal(size=24).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, 24).astype(np.float32)}
    ref_y, ref_s = JL.batch_norm_act(p, s, x, train, act)
    ref_n, _ = JL.batch_norm(p, s, x, train)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ts_ = {k: torch.from_numpy(v) for k, v in s.items()}
    got_y, got_s = TL.batch_norm_act(tp, ts_, torch.from_numpy(x), train, act)
    got_n, _ = TL.batch_norm(tp, ts_, torch.from_numpy(x), train)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(ref_y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), rtol=1e-5,
                               atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]),
                                   rtol=1e-6, atol=1e-6)
