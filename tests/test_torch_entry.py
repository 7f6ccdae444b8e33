"""The port's entry points against the root ``__graft_entry__.py`` on the
CPU: `entry` against JAX's ``entry`` on the same params and inputs (bf16
at full width; the same helper in f32 at tiny widths), the dry run's mesh
arithmetic, and one group of 4 ``gloo`` ranks (data 2, model 2) through
``tools/dp_ticks``: the dry run's host-fed WGAN-CLS + GAN-INT tick with the
``stem`` and ``embed`` ``w`` column-sharded over ``model`` against one
process on the global batch with replicated params, the column-parallel
linear's first and second derivatives against the replicated linear's,
and the resident tick.

The ranks are processes of ``text_to_image_tpu_torch.tools.dp_ticks``
joined through a ``file://`` store under ``tmp_path``, killed after 60 s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.models.registry import get_model as jget_model
from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu.parallel import mesh as jmesh
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert, entry
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.parallel import mesh as tmesh
from text_to_image_tpu_torch.tools import dp_ticks

# bf16 at full width: the packages round at other points (JAX each conv
# output and bias add, the port's kernels once in their epilogue), and the
# train-mode BN at batch 16 carries the gaps through every layer.  Read on
# the CPU (JAX bf16 against the port's plain versions): fake 1.21e-2 of the
# largest |value|, logits 1.99e-2; f32 at tiny widths 8.4e-7
ENTRY_BF16_RTOL = 5e-2
ENTRY_F32_TOL = 1e-4
# the JAX package's DP tolerances (tests/test_parallel.py:149-151)
METRIC_RTOL = {"d": 5e-3, "g": 5e-2}
METRIC_ATOL, PARAM_LRS = 1e-4, 10
# all-reduced gradients against one process's, per leaf ‖Δ‖ ≤
# DP_GRAD_RTOL·(‖g_leaf‖ + max ‖g‖ of the net) (chip_smoke.py)
DP_GRAD_RTOL = 1e-2
LINEAR_TOL = 1e-5
LAUNCH_TIMEOUT_S = 60


def _jax_fwd(bundle, policy, key):
    """The body of JAX's ``entry`` for any bundle."""
    def fwd(g_params, g_state, d_params, d_state, z, emb, real, wrong):
        fake, _, _ = bundle.gen_apply(g_params, g_state, {}, z, emb, key,
                                      True, policy)
        xs = jnp.stack([real, fake, wrong])
        embs = jnp.stack([emb, emb, emb])
        logits, _ = bundle.disc_streams(d_params, d_state, {}, xs, embs,
                                        True, policy)
        return fake, logits
    return fwd


def _to_port(args):
    gp, gs, dp, ds, *inputs = jax.device_get(args)
    return (*convert.from_jax_generator(gp, gs, "cpu"),
            *convert.from_jax_discriminator(dp, ds, "cpu"),
            *(torch.from_numpy(np.array(v, np.float32)) for v in inputs))


def _rel_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return (float(np.abs(got.float().numpy() - ref).max())
            / float(np.abs(ref).max()))


def test_entry_matches_jax_entry_bf16_full_width():
    """JAX's ``entry()`` (GAN-CLS 64 px, bf16, gf 128, df 64, batch 16):
    its params converted and its own z, emb, real and wrong passed to the
    port's ``entry_fn``; fake and logits within ENTRY_BF16_RTOL of the
    largest |value|."""
    import __graft_entry__ as ge
    fwd, args = ge.entry()
    ref_fake, ref_logits = jax.jit(fwd)(*args)
    cfg = entry.entry_config()
    fake, logits = entry.check_entry(entry.entry_fn(cfg), _to_port(args))
    assert fake.dtype == torch.bfloat16 and logits.shape == (3, 16)
    assert _rel_err(fake, ref_fake) <= ENTRY_BF16_RTOL
    assert _rel_err(logits, ref_logits) <= ENTRY_BF16_RTOL


def test_entry_helper_matches_jax_f32_tiny():
    """The same helper at tiny widths in f32: within 1e-4 of the largest
    |value|."""
    jcfg = tiny_config().replace(dtype="float32")       # 16 px
    bundle = jget_model(jcfg)
    key = jprng.base_key(0)
    params = jax.jit(bundle.init)(key)
    b, r = 4, jcfg.data.image_size
    z = jax.random.normal(key, (b, jcfg.gan.z_dim), jnp.float32)
    emb = jax.random.normal(key, (b, jcfg.gan.embed_dim), jnp.float32)
    real = jax.random.uniform(key, (b, r, r, 3), jnp.float32, -1, 1)
    wrong = jax.random.uniform(jax.random.fold_in(key, 1), (b, r, r, 3),
                               jnp.float32, -1, 1)
    args = (*params, z, emb, real, wrong)
    ref = _jax_fwd(bundle, JL.Policy.from_str("float32"), key)(*args)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    got = entry.entry_fn(cfg)(*_to_port(args))
    for g, r in zip(got, ref):
        assert _rel_err(g, r) <= ENTRY_F32_TOL


def test_entry_draws_its_own_inputs():
    """``entry_args`` at tiny widths: the nets from the seed, the inputs'
    shapes and ranges; `check_entry` passes them."""
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))  # 16 px, f32
    args = entry.entry_args(cfg, "cpu", batch=2)
    assert [tuple(a.shape) for a in args[4:]] == [(2, 8), (2, 32),
                                                   (2, 16, 16, 3),
                                                   (2, 16, 16, 3)]
    assert float(args[6].abs().max()) <= 1.0
    entry.check_entry(entry.entry_fn(cfg), args)


# --- the dry run's meshes ----------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16])
def test_dryrun_meshes_are_jax_meshes(n):
    """model 2 when n is even and ≥ 4; the (slice 2, data, model) mesh too
    when n ≥ 8 and n % 4 == 0; each a mesh of n ranks."""
    meshes = entry.dryrun_meshes(n)
    model = 2 if (n % 2 == 0 and n >= 4) else 1
    assert meshes[0] == dict(data=n // model, model=model)
    assert len(meshes) == (2 if n >= 8 and n % 4 == 0 else 1)
    for m in meshes:
        assert tmesh.create_mesh(world=n, rank=0, **m).world == n


@pytest.mark.parametrize("mesh", [dict(data=4, model=2),
                                  dict(slices=2, data=2, model=2)],
                         ids=["data4_model2", "slice2_data2_model2"])
def test_dryrun_mesh_coordinates(mesh):
    """Over 8 ranks: every rank's coordinates, shard, batch ranks (one
    model coordinate, in shard order) and model ranks (one shard, in model
    order); every rank in exactly one batch and one model group."""
    batch_groups, model_groups = set(), set()
    for r in range(8):
        env = tmesh.create_mesh(world=8, rank=r, **mesh)
        s, d, m = env.coords
        assert r == (s * env.data_size + d) * 2 + m
        assert env.shard_index == s * env.data_size + d
        assert env.batch_ranks() == [i * 2 + m for i in range(4)]
        assert env.model_ranks() == [env.shard_index * 2,
                                     env.shard_index * 2 + 1]
        assert r in env.batch_ranks() and r in env.model_ranks()
        assert env.rows(8) == slice(2 * env.shard_index,
                                    2 * env.shard_index + 2)
        batch_groups.add(tuple(env.batch_ranks()))
        model_groups.add(tuple(env.model_ranks()))
    assert len(batch_groups) == 2 and len(model_groups) == 4
    assert sorted(sum(batch_groups, ())) == list(range(8))
    assert sorted(sum(model_groups, ())) == list(range(8))


@pytest.mark.parametrize("kw", [dict(model=3), dict(data=2, model=2),
                                dict(slices=2, model=3),
                                dict(slices=4, data=1, model=4)])
def test_mesh_errors_with_model_axis_match_jax(kw):
    """`create_mesh` raises JAX's errors for meshes over 8 ranks whose
    model axis does not fit."""
    with pytest.raises(ValueError) as port:
        tmesh.create_mesh(world=8, rank=0, **kw)
    with pytest.raises(ValueError) as ref:
        jmesh.create_mesh(**kw)
    assert str(port.value) == str(ref.value)


# --- one group of 4 ranks ----------------------------------------------------

MESH = dict(data=2, model=2)
AT_REST = {"train.generator_lr": 0.0, "train.discriminator_lr": 0.0}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """4 ranks (data 2, model 2): the dry run at its learning rates, then at
    lr 0 recording every update's gradients, then the linear check."""
    spec = {"world": 4, "backend": "gloo", "device": "cpu",
            "dryrun": [{"mesh": MESH},
                       {"mesh": MESH, "set": AT_REST, "record_grads": True}],
            "linear_check": True}
    return dp_ticks.launch(spec, tmp_path_factory.mktemp("dryrun"),
                           LAUNCH_TIMEOUT_S)


def _one_process(overrides=None, record_grads=False):
    env = tmesh.create_mesh(world=4, rank=0, **MESH)
    cfg = entry.dryrun_config(env, overrides)
    return cfg, dp_ticks.run(entry.dryrun_spec(cfg, record_grads),
                             torch.device("cpu"))


def test_sharded_tick_matches_one_process(ranks):
    """The host-fed tick: every rank's metrics within the JAX DP
    tolerances of one process's on the global batch with replicated
    params; the gathered params within 10·lr; each rank's slices its
    columns of them; the ranks' gathered states bit-identical."""
    cfg, one = _one_process()
    lr = max(cfg.train.generator_lr, cfg.train.discriminator_lr)
    for r, out in enumerate(ranks):
        got = out["dryrun"][0]
        assert got["metrics"].keys() == one["metrics"][0].keys()
        for k, v in one["metrics"][0].items():
            np.testing.assert_allclose(
                got["metrics"][k], v, atol=METRIC_ATOL,
                rtol=METRIC_RTOL["g" if k.startswith("g") else "d"],
                err_msg=f"rank {r} {k}")
        m = tmesh.create_mesh(world=4, rank=r, **MESH).coords[2]
        for net in "gd":
            whole = one["state"][f"{net}_params"]
            for k, v in got["state"][f"{net}_params"].items():
                np.testing.assert_allclose(v.numpy(), whole[k].numpy(),
                                           atol=PARAM_LRS * lr,
                                           err_msg=f"rank {r} {net} {k}")
                assert torch.equal(v, ranks[0]["dryrun"][0]["state"][
                    f"{net}_params"][k]), (r, net, k)
            sliced = got["slices"][net]
            assert sorted(sliced) == sorted(
                k for k in whole if k.endswith("w") and whole[k].dim() == 2
                and k.split("/")[0] in ("stem", "embed"))
            for k, v in sliced.items():
                cols = v.shape[1]
                assert cols * 2 == whole[k].shape[1]
                assert torch.equal(v, got["state"][f"{net}_params"][k][
                    :, m * cols:(m + 1) * cols])
        assert got["state"]["step"] == 1


def test_sharded_gradients_match_one_process_at_rest(ranks):
    """At lr 0 (every update reads the same params on both sides): every
    update's all-reduced gradients, the sharded ``w``'s this rank's columns
    of one process's, within DP_GRAD_RTOL·(‖g_leaf‖ + max ‖g‖)."""
    _, one = _one_process(AT_REST, record_grads=True)
    for r, out in enumerate(ranks):
        got = out["dryrun"][1]["grads"]
        m = tmesh.create_mesh(world=4, rank=r, **MESH).coords[2]
        for net in "dg":
            assert len(got[net]) == len(one["grads"][net]) == (
                2 if net == "d" else 1)
            for u, ref in enumerate(one["grads"][net]):
                big = max(float(v.norm()) for v in ref.values())
                for k, v in ref.items():
                    g = got[net][u][k]
                    if g.shape != v.shape:          # a column block
                        cols = g.shape[1]
                        v = v[:, m * cols:(m + 1) * cols]
                        assert k.split("/")[0] in ("stem", "embed"), k
                    err = float((g - v).norm())
                    assert err <= DP_GRAD_RTOL * (float(v.norm()) + big), (
                        f"rank {r} {net} update {u} {k}: {err:.3e}")


def test_column_parallel_linear_derivatives(ranks):
    """The column-parallel linear against the replicated one on every rank:
    the output, the first derivatives (create_graph) and the second, each
    within LINEAR_TOL of the replicated one's largest |value|."""
    for r, out in enumerate(ranks):
        errs = out["linear"]
        assert set(errs) == {"y", "dx", "dw", "db", "d2x", "d2w", "d2b"}
        assert max(errs.values()) <= LINEAR_TOL, (r, errs)


def test_resident_tick_runs_sharded(ranks):
    """The resident tick of each run on every rank: step 1 (asserted in the
    rank), finite metrics, the same on every rank (the global ones)."""
    for out in ranks:
        for i, mesh in enumerate(out["dryrun"]):
            assert mesh["resident_metrics"] == ranks[0]["dryrun"][i][
                "resident_metrics"]
            assert all(np.isfinite(v) for v in
                       mesh["resident_metrics"].values())
            assert mesh["line"].startswith(
                "dryrun_multichip OK: mesh data=2 model=2")
