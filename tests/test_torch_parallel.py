"""The port's data parallelism on the CPU against the JAX package: the mesh
arithmetic and errors (as ``tests/test_parallel.py`` holds JAX's), whole
GAN-CLS ticks of 4 ``gloo`` ranks on (slice 2, data 2) and (data 2, model
2) meshes against JAX's single-device step on the global batch (the JAX
package's own DP tolerances: metrics within rtol 5e-3 / atol 1e-4, params
within 10·lr), the replicated tier's and the host tier's rows of the
global batch, the sharded resident tier's staging against JAX's array for
array, the tier rule against the JAX trainer's for several devices, and a
2-rank ``main.py --train`` run that writes from rank 0 alone and resumes
bit-identical.

The ranks are processes of ``text_to_image_tpu_torch.tools.dp_ticks``
(no JAX in them), joined through a ``file://`` store under ``tmp_path``;
each launch kills its ranks and fails after 60 s, so a hung collective
cannot hang the suite.  The JAX reference runs in this process."""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from tests.test_torch_train import _jax_draws
from tests.test_torch_trainer import _Arrays
from text_to_image_tpu.data import device as jdevice
from text_to_image_tpu.parallel import mesh as jmesh
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.train.trainer import Trainer as JTrainer
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.data import device as tdevice
from text_to_image_tpu_torch.data.pipeline import InputPipeline
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.parallel import mesh as tmesh
from text_to_image_tpu_torch.tools import dp_ticks
from text_to_image_tpu_torch.train import checkpoint as tckpt
from text_to_image_tpu_torch.train.trainer import Trainer
from text_to_image_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's DP tolerances (tests/test_parallel.py)
METRIC_RTOL, METRIC_ATOL, PARAM_LRS = 5e-3, 1e-4, 10
# the first tick's mean gradient against jax.grad's on the global batch
# (f32; reduction order and the D update's round-off steps before G's)
GRAD_RTOL = 1e-4
LAUNCH_TIMEOUT_S = 60


# --- the mesh ----------------------------------------------------------------

def test_mesh_shapes_and_errors_match_jax():
    """`create_mesh` over 8 ranks: the shapes and the errors of the JAX
    package's over its 8 devices."""
    env = tmesh.create_mesh(data=4, model=2, world=8, rank=0)
    assert (env.data_size, env.model_size, env.slice_size) == (4, 2, 1)
    env2 = tmesh.create_mesh(model=2, world=8, rank=0)
    assert env2.data_size * 2 == 8
    env3 = tmesh.create_mesh(slices=2, model=1, world=8, rank=0)
    assert (env3.slice_size, env3.data_size) == (2, 4)
    for kw in (dict(data=3, model=3), dict(slices=3), dict(model=3)):
        with pytest.raises(ValueError) as port:
            tmesh.create_mesh(world=8, rank=0, **kw)
        with pytest.raises(ValueError) as ref:
            jmesh.create_mesh(**kw)
        assert str(port.value) == str(ref.value)
    assert tmesh.create_mesh().world == 1       # no process group here
    assert tmesh.create_mesh().batch_group is None


def test_mesh_coordinates_are_rank_major():
    """rank = (slice·data + data)·model + model; the batch group of a rank
    is the ranks of its model coordinate, in shard order, and its rows of
    the global batch are its shard's."""
    seen = set()
    for rank in range(8):
        env = tmesh.create_mesh(slices=2, data=2, model=2, world=8,
                                rank=rank)
        s, d, m = env.coords
        assert rank == (s * 2 + d) * 2 + m
        assert env.shard_index == s * 2 + d
        assert env.batch_ranks() == [m, 2 + m, 4 + m, 6 + m]
        assert env.rows(16) == slice(4 * env.shard_index,
                                     4 * env.shard_index + 4)
        seen.add((s, d, m))
    assert len(seen) == 8
    with pytest.raises(ValueError, match="divisible"):
        env.rows(6)


# --- ticks against the JAX step ----------------------------------------------

def port_cfg(jcfg):
    return config_from_dict(dataclasses.asdict(jcfg))


def _tensors(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def dp_run(ticks, tmp_path, world, mesh, draws):
    """The JAX ticks' batches on `world` gloo ranks of `mesh`, from the
    converted JAX start state, with the JAX step's noise (`draws(jcfg,
    step, batch)`); every rank's outcome."""
    state_dir = tmp_path / "start"
    ts = convert.from_jax_train_state(ticks.states[0], ticks.cfg, ticks.spe,
                                      "cpu")
    tckpt.CheckpointManager(str(state_dir)).save(ts.step, ts)
    b = ticks.batches[0]["emb"].shape[1]
    spec = {"cfg": dataclasses.asdict(ticks.cfg), "steps_per_epoch": ticks.spe,
            "mesh": mesh, "backend": "gloo", "device": "cpu", "world": world,
            "state": str(state_dir), "record_grads": True,
            "batches": [_tensors(x) for x in ticks.batches],
            "noise": [_tensors(draws(ticks.jcfg, ts.step + i, b))
                      for i in range(len(ticks.batches))]}
    return dp_ticks.launch(spec, tmp_path / "ranks", LAUNCH_TIMEOUT_S)


def check_grad_scale(ticks, outs):
    """The gradients each rank handed Adam in the first tick (the mean over
    the batch group), run through Adam's first-moment recurrence from the
    start state's, against JAX's first moment after that tick: jax.grad of
    the global-batch loss.  Adam's update does not see a gradient's scale;
    its first moment does, so a wrong factor in the all-reduce (÷ D, or a
    leaf counted twice) fails here.  Per leaf ‖Δ‖ ≤ GRAD_RTOL·‖μ_leaf‖ +
    GRAD_RTOL·max ‖μ‖ over the net's leaves (the second term for the
    BN-fronted biases, whose true gradient is 0)."""
    b1 = ticks.cfg.train.beta1
    start, after = (convert.from_jax_train_state(s, ticks.cfg, ticks.spe,
                                                 "cpu")
                    for s in ticks.states[:2])
    for r, out in enumerate(outs):
        for net in ("d", "g"):
            mu = {k: v.clone() for k, v in
                  getattr(start, f"{net}_opt").moments()[0].items()}
            assert out["grads"][net], f"rank {r}: no {net} update recorded"
            for grads in out["grads"][net]:
                mu = {k: b1 * m + (1 - b1) * grads[k] for k, m in mu.items()}
            ref = getattr(after, f"{net}_opt").moments()[0]
            floor = GRAD_RTOL * max(float(v.norm()) for v in ref.values())
            for k, v in ref.items():
                err = float((mu[k] - v).norm())
                assert err <= GRAD_RTOL * float(v.norm()) + floor, (
                    f"rank {r} {net} {k}: first moment {err:.3e} from JAX's "
                    f"(‖μ‖ {float(v.norm()):.3e})")


def check_against_jax(ticks, outs):
    """Every rank's metrics against JAX's, tick by tick; its final params
    within PARAM_LRS·lr of JAX's; the first tick's gradients against
    JAX's (`check_grad_scale`); every rank's final state bit-identical to
    rank 0's."""
    from text_to_image_tpu_torch.train.optim import flatten
    lr = ticks.cfg.train.generator_lr
    check_grad_scale(ticks, outs)
    for r, out in enumerate(outs):
        assert len(out["metrics"]) == len(ticks.metrics)
        for i, (got, ref) in enumerate(zip(out["metrics"], ticks.metrics)):
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(
                    got[k], float(ref[k]), rtol=METRIC_RTOL, atol=METRIC_ATOL,
                    err_msg=f"rank {r} tick {i} metric {k}")
        for tree in ("g_params", "d_params"):
            ref = dict(flatten(getattr(ticks.states[-1], tree)))
            for k, v in out["state"][tree].items():
                np.testing.assert_allclose(v.numpy(), ref[k],
                                           atol=PARAM_LRS * lr,
                                           err_msg=f"rank {r} {tree} {k}")
        for tree in ("g_params", "d_params", "g_state", "d_state"):
            for k, v in out["state"][tree].items():
                assert torch.equal(v, outs[0]["state"][tree][k]), (r, tree, k)
        assert out["state"]["step"] == int(ticks.states[-1].step)


@functools.lru_cache(maxsize=None)
def gancls_ticks(n_ticks=3):
    """Three single-device JAX GAN-CLS ticks at batch 8 (the global batch),
    from seed 0: states, batches, metrics."""
    jcfg = tiny_config("gancls")
    spe = 3
    ts0 = jax.device_get(jsteps.init_train_state(jprng.base_key(0), jcfg,
                                                 spe))
    body = jax.jit(jsteps._make_step_body(jcfg.compute_key(), spe))
    rng = np.random.default_rng(3)
    k, b = jcfg.train.n_critic, jcfg.train.batch_size
    res = jcfg.data.image_size
    batches = [{"real": rng.integers(0, 256, (k, b, res, res, 3), np.uint8),
                "wrong": rng.integers(0, 256, (k, b, res, res, 3), np.uint8),
                "emb": rng.normal(size=(k, b, jcfg.gan.embed_dim)
                                  ).astype(np.float32)}
               for _ in range(n_ticks)]
    states, metrics = [ts0], []
    for batch in batches:
        ts, m = body(states[-1], batch)
        states.append(jax.device_get(ts))
        metrics.append(jax.device_get(m))
    return types.SimpleNamespace(jcfg=jcfg, cfg=port_cfg(jcfg), spe=spe,
                                 states=states, metrics=metrics,
                                 batches=batches)


@pytest.mark.parametrize("mesh", [dict(slices=2, data=2, model=1),
                                  dict(slices=1, data=2, model=2)],
                         ids=["slice2_data2", "data2_model2"])
def test_gancls_dp_ticks_match_jax_single_device(mesh, tmp_path):
    """4 ranks, 3 ticks: the batch norm's global statistics (bn_partials /
    bn_finish around an all-gather), the synced backward and the gradient
    all-reduce; on (data 2, model 2) the two model coordinates are two
    batch groups that compute the same thing."""
    ticks = gancls_ticks()
    outs = dp_run(ticks, tmp_path, 4, mesh,
                  lambda jcfg, step, b: _jax_draws(jcfg, step, b))
    check_against_jax(ticks, outs)
    per_group = {tuple(o["all_reduce_bytes"]) for o in outs}
    assert len(per_group) == 1 and min(next(iter(per_group))) > 0


# --- the data tiers ----------------------------------------------------------

def _split(n=40, classes=5, seed=0):
    rng = np.random.default_rng(seed)
    return types.SimpleNamespace(
        images=rng.integers(0, 256, (n, 10, 10, 3), np.uint8),
        embeddings=rng.normal(size=(n, 4, 6)).astype(np.float32),
        class_ids=np.arange(n) % classes, num_examples=n)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_staging_matches_jax(shards):
    """Shard r's arrays are rows r·Nl … (r+1)·Nl of the JAX tier's sharded
    arrays and row r of its class tables (n = 39: the tail wraps)."""
    ds = _split(n=39)
    env = jmesh.create_mesh(data=shards, devices=jax.devices()[:shards])
    ref = jax.device_get(jdevice.stage_sharded(ds, env, seed=7))
    nl = -(-39 // shards)
    for r in range(shards):
        got = tdevice.stage_sharded(ds, r, shards, seed=7, device="cpu")
        assert (got.shard, got.shards) == (r, shards)
        rows = slice(r * nl, (r + 1) * nl)
        np.testing.assert_array_equal(got.images.numpy(), ref.images[rows])
        np.testing.assert_array_equal(got.embeddings.numpy(),
                                      ref.embeddings[rows])
        for name in ("class_perm", "other_start", "other_count"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(ref, name)[r], err_msg=name)


def test_sharded_staging_refuses_a_single_class_shard():
    ds = _split(n=4, classes=2)
    ds.class_ids = np.array([0, 0, 0, 1])
    env = jmesh.create_mesh(data=4, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="single-class") as ref:
        jdevice.stage_sharded(ds, env, seed=0)
    with pytest.raises(ValueError, match="single-class") as got:
        tdevice.stage_sharded(ds, 0, 4, seed=0, device="cpu")
    assert str(got.value) == str(ref.value)


def test_sharded_draws_come_from_the_shard_and_its_key():
    """A rank's B/D rows are drawn from its own shard with key fold_in(key,
    shard): the same as the replicated sampler over the shard alone."""
    ds = _split()
    shard = tdevice.stage_sharded(ds, 1, 2, seed=3, device="cpu")
    args = (2, 8, 8, 2, True, True)
    got = tdevice.sample_stacked_sharded(shard, 11, *args)
    assert got["real"].shape == (2, 4, 8, 8, 3)
    ref = tdevice.sample_stacked(shard, prng.fold_in(11, 1), 2, 4,
                                 *args[2:])
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tdevice.sample_stacked_sharded(shard, 11, 2, 7, *args[2:])


def test_replicated_tier_ranks_gather_their_rows_of_the_global_batch():
    """Every rank draws the global [K, B] variables and gathers its rows:
    the D pieces are the one-device batch, bit for bit."""
    data = tdevice.stage(_split(), device="cpu")
    args = (2, 8, 8, 2, True, True)
    whole = tdevice.sample_stacked(data, 5, *args)
    env = tmesh.create_mesh(data=4, world=4, rank=0)
    for r in range(4):
        rows = dataclasses.replace(env, rank=r).rows(8)
        part = tdevice.sample_stacked(data, 5, *args, rows=rows)
        for k in whole:
            torch.testing.assert_close(part[k], whole[k][:, rows], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("model", ["stackgan_stage1", "stackgan_stage2",
                                   "pggan", "wgancls"])
def test_noise_shards_along_each_entrys_batch_axis(model):
    """`shard_noise` keeps a rank's rows of the global noise: every entry
    takes the shape `draw_noise` gives the rank's batch (the CA ε's from
    the bundle's ``eps_shape``: [2, B, ca] for Stage-II), and the ranks'
    pieces put back along that axis are the global draw."""
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.train import steps as tsteps
    cfg = port_cfg(tiny_config(model, use_interpolation=True))
    whole = tsteps.draw_noise(cfg, 3, 8)
    local = tsteps.draw_noise(cfg, 3, 4)          # the shapes at B/D
    assert ("g_eps" in whole) == (get_model(cfg).eps_shape(8) is not None)
    assert ("gp_eps" in whole) == get_model(cfg).is_wgan
    env = tmesh.create_mesh(data=2, world=2, rank=0)
    # a stand-in group: sharding reads only the rank's rows
    parts = [tsteps.shard_noise(cfg, dataclasses.replace(
        env, rank=r, batch_group=object()), whole) for r in range(2)]
    assert parts[0].keys() == whole.keys() == local.keys()
    for k, v in whole.items():
        assert parts[0][k].shape == parts[1][k].shape == local[k].shape, k
        axis = [a != b for a, b in zip(v.shape, local[k].shape)].index(True)
        torch.testing.assert_close(torch.cat([p[k] for p in parts], axis),
                                   v, rtol=0, atol=0)


def test_host_tier_ranks_copy_their_rows_of_the_global_batch():
    """Every rank assembles the same global batch from the dataset's seed
    and keeps its rows."""
    def ds():
        return SyntheticDataset(num_examples=32, image_size=8, embed_dim=6,
                                seed=4)
    whole = InputPipeline(ds(), 8, "cpu", batches_per_step=2)
    halves = [InputPipeline(ds(), 8, "cpu", batches_per_step=2,
                            rows=slice(4 * r, 4 * r + 4)) for r in range(2)]
    try:
        for _ in range(2):
            w = next(whole)
            parts = [next(h) for h in halves]
            for k in w:
                torch.testing.assert_close(
                    torch.cat([p[k] for p in parts], 1), w[k], rtol=0, atol=0)
    finally:
        for p in [whole, *halves]:
            p.close()


@pytest.mark.parametrize("mode,mb,budget,d,batch", [
    ("sharded", 1, 4096, 2, 8), ("sharded", 1, 4096, 4, 6),
    ("auto", 8, 4, 2, 8), ("auto", 8, 4, 4, 8), ("auto", 8, 4, 4, 6),
    ("auto", 8, 2, 2, 8), ("auto", 1, 4096, 4, 8), ("on", 8, 4, 4, 8)])
def test_resident_tier_is_jax_rule_on_several_devices(mode, mb, budget, d,
                                                      batch):
    """`_resident_tier` against the JAX trainer's with D = slice·data
    batch-axis devices: sharded on request, or on `auto` when the split
    fits D budgets but not one; the error for B not divisible by D."""
    ds = _Arrays(True, mb)
    out = []
    for cls, cfg in ((JTrainer, tiny_config()),
                     (Trainer, port_cfg(tiny_config()))):
        cfg = cfg.replace(
            data=dataclasses.replace(cfg.data, device_resident=mode,
                                     resident_budget_mb=budget),
            train=dataclasses.replace(cfg.train, batch_size=batch))
        self = types.SimpleNamespace(cfg=cfg, dataset=ds,
                                     env=types.SimpleNamespace(
                                         slice_size=2 if d == 4 else 1,
                                         data_size=2 if d == 4 else d))
        try:
            out.append(cls._resident_tier(self))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


# --- the trainer on 2 ranks --------------------------------------------------

def _train_argv(root, steps):
    return ["--cfg", os.path.join(ROOT, "configs", "gancls_flowers.yml"),
            "--device", "cpu", "--train", "--steps", str(steps),
            "--dist-backend", "gloo", "--set", "data.dataset_name=synthetic",
            "data.image_size=16", "gan.gf_dim=8", "gan.df_dim=8",
            "gan.embed_dim=32", "train.batch_size=8",
            "train.summary_interval=1", "train.snapshot_interval=2",
            "train.sample_interval=2", "dtype=float32",
            "data.device_resident=sharded",
            *(f"{k}={root / k.split('_')[0]}"
              for k in ("checkpoint_dir", "log_dir", "sample_dir"))]


def _train(root, steps, tag):
    spec = {"argv": _train_argv(root, steps), "backend": "gloo",
            "device": "cpu", "world": 2}
    return dp_ticks.launch(spec, root / f"ranks_{tag}", LAUNCH_TIMEOUT_S)


def test_two_rank_trainer_writes_from_rank0_and_resumes_bit_identical(
        tmp_path):
    """``main.py --train`` on 2 ranks over the sharded resident tier: 4
    straight ticks, and 2 ticks then a second run to 4 that restores the
    step-2 checkpoint.  One metric line a step and one grid an interval
    (rank 0 alone writes); the two runs' step-4 checkpoints are
    bit-identical; both ranks hold the same metrics (the throughput is each
    rank's own clock)."""
    straight = _train(tmp_path / "a", 4, "a")
    assert [o["step"] for o in straight] == [4, 4]
    assert [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in straight[0]["history"]] == [
        {k: v for k, v in h.items() if k != "images_per_sec"}
        for h in straight[1]["history"]]
    lines = [json.loads(s) for s in open(
        tmp_path / "a" / "log" / "gancls" / "synthetic" / "train.jsonl")]
    assert [rec["step"] for rec in lines] == [1, 2, 3, 4]
    grids = sorted(os.listdir(tmp_path / "a" / "sample" / "gancls" /
                              "synthetic"))
    assert grids == ["train_00000002.png", "train_00000004.png"]
    _train(tmp_path / "b", 2, "b1")
    resumed = _train(tmp_path / "b", 4, "b2")
    assert [o["step"] for o in resumed] == [4, 4]
    assert [h["d_loss"] for h in resumed[0]["history"]] == [
        h["d_loss"] for h in straight[0]["history"][2:]]
    ckpts = [tckpt.CheckpointManager(str(tmp_path / d / "checkpoint" /
                                         "gancls" / "synthetic"))
             for d in ("a", "b")]
    assert ckpts[1].all_steps() == [2, 4]
    a, b = (m.load(4)[0] for m in ckpts)
    for tree in ("g_params", "d_params", "g_state", "d_state"):
        for k, v in a[tree].items():
            assert torch.equal(v, b[tree][k]), (tree, k)
    for name in ("g_opt", "d_opt"):
        assert a[name]["count"] == b[name]["count"]
        for k, v in a[name]["mu"].items():
            assert torch.equal(v, b[name]["mu"][k]), (name, k)
