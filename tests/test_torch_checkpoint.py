"""The port's checkpoints on the CPU: a save restores bit for bit into a
fresh state (both nets, BN states, Adam counts and moments, step, EMA,
Stage-II's frozen Stage-I), in place so that the optimizers keep their
leaves; ``max_to_keep``; the EMA dropped or backfilled when
``train.ema_decay`` was toggled, and any other mismatch refused; async
saves; Stage-I from a run directory, EMA first; and a JAX ``TrainState``
carried across with ``convert.py`` survives a save and a restore."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tests.helpers import make_batch, tiny_config
from text_to_image_tpu.train import steps as jsteps
from text_to_image_tpu.utils import prng as jprng
from text_to_image_tpu_torch import convert
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.train import checkpoint as ckpt
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train.optim import flatten

SPE = 3


def port_cfg(model="gancls", **train):
    return config_from_dict(dataclasses.asdict(tiny_config(model, **train)))


def trained_state(cfg, ticks=2, seed=0):
    """A state `ticks` ticks from init (Adam moments, BN state and, with
    ``ema_decay``, the EMA all moved)."""
    ts = tsteps.init_train_state(seed, cfg, SPE, "cpu")
    step = tsteps.make_train_step(cfg, SPE, "cpu")
    for i in range(ticks):
        ts, _ = step(ts, make_batch(cfg, seed=i))
    return ts


def leaves(ts):
    """Every tensor of a TrainState by name, and the scalars."""
    out = {}
    for name in ("g_params", "g_state", "d_params", "d_state"):
        out.update({f"{name}/{k}": v for k, v in flatten(getattr(ts, name))})
    for key, tree in ts.aux.items():
        out.update({f"aux/{key}/{k}": v for k, v in flatten(tree)})
    for name in ("g_opt", "d_opt"):
        opt = getattr(ts, name)
        mu, nu = opt.moments()
        out.update({f"{name}/mu/{k}": v for k, v in mu.items()})
        out.update({f"{name}/nu/{k}": v for k, v in nu.items()})
        out[f"{name}/count"] = opt.count
    out["step"] = ts.step
    return out


def assert_same(got, ref):
    a, b = leaves(got), leaves(ref)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, k
            assert torch.equal(a[k].detach(), b[k].detach()), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("model,train", [
    ("gancls", {}), ("gancls", {"ema_decay": 0.9}),
    ("stackgan_stage2", {"ema_decay": 0.5})])
def test_round_trip_is_bit_exact_and_in_place(tmp_path, model, train):
    cfg = port_cfg(model, **train)
    ts = trained_state(cfg)
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    assert mgr.latest_step() is None
    assert mgr.save(ts.step, ts)
    assert os.listdir(mgr.directory) == [f"step_{ts.step}.pt"]
    fresh = tsteps.init_train_state(5, cfg, SPE, "cpu")
    held = list(fresh.g_opt.leaves) + list(fresh.d_opt.leaves)
    got, step = mgr.restore(fresh)
    assert step == ts.step == 2 and got is fresh
    assert_same(got, ts)
    # in place: each optimizer still steps the tensors the trees hold
    assert [id(t) for t in held] == [
        id(t) for t in list(got.g_opt.leaves) + list(got.d_opt.leaves)]
    assert all(a is b for (_, a), b in zip(flatten(got.g_params),
                                           got.g_opt.leaves))
    # the next tick from the restored state is the next tick of the saved one
    step_fn = tsteps.make_train_step(cfg, SPE, "cpu")
    a, ma = step_fn(got, make_batch(cfg, seed=9))
    b, mb = step_fn(ts, make_batch(cfg, seed=9))
    assert_same(a, b)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_max_to_keep_and_steps_saved_once(tmp_path):
    cfg = port_cfg()
    ts = tsteps.init_train_state(0, cfg, SPE, "cpu")
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in range(1, 7):
        ts.step = s
        assert mgr.save(s, ts)
    assert mgr.all_steps() == [4, 5, 6] and mgr.latest_step() == 6
    assert not mgr.save(6, ts) and not mgr.save(2, ts)
    assert sorted(os.listdir(str(tmp_path))) == [
        "step_4.pt", "step_5.pt", "step_6.pt"]
    ts.step = 0
    assert mgr.restore(ts, step=5)[0].step == 5


@pytest.mark.parametrize("saved_ema", [True, False])
def test_ema_toggled_between_runs(tmp_path, saved_ema):
    """A run with the EMA into one without drops the average; a run
    without into one with starts the average from the restored params."""
    on, off = port_cfg(ema_decay=0.9), port_cfg()
    src, dst = (on, off) if saved_ema else (off, on)
    ts = trained_state(src)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(ts.step, ts)
    got, _ = mgr.restore(tsteps.init_train_state(3, dst, SPE, "cpu"))
    assert ("ema_g_params" in got.aux) == (not saved_ema)
    for (name, a), (_, b) in zip(flatten(got.g_params), flatten(ts.g_params)):
        assert torch.equal(a, b), name
    if not saved_ema:
        for (name, e), (_, p) in zip(flatten(got.aux["ema_g_params"]),
                                     flatten(got.g_params)):
            assert torch.equal(e, p) and e.data_ptr() != p.data_ptr(), name


@pytest.mark.parametrize("change", ["width", "model"])
def test_mismatched_structure_raises(tmp_path, change):
    ts = trained_state(port_cfg(), ticks=1)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(ts.step, ts)
    other = port_cfg("stackgan_stage1") if change == "model" else \
        dataclasses.replace(port_cfg(), gan=dataclasses.replace(
            port_cfg().gan, gf_dim=16))
    like = tsteps.init_train_state(0, other, SPE, "cpu")
    before = {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
              for k, v in leaves(like).items()}
    with pytest.raises(ValueError, match="does not match the current model"):
        mgr.restore(like)
    after = leaves(like)
    for k, v in before.items():   # a refused restore leaves the state be
        assert (torch.equal(v, after[k].detach())
                if isinstance(v, torch.Tensor) else v == after[k]), k


def test_async_save_then_restore(tmp_path):
    cfg = port_cfg(ema_decay=0.9)
    ts = trained_state(cfg)
    mgr = ckpt.CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(ts.step, ts)
    want = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
            for k, v in leaves(ts).items()}
    with torch.no_grad():          # the snapshot was taken at save
        for _, p in flatten(ts.g_params):
            p.add_(1.0)
    got, step = mgr.restore(tsteps.init_train_state(1, cfg, SPE, "cpu"))
    assert step == 2
    for k, v in leaves(got).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v.detach(), want[k].detach()), k
    mgr.close()


@pytest.mark.parametrize("ema", [True, False])
def test_load_stage1_generator_prefers_the_ema(tmp_path, ema):
    cfg = port_cfg("stackgan_stage1", **({"ema_decay": 0.5} if ema else {}))
    ts = trained_state(cfg)
    mgr = ckpt.CheckpointManager(str(tmp_path / "stage1"))
    mgr.save(ts.step, ts)
    params, state = convert.load_stage1_generator(str(tmp_path / "stage1"),
                                                  "cpu")
    want = ts.aux["ema_g_params"] if ema else ts.g_params
    if ema:        # the average differs from the live params after 2 ticks
        assert not torch.equal(want["up0"]["conv"]["w"],
                               ts.g_params["up0"]["conv"]["w"])
    for tree, ref in ((params, want), (state, ts.g_state)):
        a, b = dict(flatten(tree)), dict(flatten(ref))
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k].detach()), k
    with pytest.raises(FileNotFoundError, match="no Stage-I checkpoint"):
        ckpt.load_stage1_generator(str(tmp_path / "empty"))


@pytest.mark.parametrize("model", ["gancls", "stackgan_stage2"])
def test_jax_train_state_carried_across_survives_a_checkpoint(tmp_path,
                                                              model):
    """A JAX TrainState (EMA on, Adam moved by one JAX tick) → the port
    with `convert.from_jax_train_state` → saved → restored: equal to the
    converted state, leaf for leaf, and to the JAX arrays."""
    jcfg = tiny_config(model, ema_decay=0.9)
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    jts = jsteps.init_train_state(jprng.base_key(4), jcfg, SPE)
    body = jax.jit(jsteps._make_step_body(jcfg.compute_key(), SPE))
    jts, _ = body(jts, make_batch(jcfg, seed=1))
    host = jax.device_get(jts)
    conv = convert.from_jax_train_state(host, cfg, SPE, "cpu")
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(conv.step, conv)
    got, step = mgr.restore(tsteps.init_train_state(0, cfg, SPE, "cpu"))
    assert step == int(host.step) == 1
    assert_same(got, conv)
    np.testing.assert_array_equal(
        got.d_params["down1"]["w"].detach().numpy(),
        np.asarray(host.d_params["down1"]["w"]))
