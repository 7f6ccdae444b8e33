"""Which groups a mesh makes: a live process group of one rank (gloo, in
this process, through a ``file://`` store) has no batch group, so
``Trainer`` runs the one-process tick (no collective, the same numbers as
without a group), as a JAX mesh of one device has nothing to reduce; the
(data 1, model 2) mesh's arithmetic; the checksum check of a group of one
rank."""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from tests.helpers import tiny_config
from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.parallel import collectives
from text_to_image_tpu_torch.parallel import mesh as tmesh
from text_to_image_tpu_torch.train import steps as tsteps
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.trainer import Trainer


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cfg(tmp_path, tag):
    cfg = config_from_dict(dataclasses.asdict(tiny_config()))
    return cfg.replace(checkpoint_dir=str(tmp_path / tag / "ck"),
                       log_dir=str(tmp_path / tag / "logs"),
                       sample_dir=str(tmp_path / tag / "samples"),
                       train=dataclasses.replace(cfg.train,
                                                 summary_interval=1))


def test_world1_group_has_no_batch_group(world1):
    env = tmesh.create_mesh()
    assert env.live and env.world == 1
    assert env.batch_group is None and env.model_group is None
    assert tsteps.batch_sync_of(env) is None
    assert tsteps.model_sync_of(env) is None
    tmesh.check_replicated(env, [torch.ones(3)], "params")   # nothing to do


def test_world1_trainer_runs_the_one_process_tick(world1, tmp_path, capsys):
    """Two ticks under the group: no byte all-reduced, and the metrics and
    params of the same two ticks without a group, bit for bit."""
    collectives.all_reduce_sum.bytes = 0
    grouped = Trainer(_cfg(tmp_path, "group"), device="cpu")
    grouped.train(num_steps=2)
    grouped.close()
    assert collectives.all_reduce_sum.bytes == 0
    assert "data parallel" not in capsys.readouterr().out
    alone = Trainer(_cfg(tmp_path, "alone"), device="cpu",
                    env=tmesh.MeshEnv())
    alone.train(num_steps=2)
    alone.close()
    strip = [{k: v for k, v in h.items() if k != "images_per_sec"}
             for t in (grouped, alone) for h in t.history]
    assert strip[:2] == strip[2:]
    for net in ("g_params", "d_params"):
        ref = dict(flatten(getattr(alone.ts, net)))
        for k, v in flatten(getattr(grouped.ts, net)):
            assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("rank", [0, 1])
def test_data1_model2_mesh(rank):
    """Two ranks of one shard: each holds the whole batch (no batch
    group's rows), both form the model group."""
    env = tmesh.create_mesh(data=1, model=2, world=2, rank=rank)
    assert (env.slice_size, env.data_size, env.model_size) == (1, 1, 2)
    assert env.coords == (0, 0, rank) and env.shard_index == 0
    assert env.shards == 1 and env.batch_ranks() == [rank]
    assert env.model_ranks() == [0, 1]
    assert env.rows(8) == slice(0, 8)
    assert not env.live and env.batch_group is None
