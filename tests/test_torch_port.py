"""The port's package boundary and entry points on the CPU: it imports
neither JAX nor the JAX package, its CLI writes the three grids (from a
seed, from JAX weights or from its latest checkpoint) and trains, writing
snapshots and grids, for GAN-CLS and both StackGAN stages; Stage-II takes
its Stage-I from an ``.npz`` or a Stage-I run directory; the StackGAN
reader refuses a missing split naming the preprocessing; the models once
left to port (WGAN-CLS, C-PGGAN) have bundles, and weights survive the
``.npz`` round trip."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config
from text_to_image_tpu.models import gancls as jgancls
from text_to_image_tpu.models import stackgan as jstackgan
from text_to_image_tpu_torch import convert, main
from text_to_image_tpu_torch.config import (Config, DataConfig, GanConfig,
                                            load_config)
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.models import gancls, registry, stackgan
from text_to_image_tpu_torch.ops import layers
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the package (walked, ``tools/`` included) and
    ``chip_smoke.py`` import with ``jax`` made unimportable, and none of
    them loads a module of the JAX package."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import text_to_image_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        assert len(names) > 40, names
        assert "text_to_image_tpu_torch.eval.inception_v3" in names
        assert "text_to_image_tpu_torch.entry" in names
        assert "text_to_image_tpu_torch.bench" in names
        assert "text_to_image_tpu_torch.parallel.tensor" in names
        bad = sorted(m for m in sys.modules
                     if m == "text_to_image_tpu"
                     or m.startswith("text_to_image_tpu."))
        assert not bad, bad
        print("clean")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def _tiny_yaml(tmp_path):
    path = tmp_path / "tiny.yml"
    path.write_text(textwrap.dedent(f"""
        model: gancls
        data: {{dataset_name: synthetic, image_size: 16}}
        gan: {{gf_dim: 8, z_dim: 8, embed_dim: 32, compressed_embed_dim: 16}}
        dtype: float32
        sample_dir: {tmp_path / "samples"}
        checkpoint_dir: {tmp_path / "ck"}
        log_dir: {tmp_path / "logs"}
    """))
    return str(path)


@pytest.mark.parametrize("weights", [False, True])
def test_cli_writes_three_grids(tmp_path, weights, capsys):
    """From a seed, and from weights the JAX package initialised."""
    argv = ["--cfg", _tiny_yaml(tmp_path), "--device", "cpu"]
    if weights:
        jcfg = tiny_config()
        params, state = jax.device_get(
            jgancls.generator_init(jax.random.PRNGKey(1), jcfg.gan, 16))
        convert.save_npz(str(tmp_path / "g.npz"), params, state)
        argv += ["--weights", str(tmp_path / "g.npz")]
    main.main(argv)
    out = tmp_path / "samples" / "gancls" / "synthetic"
    tag = "weights" if weights else "init"
    for name in ("eval_grid", "z_interp", "t_interp"):
        assert (out / f"{name}_{tag}.png").exists(), name
    said = capsys.readouterr().out
    assert ("sampling from " + str(tmp_path / "g.npz") if weights else
            "initialised from seed 0") in said


def test_cli_train_is_not_ported(tmp_path, capsys):
    """Training runs (``--train --steps 2 --device cpu`` prints finite
    metrics) and writes what was once not ported: a snapshot every
    ``snapshot_interval`` steps and at the end, a grid every
    ``sample_interval`` steps; sampling then takes the latest checkpoint."""
    argv = ["--cfg", _tiny_yaml(tmp_path), "--train", "--device", "cpu"]
    main.main(argv + ["--steps", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step 2]")]
    assert len(lines) == 1, lines
    fields = dict(kv.split("=") for kv in lines[0].split()[2:])
    for k in ("d_loss", "d_real", "d_fake", "d_wrong", "g_loss",
              "images_per_sec"):
        assert np.isfinite(float(fields[k])), k
    run = os.path.join("gancls", "synthetic")
    assert os.listdir(tmp_path / "ck" / run) == ["step_2.pt"]
    main.main(argv + ["--steps", "5", "--set", "train.snapshot_interval=2",
                      "train.sample_interval=2"])
    assert "restored checkpoint at step 2" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ck" / run)) == [
        "step_2.pt", "step_4.pt", "step_5.pt"]
    assert sorted(os.listdir(tmp_path / "samples" / run)) == [
        "train_00000004.png"]
    main.main(argv[:-3] + ["--device", "cpu"])
    assert "sampling from the step-5 checkpoint" in capsys.readouterr().out
    assert (tmp_path / "samples" / run / "eval_grid_5.png").exists()


def test_cli_keeps_the_grids_of_each_sampled_checkpoint(tmp_path, capsys):
    """Sampling a run at step 1 and again at step 2 leaves both sets of
    grids, named by step as the root ``main.py`` names them."""
    argv = ["--cfg", _tiny_yaml(tmp_path), "--device", "cpu"]
    out = tmp_path / "samples" / "gancls" / "synthetic"
    for step in (1, 2):
        main.main(argv + ["--train", "--steps", str(step), "--set",
                          "train.batch_size=8"])
        main.main(argv)
        assert (f"sampling from the step-{step} checkpoint"
                in capsys.readouterr().out)
    assert sorted(os.listdir(out)) == sorted(
        f"{name}_{step}.png" for name in ("eval_grid", "z_interp", "t_interp")
        for step in (1, 2))


def test_cli_overrides_are_typed():
    assert main.parse_overrides(["a=true", "b=3", "c=x", "d=0.5"]) == {
        "a": True, "b": 3, "c": "x", "d": 0.5}


@pytest.mark.parametrize("model,item", [("wgancls", "item 5"),
                                        ("pggan", "item 7")])
def test_unported_models_name_their_roadmap_item(model, item):
    """The two families once refused here (WGAN-CLS, ROADMAP item 5;
    C-PGGAN, item 7) now have bundles: a critic with the GP loss, drawn and
    applied on the CPU, and a tick that runs."""
    cfg = Config(model=model, gan=GanConfig(
        gf_dim=8, df_dim=8, z_dim=8, embed_dim=32, compressed_embed_dim=16,
        ca_dim=8), data=DataConfig(dataset_name="synthetic", image_size=8))
    bundle = registry.get_model(cfg)
    assert bundle.name == model and bundle.is_wgan
    assert bundle.has_ca == (model == "pggan")
    gp, gs, dp, ds = bundle.init(0, "cpu")
    x = torch.zeros(2, bundle.resolution, bundle.resolution, 3)
    scores, new_ds = bundle.disc_apply(dp, ds, {}, x, torch.zeros(2, 32),
                                       True, layers.FP32)
    assert tuple(scores.shape) == (2,) and new_ds == {}
    from text_to_image_tpu_torch.train import steps
    noise = steps.draw_noise(cfg, 0, 2)
    assert noise["gp_eps"].shape == (cfg.train.n_critic, 2, 1, 1, 1)


@pytest.mark.parametrize("model", ["gancls", "stackgan_stage1",
                                   "stackgan_stage2"])
def test_ported_models_have_a_bundle(model):
    bundle = registry.get_model(Config(model=model))
    assert bundle.name == model
    assert bundle.has_ca == bundle.name.startswith("stackgan")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model(Config(model="dcgan"))


def _run_dirs(tmp_path):
    """``--set`` pairs that keep a run's checkpoints, logs and grids under
    `tmp_path` (else a run would restore another's checkpoint)."""
    return [f"{k}={tmp_path / v}" for k, v in (
        ("checkpoint_dir", "ck"), ("log_dir", "logs"),
        ("sample_dir", "samples"))]


STACKGAN_TINY = ["data.dataset_name=synthetic", "gan.gf_dim=8", "gan.df_dim=8",
                 "gan.z_dim=8", "gan.embed_dim=32", "gan.ca_dim=8",
                 "gan.res_blocks=1", "train.batch_size=4", "dtype=float32",
                 "train.summary_interval=1"]


@pytest.mark.parametrize("stage,res", [(1, 16), (2, 64)])
def test_stackgan_cli_writes_grids_and_trains(tmp_path, capsys, stage, res):
    """The shipped StackGAN configs at tiny widths (Stage-I at 16 px,
    Stage-II at 64 px over a 16 px Stage-I drawn from the seed): the three
    grids, then two ticks with finite losses and the KL term."""
    argv = ["--cfg", os.path.join(ROOT, "configs",
                                  f"stackgan_stage{stage}_flowers.yml"),
            "--device", "cpu"]
    sets = ["--set", *STACKGAN_TINY, f"data.image_size={res}",
            *_run_dirs(tmp_path), "stage1_checkpoint="]
    main.main(argv + sets)
    out = tmp_path / "samples" / f"stackgan_stage{stage}" / "synthetic"
    for name in ("eval_grid", "z_interp", "t_interp"):
        assert (out / f"{name}_init.png").exists(), name
    capsys.readouterr()
    main.main(argv + ["--train", "--steps", "2"] + sets)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step 2]")]
    assert len(lines) == 1, lines
    fields = dict(kv.split("=") for kv in lines[0].split()[2:])
    for k in ("d_loss", "g_loss", "g_fake", "kl", "images_per_sec"):
        assert np.isfinite(float(fields[k])), k


def test_stage2_takes_stage1_from_an_npz_and_refuses_a_directory(tmp_path,
                                                                 capsys):
    """``stage1_checkpoint``: an ``.npz`` is loaded into ``aux``; so is the
    latest checkpoint of a Stage-I run directory (its EMA weights), named
    by the option or found under ``<checkpoint_dir>/stackgan_stage1/
    <dataset>`` when the option names no directory (the shipped YAML's
    path before a Stage-I run), for training and for sampling; with no
    Stage-I run there it raises `FileNotFoundError`."""
    cfg = os.path.join(ROOT, "configs", "stackgan_stage2_flowers.yml")
    sets = ["--set", *STACKGAN_TINY, "data.image_size=32",
            *_run_dirs(tmp_path)]

    def stage2(*extra, train=True):
        flags = ["--train", "--steps", "1"] if train else []
        return main.main(["--cfg", cfg, "--device", "cpu", *flags, *sets,
                          *extra])

    for train in (False, True):
        with pytest.raises(FileNotFoundError, match="no Stage-I checkpoint"):
            stage2(train=train)
    # a Stage-I run with the EMA under checkpoint_dir; Stage-II finds it
    # there, or where stage1_checkpoint names it
    s1 = main.main(["--cfg", os.path.join(ROOT, "configs",
                                          "stackgan_stage1_flowers.yml"),
                    "--device", "cpu", "--train", "--steps", "2", "--set",
                    *STACKGAN_TINY, "data.image_size=8", "train.ema_decay=0.5",
                    *_run_dirs(tmp_path)])
    ema = dict(flatten(s1.ts.aux["ema_g_params"]))
    run1 = str(tmp_path / "ck" / "stackgan_stage1" / "synthetic")
    for extra in ([], [f"stage1_checkpoint={run1}",
                       f"checkpoint_dir={tmp_path / 'ck2'}"]):
        s2 = stage2(*extra)
        got = dict(flatten(s2.ts.aux["stage1_g_params"]))
        assert got.keys() == ema.keys()
        for k in got:
            assert torch.equal(got[k], ema[k]), k
    capsys.readouterr()
    stage2(f"stage1_checkpoint={run1}", f"checkpoint_dir={tmp_path / 'ck3'}",
           train=False)
    assert f"frozen Stage-I generator: {run1}" in capsys.readouterr().out

    gan = load_config(cfg, main.parse_overrides(STACKGAN_TINY)).gan
    params, state = jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(1), gan, 8))
    path = str(tmp_path / "stage1.npz")
    convert.save_npz(path, params, state)
    trainer = stage2(f"stage1_checkpoint={path}",
                     f"checkpoint_dir={tmp_path / 'ck4'}")
    np.testing.assert_array_equal(
        trainer.ts.aux["stage1_g_params"]["up0"]["conv"]["w"].numpy(),
        params["up0"]["conv"]["w"])
    assert convert.load_stage1_generator("", "cpu") is None


def test_unported_datasets_name_their_roadmap_item(tmp_path):
    """The StackGAN-format reader: a missing split raises
    `FileNotFoundError` naming the preprocessing step; a split written by
    the test loads (train and test)."""
    from tests.test_torch_data import write_split
    cfg = Config(data=DataConfig(data_dir=str(tmp_path / "flowers")),
                 gan=GanConfig(embed_dim=32))
    with pytest.raises(FileNotFoundError,
                       match="text_to_image_tpu_torch.data.preprocess"):
        get_dataset(cfg)
    write_split(tmp_path / "flowers", "train", n=10)
    write_split(tmp_path / "flowers", "test", n=4)
    assert get_dataset(cfg).num_examples == 10
    test = get_dataset(cfg, split="test")
    assert test.num_examples == 4 and test.test_embeddings(2).shape == (2, 32)


@pytest.mark.parametrize("cfg", ["gancls_flowers.yml", "gancls_birds.yml",
                                 "gancls_int_flowers.yml"])
def test_repo_configs_load(cfg):
    loaded = load_config(os.path.join(ROOT, "configs", cfg))
    assert loaded.model == "gancls" and loaded.gan.gf_dim == 128


@pytest.mark.parametrize("stage,res", [(1, 64), (2, 256)])
def test_stackgan_configs_load(stage, res):
    loaded = load_config(os.path.join(ROOT, "configs",
                                      f"stackgan_stage{stage}_flowers.yml"))
    assert loaded.model == f"stackgan_stage{stage}"
    assert (loaded.data.image_size, loaded.gan.gf_dim, loaded.gan.df_dim,
            loaded.gan.ca_dim, loaded.gan.res_blocks, loaded.train.g_steps,
            loaded.train.coeff.kl, loaded.dtype) == (
                res, 128, 64, 128, 2, 1, 2.0, "bfloat16")


def test_npz_round_trip(tmp_path):
    gan = tiny_config().gan
    params, state = gancls.generator_init(4, gan, 16)
    path = str(tmp_path / "g.npz")
    convert.save_npz(path, params, state)
    p2, s2 = convert.load_npz(path, "cpu")
    flat = convert._flatten(params, "p") | convert._flatten(state, "s")
    flat2 = convert._flatten(p2, "p") | convert._flatten(s2, "s")
    assert flat.keys() == flat2.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat2[k], err_msg=k)


@pytest.mark.parametrize("stage", [1, 2])
def test_stackgan_npz_round_trip_and_layer_names(tmp_path, stage):
    """StackGAN's nested trees (``ca/fc``, ``up<i>/conv|bn``,
    ``res<i>/conv1|bn1|conv2|bn2``) are accepted and survive the ``.npz``;
    a wrong name at either level is refused."""
    gan = tiny_config().gan
    init = (stackgan.stage1_generator_init if stage == 1
            else stackgan.stage2_generator_init)
    params, state = init(4, gan, 16)
    path = str(tmp_path / "g.npz")
    convert.save_npz(path, params, state)
    p2, s2 = convert.load_npz(path, "cpu")
    flat = convert._flatten(params, "p") | convert._flatten(state, "s")
    flat2 = convert._flatten(p2, "p") | convert._flatten(s2, "s")
    assert flat.keys() == flat2.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], flat2[k], err_msg=k)
    leaf = {"w": np.zeros(1)}
    with pytest.raises(ValueError, match="up0/conv9"):
        convert.from_jax_generator({"up0": {"conv9": leaf}}, {}, "cpu")
    with pytest.raises(ValueError, match="res0/conv"):
        convert.from_jax_generator({"res0": {"conv": leaf}}, {}, "cpu")
    with pytest.raises(ValueError, match="stem"):
        convert.from_jax_generator({"stem": {"fc": leaf}}, {}, "cpu")
    with pytest.raises(ValueError, match="gamma"):
        convert.from_jax_generator({"stem_bn": {"gamma": np.zeros(1)}}, {},
                                   "cpu")
    with pytest.raises(ValueError, match="res0"):
        convert.from_jax_discriminator({"res0": {"conv1": leaf}}, {}, "cpu")


def test_from_jax_generator_rejects_foreign_layers():
    """`down0` is a discriminator layer, not a generator one; a name that
    neither network has is refused by both."""
    with pytest.raises(ValueError, match="down0"):
        convert.from_jax_generator({"down0": {"w": np.zeros(1)}}, {}, "cpu")
    convert.from_jax_discriminator({"down0": {"w": np.zeros(1)}}, {}, "cpu")
    for fn in (convert.from_jax_generator, convert.from_jax_discriminator):
        with pytest.raises(ValueError, match="conv9"):
            fn({"conv9": {"w": np.zeros(1)}}, {}, "cpu")
    with pytest.raises(ValueError, match="up0"):
        convert.from_jax_discriminator({}, {"up0": {"mean": np.zeros(1)}},
                                       "cpu")


def test_init_is_a_function_of_the_key():
    gan = tiny_config().gan
    a, _ = gancls.generator_init(7, gan, 16)
    b, _ = gancls.generator_init(7, gan, 16)
    c, _ = gancls.generator_init(8, gan, 16)
    torch.testing.assert_close(a["up0"]["w"], b["up0"]["w"], rtol=0, atol=0)
    assert not torch.equal(a["up0"]["w"], c["up0"]["w"])
    assert abs(float(a["up0"]["w"].std()) - 0.02) < 0.002
    keys = prng.split_tree(7, ("embed", "stem"))
    assert keys == prng.split_tree(7, ("stem", "embed"))
    assert len(set(keys.values())) == 2
