"""The port's package boundary and entry points on the CPU: it imports
neither JAX nor the JAX package, its CLI writes the three grids (from a
seed or from JAX weights) and trains, for GAN-CLS and both StackGAN stages,
unported models, datasets and checkpoints name their ROADMAP item, and
weights survive the ``.npz`` round trip."""

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
from text_to_image_tpu_torch.config import Config, load_config
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.models import gancls, registry, stackgan
from text_to_image_tpu_torch.utils import prng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None          # any `import jax` now fails
        import text_to_image_tpu_torch.main
        import text_to_image_tpu_torch.eval.sampler
        import text_to_image_tpu_torch.convert
        import text_to_image_tpu_torch.data
        import text_to_image_tpu_torch.utils.images
        import text_to_image_tpu_torch.models.registry
        import text_to_image_tpu_torch.models.stackgan
        import text_to_image_tpu_torch.ops.kernels.conv
        import text_to_image_tpu_torch.ops.kernels.fused
        import text_to_image_tpu_torch.ops.kernels._build
        import text_to_image_tpu_torch.models.losses
        import text_to_image_tpu_torch.train.optim
        import text_to_image_tpu_torch.train.state
        import text_to_image_tpu_torch.train.steps
        import text_to_image_tpu_torch.train.trainer
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
    """))
    return str(path)


@pytest.mark.parametrize("weights", [False, True])
def test_cli_writes_three_grids(tmp_path, weights):
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
    for name in ("eval_grid", "z_interp", "t_interp"):
        assert (out / f"{name}.png").exists() or \
            (out / f"{name}.png.npy").exists(), name


def test_cli_train_is_not_ported(tmp_path, capsys):
    """Training runs (``--train --steps 2 --device cpu`` prints finite
    metrics); what is not ported of it, checkpoints and sample grids, raises
    naming ROADMAP item 3 before the first step."""
    argv = ["--cfg", _tiny_yaml(tmp_path), "--train", "--device", "cpu"]
    main.main(argv + ["--steps", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step 2]")]
    assert len(lines) == 1, lines
    fields = dict(kv.split("=") for kv in lines[0].split()[2:])
    for k in ("d_loss", "d_real", "d_fake", "d_wrong", "g_loss",
              "images_per_sec"):
        assert np.isfinite(float(fields[k])), k
    for key in ("snapshot_interval", "sample_interval"):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 3"):
            main.main(argv + ["--steps", "2", "--set", f"train.{key}=2"])


def test_cli_overrides_are_typed():
    assert main.parse_overrides(["a=true", "b=3", "c=x", "d=0.5"]) == {
        "a": True, "b": 3, "c": "x", "d": 0.5}


@pytest.mark.parametrize("model,item", [("wgancls", "item 5"),
                                        ("pggan", "item 7")])
def test_unported_models_name_their_roadmap_item(model, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        registry.get_model(Config(model=model))


@pytest.mark.parametrize("model", ["gancls", "stackgan_stage1",
                                   "stackgan_stage2"])
def test_ported_models_have_a_bundle(model):
    bundle = registry.get_model(Config(model=model))
    assert bundle.name == model
    assert bundle.has_ca == bundle.name.startswith("stackgan")
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_model(Config(model="dcgan"))


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
            f"sample_dir={tmp_path / 'samples'}", "stage1_checkpoint="]
    main.main(argv + sets)
    out = tmp_path / "samples" / f"stackgan_stage{stage}" / "synthetic"
    for name in ("eval_grid", "z_interp", "t_interp"):
        assert (out / f"{name}.png").exists() or \
            (out / f"{name}.png.npy").exists(), name
    capsys.readouterr()
    main.main(argv + ["--train", "--steps", "2"] + sets)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[step 2]")]
    assert len(lines) == 1, lines
    fields = dict(kv.split("=") for kv in lines[0].split()[2:])
    for k in ("d_loss", "g_loss", "g_fake", "kl", "images_per_sec"):
        assert np.isfinite(float(fields[k])), k


def test_stage2_takes_stage1_from_an_npz_and_refuses_a_directory(tmp_path):
    """``stage1_checkpoint``: an ``.npz`` is loaded into ``aux``; the shipped
    YAML's checkpoint directory raises naming ROADMAP item 3, for sampling
    and for training."""
    cfg = os.path.join(ROOT, "configs", "stackgan_stage2_flowers.yml")
    sets = ["--set", *STACKGAN_TINY, "data.image_size=32",
            f"sample_dir={tmp_path / 'samples'}"]
    for extra in ([], ["--train", "--steps", "1"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.*item 3"):
            main.main(["--cfg", cfg, "--device", "cpu", *extra, *sets])
    gan = load_config(cfg, main.parse_overrides(STACKGAN_TINY)).gan
    params, state = jax.device_get(
        jstackgan.stage1_generator_init(jax.random.PRNGKey(1), gan, 8))
    path = str(tmp_path / "stage1.npz")
    convert.save_npz(path, params, state)
    trainer = main.main(["--cfg", cfg, "--device", "cpu", "--train", "--steps",
                         "1", *sets, f"stage1_checkpoint={path}"])
    np.testing.assert_array_equal(
        trainer.ts.aux["stage1_g_params"]["up0"]["conv"]["w"].numpy(),
        params["up0"]["conv"]["w"])
    assert convert.load_stage1_generator("", "cpu") is None


def test_unported_datasets_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_dataset(Config())


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
