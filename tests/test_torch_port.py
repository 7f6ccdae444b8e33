"""The port's package boundary and entry points on the CPU: it imports
neither JAX nor the JAX package, its CLI writes the three grids (from a
seed or from JAX weights), unported models and datasets name their ROADMAP
item, and weights survive the ``.npz`` round trip."""

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
from text_to_image_tpu_torch import convert, main
from text_to_image_tpu_torch.config import Config, load_config
from text_to_image_tpu_torch.data import get_dataset
from text_to_image_tpu_torch.models import gancls, registry
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
        import text_to_image_tpu_torch.ops.kernels._build
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


def test_cli_train_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main.main(["--cfg", _tiny_yaml(tmp_path), "--train"])


def test_cli_overrides_are_typed():
    assert main.parse_overrides(["a=true", "b=3", "c=x", "d=0.5"]) == {
        "a": True, "b": 3, "c": "x", "d": 0.5}


@pytest.mark.parametrize("model", ["wgancls", "stackgan_stage1",
                                   "stackgan_stage2", "pggan"])
def test_unported_models_name_their_roadmap_item(model):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_model(Config(model=model))


def test_unported_datasets_name_their_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_dataset(Config())


@pytest.mark.parametrize("cfg", ["gancls_flowers.yml", "gancls_birds.yml",
                                 "gancls_int_flowers.yml"])
def test_repo_configs_load(cfg):
    loaded = load_config(os.path.join(ROOT, "configs", cfg))
    assert loaded.model == "gancls" and loaded.gan.gf_dim == 128


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


def test_from_jax_generator_rejects_foreign_layers():
    with pytest.raises(ValueError, match="down0"):
        convert.from_jax_generator({"down0": {"w": np.zeros(1)}}, {}, "cpu")


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
