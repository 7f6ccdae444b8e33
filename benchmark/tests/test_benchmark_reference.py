"""Each plain reference against the program on the same inputs, on the
CPU at tiny widths in f32, before any of it costs chip time: the
references' parameter trees are the program's, their ticks and grids give
the program's numbers, and the frozen copies of the program's draws (the
tick's noise, its batch, the class tables) give the program's draws."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.common import harness, inputs, program, traffic
from benchmark.reference import plain as P

BENCH = Path(__file__).resolve().parents[1]
CELLS = ["cpggan256.train"]


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _spec_shapes(spec):
    return {k: _spec_shapes(v) if isinstance(v, dict) else tuple(v[0])
            for k, v in spec.items()}


@pytest.mark.parametrize("name", ["cpggan_flowers_256"])
def test_parameter_trees_are_the_programs(name):
    """At the published widths: every leaf's name, order and shape."""
    from text_to_image_tpu_torch.models.registry import get_model
    conf = harness.load_json(BENCH / "configs" / f"{name}.json")
    ref = harness.load_module(BENCH / "reference" / f"{name}.py", name)
    spec = ref.param_spec(conf["config"])
    cfg = program.load_config(conf, 0)
    gp, gs, dp, ds = get_model(cfg).init(0, "cpu")
    assert _spec_shapes(spec["g"]) == _shapes(gp)
    assert _spec_shapes(spec["d"]) == _shapes(dp)
    assert _spec_shapes(spec["g_state"]) == _shapes(gs)
    assert _spec_shapes(spec["d_state"]) == _shapes(ds)
    assert list(P.flat(spec["g"])) and [n for n, _ in P.flat(spec["g"])] == \
        [n for n, _ in P.flat(gp)]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, tiny_checkout):
    """The program's checking ticks against the reference, both f32:
    every gap at rounding level."""
    run = harness.load_run(tiny_checkout, cell, 2**31 + 3, "cpu")
    drv = traffic.driver(run)
    drv.setup()
    drv.release()
    numbers = drv.check()
    assert numbers and all(v <= run.cell["limits"][k]
                           for k, v in numbers.items()), numbers


def test_generator_gradient_through_a_given_critic(tiny_checkout):
    """Through the critic that the reference's own first generator update
    found, the reference's generator gradient is the one that update
    took; through another critic it is not."""
    from benchmark.common import compare
    run = harness.load_run(tiny_checkout, "cpggan256.train", 2**31 + 4, "cpu")
    drv = traffic.driver(run)
    ref = drv.reference()
    own = drv.g_reference(ref["d_at_g"])
    assert max(compare.diff_gaps(own, ref["grad"]["g"]).values()) < 1e-5
    moved = {k: v * 1.01 for k, v in ref["d_at_g"].items()}
    other = drv.g_reference(moved)
    assert max(compare.diff_gaps(other, ref["grad"]["g"]).values()) > 1e-3


def test_nest_undoes_flat():
    tree = {"a": {"w": 1, "b": 2}, "c": {"d": {"e": 3}}, "f": 4}
    assert P.nest(dict(P.flat(tree))) == tree


def test_frozen_draws_are_the_programs(tiny_checkout):
    """The reference's copies of the tick's noise and batch draw, and of
    the wrong-pair tables, give what the program draws."""
    from text_to_image_tpu_torch.data import device as DD
    from text_to_image_tpu_torch.train.steps import draw_noise
    run = harness.load_run(tiny_checkout, "cpggan256.train", 99, "cpu")
    cfg = program.load_config(run.conf, 99)
    split = inputs.make_split(run.conf["split"], 99, "cpu")
    ids = split["class_ids"].numpy()
    for a, b in zip(P.class_tables(ids), DD.class_tables(ids)):
        np.testing.assert_array_equal(a, b)
    for step in (0, 13500, 2**40):
        ours = draw_noise(cfg, step, 4)
        ref = P.tick_noise(99, step, cfg.train.n_critic, 4, cfg.gan.z_dim,
                           (4, cfg.gan.ca_dim), critic=True)
        assert set(ours) == set(ref)
        for k in ours:
            torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
        data = program.device_data(split)
        ours = DD.sample_stacked(data, DD.batch_key(99, step), 2, 4, 16, 4,
                                 True, True)
        ref = P.tick_batch(split, 99, step, 2, 4, 16, 4, True, True)
        for k in ours:
            torch.testing.assert_close(ours[k], ref[k], rtol=1e-6, atol=1e-6)


def test_weights_repeat_from_the_seed():
    spec = {"a": {"w": ((3, 4), "normal:0.02"), "b": ((4,), "zeros")},
            "bn": {"scale": ((4,), "bn_scale"), "var": ((4,), "ones")}}
    a = inputs.make_tree(spec, 2**31 + 5, "x", "cpu")
    b = inputs.make_tree(spec, 2**31 + 5, "x", "cpu")
    c = inputs.make_tree(spec, 2**31 + 6, "x", "cpu")
    torch.testing.assert_close(a["a"]["w"], b["a"]["w"], rtol=0, atol=0)
    assert not torch.equal(a["a"]["w"], c["a"]["w"])
    assert float(a["a"]["w"].std()) < 0.05
    assert torch.equal(a["a"]["b"], torch.zeros(4))
    assert torch.equal(a["bn"]["var"], torch.ones(4))
    assert float((a["bn"]["scale"] - 1).abs().max()) < 0.2


def test_split_has_the_same_sizes_for_every_seed():
    shape = {"images": 50, "classes": 7, "source_px": 8, "captions": 3,
             "embed_dim": 5}
    counts = [np.bincount(inputs.class_ids(shape, s), minlength=7)
              for s in (1, 2**31 + 9)]
    np.testing.assert_array_equal(counts[0], counts[1])
    assert not np.array_equal(inputs.class_ids(shape, 1),
                              inputs.class_ids(shape, 2))
