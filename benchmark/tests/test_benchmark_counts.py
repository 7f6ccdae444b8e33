"""The benchmark's work arithmetic (`benchmark/common/work.py`): the frozen
tap counts against the program's kernel microbench, the layer tables
against the plain references' own products, and the bounds that keep a
roofline at or under 100 %."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.common import readers, work
from benchmark.common.trace import Trace
from benchmark.reference import cpggan_flowers_256 as CP
from benchmark.reference import plain as P
from text_to_image_tpu_torch.tools import bench_kernels as BK

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def conf(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8, 16, 63, 64, 128, 255, 256])
def test_frozen_taps_match_the_microbench(n):
    assert work.s2_taps(n) == BK.s2_taps(n)
    assert work.up_taps(n) == BK.up_taps(n)
    assert work.taps(n, 5, 2) == work.s2_taps(n)
    assert work.s2_ops(3, n, n, 64, 32) == BK.s2_ops(3, n, n, 64, 32)


@pytest.mark.parametrize("shape,co", [((32, 128, 128, 64), 32),
                                     ((64, 128, 128, 64), 64),
                                     ((64, 16, 16, 512), 256),
                                     ((64, 4, 4, 1024), 512)])
def test_upconv_work_matches_the_microbench(shape, co):
    """The up-block's bytes and operations of a forward, dx and dw at the
    shapes the microbench reports (the 128²×64→32 call of C-PGGAN 256 px
    first), and the bound run 19o printed for it (0.0601 ms, bytes)."""
    b, n, _, cin = shape
    layer = {"op": "upconv3x3", "hw": n, "cin": cin, "cout": co}
    for kind, ref in (("fwd", BK.upconv_work), ("dx", BK.upconv_dx_work),
                      ("dw", BK.upconv_dw_work)):
        nbytes, flops = ref(shape, co)
        assert work._upconv_bytes(kind, b, n, cin, co) == nbytes
        assert work.layer_flops(layer, b) == flops
    if shape == (32, 128, 128, 64):
        ms = 1e3 * work.bound_s(*BK.upconv_work(shape, co))
        assert round(ms, 4) == 0.0601


@pytest.mark.parametrize("shape,co", [((192, 256, 256, 3), 64),
                                     ((192, 128, 128, 64), 128),
                                     ((64, 8, 8, 512), 512),
                                     ((64, 5, 7, 3), 64)])
def test_conv5x5_work_matches_the_microbench(shape, co):
    b, n, w, cin = shape
    if n != w:
        assert work.s2_ops(b, n, w, cin, co) == BK.conv_work(shape, co)[1]
        return
    layer = {"op": "conv5x5_s2", "hw": n, "cin": cin, "cout": co}
    for kind, ref in (("fwd", BK.conv_work), ("dx", BK.conv_dx_work),
                      ("dw", BK.conv_dw_work)):
        nbytes, flops = ref(shape, co)
        assert work._conv5_bytes(kind, b, n, cin, co) == nbytes
        assert work.layer_flops(layer, b) == flops


def _count(fn, *args):
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def _meta_tree(spec):
    return {k: _meta_tree(v) if isinstance(v, dict)
            else torch.zeros(v[0], device="meta") for k, v in spec.items()}


def test_layer_tables_match_the_references_products():
    """Each network's table, counted densely (every tap, the up-block as
    a 3×3 conv over the ×2 map), equals what a FLOP counter reads from the
    plain reference's forward at the published widths, batch 2, on the
    meta device: the tables have the models' shapes."""
    q, b = P.Precision("f32"), 2
    meta = lambda *s: torch.zeros(*s, device="meta")  # noqa: E731
    c = conf("cpggan_flowers_256")
    cc = c["config"]
    spec = _meta_tree(CP.param_spec(cc))
    g_ops = _count(CP.generator, spec["g"], meta(b, 100), meta(b, 1024),
                   meta(b, 128), 7, 0.5, q)
    d_ops = _count(CP.critic, spec["d"], meta(b, 3, 256, 256), meta(b, 1024),
                   7, 0.5, 1, q)
    # the generator's unused toRGB of stages 1-5 run in its forward
    waste = sum(2 * b * (4 * 2**(s - 1))**2 * CP.stage_channels(s, 128) * 3
                for s in range(1, 6))
    assert g_ops == work.net_dense_flops(c["layers"]["G"], b) + waste
    assert d_ops == work.net_dense_flops(c["layers"]["D"], b)


# a table of the 5×5 stride-2 family's layers (no configuration of the
# benchmark has them yet): a critic's first two layers, forward and
# backward
CONV5 = {"layers": {"D": [{"op": "conv5x5_s2", "hw": 64, "cin": 3,
                           "cout": 64, "input": "image"},
                          {"op": "conv5x5_s2", "hw": 32, "cin": 64,
                           "cout": 128}]},
         "tick": [{"net": "D", "batch": 64, "fwd": 1, "dx": 1, "dw": 1}]}


@pytest.mark.parametrize("c", [conf("cpggan_flowers_256"), CONV5],
                         ids=["cpggan_flowers_256", "conv5x5_s2"])
def test_in_map_work_never_exceeds_the_dense_work(c):
    for layers in c["layers"].values():
        for layer in layers:
            assert 0 < work.layer_flops(layer, 4) <= work.dense_flops(layer, 4)


def _trace_at(seconds_by_family: dict, units: int) -> Trace:
    """A trace of `units` ticks whose kernels of each family took the
    given device seconds."""
    names = {"upconv3x3 (CUDA)": "t2i_namespace)::upconv_kernel",
             "upconv3x3 backward (CUDA)": "t2i_namespace)::dx_ring",
             "conv5x5_s2_act (CUDA)": "t2i_namespace)::conv_kernel"}
    ev, t, spans = [], 0.0, []
    for i in range(units):
        spans.append(("tick", int(t * 1e3), int((t + 1e6) * 1e3)))
        for fam, s in seconds_by_family.items():
            dur = s * 1e6 / units
            ev.append({"ph": "X", "cat": "kernel", "name": names[fam],
                       "ts": t + 1, "dur": dur, "args": {"correlation": i}})
            t += dur + 1
        t += 1e6
    return Trace(ev, ("tick",), spans, 0)


@pytest.mark.parametrize("c,op", [(conf("cpggan_flowers_256"), "upconv3x3"),
                                 (CONV5, "conv5x5_s2")],
                         ids=["cpggan_flowers_256", "conv5x5_s2"])
def test_a_family_at_its_least_time_reads_100_and_no_more(c, op):
    """Every call bounded by the larger of its bytes and its products:
    kernels that take exactly the least time read 100 %, slower ones
    less."""
    least = work.family_least_s(c, "tick", op)
    for kind, b, layer in work.family_calls(c, "tick", op):
        size = (work._upconv_bytes if op == "upconv3x3"
                else work._conv5_bytes)(kind, b, layer["hw"], layer["cin"],
                                        layer["cout"])
        flops = work.layer_flops(layer, b)
        assert work.bound_s(size, flops) >= max(size / work.PEAK_BYTES,
                                                flops / work.PEAK_FLOPS)
    fam = {"upconv3x3": "upconv3x3 (CUDA)",
           "conv5x5_s2": "conv5x5_s2_act (CUDA)"}[op]
    for factor, want in ((1.0, 100.0), (2.0, 50.0)):
        run = SimpleNamespace(device="cuda", conf=c,
                              trace=_trace_at({fam: 3 * least * factor}, 3),
                              timing={"unit": "tick", "count": 3,
                                      "seconds": 1.0})
        assert readers.roofline(run, op) == pytest.approx(want)


def test_calls_a_tick_as_the_smoke_run_counts_them():
    """The layer table gives the launches a tick that chip_smoke counts:
    C-PGGAN stage 7 upconv / dx / dw 18 / 6 / 6."""
    def kinds(name, op):
        calls = work.family_calls(conf(name), "tick", op)
        return [sum(1 for k, _, _ in calls if k == kind)
                for kind in ("fwd", "dx", "dw")]
    assert kinds("cpggan_flowers_256", "upconv3x3") == [18, 6, 6]
