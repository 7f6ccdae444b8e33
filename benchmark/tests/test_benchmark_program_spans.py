"""The per-layer metrics read from the program's own spans and counters
(``common/program_spans.py``): silent without a card, without a trace,
with no spans and with a program that records none; the right numbers a
tick from a hand-made recorder; and, on the CPU, a traced run of the tiny
checkout records the program's spans inside the benchmark's profiled
stretch and still prints its line."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark.common import harness, work
from benchmark.tests.test_benchmark_harness import run_cell
from text_to_image_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]
NEW = ("data_draw_ms.train", "d_step_ms.train", "d_backward_ms.train",
       "g_step_ms.train", "optim_ms.train", "sync_gap_ms.train",
       "host_waits.train", "upconv3x3_span_roofline.train")


def _reader(name):
    return harness.load_module(REPO / "benchmark" / "metrics" / f"{name}.py",
                               "t_" + name.replace(".", "_")).read


def _conf():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (c,) = [c for c in bench["configs"] if c["name"] == "cpggan_flowers_256"]
    return json.loads((REPO / c["file"]).read_text())


def _run(device="cuda", trace=True):
    return SimpleNamespace(device=device, trace=object() if trace else None,
                           conf=_conf(), timing={"unit": "tick"})


def _recorder():
    """Two ticks: each a draw (0.5 ms), then the tick (600) holding two
    waits (0.25, 0.5; 3 and 2 host waits), two D steps (240, each with a
    backward of 150 and Adam 0.5), a G step (110: Adam 0.75, the up-block
    20 + 5 + 5 with a wrapper nested in the forward's) and the EMA (0.25)."""
    recs = []

    def add(name, ms, parent=None, wait=False, counts=None):
        recs.append(profiling.SpanRecord(name, len(recs), len(recs) + 1, 0,
                                         parent, 1, ms, wait, counts or {}))
        return len(recs) - 1

    for _ in range(2):
        add("data.draw", 0.5)
        t = add("train.tick", 600.0)
        add("train.noise", 0.25, t, True, {"train.host_waits": 3})
        for _ in range(2):
            d = add("train.d_step", 240.0, t)
            add("train.d_step.backward", 150.0, d)
            add("train.adam", 0.5, d)
        add("train.noise", 0.5, t, True, {"train.host_waits": 2})
        g = add("train.g_step", 110.0, t)
        f = add("train.g_step.forward", 40.0, g)
        up = add("kernels.upconv3x3", 20.0, f)
        add("kernels.upconv3x3", 1.0, up)        # nested: not counted again
        b = add("train.g_step.backward", 60.0, g)
        add("kernels.upconv3x3_dx", 5.0, b)
        add("kernels.upconv3x3_dw", 5.0, b)
        add("train.adam", 0.75, g)
        add("train.ema", 0.25, t)
    return recs


@pytest.mark.parametrize("name", NEW)
def test_new_readers_are_silent_without_something_to_read(name,
                                                          monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling, "spans", _recorder)
    assert read(_run(device="cpu")) is None
    assert read(_run(trace=False)) is None
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(_run()) is None
    monkeypatch.delattr(profiling, "spans")     # a program without spans
    assert read(_run()) is None


def test_new_readers_read_a_hand_made_recorder(monkeypatch):
    monkeypatch.setattr(profiling, "spans", _recorder)
    got = {name: _reader(name)(_run()) for name in NEW}
    least_ms = 1e3 * work.family_least_s(_conf(), "tick", "upconv3x3")
    want = {"data_draw_ms.train": 0.5, "d_step_ms.train": 480.0,
            "d_backward_ms.train": 300.0, "g_step_ms.train": 110.0,
            "optim_ms.train": 0.5 * 2 + 0.75 + 0.25,
            "sync_gap_ms.train": 0.75, "host_waits.train": 5.0,
            "upconv3x3_span_roofline.train": 100.0 * least_ms / 30.0}
    assert got == pytest.approx(want, rel=1e-12)


def test_a_device_time_left_unread_reads_nothing(monkeypatch):
    recs = _recorder()
    recs[0] = recs[0]._replace(device_ms=None)
    monkeypatch.setattr(profiling, "spans", lambda: recs)
    assert _reader("data_draw_ms.train")(_run()) is None
    assert _reader("d_step_ms.train")(_run()) == 480.0


def test_a_traced_tiny_run_records_the_programs_spans(tiny_checkout,
                                                      capsys):
    """The benchmark's profiled stretch turns the program's spans on (CPU
    activity here): one ``data.draw`` and one ``train.tick`` a tick, the
    host waits counted in them; the line is printed as before, and on a
    card the readers would find them (no device times on the CPU)."""
    profiling.clear()
    line, _ = run_cell(tiny_checkout, "cpggan256.train", 1, capsys,
                       seed=2**31 + 5)
    assert line["correct"] is True and line["metrics"] == {}
    recs = profiling.spans()
    profiling.clear()
    ticks = [r for r in recs if r.name == "train.tick"]
    assert len(ticks) >= 2
    assert sum(r.name == "data.draw" for r in recs) == len(ticks)
    assert sum(r.counts.get("train.host_waits", 0) for r in recs) == \
        5 * len(ticks)
