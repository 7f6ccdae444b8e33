"""The program's spans and counters (``utils/profiling``): off without a
profiler (no record, no event), live under one over a tick of a tiny
C-PGGAN on the resident tier (every span of the tick with its parent and
tick, the up-block's kernel spans in their phases, the host waits
counted), the parent of a span opened on another thread, the cap, a wait
span's device end moved to the next boundary, the benchmark's host clock,
the Chrome trace's user annotations, and the one list of counters."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.common import trace as btrace
from text_to_image_tpu_torch.config import (Config, DataConfig, GanConfig,
                                            PgganConfig, TrainConfig)
from text_to_image_tpu_torch.data import device as DD
from text_to_image_tpu_torch.tools import dp_ticks
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_resident_step)
from text_to_image_tpu_torch.utils import profiling

N_CRITIC = 2
STEP = 10          # stage 3 of 4 steps a stage: mid-fade


def _cpggan():
    return Config(model="pggan",
                  gan=GanConfig(gf_dim=4, z_dim=8, embed_dim=32,
                                compressed_embed_dim=8, ca_dim=4),
                  train=TrainConfig(batch_size=4, n_critic=N_CRITIC,
                                    g_steps=1, ema_decay=0.9),
                  data=DataConfig(dataset_name="synthetic", image_size=16,
                                  caption_window=2),
                  pggan=PgganConfig(stage=3, steps_per_stage=4),
                  dtype="float32", seed=3)


def _data(n=12):
    rng = np.random.default_rng(0)
    perm, start, count = (torch.as_tensor(a) for a in
                          DD.class_tables(np.arange(n) % 3))
    return DD.DeviceData(
        images=torch.as_tensor(rng.integers(0, 255, (n, 20, 20, 3),
                                            dtype=np.uint8)),
        embeddings=torch.as_tensor(rng.normal(size=(n, 3, 32))
                                   .astype(np.float32)),
        class_perm=perm, other_start=start, other_count=count)


@pytest.fixture(scope="module")
def tick():
    """One resident tick of a tiny C-PGGAN at step `STEP`: ``run()``."""
    cfg = _cpggan()
    step, data = make_resident_step(cfg, 10, "cpu"), _data()

    def run():
        ts = init_train_state(0, cfg, 10, "cpu")
        ts.step = STEP
        return step(ts, data)
    return run


@pytest.fixture(autouse=True)
def _fresh():
    profiling.clear()
    yield
    profiling.clear()


def _live_tick(tick):
    with profile(activities=[ProfilerActivity.CPU]):
        tick()
    return profiling.spans()


def test_spans_off_record_nothing_and_make_no_event(tick, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span off touched the recorder")
    monkeypatch.setattr(profiling.Recorder, "_open", refuse)
    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("train.tick", step=1) is profiling._NULL
    assert profiling.span("kernels.x") is profiling.span("kernels.y")
    before = dict(profiling.RECORDER.counts)
    tick()
    assert profiling.spans() == [] and profiling.RECORDER.dropped == 0
    # the counters still count: plain integers
    waits = profiling.RECORDER.counts["train.host_waits"]
    assert waits == before.get("train.host_waits", 0) + 5


def test_a_live_tick_records_every_span_under_its_parent(tick):
    recs = _live_tick(tick)

    def parent(r):
        return None if r.parent is None else recs[r.parent].name

    names = [r.name for r in recs]
    assert {r.step for r in recs} == {STEP}
    assert all(r.device_ms is None for r in recs)    # no CUDA here
    want = {"data.draw": None, "train.tick": None,
            "train.noise": "train.tick", "train.d_step": "train.tick",
            "train.d_step.forward": "train.d_step",
            "train.gp": "train.d_step.forward",
            "train.d_step.backward": "train.d_step",
            "train.g_step": "train.tick",
            "train.g_step.forward": "train.g_step",
            "train.g_step.backward": "train.g_step",
            "train.ema": "train.tick"}
    for name, up in want.items():
        got = {parent(r) for r in recs if r.name == name}
        assert got == {up}, (name, got)
    assert {parent(r) for r in recs if r.name == "train.adam"} == {
        "train.d_step", "train.g_step"}
    assert names.count("train.d_step") == N_CRITIC
    assert names.count("train.g_step") == 1 and names.count("train.tick") == 1
    assert names.index("data.draw") < names.index("train.tick")
    # the up-block: forward in both steps' forwards (G's under no_grad in
    # the D step), dx and dw inside the G step's backward
    ups = {parent(r) for r in recs if r.name == "kernels.upconv3x3"}
    assert ups == {"train.d_step.forward", "train.g_step.forward"}
    for name in ("kernels.upconv3x3_dx", "kernels.upconv3x3_dw"):
        assert {parent(r) for r in recs if r.name == name} == {
            "train.g_step.backward"}
    # the host waits: the D steps' z, CA ε and GP ε, the G step's z and ε
    waits = [r for r in recs if r.wait]
    assert [r.name for r in waits] == ["train.noise"] * 2
    assert [r.counts for r in waits] == [{"train.host_waits": 3},
                                         {"train.host_waits": 2}]
    for r in recs:
        if r.parent is not None:
            up = recs[r.parent]
            assert up.t0_ns <= r.t0_ns <= r.t1_ns <= up.t1_ns, r.name


def test_a_span_on_another_thread_takes_the_callers_innermost():
    """Autograd runs a CUDA backward on its device thread: a span opened
    there, with none open on its own thread, nests in the span of the
    thread that called backward, and takes its tick."""
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.g_step.backward", step=7):
            def device_thread():
                with profiling.span("kernels.upconv3x3_dx"):
                    with profiling.span("kernels.inner"):
                        pass
                got.append(True)
            t = threading.Thread(target=device_thread)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    recs = profiling.spans()
    assert got == [True]
    by = {r.name: r for r in recs}
    dx, inner = by["kernels.upconv3x3_dx"], by["kernels.inner"]
    assert recs[dx.parent].name == "train.g_step.backward"
    assert recs[inner.parent].name == "kernels.upconv3x3_dx"
    assert dx.step == inner.step == 7
    assert dx.thread == inner.thread != by["train.g_step.backward"].thread


def test_spans_past_the_cap_are_dropped_and_counted(monkeypatch):
    rec = profiling.Recorder(cap=2)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with profiling.span(f"s{i}"):
                profiling.count("c")
    assert [r.name for r in rec.spans()] == ["s0", "s1"]
    assert rec.dropped == 3 and rec.counts["c"] == 5
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


class _Event:
    """A stand-in timing event: its time is the order it was recorded."""
    clock = 0

    def __init__(self, enable_timing=True):
        self.at = None

    def record(self, stream):
        assert stream == "stream"
        _Event.clock += 1
        self.at = _Event.clock

    def elapsed_time(self, end):
        return float(end.at - self.at)


def test_a_wait_span_runs_on_to_the_next_boundary(monkeypatch):
    """Device times are event distances; a wait span's end event is taken
    again at the next span boundary (the host's next enqueue), and a wait
    that no boundary follows ends at its own exit."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    _Event.clock = 0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.tick"):                    # event 1
            with profiling.span("train.noise", wait=True):    # 2
                pass                                          # 3, then 4
            with profiling.span("train.d_step"):              # 5
                pass                                          # 6
            with profiling.span("train.noise", wait=True):    # 7
                pass                                          # 8
        # tick's end: 9 (the wait's moved end) and 10
    by = [(r.name, r.device_ms) for r in rec.spans()]
    assert by == [("train.tick", 9.0), ("train.noise", 2.0),
                  ("train.d_step", 1.0), ("train.noise", 2.0)]
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.noise", wait=True):
            pass
    assert rec.spans()[-1].device_ms == 1.0
    assert rec._pool                    # read events go back to the pool


def test_program_spans_nest_in_the_benchmarks_on_one_clock():
    outer = btrace.Spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with outer("tick"):
            with profiling.span("train.tick", step=0):
                torch.ones(64).cumsum(0)
    ((name, t0, t1),) = outer.items
    (r,) = profiling.spans()
    assert t0 <= r.t0_ns <= r.t1_ns <= t1
    assert r[:3] == (r.name, r.t0_ns, r.t1_ns)      # what Trace takes


def test_the_chrome_trace_holds_each_span_as_a_user_annotation(tick,
                                                              tmp_path):
    with profiling.trace(str(tmp_path)):
        tick()
    names = {r.name for r in profiling.spans()}
    (path,) = os.listdir(tmp_path)
    raw = json.loads((tmp_path / path).read_text())
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    annotated = {e["name"] for e in events
                 if e.get("cat") == "user_annotation"}
    assert "train.tick" in names and names <= annotated


def test_one_list_of_counters(tick):
    before = dp_ticks.counters()
    assert before == profiling.counters()
    assert {"upconv3x3", "upconv3x3_dx", "upconv3x3_dw", "bn_stats",
            "bn_partials", "bn_finish", "conditioning_join",
            "deconv5x5_s2_dx"} <= set(before)
    assert all("." not in k for k in before if k != "train.host_waits")
    tick()
    since = dp_ticks.counted_since(before)
    assert since["train.host_waits"] == 5
    assert all(v == 0 for k, v in since.items() if "." not in k)   # CPU
