"""The harness end to end on the CPU at tiny widths (the program's plain
kernel versions): every cell's run and its result line, the refusal to run
without a card, the trace reader, and pieces added as files found by name
alone."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.common import harness, traffic
from benchmark.common.trace import Trace

REPO = Path(__file__).resolve().parents[2]
CELLS = ["cpggan256.train"]


def load_run_module():
    spec = importlib.util.spec_from_file_location(
        "benchmark_run_under_test", REPO / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_cell(root: Path, cell: str, trace: int, capsys, seed: int = 7,
             seconds: float = 0.3) -> dict:
    rc = load_run_module().main(
        ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], root=root, device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err[-3000:]
    last = out.out.strip().splitlines()[-1]
    return json.loads(last), out.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_prints_a_well_formed_line(cell, trace, tiny_checkout,
                                             capsys):
    line, err = run_cell(tiny_checkout, cell, trace, capsys, seed=2**31 + 11)
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    bench = json.loads((tiny_checkout / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    if trace == 0:
        assert set(line["metrics"]) == e2e
        for m in line["metrics"].values():
            assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    else:
        # a CPU run reads no device metric: every per-layer reader is
        # silent, and the line says how long the traced stretch was
        assert line["metrics"] == {}
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name}: " in err.strip().splitlines()[-len(
            line["checks"]):][list(line["checks"]).index(name)]


def test_same_seed_same_numbers(tiny_checkout, capsys):
    a, _ = run_cell(tiny_checkout, "cpggan256.train", 0, capsys, seed=5)
    b, _ = run_cell(tiny_checkout, "cpggan256.train", 0, capsys, seed=5)
    assert a["checks"] == b["checks"]


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result; the same in a directory that holds only BENCHMARK.json and the
    benchmark (the program missing)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd, script in ((REPO, REPO / "benchmark" / "run.py"),
                        (tmp_path, tmp_path / "benchmark" / "run.py")):
        out = subprocess.run(
            [sys.executable, str(script), "--workload", "cpggan256.train",
             "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert not out.stdout.strip()


def test_trace_reader_attributes_kernels_to_spans_and_gaps():
    """Spans on the host clock (ns) land on the trace's clock (µs) through
    the marker synchronisation; each kernel goes to the span of its
    launch."""
    host0 = 7_000_000_000            # the host clock when the marker ran
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": 0, "dur": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 5, "dur": 1, "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": 20, "dur": 1, "args": {"correlation": 2}},
          {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
           "ts": 30, "dur": 1, "args": {"correlation": 3}},
          {"ph": "X", "cat": "kernel", "name": "index_kernel", "ts": 8,
           "dur": 4, "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16",
           "ts": 22, "dur": 10, "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel",
           "name": "void (anonymous namespace)::upconv_kernel<64>",
           "ts": 62, "dur": 20, "args": {"correlation": 3}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> "
           "Pageable)", "ts": 90, "dur": 5, "args": {"correlation": 9}}]
    spans = [("data", host0, host0 + 10_000),
             ("tick", host0 + 10_000, host0 + 110_000)]
    t = Trace(ev, ("data", "tick"), spans, host0)
    assert t.counts == {"data": 1, "tick": 1}
    assert t.busy_s == pytest.approx(39e-6)
    assert t.window_s == pytest.approx(110e-6)
    assert t.span_s() == pytest.approx({"data": 4e-6, "tick": 30e-6,
                                        "none": 5e-6})
    fams = t.family_s()
    assert fams["matmul (cuBLAS)"] == pytest.approx(10e-6)
    assert fams["upconv3x3 (CUDA)"] == pytest.approx(20e-6)
    assert fams["memcpy DtoH"] == pytest.approx(5e-6)
    gaps = t.gaps()
    assert gaps[0] == ("tick", pytest.approx(30e-6))
    assert ("data", pytest.approx(8e-6)) in gaps
    assert len(t.breakdown()["device_ops"]) == 4


# a new kind of traffic: ticks back to back as ``closed_train`` runs
# them, the host reading each tick's losses before it issues the next (as
# a trainer that logs every step does)
SYNCED_DRIVER = """
from pathlib import Path

from benchmark.common import harness

_closed = harness.load_module(Path(__file__).with_name("closed_train.py"),
                              "benchmark_driver_closed_train")


class Driver(_closed.Driver):
    def one(self, spans=None):
        super().one(spans)
        float(self.m["d_loss"])
"""


def _add_pieces(root: Path) -> None:
    """A new configuration (a copy of C-PGGAN under another name, with
    its reference), a new traffic mix that brings its own driver, a new
    per-layer metric and a new cell: only new files and new entries."""
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "cpggan_flowers_256.json")
                      .read_text())
    conf["name"] = "cpggan_copy"
    (b / "configs" / "cpggan_copy.json").write_text(json.dumps(conf))
    shutil.copy(b / "reference" / "cpggan_flowers_256.py",
                b / "reference" / "cpggan_copy.py")
    (b / "drivers" / "synced_train.py").write_text(SYNCED_DRIVER)
    mix = json.loads((b / "traffic" / "resident_train.json").read_text())
    mix["driver"] = "synced_train"
    (b / "traffic" / "synced_ticks.json").write_text(json.dumps(mix))
    (b / "metrics" / "ticks_seen.synced.py").write_text(
        "def read(run):\n    return float(run.timing['count'])\n")
    cell = json.loads((b / "workloads" / "cpggan256.train.json").read_text())
    cell.update(config="cpggan_copy", traffic="synced_ticks")
    (b / "workloads" / "cpggan_copy.synced.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "cpggan_copy",
                             "file": "benchmark/configs/cpggan_copy.json"})
    bench["workloads"].append({"name": "cpggan_copy.synced",
                               "config": "cpggan_copy",
                               "traffic": "synced_ticks", "chips": 1,
                               "why": "ticks with the losses read each tick"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_images_per_s":
            m["workloads"].append("cpggan_copy.synced")
    bench["per_layer"].append({
        "name": "ticks_seen.synced", "unit": "ticks", "better": "higher",
        "source": "program_counter", "layer": "step",
        "moves": "train_images_per_s", "workloads": ["cpggan_copy.synced"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_new_pieces_are_found_by_name(tiny_checkout, capsys):
    before = {p: p.read_bytes() for p in (tiny_checkout / "benchmark")
              .rglob("*") if p.is_file()}
    _add_pieces(tiny_checkout)
    for p, data in before.items():
        assert p.read_bytes() == data      # no file that was there changed
    drv = traffic.driver(harness.load_run(tiny_checkout, "cpggan_copy.synced",
                                          7, "cpu"))
    assert type(drv).__module__ == "benchmark_driver_synced_train"
    line, _ = run_cell(tiny_checkout, "cpggan_copy.synced", 0, capsys)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_images_per_s", "setup_s"}
    line, _ = run_cell(tiny_checkout, "cpggan_copy.synced", 1, capsys)
    assert line["metrics"]["ticks_seen.synced"]["value"] >= 1


def test_a_mix_names_a_driver_that_exists(tiny_checkout):
    (tiny_checkout / "benchmark" / "traffic" / "resident_train.json"
     ).write_text(json.dumps({"driver": "no_such_driver"}))
    run = harness.load_run(tiny_checkout, "cpggan256.train", 7, "cpu")
    with pytest.raises(ValueError, match="no_such_driver"):
        traffic.driver(run)
