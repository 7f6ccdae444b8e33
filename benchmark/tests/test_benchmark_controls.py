"""The check that decides ``correct`` has to fail what it exists to catch.

On the CPU at tiny widths a whole run is driven with the timed path broken
underneath it, and ``correct`` has to come out false, once for each fault
a cell can have: a step that returns its state unchanged; half of the
batch left out, the mean taken over the rest; and each fault of the
generator's backward alone that ``benchmark/calibrate.py`` plants (the
up-block's weight gradient permuted, or scaled).  (Every cell runs on one
card: there is no exchange between chips to leave out.)

On a card (marker ``chip``), at the cell's own size and on three seeds:
the control, the plain reference computed in float8 in the program's
place, and each planted fault have to fail one of the cell's committed
limits on every seed, and the program has to pass them all.  Run there
with ``python -m pytest benchmark/tests -m chip``.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark.tests.test_benchmark_harness import run_cell

REPO = Path(__file__).resolve().parents[2]


def _adam_does_nothing(monkeypatch):
    from text_to_image_tpu_torch.train import optim

    def update(self, grads):
        self.count += 1

    monkeypatch.setattr(optim.Adam, "update", update)


def _half_the_batch(monkeypatch):
    """Each tick gathers its batch and keeps the first half of its rows:
    every mean of the tick is taken over the rest."""
    from text_to_image_tpu_torch.data import device as DD
    full = DD.sample_stacked

    def half(*args, **kwargs):
        out = full(*args, **kwargs)
        return {k: v[:, :v.shape[1] // 2] for k, v in out.items()}

    monkeypatch.setattr(DD, "sample_stacked", half)


def _planted(name):
    def plant(monkeypatch):
        from benchmark.calibrate import PLANTED
        monkeypatch.setattr(*PLANTED[name]())
    plant.__name__ = name
    return plant


# (cell, fault, the number that has to read over its limit: None, any)
FAULTS = [("cpggan256.train", _adam_does_nothing, None),
          ("cpggan256.train", _half_the_batch, None),
          ("cpggan256.train", _planted("upconv_dw_flipped"), "g_grad"),
          ("cpggan256.train", _planted("upconv_dw_scaled"), "g_grad")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault, number,
                                            tiny_checkout, capsys,
                                            monkeypatch):
    fault(monkeypatch)
    line, _ = run_cell(tiny_checkout, cell, 0, capsys, seed=2**31 + 21)
    checks = line["checks"]
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in checks.values())
    if number is not None:
        assert checks[number]["value"] > checks[number]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["cpggan256.train"])
def test_the_control_fails_the_committed_limits(cell, card):
    from benchmark.calibrate import PLANTED, readings
    limits = json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    seeds = [2**31 + 101, 2**31 + 102, 2**31 + 103]
    r = readings(cell, seeds, seeds, seeds)
    for seed in seeds:
        assert all(v <= limits[k] for k, v in r["program"][seed].items())
        for side in ("control", *PLANTED):
            assert any(v > limits[k] for k, v in r[side][seed].items())
