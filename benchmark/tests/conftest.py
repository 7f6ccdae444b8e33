"""Shared set-up of the benchmark's tests.

The marker ``chip`` is for tests that need a CUDA card; each decides
inside the test whether there is one and skips there (never while the
module is imported).  `tiny_checkout` copies the benchmark into a
temporary checkout whose configurations are cut to tiny widths, f32 and
a split of a few dozen examples, so that a whole run takes seconds on
the CPU with the program's plain kernel versions.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_SPLIT = {"images": 24, "classes": 3, "source_px": 20, "captions": 5,
              "embed_dim": 32}
TINY_LIMITS = {"grad": 1e-4, "g_grad": 1e-4, "g_grad_outlier": 1e-2,
               "change": 5e-2}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card (skips without one)")


def _tiny(conf: dict) -> dict:
    """A progressive GAN's configuration cut to stage 3 (16 px), widths
    of a few channels, batch 4, f32."""
    c = json.loads(json.dumps(conf))
    c["split"] = dict(TINY_SPLIT)
    cfg = c["config"]
    cfg["dtype"] = "float32"
    gan = {"gf_dim": 4, "z_dim": 8, "embed_dim": 32, "ca_dim": 4,
           "compressed_embed_dim": 8}
    cfg["gan"].update(gan)
    cfg["data"]["image_size"] = 16
    cfg["pggan"]["stage"] = 3
    c["start_step"] = 2 * 6000 + 1500
    cfg["train"]["batch_size"] = 4
    over = dict(c["overrides"])
    over.update({"dtype": "float32", "data.image_size": 16,
                 "train.batch_size": 4, "pggan.stage": 3})
    over.update({f"gan.{k}": v for k, v in gan.items()})
    c["overrides"] = over
    return c


def make_tiny_checkout(dest: Path) -> Path:
    """A checkout at `dest` holding BENCHMARK.json and benchmark/, the
    configurations cut to tiny sizes and the cells' limits set for f32
    against f32 (rounding, except that Adam moves a few weights by the
    sign of gradients near zero, which ``change`` reads)."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        f.write_text(json.dumps(_tiny(json.loads(f.read_text()))))
    for f in (dest / "benchmark" / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w["limits"] = dict(TINY_LIMITS)
        w.setdefault("params", {}).update({"profile_seconds": 0.1})
        f.write_text(json.dumps(w))
    return dest


@pytest.fixture
def tiny_checkout(tmp_path) -> Path:
    return make_tiny_checkout(tmp_path)
