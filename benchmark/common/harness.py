"""Finding a run's pieces by name, and the result line.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics; each piece lives in a file of its own, found by its name:

* ``benchmark/workloads/<cell>.json``: the cell's configuration and mix
  (as in ``BENCHMARK.json``), the mix's parameters for this cell
  (``params``) and the limits of the numbers that decide ``correct``
  (``limits``);
* the configuration's ``file`` (``benchmark/configs/<config>.json``) and
  its plain reference, ``benchmark/reference/<config>.py``;
* ``benchmark/traffic/<mix>.json``: the mix, data: the name of its
  driver and its parameters;
* ``benchmark/drivers/<driver>.py``: the code that runs a kind of traffic
  (``Driver``; see ``benchmark/common/traffic.py``);
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(run) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

BANNED = ("jax", "jaxlib", "flax", "text_to_image_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports: a
    metric with ``workloads`` where it lists the cell; an end-to-end one
    without, everywhere; a per-layer one without, wherever its ``moves``
    is reported."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in {e["name"] for e in e2e})]


def load_run(root: Path, cell: str, seed: int, device: str
             ) -> SimpleNamespace:
    """Everything a run of `cell` needs, read from the checkout at
    `root`."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    w = cells[cell]
    cfgs = {c["name"]: c for c in bench["configs"]}
    conf = load_json(root / cfgs[w["config"]]["file"])
    bdir = root / "benchmark"
    ref = load_module(bdir / "reference" / f"{w['config']}.py",
                      f"benchmark_reference_{w['config']}")
    return SimpleNamespace(
        root=root, bench=bench, entry=w,
        cell=load_json(bdir / "workloads" / f"{cell}.json"),
        conf=conf,
        traffic=load_json(bdir / "traffic" / f"{w['traffic']}.json"),
        reference=ref, seed=seed, device=device,
        e2e=cell_metrics(bench, cell, "end_to_end"),
        per_layer=cell_metrics(bench, cell, "per_layer"))


def read_metric(root: Path, metric: Dict, run) -> Optional[float]:
    mod = load_module(root / "benchmark" / "metrics" / f"{metric['name']}.py",
                      f"benchmark_metric_{metric['name'].replace('.', '_')}")
    return mod.read(run)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is one the run may not hold,
    compared whole (the port's own name begins with the JAX package's)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(BANNED))


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict], device: Dict,
                breakdown: Optional[Dict], checks: Dict[str, Dict]) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
