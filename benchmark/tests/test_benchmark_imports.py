"""What the benchmark's processes load.  A run may hold no module of JAX
or of the JAX package (``text_to_image_tpu``); the references and the
work arithmetic hold nothing of the program (``text_to_image_tpu_torch``)
either.  Names are compared by their top-level part, whole: the port's
name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
JAX = {"jax", "jaxlib", "flax", "text_to_image_tpu"}
PORT = "text_to_image_tpu_torch"

# modules a process imports, then prints its loaded top-level names
_PROBE = """
import json, sys
sys.path.insert(0, {repo!r})
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(body: str, cwd: Path = REPO) -> set:
    out = subprocess.run([sys.executable, "-c",
                          _PROBE.format(repo=str(REPO), body=body)],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & JAX
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_references_and_the_yardstick_import_nothing_of_the_program():
    for path in [*(BENCH / "reference").glob("*.py"),
                 BENCH / "common" / "work.py",
                 BENCH / "common" / "kernels.py"]:
        assert PORT not in _imports(path), path.relative_to(REPO)


@pytest.mark.parametrize("cell", ["cpggan256.train"])
def test_a_whole_run_loads_no_jax(cell, tiny_checkout):
    """A run at tiny widths on the CPU (the program's plain kernel
    versions), traced: every module it loaded, transitively."""
    root = tiny_checkout
    body = (f"import importlib.util\n"
            f"from pathlib import Path\n"
            f"spec = importlib.util.spec_from_file_location('r', "
            f"{str(BENCH / 'run.py')!r})\n"
            f"m = importlib.util.module_from_spec(spec)\n"
            f"spec.loader.exec_module(m)\n"
            f"rc = m.main(['--workload', {cell!r}, '--seed', '3', "
            f"'--seconds', '0.2', '--trace', '1'], root=Path({str(root)!r}), "
            f"device='cpu')\n"
            f"assert rc == 0, rc")
    loaded = _loaded(body, root)
    assert PORT in loaded
    assert not loaded & JAX, loaded & JAX


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "reference").glob("*.py")
    if p.stem not in ("__init__", "plain")))
def test_a_reference_alone_loads_nothing_of_the_program(name):
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    body = (f"import json\n"
            f"from benchmark.reference import {name} as R\n"
            f"R.param_spec(json.loads("
            f"{json.dumps(json.dumps(conf['config']))}))")
    loaded = _loaded(body)
    assert not loaded & (JAX | {PORT}), loaded & (JAX | {PORT})
