"""The JAX package's ``scripts/`` on the port: the user journeys that show
the models learn (convergence, the StackGAN chain, the C-PGGAN progression,
the Stage-II dynamics A/B), the step trace, the per-stage serving profile,
the end-to-end demo, the parity runbook and the InceptionV3 converter.

Each module is run as ``python -m text_to_image_tpu_torch.scripts.<name>``
with the JAX script's arguments, plus ``--device cpu`` (or
``--device=cpu``) to run on the CPU, where every kernel is its plain
version; the default is the card.  Importing a module runs nothing: the work
is in its ``main()``, which returns the exit code.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Tuple

# the directory that holds the package: what ``python -m`` needs on its path
PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def split_device(argv: List[str], default: str = "cuda"
                 ) -> Tuple[str, List[str]]:
    """(device, the other arguments) from ``--device X`` or ``--device=X``
    anywhere in `argv`."""
    device, rest, it = default, [], iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value (cuda, cpu, …)")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return device, rest


def run_module(module: str, *args: str) -> str:
    """``python -m <module> <args>`` in a process of its own (the package
    on its path), its output printed; returns what it printed to stdout.
    Raises `RuntimeError` with the end of its output when it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    print(f"$ python -m {module} {' '.join(args)}", flush=True)
    proc = subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"python -m {module} exited {proc.returncode}:\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout
