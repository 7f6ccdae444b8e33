"""Build the package's CUDA C++ kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC``, into ``build/torch_kernels/lib<name>.so`` beside the package.  No
PyTorch header is included, so a build takes seconds.  Sources are built at
first use, once per process; `build` starts one ``nvcc`` per source, all
together.  A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_PTXAS: Dict[str, str] = {}   # name → the compiler's register/smem report
_LOCK = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are compiled at first use")


def build(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile and load ``csrc/<name>.cu`` for each name not yet loaded in
    this process (one nvcc each, run in parallel); returns every library."""
    names = list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            compiler = nvcc()
            procs = {}
            for n in todo:
                src = CSRC / f"{n}.cu"
                if not src.is_file():
                    raise FileNotFoundError(src)
                tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.so"
                procs[n] = (tmp, subprocess.Popen(
                    [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{n}.cu (rc {proc.returncode}):\n{out}")
                    continue
                _PTXAS[n] = out
                final = BUILD_DIR / f"lib{n}.so"
                os.replace(tmp, final)
                _LIBS[n] = ctypes.CDLL(str(final))
            if failed:
                raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return {n: _LIBS[n] for n in names}


def library(name: str) -> ctypes.CDLL:
    return build([name])[name]


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` printed for this source (registers, spills,
    shared memory per kernel); empty until it is built."""
    return _PTXAS.get(name, "")


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))
