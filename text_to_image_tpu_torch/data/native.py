"""ctypes loader for the host-side C++ augmentation helpers of the input
pipeline (counterpart of ``text_to_image_tpu/data/native.py``, over the same
``csrc/augment.cpp``).

The library is built on first use with ``g++ -O3 -shared -fPIC`` into
``build/torch_native/libt2i_augment.so`` (git-ignored, beside the CUDA
kernels' ``build/torch_kernels``), never beside the source: the JAX
package's loader owns ``csrc/libt2i_augment.so``.  The build writes a
temporary file and renames it, so concurrent processes never load half a
library.  Every entry point has the JAX package's pure-numpy fallback, taken
when there is no compiler or the build fails; `available` says which path
runs.  These are host helpers of the host tier (``data/pipeline.py``), not
device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "csrc", "augment.cpp")
LIBRARY = os.path.join(_ROOT, "build", "torch_native", "libt2i_augment.so")


def _build_and_load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(SOURCE):
        return None
    try:
        if (not os.path.exists(LIBRARY)
                or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE)):
            os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
            tmp = f"{LIBRARY}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 SOURCE, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, LIBRARY)
        lib = ctypes.CDLL(LIBRARY)
        lib.crop_flip_normalize.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.crop_flip_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        lib.gather_average_embeddings.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        for fn in (lib.crop_flip_normalize, lib.crop_flip_u8,
                   lib.gather_average_embeddings):
            fn.restype = None
        return lib
    except (subprocess.CalledProcessError, OSError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def crop_flip_normalize(images: np.ndarray, idx: np.ndarray, size: int,
                        ys: np.ndarray, xs: np.ndarray, flips: np.ndarray,
                        num_threads: int = 0) -> np.ndarray:
    """Gather images[idx], crop (ys, xs, size), flip where flips, normalize
    uint8 → float32 [-1, 1].  Native when available, numpy otherwise."""
    n = len(idx)
    _, h, w, _ = images.shape
    lib = get_lib()
    if lib is not None and images.flags["C_CONTIGUOUS"]:
        out = np.empty((n, size, size, 3), np.float32)
        lib.crop_flip_normalize(
            _ptr(images), _ptr(np.ascontiguousarray(idx, np.int64)),
            n, h, w, size,
            _ptr(np.ascontiguousarray(ys, np.int32)),
            _ptr(np.ascontiguousarray(xs, np.int32)),
            _ptr(np.ascontiguousarray(flips, np.uint8)),
            _ptr(out), num_threads)
        return out
    # numpy fallback
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        patch = images[idx[i], ys[i]:ys[i] + size, xs[i]:xs[i] + size]
        if flips[i]:
            patch = patch[:, ::-1]
        out[i] = patch
    return out / 127.5 - 1.0


def crop_flip_u8(images: np.ndarray, idx: np.ndarray, size: int,
                 ys: np.ndarray, xs: np.ndarray, flips: np.ndarray,
                 num_threads: int = 0) -> np.ndarray:
    """Gather + crop + flip, staying uint8 (normalize on device — 4x smaller
    host→device payload)."""
    n = len(idx)
    _, h, w, _ = images.shape
    lib = get_lib()
    if lib is not None and images.flags["C_CONTIGUOUS"]:
        out = np.empty((n, size, size, 3), np.uint8)
        lib.crop_flip_u8(
            _ptr(images), _ptr(np.ascontiguousarray(idx, np.int64)),
            n, h, w, size,
            _ptr(np.ascontiguousarray(ys, np.int32)),
            _ptr(np.ascontiguousarray(xs, np.int32)),
            _ptr(np.ascontiguousarray(flips, np.uint8)),
            _ptr(out), num_threads)
        return out
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        patch = images[idx[i], ys[i]:ys[i] + size, xs[i]:xs[i] + size]
        out[i] = patch[:, ::-1] if flips[i] else patch
    return out


def gather_average_embeddings(emb: np.ndarray, idx: np.ndarray,
                              picks: np.ndarray) -> np.ndarray:
    """out[i] = mean_j emb[idx[i], picks[i, j], :].  emb [N, C, E] float32."""
    n, window = picks.shape
    num, caps, dim = emb.shape
    lib = get_lib()
    if lib is not None and emb.flags["C_CONTIGUOUS"] and emb.dtype == np.float32:
        out = np.empty((n, dim), np.float32)
        lib.gather_average_embeddings(
            _ptr(emb), num, caps, dim,
            _ptr(np.ascontiguousarray(idx, np.int64)),
            _ptr(np.ascontiguousarray(picks.reshape(-1), np.int64)),
            n, window, _ptr(out))
        return out
    rows = np.asarray(idx)[:, None]
    return emb[rows, picks].mean(axis=1)
