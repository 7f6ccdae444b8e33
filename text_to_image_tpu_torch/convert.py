"""Carry generator weights between the JAX package and the port.

The port keeps the JAX package's layouts (linear ``[in, out]``, conv HWIO,
BN ``scale``/``bias``/``mean``/``var``) and its tree of names, so converting
is a tree map from numpy to torch plus a check of the names.  An ``.npz``
holds one generator as ``params/<layer>/<leaf>`` and ``state/<layer>/<leaf>``
keys; from the JAX package it is written with

    save_npz("g.npz", *jax.device_get((ts.g_params, ts.g_state)))

and ``python -m text_to_image_tpu_torch.main --weights g.npz`` serves it.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^(embed|stem|stem_bn|out|up\d+|up\d+_bn)$")


def _to_torch(tree: Dict, device) -> Dict:
    return {k: (_to_torch(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)).to(device))
            for k, v in tree.items()}


def from_jax_generator(params: Dict, state: Dict, device="cuda"
                       ) -> Tuple[Dict, Dict]:
    """JAX generator (params, state) as nested dicts of numpy arrays, as
    ``jax.device_get`` returns them, → the port's (params, state): f32
    tensors on `device`.  Raises on a layer name the GAN-CLS generator does
    not have."""
    for name in (*params, *state):
        if not _LAYER.match(name):
            raise ValueError(f"not a GAN-CLS generator layer: {name!r}")
    return _to_torch(params, device), _to_torch(state, device)


def _flatten(tree: Dict, prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().float().cpu().numpy()
        else:
            out[key] = np.asarray(v, np.float32)
    return out


def save_npz(path: str, params: Dict, state: Dict) -> None:
    """Write (params, state), numpy or torch leaves, with ``/``-joined keys."""
    np.savez(path, **_flatten(params, "params"), **_flatten(state, "state"))


def load_npz(path: str, device="cuda") -> Tuple[Dict, Dict]:
    """Read a `save_npz` file → the port's (params, state) on `device`."""
    trees: Dict[str, Dict] = {"params": {}, "state": {}}
    with np.load(path) as f:
        for key in f.files:
            root, *mid, leaf = key.split("/")
            if root not in trees or not mid:
                raise ValueError(f"unexpected key {key!r} in {path}")
            node = trees[root]
            for part in mid:
                node = node.setdefault(part, {})
            node[leaf] = f[key]
    return from_jax_generator(trees["params"], trees["state"], device)
