"""Carry weights and train states between the JAX package and the port.

The port keeps the JAX package's layouts (linear ``[in, out]``, conv HWIO,
BN ``scale``/``bias``/``mean``/``var``) and its tree of names, so converting
is a tree map from numpy to torch plus a check of the names.  An ``.npz``
holds one generator (GAN-CLS / WGAN-CLS, StackGAN Stage-I or Stage-II,
C-PGGAN) as
``params/<layer>/…/<leaf>`` and ``state/<layer>/…/<leaf>`` keys (StackGAN's
up-blocks and residual blocks nest ``conv``/``bn`` one level down); from the
JAX package it is written with

    save_npz("g.npz", *jax.device_get((ts.g_params, ts.g_state)))

and ``python -m text_to_image_tpu_torch.main --weights g.npz`` serves it; a
Stage-I ``.npz`` or Stage-I run directory named by ``cfg.stage1_checkpoint``
gives the frozen generator inside Stage-II (`load_stage1_generator`).

`from_jax_train_state` carries a whole JAX ``TrainState`` (as
``jax.device_get`` returns it): both networks, both BN states, the step,
``aux['ema_g_params']``, Stage-II's ``aux['stage1_g_params' |
'stage1_g_state']`` and each ``optax.adam`` state's update count and
moments, so the port computes the same next tick.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# a layer holds leaves; StackGAN's CA, up-blocks and residual blocks hold a
# second level of layers instead
_LEAVES = {"w", "b", "scale", "bias", "mean", "var"}
_G_LAYER = re.compile(            # GAN-CLS; StackGAN I and II; C-PGGAN
    r"^(embed|stem|stem_bn|stem_conv|out|ca|rgb\d+|up\d+|up\d+[ab]|up\d+_bn"
    r"|enc\d+|enc\d+_bn|join|join_bn)$")
_G_NESTED = {re.compile(r"^ca$"): {"fc"},
             re.compile(r"^up\d+$"): {"conv", "bn"},
             re.compile(r"^res\d+$"): {"conv1", "bn1", "conv2", "bn2"}}
_D_LAYER = re.compile(           # batch- and layer-norm D; C-PGGAN's critic
    r"^(down\d+|down\d+_bn|down\d+_ln|down\d+[ab]|from\d+|embed|join"
    r"|join_bn|join_ln|conv4|dense|logit)$")


def _to_torch(tree: Dict, device) -> Dict:
    return {k: (_to_torch(v, device) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32)).to(device))
            for k, v in tree.items()}


def _check_layer(name: str, sub: Dict, flat: re.Pattern, nested: Dict,
                 what: str) -> None:
    if sub and all(isinstance(v, dict) for v in sub.values()):
        allowed = next((c for pat, c in nested.items() if pat.match(name)),
                       None)
        if allowed is None:
            raise ValueError(f"not a {what} layer: {name!r}")
        for child in sub:
            if child not in allowed:
                raise ValueError(f"not a {what} layer: '{name}/{child}'")
        groups = sub.values()
    elif flat.match(name):
        groups = (sub,)
    else:
        raise ValueError(f"not a {what} layer: {name!r}")
    for leaves in groups:
        if not set(leaves) <= _LEAVES:
            raise ValueError(f"{what} layer {name!r}: unknown entries "
                             f"{sorted(set(leaves) - _LEAVES)}")


def _checked(params: Dict, state: Dict, flat: re.Pattern, what: str,
             device, nested: Optional[Dict] = None) -> Tuple[Dict, Dict]:
    for tree in (params, state):
        for name, sub in tree.items():
            _check_layer(name, sub, flat, nested or {}, what)
    return _to_torch(params, device), _to_torch(state, device)


def from_jax_generator(params: Dict, state: Dict, device="cuda"
                       ) -> Tuple[Dict, Dict]:
    """JAX generator (params, state) as nested dicts of numpy arrays, as
    ``jax.device_get`` returns them, → the port's (params, state): f32
    tensors on `device`.  Takes the GAN-CLS generator (``embed``, ``stem``,
    ``up<i>``, ``up<i>_bn``, ``out``), the StackGAN ones (``ca/fc``,
    ``stem``, ``enc<i>``, ``join``, their ``_bn``s, ``res<i>/conv1|bn1|…``,
    ``up<i>/conv|bn``, ``out``) and C-PGGAN's (``embed``, a flat ``ca``,
    ``stem``, ``stem_conv``, ``rgb<s>``, ``up<s>a``, ``up<s>b``); raises on
    any other layer name."""
    return _checked(params, state, _G_LAYER, "generator", device, _G_NESTED)


def from_jax_discriminator(params: Dict, state: Dict, device="cuda"
                           ) -> Tuple[Dict, Dict]:
    """As `from_jax_generator`, for the discriminators: batch norm
    (``down<i>``, ``down<i>_bn``, ``embed``, ``join``, ``join_bn``,
    ``logit``), WGAN-CLS's layer norm (``down<i>_ln``, ``join_ln``) and
    C-PGGAN's critic (``from<s>``, ``down<s>a``, ``down<s>b``, ``embed``,
    ``join``, ``conv4``, ``dense``, ``logit``)."""
    return _checked(params, state, _D_LAYER, "discriminator", device)


def _adam_state(opt_state) -> Tuple[int, Dict, Dict]:
    """(count, mu, nu) of an ``optax.adam`` state held as numpy: the
    chain's ``ScaleByAdamState`` is the element with ``mu`` and ``nu``."""
    for part in opt_state:
        if hasattr(part, "mu") and hasattr(part, "nu"):
            return int(np.asarray(part.count)), part.mu, part.nu
    raise ValueError("no Adam state (an element with mu and nu) in "
                     f"{type(opt_state).__name__}")


def from_jax_train_state(ts, cfg, steps_per_epoch: int, device="cuda"):
    """A JAX ``TrainState`` (any model) held as numpy → the port's
    TrainState on `device` for `cfg` (the same config as the JAX run), with
    the Adam counts and moments, the EMA and Stage-II's frozen Stage-I
    generator carried."""
    from text_to_image_tpu_torch.train.optim import flatten
    from text_to_image_tpu_torch.train.steps import make_train_state

    gp, gs = from_jax_generator(ts.g_params, ts.g_state, device)
    dp, ds = from_jax_discriminator(ts.d_params, ts.d_state, device)
    aux = {}
    if "ema_g_params" in ts.aux:
        aux["ema_g_params"] = from_jax_generator(ts.aux["ema_g_params"], {},
                                                 device)[0]
    if "stage1_g_params" in ts.aux:
        aux["stage1_g_params"], aux["stage1_g_state"] = from_jax_generator(
            ts.aux["stage1_g_params"], ts.aux["stage1_g_state"], device)
    out = make_train_state(cfg, steps_per_epoch, gp, gs, dp, ds,
                           step=int(np.asarray(ts.step)), aux=aux)
    for opt, jax_opt in ((out.g_opt, ts.g_opt), (out.d_opt, ts.d_opt)):
        count, mu, nu = _adam_state(jax_opt)
        opt.load(count, dict(flatten(_to_torch(mu, device))),
                 dict(flatten(_to_torch(nu, device))))
    return out


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


def load_stage1_generator(path: str, device="cuda"
                          ) -> Optional[Tuple[Dict, Dict]]:
    """A Stage-I generator for Stage-II's frozen slot: None for an empty
    path (the caller draws one from its seed), (params, state) from an
    ``.npz`` written by `save_npz`, else from the latest checkpoint of the
    Stage-I run directory `path` (its EMA params where it kept them;
    ``train/checkpoint.load_stage1_generator``)."""
    if not path:
        return None
    if path.endswith(".npz"):
        return load_npz(path, device)
    from text_to_image_tpu_torch.train import checkpoint
    return from_jax_generator(*checkpoint.load_stage1_generator(path, "cpu"),
                              device)
