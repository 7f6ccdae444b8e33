"""InceptionV3 over the JAX package's param tree (counterpart of
``text_to_image_tpu/eval/inception_v3.py``): the classifier of the
reference's Inception-score protocol (a dataset-finetuned Inception,
lineage hanzhanggit/StackGAN-inception-model → openai/improved-gan).

The standard topology (Szegedy et al. 2015, torchvision layout, no aux
head): stem convs → InceptionA×3 → B → C×4 → D → E×2 → global mean pool →
FC, with the JAX package's unit and block names, so one ``.npz`` loads into
both.  Params keep its layouts (conv ``w`` HWIO, fc ``w`` [in, out]) and its
BN buffers (``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``, eps 1e-3)
apart from the weights: folding them into ``w`` would round otherwise than
JAX does.  A unit is ``F.conv2d`` in the input's dtype, then in f32 ``(y −
mean)·rsqrt(var + 1e-3)·scale + bias`` and relu; activations run NCHW
inside and the images come in NHWC, in tanh range, resized to 299×299
bilinearly (``F.interpolate``, no antialiasing: the JAX package's
``jax.image.resize`` equals it when upsampling, which every generator
resolution below 299 is).  The JAX package computes these convolutions in
lax, outside any kernel; so does this module, in cuDNN.  TF32: see
``eval/classifier.py`` (the IS path's classifier calls run with it off).

`params_from_torch_state_dict` reads a torchvision-format state dict (OIHW →
HWIO, fc transposed) and `export_torchvision_state_dict` writes one; `init`
gives random weights of the JAX package's distribution (the port's own
random numbers).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.utils import prng

BN_EPS = 1e-3
RESOLUTION = 299
FEATURES = 2048

# --- the topology: (kh, kw, cin, cout) of every unit -------------------------

_STEM = (("1a", 3, 3, 3, 32), ("2a", 3, 3, 32, 32), ("2b", 3, 3, 32, 64),
         ("3b", 1, 1, 64, 80), ("4a", 3, 3, 80, 192))

_MIXED = (("5b", "a", 192, 32), ("5c", "a", 256, 64), ("5d", "a", 288, 64),
          ("6a", "b", 288, None), ("6b", "c", 768, 128), ("6c", "c", 768, 160),
          ("6d", "c", 768, 160), ("6e", "c", 768, 192), ("7a", "d", 768, None),
          ("7b", "e", 1280, None), ("7c", "e", 2048, None))


def _block_units(kind: str, cin: int, extra) -> Dict[str, Tuple[int, ...]]:
    """Unit name → (kh, kw, cin, cout) of a block (``extra``: block a's
    pool features, block c's 7×7 width)."""
    if kind == "a":
        return {"b1": (1, 1, cin, 64), "b5_1": (1, 1, cin, 48),
                "b5_2": (5, 5, 48, 64), "d1": (1, 1, cin, 64),
                "d2": (3, 3, 64, 96), "d3": (3, 3, 96, 96),
                "p": (1, 1, cin, extra)}
    if kind == "b":
        return {"b3": (3, 3, cin, 384), "d1": (1, 1, cin, 64),
                "d2": (3, 3, 64, 96), "d3": (3, 3, 96, 96)}
    if kind == "c":
        c7 = extra
        return {"b1": (1, 1, cin, 192), "s1": (1, 1, cin, c7),
                "s2": (1, 7, c7, c7), "s3": (7, 1, c7, 192),
                "d1": (1, 1, cin, c7), "d2": (7, 1, c7, c7),
                "d3": (1, 7, c7, c7), "d4": (7, 1, c7, c7),
                "d5": (1, 7, c7, 192), "p": (1, 1, cin, 192)}
    if kind == "d":
        return {"t1": (1, 1, cin, 192), "t2": (3, 3, 192, 320),
                "s1": (1, 1, cin, 192), "s2": (1, 7, 192, 192),
                "s3": (7, 1, 192, 192), "s4": (3, 3, 192, 192)}
    return {"b1": (1, 1, cin, 320), "s1": (1, 1, cin, 384),
            "s2a": (1, 3, 384, 384), "s2b": (3, 1, 384, 384),
            "d1": (1, 1, cin, 448), "d2": (3, 3, 448, 384),
            "d3a": (1, 3, 384, 384), "d3b": (3, 1, 384, 384),
            "p": (1, 1, cin, 192)}


def param_shapes(num_classes: int) -> Dict:
    """The shape of every leaf of the param tree, by name."""
    def unit(kh, kw, cin, cout):
        return {"w": (kh, kw, cin, cout),
                **{k: (cout,) for k in ("bn_scale", "bn_bias", "bn_mean",
                                        "bn_var")}}
    tree: Dict = {f"conv_{name}": unit(kh, kw, cin, cout)
                  for name, kh, kw, cin, cout in _STEM}
    for name, kind, cin, extra in _MIXED:
        tree[f"mixed_{name}"] = {u: unit(*shape) for u, shape in
                                 _block_units(kind, cin, extra).items()}
    tree["fc"] = {"w": (FEATURES, num_classes), "b": (num_classes,)}
    return tree


# --- init ---------------------------------------------------------------------

def hashs(s: str) -> int:
    return zlib.crc32(s.encode()) % (2**31)


def _truncated_normal(key: int, shape) -> torch.Tensor:
    """N(0, 1) truncated to ±2σ, by the inverse CDF of a uniform draw."""
    lo, hi = (math.erf(c / math.sqrt(2.0)) for c in (-2.0, 2.0))
    u = torch.empty(shape).uniform_(lo, hi, generator=prng.generator(key))
    return (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _unit_init(key: int, kh: int, kw: int, cin: int, cout: int) -> Dict:
    # He-scaled, as the JAX package (not torchvision's trunc_normal(0.1)):
    # the BN buffers are fixed, so the init itself must keep the activation
    # scale through ~40 sequential units for a from-scratch finetune
    std = math.sqrt(2.0 / (kh * kw * cin))
    return {"w": _truncated_normal(key, (kh, kw, cin, cout)) * std,
            "bn_scale": torch.ones(cout), "bn_bias": torch.zeros(cout),
            "bn_mean": torch.zeros(cout), "bn_var": torch.ones(cout)}


def init(key: int, num_classes: int = 1000) -> Dict:
    """Random params on the CPU: each stem unit from ``fold_in(key,
    crc32(name))``, each block's units from a named split of
    ``fold_in(key, crc32("mix" + name))``, the fc from ``fold_in(key,
    crc32("fc"))`` (w ~ N(0, 0.01²), b 0), as the JAX package derives its
    keys."""
    params: Dict = {}
    for name, kh, kw, cin, cout in _STEM:
        params[f"conv_{name}"] = _unit_init(prng.fold_in(key, hashs(name)),
                                            kh, kw, cin, cout)
    for name, kind, cin, extra in _MIXED:
        units = _block_units(kind, cin, extra)
        keys = prng.split_tree(prng.fold_in(key, hashs("mix" + name)),
                               tuple(units))
        params[f"mixed_{name}"] = {u: _unit_init(keys[u], *shape)
                                   for u, shape in units.items()}
    kfc = prng.fold_in(key, hashs("fc"))
    params["fc"] = {
        "w": torch.randn(FEATURES, num_classes,
                         generator=prng.generator(kfc)) * 0.01,
        "b": torch.zeros(num_classes)}
    return params


# --- forward (NCHW inside) -------------------------------------------------------

def _unit(p: Dict, x: torch.Tensor, stride: int = 1, padding=(0, 0)
          ) -> torch.Tensor:
    y = F.conv2d(x, p["w"].to(x.dtype).permute(3, 2, 0, 1), stride=stride,
                 padding=padding)
    inv = torch.rsqrt(p["bn_var"] + BN_EPS) * p["bn_scale"]
    y32 = ((y.float() - p["bn_mean"][:, None, None]) * inv[:, None, None]
           + p["bn_bias"][:, None, None])
    return torch.relu(y32).to(x.dtype)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3s1(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _block_a(p, x):
    b1 = _unit(p["b1"], x)
    b5 = _unit(p["b5_2"], _unit(p["b5_1"], x), padding=(2, 2))
    d = _unit(p["d3"], _unit(p["d2"], _unit(p["d1"], x), padding=(1, 1)),
              padding=(1, 1))
    pool = _unit(p["p"], _avgpool3s1(x))
    return torch.cat([b1, b5, d, pool], 1)


def _block_b(p, x):
    b3 = _unit(p["b3"], x, stride=2)
    d = _unit(p["d2"], _unit(p["d1"], x), padding=(1, 1))
    d = _unit(p["d3"], d, stride=2)
    return torch.cat([b3, d, _maxpool3s2(x)], 1)


def _block_c(p, x):
    b1 = _unit(p["b1"], x)
    s = _unit(p["s2"], _unit(p["s1"], x), padding=(0, 3))
    s = _unit(p["s3"], s, padding=(3, 0))
    d = _unit(p["d2"], _unit(p["d1"], x), padding=(3, 0))
    d = _unit(p["d3"], d, padding=(0, 3))
    d = _unit(p["d4"], d, padding=(3, 0))
    d = _unit(p["d5"], d, padding=(0, 3))
    pool = _unit(p["p"], _avgpool3s1(x))
    return torch.cat([b1, s, d, pool], 1)


def _block_d(p, x):
    t = _unit(p["t2"], _unit(p["t1"], x), stride=2)
    s = _unit(p["s2"], _unit(p["s1"], x), padding=(0, 3))
    s = _unit(p["s3"], s, padding=(3, 0))
    s = _unit(p["s4"], s, stride=2)
    return torch.cat([t, s, _maxpool3s2(x)], 1)


def _block_e(p, x):
    b1 = _unit(p["b1"], x)
    s = _unit(p["s1"], x)
    s = torch.cat([_unit(p["s2a"], s, padding=(0, 1)),
                   _unit(p["s2b"], s, padding=(1, 0))], 1)
    d = _unit(p["d2"], _unit(p["d1"], x), padding=(1, 1))
    d = torch.cat([_unit(p["d3a"], d, padding=(0, 1)),
                   _unit(p["d3b"], d, padding=(1, 0))], 1)
    pool = _unit(p["p"], _avgpool3s1(x))
    return torch.cat([b1, s, d, pool], 1)


_BLOCK_APPLY = {"a": _block_a, "b": _block_b, "c": _block_c, "d": _block_d,
                "e": _block_e}


def stem(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The stem over NCHW 299² input: 1a s2, 2a, 2b (pad 1), max pool,
    3b, 4a, max pool → [B, 192, 35, 35]."""
    x = _unit(params["conv_1a"], x, stride=2)
    x = _unit(params["conv_2a"], x)
    x = _unit(params["conv_2b"], x, padding=(1, 1))
    x = _maxpool3s2(x)
    x = _unit(params["conv_3b"], x)
    x = _unit(params["conv_4a"], x)
    return _maxpool3s2(x)


def block(kind: str, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """Inception block `kind` (a–e) over NCHW x."""
    return _BLOCK_APPLY[kind](p, x)


def apply(params: Dict, images: torch.Tensor) -> torch.Tensor:
    """images[B,H,W,3] in tanh range → logits[B, num_classes], in f32;
    resized to 299×299 bilinearly when H is not 299."""
    x = images.float().permute(0, 3, 1, 2)
    if x.shape[2] != RESOLUTION:
        x = F.interpolate(x, size=(RESOLUTION, RESOLUTION), mode="bilinear",
                          align_corners=False, antialias=False)
    x = stem(params, x)
    for name, kind, _, _ in _MIXED:
        x = block(kind, params[f"mixed_{name}"], x)
    x = x.mean(dim=(2, 3))
    return x @ params["fc"]["w"] + params["fc"]["b"]


def make_classifier(params: Dict):
    """``images → logits`` closure for `compute_inception_score`
    (inference mode, TF32 off: ``eval/classifier.py``)."""
    from text_to_image_tpu_torch.eval.classifier import make_classifier_fn
    return make_classifier_fn(params, apply_fn=apply)


# --- torchvision weights -------------------------------------------------------

_TV_UNIT = {  # our unit name → torchvision module prefix
    "conv_1a": "Conv2d_1a_3x3", "conv_2a": "Conv2d_2a_3x3",
    "conv_2b": "Conv2d_2b_3x3", "conv_3b": "Conv2d_3b_1x1",
    "conv_4a": "Conv2d_4a_3x3",
}

_TV_BRANCH = {
    "a": {"b1": "branch1x1", "b5_1": "branch5x5_1", "b5_2": "branch5x5_2",
          "d1": "branch3x3dbl_1", "d2": "branch3x3dbl_2",
          "d3": "branch3x3dbl_3", "p": "branch_pool"},
    "b": {"b3": "branch3x3", "d1": "branch3x3dbl_1", "d2": "branch3x3dbl_2",
          "d3": "branch3x3dbl_3"},
    "c": {"b1": "branch1x1", "s1": "branch7x7_1", "s2": "branch7x7_2",
          "s3": "branch7x7_3", "d1": "branch7x7dbl_1", "d2": "branch7x7dbl_2",
          "d3": "branch7x7dbl_3", "d4": "branch7x7dbl_4",
          "d5": "branch7x7dbl_5", "p": "branch_pool"},
    "d": {"t1": "branch3x3_1", "t2": "branch3x3_2", "s1": "branch7x7x3_1",
          "s2": "branch7x7x3_2", "s3": "branch7x7x3_3", "s4": "branch7x7x3_4"},
    "e": {"b1": "branch1x1", "s1": "branch3x3_1", "s2a": "branch3x3_2a",
          "s2b": "branch3x3_2b", "d1": "branch3x3dbl_1",
          "d2": "branch3x3dbl_2", "d3a": "branch3x3dbl_3a",
          "d3b": "branch3x3dbl_3b", "p": "branch_pool"},
}

_TV_BN = (("bn_scale", "bn.weight"), ("bn_bias", "bn.bias"),
          ("bn_mean", "bn.running_mean"), ("bn_var", "bn.running_var"))


def _tv_units():
    """(path in our tree, torchvision prefix) of every unit."""
    for ours, tv in _TV_UNIT.items():
        yield (ours,), tv
    for name, kind, _, _ in _MIXED:
        for ours, tv in _TV_BRANCH[kind].items():
            yield (f"mixed_{name}", ours), f"Mixed_{name}.{tv}"


def params_from_torch_state_dict(sd, device="cpu") -> Dict:
    """A torchvision InceptionV3 state dict (torch tensors or numpy, e.g. a
    dataset-finetuned checkpoint) → our param tree on `device` (through
    `convert.from_jax_classifier`, which checks names and shapes).  Conv
    OIHW → HWIO; linear [out, in] → [in, out]."""
    from text_to_image_tpu_torch import convert

    def host(v):
        return np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v, np.float32)

    tree: Dict = {}
    for path, prefix in _tv_units():
        unit = {"w": np.transpose(host(sd[f"{prefix}.conv.weight"]),
                                  (2, 3, 1, 0))}
        unit.update({ours: host(sd[f"{prefix}.{tv}"]) for ours, tv in _TV_BN})
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = unit
    tree["fc"] = {"w": host(sd["fc.weight"]).T, "b": host(sd["fc.bias"])}
    return convert.from_jax_classifier(tree, device)


def export_torchvision_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_torch_state_dict`: our tree (torch or numpy
    leaves) → a torchvision-layout state dict of CPU torch tensors, e.g. to
    write a stand-in for a finetuned checkpoint that cannot be downloaded."""
    def t(v):
        return torch.as_tensor(np.asarray(
            v.detach().cpu() if isinstance(v, torch.Tensor) else v,
            np.float32))

    sd = {}
    for path, prefix in _tv_units():
        unit = params
        for part in path:
            unit = unit[part]
        sd[f"{prefix}.conv.weight"] = t(unit["w"]).permute(3, 2, 0, 1
                                                           ).contiguous()
        for ours, tv in _TV_BN:
            sd[f"{prefix}.{tv}"] = t(unit[ours]).clone()
    sd["fc.weight"] = t(params["fc"]["w"]).T.contiguous()
    sd["fc.bias"] = t(params["fc"]["b"]).clone()
    return sd


def load_npz(path: str, device="cuda") -> Dict:
    """A converted checkpoint (``scripts/convert_inception.py`` output) →
    our param tree on `device`."""
    from text_to_image_tpu_torch import convert
    with np.load(path, allow_pickle=True) as data:
        return convert.from_jax_classifier(data["params"].item(), device)
