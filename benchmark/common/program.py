"""The benchmark's only door into the program under test,
``text_to_image_tpu_torch``: its configuration loader, its kernels'
build, its training state, and its device-resident data tier and tick.
Each function imports what it uses when it is called.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict

import torch

ROOT = Path(__file__).resolve().parents[2]


def _get(cfg, dotted: str):
    obj = cfg
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _dotted(tree: Dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dotted(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def load_config(conf: Dict, seed: int):
    """The program's Config: the configuration's YAML under its
    overrides, as ``main.py --set`` loads it, with ``seed``.  Refuses to
    run when a value the configuration's file states differs (the YAML
    changed under the benchmark)."""
    from text_to_image_tpu_torch.config import load_config as load
    cfg = load(str(ROOT / conf["yaml"]), {**conf["overrides"], "seed": seed})
    for key, want in _dotted(conf["config"]):
        got = _get(cfg, key)
        if got != want and not (isinstance(want, float)
                                and math.isclose(got, want)):
            raise ValueError(f"{conf['yaml']}: {key} is {got!r}, the "
                             f"benchmark's configuration states {want!r}")
    return cfg


def build_kernels(device) -> None:
    """Every CUDA source of the program built (or loaded as built) into
    ``build/torch_kernels`` inside the checkout."""
    if torch.device(device).type != "cuda":
        return
    from text_to_image_tpu_torch.ops.kernels import _build
    _build.build(_build.sources())


def device_data(split: Dict[str, torch.Tensor]):
    """The split as the device-resident tier holds it: the images and
    embeddings as made, the wrong-pair tables from the class ids."""
    from text_to_image_tpu_torch.data import device as DD
    dev = split["images"].device
    perm, start, count = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                          for a in DD.class_tables(
                              split["class_ids"].cpu().numpy()))
    return DD.DeviceData(images=split["images"],
                         embeddings=split["embeddings"], class_perm=perm,
                         other_start=start, other_count=count)


def train_state(cfg, weights: Dict, step: int, steps_per_epoch: int):
    from text_to_image_tpu_torch.train.steps import make_train_state
    return make_train_state(cfg, steps_per_epoch, weights["g"],
                            weights["g_state"], weights["d"],
                            weights["d_state"], step=step)


def resident_step(cfg, steps_per_epoch: int, device):
    """``step(ts, data)``, with ``step.batch_at`` and ``step.tick`` its
    two halves, as ``train/trainer.py`` runs the resident tier."""
    from text_to_image_tpu_torch.train.steps import make_resident_step
    return make_resident_step(cfg, steps_per_epoch, device)


def record_first_gradients(ts) -> Dict[str, Dict[str, torch.Tensor]]:
    """What the checking ticks' first updates saw, copied to the host by
    hooks on the program's ``torch.optim.Adam`` that then remove
    themselves: under ``"d"`` and ``"g"`` each leaf's m / (1 − β1) right
    after that network's first update (its first gradient as Adam took
    it), and under ``"d_at_g"`` the critic's leaves as the generator's
    first update finds them (the critic that gradient was taken through).
    Returns the dict the hooks fill."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    handles = {}
    d_opt = ts.d_opt

    def host(opt, tensors):
        return {name: t.detach().to("cpu", torch.float32, copy=True)
                for name, t in zip(opt.names, tensors)}

    def post_hook(net: str, opt):
        def hook(optimizer, args, kwargs):
            b1 = optimizer.param_groups[0]["betas"][0]
            out[net] = host(opt, [optimizer.state[p]["exp_avg"] / (1.0 - b1)
                                  for p in opt.leaves])
            handles[net].remove()
        return hook

    def critic_hook(optimizer, args, kwargs):
        out["d_at_g"] = host(d_opt, d_opt.leaves)
        handles["d_at_g"].remove()

    for net in ("g", "d"):
        opt = getattr(ts, f"{net}_opt")
        handles[net] = opt.opt.register_step_post_hook(post_hook(net, opt))
    handles["d_at_g"] = ts.g_opt.opt.register_step_pre_hook(critic_hook)
    return out


def change_norms(ts, start: Dict[str, Dict]) -> Dict[str, Dict[str, float]]:
    """Each leaf's ‖now − start‖."""
    from text_to_image_tpu_torch.train.optim import flatten
    out = {}
    for net in ("g", "d"):
        s = dict(flatten(start[net]))
        out[net] = {name: float(torch.linalg.vector_norm(
            (p.detach() - s[name]).double()))
            for name, p in flatten(getattr(ts, f"{net}_params"))}
    return out
