"""Plain PyTorch building blocks of the benchmark's references.

Nothing here imports the program under test.  What the program derives
from the benchmark's inputs (the tick's noise from the seed, each tick's
batch drawn from the staged split, the class tables of the wrong-pair
draw, Adam's update) is worked out again here from the same inputs, after
the published semantics of each piece:

* keys: ``fold_in(key, data)`` through numpy's SeedSequence, a CPU
  ``torch.Generator`` seeded with a key where numbers are drawn;
* the tick's noise: z, the conditioning-augmentation ε and the gradient
  penalty's ε of each critic update from ``fold_in(fold_in(seed, step),
  0)``, the generator update's from ``…, 1)``;
* the tick's batch: a ``torch.Generator`` on the split's device seeded with
  ``fold_in(fold_in(seed, step), 2)``, uniform example draws, a uniform
  draw among the other classes' examples for the wrong image, a random
  crop and flip of each, the mean of ``window`` distinct captions;
* Adam as ``torch.optim.Adam`` defines it (eps outside the square root,
  bias correction), with the StackGAN staircase schedule.

Tensors are NCHW inside the layers; images and weights arrive as the
benchmark makes them (NHWC images, HWIO conv weights, ``[in, out]`` linear
weights).  Every layer takes a `Precision`: ``f32`` computes in float32
(TF32 is switched off by the caller); ``fp8``, the lower precision the
control stands in with, rounds both operands of every convolution and
matrix product to float8 e4m3, and the gradients flowing back into them
to e5m2, each under one scale a tensor.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# float8 formats: e4m3 for a product's operands, e5m2 for the gradients
# flowing back, the usual split of float8 training; and their largest
# finite values
F8_FORWARD, F8_BACKWARD = torch.float8_e4m3fn, torch.float8_e5m2
F8_MAX = {F8_FORWARD: 448.0, F8_BACKWARD: 57344.0}


def fold_in(key: int, data: int) -> int:
    seq = np.random.SeedSequence([int(key) % 2**63, int(data) % 2**63])
    return int(seq.generate_state(1, np.uint64)[0] % 2**63)


def cpu_generator(key: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(key))


def round_fp8(x: torch.Tensor, fmt=F8_FORWARD) -> torch.Tensor:
    """x rounded to float8 `fmt` under one scale that maps its largest
    magnitude to the format's largest."""
    scale = F8_MAX[fmt] / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(fmt).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """An operand of a product in float8: rounded on the way in, and its
    gradient rounded on the way back (the backward's products in float8
    too)."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        # straight through for a second derivative (the GP's)
        d = g.detach()
        return g + (round_fp8(d, F8_BACKWARD) - d)


class Precision:
    """Where the operands of a product are rounded: nowhere (``f32``) or
    to float8 with a per-tensor scale (``fp8``: e4m3 forward, the
    gradients e5m2)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r} not in f32, fp8")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _Fp8.apply(x)


# --- layers (NCHW) -----------------------------------------------------------

def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding over n pixels: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
         stride: int, prec: Precision, padding: str = "SAME",
         scale: float = 1.0) -> torch.Tensor:
    """conv of NCHW x with the HWIO weight w·scale, TF SAME or VALID."""
    k = w.shape[0]
    if padding == "SAME":
        (pt, pb), (pl, pr) = (same_pads(n, k, stride) for n in x.shape[2:])
        x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(prec(x), prec((w * scale).permute(3, 2, 0, 1)), b,
                    stride=stride)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           prec: Precision, scale: float = 1.0) -> torch.Tensor:
    y = prec(x) @ prec(w * scale)
    return y if b is None else y + b


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avgpool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def tile_concat(h: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[h; t tiled over h's map] on channels."""
    b, _, hh, ww = h.shape
    return torch.cat([h, t[:, :, None, None].expand(b, t.shape[1], hh, ww)],
                     dim=1)


def flatten_hwc(h: torch.Tensor) -> torch.Tensor:
    """NCHW → [B, H·W·C] in NHWC order (the weights' row order)."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def images(x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC → f32 NCHW in [-1, 1]."""
    return to_nchw(x.float() / 127.5 - 1.0)


# --- losses ------------------------------------------------------------------

def ca_kl(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return (-0.5 * (1.0 + logvar - mu**2 - torch.exp(logvar)).sum(-1)).mean()


# --- parameter trees ---------------------------------------------------------

def flat(tree: Dict, prefix: str = "") -> List[Tuple[str, object]]:
    """(``a/b`` name, leaf) pairs of a nested dict, in key order."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += flat(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def nest(named: Dict[str, object]) -> Dict:
    """The nested dict of (``a/b`` name, leaf) pairs: `flat` undone."""
    out: Dict = {}
    for name, v in named.items():
        *path, last = name.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def leaves(tree: Dict) -> Dict:
    """A copy of a tensor tree whose leaves are f32 tensors that require
    grad."""
    return {k: leaves(v) if isinstance(v, dict)
            else v.detach().float().clone().requires_grad_(True)
            for k, v in tree.items()}


class Adam:
    """``torch.optim.Adam`` (eps 1e-8 outside the square root, bias
    correction) over a tree's leaves, with the staircase schedule
    ``lr·factor^⌊count / period⌋``."""

    def __init__(self, tree: Dict, lr: float, betas: Tuple[float, float],
                 period: int, factor: float):
        self.names, self.params = zip(*flat(tree))
        self.lr, (self.b1, self.b2) = lr, betas
        self.period, self.factor = max(1, min(period, 2**31 - 1)), factor
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.first: Dict[str, torch.Tensor] = {}

    def update(self, loss: torch.Tensor) -> None:
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        lr = self.lr * self.factor ** (self.count // self.period)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                g = torch.zeros_like(p) if g is None else g
                m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = v.sqrt() / math.sqrt(bc2) + 1e-8
                p.addcdiv_(m, denom, value=-lr / bc1)
        if self.count == 1:
            # the first gradient, as it is worked out from the state
            self.first = {n: (m / bc1).cpu()
                          for n, m in zip(self.names, self.m)}


def param_norms_from(tree: Dict, start: Dict) -> Dict[str, float]:
    """‖leaf − its start‖ a leaf of a tree."""
    s = dict(flat(start))
    return {n: float(torch.linalg.vector_norm((p.detach() - s[n]).double()))
            for n, p in flat(tree)}


# --- the tick's noise --------------------------------------------------------

def tick_noise(seed: int, step: int, n_critic: int, batch: int, z_dim: int,
               eps_shape: Optional[Sequence[int]], critic: bool
               ) -> Dict[str, torch.Tensor]:
    """The noise of tick `step` on the CPU: ``d`` [n_critic, B, z], ``g``
    [B, z]; ``d_eps`` [n_critic, *eps_shape] and ``g_eps`` for a model with
    conditioning augmentation; ``gp_eps`` [n_critic, B, 1, 1, 1] ∈ U[0, 1)
    for a critic."""
    key = fold_in(seed, step)
    dkey, gkey = fold_in(key, 0), fold_in(key, 1)
    d_keys = [fold_in(dkey, k) for k in range(n_critic)]

    def normal(k, shape):
        return torch.randn(*shape, generator=cpu_generator(k))

    out = {"d": torch.stack([normal(k, (batch, z_dim)) for k in d_keys]),
           "g": normal(gkey, (batch, z_dim))}
    if eps_shape is not None:
        out["d_eps"] = torch.stack([normal(fold_in(k, 2), eps_shape)
                                    for k in d_keys])
        out["g_eps"] = normal(fold_in(gkey, 2), eps_shape)
    if critic:
        out["gp_eps"] = torch.stack([
            torch.rand(batch, generator=cpu_generator(fold_in(k, 3)))
            for k in d_keys])[:, :, None, None, None]
    return out


# --- the tick's batch --------------------------------------------------------

def class_tables(class_ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """(examples sorted by class, where each example's other-class ring
    starts in that order, how many examples of other classes there are)."""
    cls = np.asarray(class_ids)
    n = len(cls)
    perm = np.argsort(cls, kind="stable")
    uniq, starts, counts = np.unique(cls[perm], return_index=True,
                                     return_counts=True)
    at = np.searchsorted(uniq, cls)
    return perm, (starts[at] + counts[at]) % n, n - counts[at]


def tick_batch(split: Dict[str, torch.Tensor], seed: int, step: int,
               n_critic: int, batch: int, size: int, window: int,
               crop: bool, flip: bool) -> Dict[str, torch.Tensor]:
    """Tick `step`'s real and wrong images (uint8 NHWC) and caption means
    (f32), [n_critic, B, …], drawn on the split's device."""
    imgs, embs = split["images"], split["embeddings"]
    dev = imgs.device
    n, src = imgs.shape[:2]
    caps = embs.shape[1]
    perm, other_start, other_count = (
        torch.as_tensor(a, dtype=torch.int64, device=dev)
        for a in class_tables(split["class_ids"].cpu().numpy()))
    g = torch.Generator(device=dev)
    g.manual_seed(int(fold_in(fold_in(seed, step), 2)))
    kw = {"generator": g, "device": dev}
    lead = (n_critic, batch)
    idx = torch.randint(0, n, lead, **kw)
    count = other_count[idx]
    u = (torch.rand(lead, dtype=torch.float64, **kw) * count).long()
    u = torch.minimum(u, count - 1)
    draws = {}
    for s in ("real", "wrong"):
        draws[f"{s}_off"] = (torch.randint(0, src - size + 1, (2, *lead), **kw)
                             if crop and src != size else None)
        draws[f"{s}_flip"] = torch.rand(lead, **kw) < 0.5 if flip else None
    keys = torch.rand((*lead, caps), **kw) if window < caps else None
    wrong = perm[(other_start[idx] + u) % n]

    def crops(which: torch.Tensor, s: str) -> torch.Tensor:
        out = torch.empty(*lead, size, size, imgs.shape[-1], dtype=imgs.dtype,
                          device=dev)
        off, flips = (None if t is None else t.cpu()
                      for t in (draws[f"{s}_off"], draws[f"{s}_flip"]))
        for k in range(n_critic):
            for b in range(batch):
                y0 = x0 = (src - size) // 2
                if off is not None:
                    y0, x0 = int(off[0, k, b]), int(off[1, k, b])
                im = imgs[which[k, b], y0:y0 + size, x0:x0 + size]
                if flips is not None and bool(flips[k, b]):
                    im = im.flip(1)
                out[k, b] = im
        return out

    if keys is None:
        emb = embs[idx].mean(-2)
    else:
        picks = torch.argsort(keys, dim=-1, stable=True)[..., :window]
        emb = embs[idx[..., None], picks].mean(-2)
    return {"real": crops(idx, "real"), "wrong": crops(wrong, "wrong"),
            "emb": emb}


def half_rows(batch: Dict[str, torch.Tensor], axis: int = 1
              ) -> Dict[str, torch.Tensor]:
    """The first half of the batch rows of each tensor (a fault the
    benchmark's own check has to catch)."""
    return {k: v.narrow(axis, 0, v.shape[axis] // 2)
            for k, v in batch.items()}
