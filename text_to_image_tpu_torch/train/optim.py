"""Optimizers (counterpart of ``text_to_image_tpu/train/optim.py``): Adam
with the config's betas and the StackGAN staircase LR decay (×factor every
``lr_decay_epoch`` epochs), as ``optax.adam`` over
``optax.exponential_decay(staircase=True)``.

`Adam` wraps ``torch.optim.Adam`` over a params tree: eps 1e-8, no eps
inside the square root, bias correction; the LR of an update is the
schedule at the update count before it, as optax's ``scale_by_schedule``
reads it.  ``tests/test_torch_train.py`` holds it against ``optax.adam``
over updates that cross a decay boundary.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from text_to_image_tpu_torch.config import TrainConfig


def make_schedule(base_lr: float, cfg: TrainConfig, steps_per_epoch: int
                  ) -> Callable[[int], float]:
    """count → LR: ``base_lr·factor^⌊count / period⌋`` with the period
    ``lr_decay_epoch·steps_per_epoch`` clamped to [1, 2³¹−1] (a huge
    ``lr_decay_epoch`` means a constant LR, as in the JAX package)."""
    period = min(max(1, cfg.lr_decay_epoch * steps_per_epoch), 2**31 - 1)
    factor = cfg.lr_decay_factor

    def schedule(count: int) -> float:
        return base_lr * factor ** (count // period)

    return schedule


def flatten(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(``a/b/c`` name, leaf) pairs of a nested dict, in key order."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += flatten(v, name + "/")
        else:
            out.append((name, v))
    return out


class Adam:
    """``optax.adam(schedule, b1, b2)`` over the leaves of a params tree,
    which it updates in place."""

    def __init__(self, params: Dict, schedule: Callable[[int], float],
                 b1: float, b2: float):
        self.names, self.leaves = zip(*flatten(params))
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.Adam(self.leaves, lr=schedule(0),
                                    betas=(b1, b2), eps=1e-8)

    def update(self, grads) -> None:
        """One Adam step with `grads` (one per leaf, in `names` order)."""
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.param_groups[0]["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        for p in self.leaves:
            p.grad = None

    def moments(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(first, second) moments by leaf name; zeros before any update."""
        mu, nu = {}, {}
        for name, p in zip(self.names, self.leaves):
            st = self.opt.state.get(p, {})
            mu[name] = st.get("exp_avg", torch.zeros_like(p))
            nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        return mu, nu

    def load(self, count: int, mu: Dict[str, torch.Tensor],
             nu: Dict[str, torch.Tensor]) -> None:
        """Set the update count and both moments (by leaf name), e.g. from
        an optax Adam state."""
        self.count = int(count)
        for name, p in zip(self.names, self.leaves):
            self.opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": mu[name].to(p).clone(),
                "exp_avg_sq": nu[name].to(p).clone()}


def generator_optimizer(params: Dict, cfg: TrainConfig,
                        steps_per_epoch: int) -> Adam:
    return Adam(params, make_schedule(cfg.generator_lr, cfg, steps_per_epoch),
                cfg.beta1, cfg.beta2)


def discriminator_optimizer(params: Dict, cfg: TrainConfig,
                            steps_per_epoch: int) -> Adam:
    return Adam(params,
                make_schedule(cfg.discriminator_lr, cfg, steps_per_epoch),
                cfg.beta1, cfg.beta2)
