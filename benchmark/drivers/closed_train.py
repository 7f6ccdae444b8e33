"""``closed_train``: training ticks back to back, each waiting on the one
before, through the resident tier's ``step(ts, data)`` as the trainer runs
it: the split staged on the card once, each tick's batch drawn and
gathered there.

Set-up makes the weights and the split from the seed and runs
``check_ticks`` ticks through that same call (they warm up every shape
and are the ticks the reference follows).  The window counts the ticks
the host issued before its end and waits for the card to finish them:
images/s = batch × ticks / seconds.  A traced stretch splits each tick
into its two halves, the batch's draw (span ``data``) and the tick
proper (span ``tick``).

The check: the reference runs the checking ticks again from the seed,
and takes the generator's first gradient once more through the critic
that the side judged held at its generator's first update.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark.common import compare, inputs, program
from benchmark.common.traffic import Driver as Base
from benchmark.common.traffic import f32_exact, sync


class Driver(Base):
    spans = ("data", "tick")
    unit = "tick"
    heavy = ("ts", "data", "step", "m")

    def __init__(self, ctx):
        super().__init__(ctx)
        self.batch = self.cfg.train.batch_size
        self.spe = max(1, self.conf["split"]["images"] // self.batch)

    def setup(self) -> None:
        c, dev = self.conf, self.device
        program.build_kernels(dev)
        weights = inputs.make_weights(self.spec, self.seed, dev)
        start = {"g": weights["g"], "d": weights["d"]}
        split = inputs.make_split(c["split"], self.seed, dev)
        self.data = program.device_data(split)
        self.ts = program.train_state(self.cfg, weights,
                                      c.get("start_step", 0), self.spe)
        self.step = program.resident_step(self.cfg, self.spe, dev)
        first = program.record_first_gradients(self.ts)
        for _ in range(self.p["check_ticks"]):
            self.ts, self.m = self.step(self.ts, self.data)
        self.ours = {"grad": {k: first[k] for k in ("g", "d") if k in first},
                     "d_at_g": first.get("d_at_g"),
                     "change": program.change_norms(self.ts, start)}
        del start, weights, split
        sync(dev)

    def one(self, spans=None) -> None:
        """One tick: ``step(ts, data)``, or in a traced stretch its two
        halves, each inside its span."""
        if spans is None:
            self.ts, self.m = self.step(self.ts, self.data)
            return
        with spans("data"):
            batch = self.step.batch_at(self.data, self.ts.step)
        with spans("tick"):
            self.ts, self.m = self.step.tick(self.ts, batch)

    def window(self, seconds: float) -> Dict[str, float]:
        sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while n < 1 or time.perf_counter() - t0 < seconds:
            self.one()
            n += 1
        sync(self.device)
        dt = time.perf_counter() - t0
        last = torch.stack([self.m["d_loss"].float(),
                            self.m["g_loss"].float()]).cpu()
        self.attempted = n
        self.failed = 0 if bool(torch.isfinite(last).all()) else n
        self.count, self.seconds = n, dt
        return {"train_images_per_s": self.batch * n / dt}

    def _inputs(self):
        """The weights and the split, made again from the seed."""
        return (inputs.make_weights(self.spec, self.seed, self.device),
                inputs.make_split(self.conf["split"], self.seed, self.device))

    def reference(self, prec: str = "f32", fault=None) -> Dict:
        """The reference's readings of the checking ticks."""
        c = self.conf
        weights, split = self._inputs()
        with f32_exact():
            return self.ctx.reference.train(
                c["config"], weights, split, self.seed,
                c.get("start_step", 0), self.p["check_ticks"], prec=prec,
                fault=fault, steps_per_epoch=self.spe)

    def g_reference(self, d_at_g) -> Dict[str, torch.Tensor]:
        """The f32 reference's first generator gradient through the
        critic `d_at_g` (by leaf name)."""
        c = self.conf
        weights, split = self._inputs()
        with f32_exact():
            return self.ctx.reference.g_grad_at(
                c["config"], weights, split, self.seed,
                c.get("start_step", 0), d_at_g)

    def judge(self, side: Dict) -> Dict[str, float]:
        """`side`'s numbers (the program's, or the reference's own in
        lower precision or under a fault) against the f32 reference."""
        if not hasattr(self, "_ref"):
            self._ref = self.reference()
        ref_g = (self.g_reference(side["d_at_g"]) if side.get("d_at_g")
                 else None)
        return compare.train_numbers(side, self._ref, ref_g)
