"""Checkpoints (counterpart of ``text_to_image_tpu/train/checkpoint.py``,
which writes Orbax; the port writes one torch file a step).

* A save holds the whole `TrainState`: both nets, both BN states, each
  Adam's update count and moments by leaf name, the step and ``aux`` (the
  generator EMA, Stage-II's frozen Stage-I), so a resumed run computes the
  ticks the uninterrupted run would have.
* ``<directory>/step_<N>.pt`` is written as ``step_<N>.pt.tmp`` and renamed,
  so a reader never sees half a file; the newest ``max_to_keep`` are kept.
  A step at or below the latest saved one is not saved again (as Orbax's
  ``CheckpointManager.save``).
* `CheckpointManager.restore` copies into the tensors of a TrainState of
  the same structure, in place and on their device, so the optimizers'
  leaves stay the objects they hold state for.  A checkpoint of a run with
  the generator EMA restores into one without it (the average is dropped)
  and the other way (the average starts from the restored params); any
  other difference of names or shapes raises `ValueError`.
* ``async_save``: `save` copies to the host before it returns and one
  background thread writes the file; `restore`, `latest_step` and `close`
  wait for it.
* `load_stage1_generator`: Stage-II's frozen Stage-I from a Stage-I run's
  directory, its EMA weights where the run kept them.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Dict, Optional, Tuple

import torch

from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_TREES = ("g_params", "g_state", "d_params", "d_state")


def _host(tree: Dict) -> Dict[str, torch.Tensor]:
    """A tree's leaves by name, copied to the host."""
    return {k: v.detach().to("cpu", copy=True) for k, v in flatten(tree)}


def unflatten(flat: Dict[str, torch.Tensor], device="cpu") -> Dict:
    """``a/b/c`` names → the nested dict, leaves moved to `device`."""
    out: Dict = {}
    for name, v in flat.items():
        *mid, leaf = name.split("/")
        node = out
        for part in mid:
            node = node.setdefault(part, {})
        node[leaf] = v.to(device)
    return out


def state_dict(ts: TrainState) -> Dict:
    """The host copy of `ts` that a checkpoint file holds."""
    out = {name: _host(getattr(ts, name)) for name in _TREES}
    for name, opt in (("g_opt", ts.g_opt), ("d_opt", ts.d_opt)):
        mu, nu = opt.moments()
        out[name] = {"count": int(opt.count),
                     "mu": {k: v.detach().to("cpu", copy=True)
                            for k, v in mu.items()},
                     "nu": {k: v.detach().to("cpu", copy=True)
                            for k, v in nu.items()}}
    out["step"] = int(ts.step)
    out["aux"] = {k: _host(v) for k, v in ts.aux.items()}
    return out


def _mismatch(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
              what: str) -> Optional[str]:
    if want.keys() != got.keys():
        return (f"{what}: missing {sorted(want.keys() - got.keys())}, "
                f"unexpected {sorted(got.keys() - want.keys())}")
    bad = [f"{k} {tuple(got[k].shape)} != {tuple(v.shape)}"
           for k, v in want.items() if got[k].shape != v.shape]
    return f"{what}: shapes {bad}" if bad else None


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 async_save: bool = False):
        self._dir = os.path.abspath(os.path.expanduser(directory))
        self._keep = max_to_keep
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: Optional[concurrent.futures.Future] = None

    @property
    def directory(self) -> str:
        return self._dir

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def _wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()            # raises a failed write here

    def all_steps(self) -> list:
        self._wait()
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self._dir)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, ts: TrainState) -> bool:
        """Snapshot `ts` as step `step`; False (nothing written) when a
        step at or past it is saved already."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        sd = state_dict(ts)
        if self._pool is None:
            self._write(step, sd)
        else:
            self._pending = self._pool.submit(self._write, step, sd)
        return True

    def _write(self, step: int, sd: Dict) -> None:
        os.makedirs(self._dir, exist_ok=True)
        final = self.path(step)
        torch.save(sd, final + ".tmp")
        os.replace(final + ".tmp", final)
        steps = sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                    os.listdir(self._dir)) if m)
        for old in steps[:-self._keep]:
            os.remove(self.path(old))

    def load(self, step: Optional[int] = None) -> Tuple[Optional[Dict],
                                                        Optional[int]]:
        """(the host state dict, its step) of the latest checkpoint or of
        `step`; (None, None) when nothing is saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True), step

    def restore(self, ts_like: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Optional[int]]:
        """Restore the latest checkpoint (or `step`) into `ts_like`, in
        place.  Returns (state, restored step); (ts_like, None) when
        nothing is saved."""
        sd, step = self.load(step)
        if sd is None:
            return ts_like, None
        backfill = "ema_g_params" in ts_like.aux and "ema_g_params" not in sd["aux"]
        pairs = [(flatten(getattr(ts_like, n)), sd[n], n) for n in _TREES]
        for k, tree in ts_like.aux.items():
            if not (backfill and k == "ema_g_params"):
                pairs.append((flatten(tree), sd["aux"].get(k, {}), f"aux/{k}"))
        unknown = sd["aux"].keys() - ts_like.aux.keys() - {"ema_g_params"}
        errors = [f"aux: unexpected {sorted(unknown)}"] if unknown else []
        for like, saved, what in pairs:
            errors.append(_mismatch(dict(like), saved, what))
        for name in ("g_opt", "d_opt"):
            opt = getattr(ts_like, name)
            errors.append(_mismatch(dict(zip(opt.names, opt.leaves)),
                                    sd[name]["mu"], f"{name} moments"))
        errors = [e for e in errors if e]
        if errors:
            raise ValueError(
                f"checkpoint at step {step} under {self._dir} does not match "
                f"the current model/config structure (wrong model family, "
                f"image_size, network dims, or train.ema_decay toggled "
                f"between runs?) — point checkpoint_dir at a matching run or "
                f"clear it. Original error:\n" + "\n".join(errors))
        with torch.no_grad():
            for like, saved, _ in pairs:
                for k, t in like:
                    t.copy_(saved[k])
            if backfill:
                for (_, e), (_, p) in zip(flatten(ts_like.aux["ema_g_params"]),
                                          flatten(ts_like.g_params)):
                    e.copy_(p)
        for name in ("g_opt", "d_opt"):
            o = sd[name]
            getattr(ts_like, name).load(o["count"], o["mu"], o["nu"])
        ts_like.step = int(sd["step"])
        return ts_like, step

    def close(self) -> None:
        self._wait()
        if self._pool is not None:
            self._pool.shutdown(wait=True)


def load_stage1_generator(directory: str, device="cuda"
                          ) -> Tuple[Dict, Dict]:
    """(params, state) of the latest checkpoint of a Stage-I run under
    `directory`, for freezing inside the Stage-II train state: the EMA
    params where the run kept them (what its sampling uses), else the live
    ones."""
    sd, _ = CheckpointManager(directory).load()
    if sd is None:
        raise FileNotFoundError(f"no Stage-I checkpoint under {directory}")
    params = sd["aux"].get("ema_g_params", sd["g_params"])
    return unflatten(params, device), unflatten(sd["g_state"], device)
