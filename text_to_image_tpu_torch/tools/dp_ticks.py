"""Training ticks on every rank of a process group, each rank's outcome
written to a file: the data-parallel check of the tests (CPU, gloo) and of
``chip_smoke.py`` (the card, gloo or nccl).

    python -m text_to_image_tpu_torch.tools.dp_ticks SPEC RANK

SPEC is a torch file that `launch` writes: the config (``cfg``, a dict of
`config.config_from_dict`), the mesh (``mesh``: data, model, slices), the
backend, the device ("cpu", or "cuda": card RANK % device_count, so ranks
over gloo may share one), the ``init_method`` of the group (a
``file://`` path, so that no port is taken), the start state (``state``: a
checkpoint directory, or none to draw it from the seed), the global
batches, one a tick, and optionally the global noise of each tick (else
drawn from (seed, step)).  Each rank runs the ticks on its rows of them
(`run`), with TF32 off and cuDNN's deterministic algorithms, and saves
its metrics, state, launches and times to
``<dirname(SPEC)>/rank<RANK>.pt``.  A spec with ``argv`` instead runs ``main.main(argv)`` on every rank in the group
(``--train`` as ``torchrun`` would run it) and saves each rank's metric
history.  With ``turns``, each rank runs the ticks that many times,
alternating without and with the group (without, with, with, without, …
from a fresh state each time), and saves each run's tick times under
``turns``: the cost of the data-parallel machinery, measured in one
process.  With ``record_grads``, each rank keeps the gradients that every
update of the first tick hands Adam (the all-reduced mean over the batch
group), under ``grads``.  With ``profile``, each rank runs the ticks twice
more, without and with the group, and profiles the last tick of each under
`utils.profiling.trace` (traces under ``<dirname(SPEC)>/trace_alone`` and
``trace_group``; a summary of their ops under ``profile``).

`launch` starts the ranks, waits for them with a deadline, and kills them
and raises when one fails or the deadline passes, so that a hung collective
never hangs its caller.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from text_to_image_tpu_torch.config import config_from_dict
from text_to_image_tpu_torch.parallel import collectives
from text_to_image_tpu_torch.parallel.mesh import (MeshEnv, create_mesh,
                                                   shard_batch)
from text_to_image_tpu_torch.train import checkpoint as ckpt
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_train_step)

ROOT = Path(__file__).resolve().parents[2]


def counters() -> list:
    """Every kernel wrapper's launch counter, the data-parallel BN's too."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    return [conv.deconv5x5_s2, conv.conv5x5_s2_act, conv.upconv3x3,
            fused.bn_stats, fused.bn_partials, fused.bn_finish, fused.bn_act,
            fused.bn_bwd_reduce, fused.bn_bwd_apply, fused.conditioning_join]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recording(opt, into: List[Dict]) -> None:
    """Have `opt.update` keep a host copy of the gradients it is handed,
    by leaf name, in `into` (until ``del opt.update``)."""
    update = opt.update

    def recorded(grads):
        into.append({n: g.detach().to("cpu", copy=True)
                     for n, g in zip(opt.names, grads)})
        update(grads)
    opt.update = recorded


def _profile_summary(prof, ms: float) -> Dict:
    """The profiled tick: its wall ms, each op's self host time, calls and
    self device time (ms), and the device's busy ms (kernels alone)."""
    ops = {}
    busy = 0.0
    for e in prof.key_averages():
        dev = e.self_device_time_total / 1e3
        ops[e.key[:120]] = (e.self_cpu_time_total / 1e3, e.count, dev)
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith("Optimizer.")):
            busy += dev
    return {"ms": ms, "device_busy_ms": busy, "ops": ops}


def run(spec: Dict, device: torch.device, env: Optional[MeshEnv] = None,
        profile: Optional[str] = None) -> Dict:
    """The spec's ticks on this rank (one device alone when `env` has no
    batch group): per tick the metrics (floats), launches, the bytes
    all-reduced and ms (host clock between two synchronises), and the
    final state (`checkpoint.state_dict`); with ``record_grads`` the first
    tick's gradients (``grads``: per net, one dict an update); with
    `profile` (a directory) the last tick under `profiling.trace`."""
    from text_to_image_tpu_torch.utils import profiling
    cfg = config_from_dict(spec["cfg"])
    spe = spec.get("steps_per_epoch", 1000)
    ts = init_train_state(cfg.seed, cfg, spe, device)
    if spec.get("state"):
        ts, restored = ckpt.CheckpointManager(spec["state"]).restore(ts)
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {spec['state']}")
    step = make_train_step(cfg, spe, device, env)
    noises = spec.get("noise") or [None] * len(spec["batches"])
    out = {"metrics": [], "launches": [], "all_reduce_bytes": [], "ms": []}
    if spec.get("record_grads"):
        out["grads"] = {"d": [], "g": []}
        for net, into in out["grads"].items():
            _recording(getattr(ts, f"{net}_opt"), into)
    last = len(spec["batches"]) - 1
    for i, (batch, noise) in enumerate(zip(spec["batches"], noises)):
        local = shard_batch(env, batch, axis=1) if env is not None else batch
        for c in counters():
            c.launches = 0
        collectives.all_reduce_sum.bytes = 0
        traced = (profiling.trace(profile) if profile and i == last
                  else contextlib.nullcontext())
        with traced as prof:
            _sync(device)
            t0 = time.perf_counter()
            ts, metrics = step(ts, local, noise)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        if i == 0 and "grads" in out:
            del ts.d_opt.update, ts.g_opt.update
        if prof is not None:
            out["profile"] = _profile_summary(prof, ms)
        out["ms"].append(ms)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["launches"].append({c.__name__: c.launches for c in counters()})
        out["all_reduce_bytes"].append(collectives.all_reduce_sum.bytes)
    out["state"] = ckpt.state_dict(ts)
    return out


def device_of(spec: Dict, rank: int) -> torch.device:
    if spec["device"] == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def main(argv: List[str]) -> int:
    spec_path, rank = argv[0], int(argv[1])
    spec = torch.load(spec_path, weights_only=True)
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False        # f32 stays f32
    torch.backends.cuda.matmul.allow_tf32 = False
    # cuDNN's weight gradients (the conv kernels' backward) in a fixed
    # order, so that a rank's run is the same run after run
    torch.backends.cudnn.deterministic = True
    device = device_of(spec, rank)
    dist.init_process_group(
        spec["backend"], init_method=spec["init_method"], rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=spec.get("timeout_s", 60)))
    try:
        if "argv" in spec:
            from text_to_image_tpu_torch import main as port_main
            trainer = port_main.main(spec["argv"])
            out = {"history": trainer.history, "step": trainer.ts.step}
        else:
            env = create_mesh(**spec["mesh"])
            out = run(spec, device, env)
            out["turns"] = [
                {"group": bool(i % 4 in (1, 2)),
                 "ms": run(spec, device, env if i % 4 in (1, 2) else None
                           )["ms"]}
                for i in range(spec.get("turns", 0))]
            if spec.get("profile"):
                out["profile"] = {
                    tag: run(spec, device, e, os.path.join(
                        os.path.dirname(spec_path), f"trace_{tag}"))["profile"]
                    for tag, e in (("alone", None), ("group", env))}
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(os.path.dirname(spec_path),
                                 f"rank{rank}.pt"))
    return 0


def launch(spec: Dict, workdir, timeout_s: float = 60.0) -> List[Dict]:
    """Write `spec` under `workdir` (a fresh directory; its group's
    ``file://`` store goes there too), run its ``world`` ranks, and return
    their outputs in rank order.  Kills every rank and raises when one
    fails or `timeout_s` passes."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = {"timeout_s": timeout_s, **spec,
            "init_method": f"file://{workdir / 'store'}"}
    path = workdir / "spec.pt"
    torch.save(spec, path)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    logs = [workdir / f"rank{r}.log" for r in range(spec["world"])]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "text_to_image_tpu_torch.tools.dp_ticks", str(path),
                     str(r)], cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired as e:
                raise TimeoutError(
                    f"rank {r} still running after {timeout_s} s") from e
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                                   f"{logs[r].read_text()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(workdir / f"rank{r}.pt", weights_only=True)
            for r in range(spec["world"])]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
