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
history, kernel launches and bytes all-reduced.  With ``turns``, each rank runs the ticks that many times,
alternating without and with the group (without, with, with, without, …
from a fresh state each time), and saves each run's tick times under
``turns``: the cost of the data-parallel machinery, measured in one
process.  With ``record_grads``, each rank keeps the gradients that every
update of the first tick hands Adam (the all-reduced mean over the batch
group), under ``grads`` (``"all"``: every tick's).  With ``profile``, each
rank runs the ticks twice more, without and with the group, and profiles
the last tick of each under `utils.profiling.trace` (traces under
``<dirname(SPEC)>/trace_alone`` and ``trace_group``; a summary of their
ops under ``profile``).  With ``world1_batch_group`` a group of one rank
keeps the whole world as its batch group, so that its tick takes the
data-parallel path (a mesh of one rank has none: the machinery's cost
is timed so).  With ``shard_columns`` the ``stem`` and ``embed`` ``w`` are
cut to each rank's column block over the model group after the start
state is made (`steps.shard_state`); the saved state holds them
all-gathered and ``slices`` this rank's blocks.  A spec with ``dryrun``
(a list of ``{"mesh": …, "set": {config key: value}, "record_grads":
bool}``) runs `entry._dryrun_on_mesh` on each mesh instead and saves its
outcomes under ``dryrun``; with ``linear_check`` also the column-parallel
linear against the replicated one on the first mesh, under ``linear``
(`column_linear_errors`).

`launch` starts the ranks, waits for them with a deadline, and kills them
and raises when one fails or the deadline passes, so that a hung collective
never hangs its caller.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.parallel import collectives, tensor
from text_to_image_tpu_torch.parallel.mesh import (MeshEnv, check_replicated,
                                                   create_mesh, shard_batch)
from text_to_image_tpu_torch.train import checkpoint as ckpt
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                 make_train_step,
                                                 model_sync_of, shard_state)

ROOT = Path(__file__).resolve().parents[2]


def counters() -> Dict[str, int]:
    """Every kernel wrapper's launches (the data-parallel BN's too) and the
    program's other counters, by name (`profiling.counters`)."""
    from text_to_image_tpu_torch.utils import profiling
    return profiling.counters()


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    """What each of `counters` counted since it read `before`."""
    return {k: v - before.get(k, 0) for k, v in counters().items()}


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
    if spec.get("shard_columns"):
        ts = shard_state(ts, env)
    step = make_train_step(cfg, spe, device, env)
    noises = spec.get("noise") or [None] * len(spec["batches"])
    out = {"metrics": [], "launches": [], "all_reduce_bytes": [], "ms": []}
    record = spec.get("record_grads")
    if record:
        out["grads"] = {"d": [], "g": []}
        for net, into in out["grads"].items():
            _recording(getattr(ts, f"{net}_opt"), into)
    last = len(spec["batches"]) - 1
    for i, (batch, noise) in enumerate(zip(spec["batches"], noises)):
        local = shard_batch(env, batch, axis=1) if env is not None else batch
        before = counters()
        collectives.all_reduce_sum.bytes = 0
        traced = (profiling.trace(profile) if profile and i == last
                  else contextlib.nullcontext())
        with traced as prof:
            _sync(device)
            t0 = time.perf_counter()
            ts, metrics = step(ts, local, noise)
            _sync(device)
            ms = (time.perf_counter() - t0) * 1e3
        if (i == last if record == "all" else i == 0) and record:
            del ts.d_opt.update, ts.g_opt.update
        if prof is not None:
            out["profile"] = _profile_summary(prof, ms)
        out["ms"].append(ms)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["launches"].append(counted_since(before))
        out["all_reduce_bytes"].append(collectives.all_reduce_sum.bytes)
    out.update(whole_state(ts, env if spec.get("shard_columns") else None))
    return out


def whole_state(ts, env: Optional[MeshEnv]) -> Dict:
    """``state``: `checkpoint.state_dict` of `ts`, its params
    all-gathered over `env`'s model group where `steps.shard_state` cut
    them (pass `env` only then), with this rank's blocks by net and leaf
    name under ``slices``; raises unless every rank holds the same
    replicated params and its batch group the same blocks."""
    sync = model_sync_of(env)
    if sync is None:
        return {"state": ckpt.state_dict(ts)}
    leaves = {net: flatten(getattr(ts, f"{net}_params")) for net in "gd"}
    cut = {net: {k: v for k, v in named if tensor.is_sharded_leaf(
        k.split("/"), v, tensor.SHARDED_LAYERS)} for net, named in
        leaves.items()}
    check_replicated(env, [v for net, named in leaves.items()
                           for k, v in named if k not in cut[net]],
                     "the replicated params",
                     sharded=[v for c in cut.values() for v in c.values()])
    whole = dataclasses.replace(ts, **{
        f"{net}_params": tensor.gather_columns(getattr(ts, f"{net}_params"),
                                               sync) for net in "gd"})
    return {"state": ckpt.state_dict(whole), "slices": {
        net: {k: v.detach().to("cpu", copy=True) for k, v in c.items()}
        for net, c in cut.items()}}


def column_linear_errors(env: MeshEnv, device: torch.device, rows: int = 6,
                         d_in: int = 12, seed: int = 0) -> Dict[str, float]:
    """`layers.linear` column-parallel over the model group against the
    same linear replicated, f32 on inputs drawn from `seed`: the largest
    |difference| over the largest |value| of the replicated one, for the
    output, the first derivatives of Σ (c·y)² (x, this rank's block of w,
    b; taken with ``create_graph=True``) and the second (the gradients of
    Σ ∂x² with respect to x, the block and b)."""
    sync = model_sync_of(env)
    d_out = 4 * sync.size
    gen = torch.Generator().manual_seed(seed)
    x, w, b, c = (torch.randn(*shape, generator=gen).to(device)
                  for shape in ((rows, d_in), (d_in, d_out), (d_out,),
                                (rows, d_out)))
    cols = slice(sync.index * 4, sync.index * 4 + 4)
    derivs = []
    for sharded in (False, True):
        xs = x.clone().requires_grad_(True)
        p = {"w": w.clone().requires_grad_(True),
             "b": b.clone().requires_grad_(True)}
        if sharded:
            p = tensor.shard_columns({"stem": p}, sync)["stem"]
        with tensor.model_sync(sync if sharded else None):
            y = L.linear(p, xs)
            first = torch.autograd.grad((c * y).pow(2).sum(),
                                        (xs, p["w"], p["b"]),
                                        create_graph=True)
            second = torch.autograd.grad(first[0].pow(2).sum(),
                                         (xs, p["w"], p["b"]))
        derivs.append([y, *first, *second])
    names = ("y", "dx", "dw", "db", "d2x", "d2w", "d2b")
    return {n: float((got - (ref[:, cols] if n in ("dw", "d2w") else ref)
                      ).abs().max() / ref.abs().max())
            for n, ref, got in zip(names, *derivs)}


def device_of(spec: Dict, rank: int) -> torch.device:
    if spec["device"] == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _run_spec(spec: Dict, spec_path: str, device: torch.device) -> Dict:
    """One spec's work on this rank, in the group `main` made."""
    if "argv" in spec:
        from text_to_image_tpu_torch import main as port_main
        trainer = port_main.main(spec["argv"])
        return {"history": trainer.history, "step": trainer.ts.step,
                "launches": counters(),
                "all_reduce_bytes": collectives.all_reduce_sum.bytes}
    if "dryrun" in spec:
        from text_to_image_tpu_torch import entry
        out = {"dryrun": [entry._dryrun_on_mesh(
            create_mesh(**d["mesh"]), device, d.get("set"),
            d.get("record_grads", False)) for d in spec["dryrun"]]}
        if spec.get("linear_check"):
            out["linear"] = column_linear_errors(
                create_mesh(**spec["dryrun"][0]["mesh"]), device)
        return out
    env = create_mesh(**spec["mesh"])
    if spec.get("world1_batch_group") and env.world == 1:
        env = dataclasses.replace(env, batch_group=dist.group.WORLD)
    out = run(spec, device, env)
    out["turns"] = [
        {"group": bool(i % 4 in (1, 2)),
         "ms": run(spec, device, env if i % 4 in (1, 2) else None)["ms"]}
        for i in range(spec.get("turns", 0))]
    if spec.get("profile"):
        out["profile"] = {
            tag: run(spec, device, e, os.path.join(
                os.path.dirname(spec_path), f"trace_{tag}"))["profile"]
            for tag, e in (("alone", None), ("group", env))}
    return out


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
        out = ({"runs": [_run_spec(sub, spec_path, device)
                         for sub in spec["specs"]]} if "specs" in spec
               else _run_spec(spec, spec_path, device))
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


def launch_many(specs: Dict[str, Dict], workdir, timeout_s: float = 60.0
                ) -> Dict[str, List[Dict]]:
    """Several specs of one world, backend and device in one `launch`:
    each rank runs them in turn in one process group (one start-up for
    all).  Returns each spec's outputs in rank order, by name."""
    first = next(iter(specs.values()))
    group = {k: first[k] for k in ("world", "backend", "device")}
    for name, spec in specs.items():
        if any(spec[k] != v for k, v in group.items()):
            raise ValueError(f"spec {name}: {[spec[k] for k in group]}, "
                             f"not {list(group.values())}")
    outs = launch({**group, "specs": list(specs.values())}, workdir,
                  timeout_s)
    return {name: [o["runs"][i] for o in outs]
            for i, name in enumerate(specs)}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
