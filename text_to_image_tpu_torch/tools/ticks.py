"""Training ticks at the shipped configs' full widths on one card, timed
and profiled: the numbers ``chip_smoke.py`` reports for the ticks and that
``tools/tick_ab.py`` compares between checkouts.

* `tick_timing` — ms a tick and images/s (counted as the bench counts
  them: the batch a tick), median of 3 windows of ticks on a batch kept on
  the card, and the peak memory;
* `tick_profile` — the device time a tick by kernel family
  (torch.profiler), the device's busy and idle share and the launches a
  tick; the library convolutions over a 5×5 filter a tick (from the
  recorded shapes of ``aten::convolution`` / ``convolution_backward``) and
  the conv5x5_s2_dw launches a tick.

Needs a GPU (CUDA events, the profiler's device activity).
"""

from __future__ import annotations

import os
import time

import torch

from text_to_image_tpu_torch.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH = 64


def config_path(model="gancls"):
    return os.path.join(ROOT, "configs", f"{model}_flowers.yml")


def train_config(model="gancls", **overrides):
    """configs/<model>_flowers.yml on synthetic data, as ``main.py --set
    data.dataset_name=synthetic stage1_checkpoint= …`` loads it."""
    return load_config(config_path(model),
                       {"data.dataset_name": "synthetic",
                        "stage1_checkpoint": "",
                        "train.summary_interval": 1, **overrides})


def tick_timing(device, model="gancls", ticks=10):
    """Training ticks at the config's full widths, batch 64, bf16, on a
    batch kept on the card: ms per tick and images/s counted as bench.py
    counts them (batch per tick), median of 3 windows of `ticks` ticks;
    peak memory."""
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     make_train_step)
    cfg = train_config(model)
    ds = get_dataset(cfg)
    spe = max(1, ds.num_examples // BATCH)
    ts = init_train_state(cfg.seed, cfg, spe, device)
    step = make_train_step(cfg, spe, device)
    slices = [ds.next_batch(BATCH) for _ in range(cfg.train.n_critic)]
    batch = {k: torch.stack([torch.as_tensor(b[k]) for b in slices]).to(device)
             for k in slices[0]}
    for _ in range(2):
        ts, m = step(ts, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(ticks):
            ts, m = step(ts, batch)
        float(m["g_loss"])
        rates.append(ticks * BATCH / (time.perf_counter() - t0))
    rate = sorted(rates)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {model} training tick: {BATCH / rate * 1e3:.3f} ms, {rate:.1f} "
          f"images/s (median of 3 windows of {ticks} ticks: "
          f"{', '.join(f'{r:.1f}' for r in rates)}); peak memory "
          f"{peak:.2f} GiB", flush=True)
    return {"tick_ms": BATCH / rate * 1e3, "images_per_s": rate,
            "windows_images_per_s": rates, "peak_memory_gib": peak}, \
        (ts, step, batch)


def conv5x5_dw_launches(events) -> int:
    """conv5x5_s2_dw's calls among a profile's kernel events: one launch
    of its products' kernel a call (a chunk: one on every main path), and
    a reduction only where the plan has a workspace, so the reductions are
    not counted."""
    return sum(e.count for e in events
               if is_kernel(e) and "dw_reduce_kernel" not in e.key
               and kernel_family(e.key) == "conv5x5_s2_dw (CUDA)")


def is_kernel(event) -> bool:
    """A device kernel of a profile, not a range annotated around kernels
    (``Optimizer.step#Adam.step`` has device time too, which would count
    the Adam kernels twice)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not event.key.startswith("Optimizer."))


def kernel_family(name: str) -> str:
    low = name.lower()
    for keys, fam in (
            (("deconv5x5_s2", "namespace)::deconv", "namespace)::thin::"),
             "deconv5x5_s2 (CUDA)"),
            # csrc/wgrad.cuh's dw_* kernels serve both ops and carry the
            # op's policy in their names: CDw the conv's (so before
            # "::dw_"), Dw the up-block's; dx90::'s ring loop the conv's dx
            # under CDxRing (so before "dx90::"), else the up-block's dx
            (("namespace)::cdw",), "conv5x5_s2_dw (CUDA)"),
            (("cdxring", "namespace)::cdxp::"), "conv5x5_s2_dx (CUDA)"),
            # the deconv's dx: the ring under DDxRing, down0.cuh's kernel
            # under DDxThin (so before "down0::kernel", the conv's RGB
            # layer)
            (("ddxring", "ddxthin"), "deconv5x5_s2_dx (CUDA)"),
            (("namespace)::upconvdx", "namespace)::dx_", "namespace)::dw_",
              "dx90::"), "upconv3x3 backward (CUDA)"),
            (("namespace)::upconv", "combine_kernel", "up32::"),
             "upconv3x3 (CUDA)"),
            (("namespace)::conv", "down0_mma_kernel", "down0::kernel"),
             "conv5x5_s2_act (CUDA)"),
            (("namespace)::join", "join_text_kernel"),
             "conditioning_join (CUDA)"),
            (("bn_stats_kernel", "bn_apply_kernel", "bn_reduce_kernel",
              "bn_dx_kernel"), "batch norm (CUDA)"),
            # csrc/conv3x3.cu: the 3x3 stride-1 conv's forward, dx and dw
            (("k3s1::",), "conv3x3 (CUDA)"),
            (("gemm", "gemv"), "matmul (cuBLAS)"),
            (("conv", "cudnn", "dgrad", "wgrad", "xmma"),
             "conv backward (cuDNN)"),
            (("multi_tensor_apply", "foreach"), "Adam and EMA (foreach)"),
            (("reduce",), "reductions (BN statistics, grad sums)"),
            (("copy", "cat"), "casts, copies, concatenation"),
            (("fill",), "fills (zeros)")):
        if any(k in low for k in keys):
            return fam
    return "other torch elementwise"


# the dispatcher ops every library convolution passes through, and where
# their weight is among the recorded input shapes
CONV_OPS = {"aten::convolution": 1, "aten::convolution_backward": 2}


def library_conv5x5(prof) -> int:
    """Calls of a library convolution over a 5×5 filter in a profile
    recorded with shapes: `CONV_OPS` whose weight ends in 5, 5."""
    calls = 0
    for e in prof.key_averages(group_by_input_shape=True):
        i = CONV_OPS.get(e.key)
        if (i is not None and len(e.input_shapes) > i
                and list(e.input_shapes[i][-2:]) == [5, 5]):
            calls += e.count
    return calls


def tick_profile(ts, step, batch, tick_ms):
    """Device time per training tick by kernel family (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    n = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n):
            ts, m = step(ts, batch)
        torch.cuda.synchronize()
    fams: dict = {}
    launches = 0
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        fam = kernel_family(e.key)
        fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3 / n
        launches += e.count
    busy = sum(fams.values())
    if busy <= 0:
        raise RuntimeError("the profiler saw no device time")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {ms:.4f} ms per tick ({ms / busy:.1%} of device "
              f"time)", flush=True)
    top = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key[:160])
                  for e in prof.key_averages() if is_kernel(e)),
                 reverse=True)[:25]
    print(f"  device busy {busy:.4f} ms of {tick_ms:.4f} ms per tick (idle "
          f"share {1 - busy / tick_ms:.1%}); {launches / n:.0f} kernel "
          f"launches per tick", flush=True)
    dw = conv5x5_dw_launches(prof.key_averages()) / n
    lib5 = library_conv5x5(prof) / n
    print(f"  {lib5:g} library convolutions over a 5×5 filter and {dw:g} "
          f"conv5x5_s2_dw launches per tick", flush=True)
    return {"ms_per_tick_by_family": fams, "device_busy_ms": busy,
            "tick_ms": tick_ms, "idle_share": 1 - busy / tick_ms,
            "kernels_per_tick": launches / n,
            "top_kernels_ms_calls_name": top,
            "library_conv5x5_per_tick": lib5,
            "conv5x5_s2_dw_per_tick": dw}
