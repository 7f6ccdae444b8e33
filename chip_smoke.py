#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds every kernel of the sampling path from the repo's sources
   (``text_to_image_tpu_torch/csrc/*.cu`` with nvcc, one process per source;
   the Triton ``bn_act`` at its first launch);
2. holds each kernel against its plain PyTorch version at every shape the
   GAN-CLS 64 px generator gives it, at batch 64 in bf16 and f32;
3. drives the sampling path at the flagship widths (gf 128, z 100,
   embed 1024, batch 64, bf16) through ``eval/sampler.py`` — the sample grid
   and both interpolation grids — plus the BN-folded serving generator, with
   every launch counter set to 0 just before and read just after; checks the
   images (finite, shape, tanh range) and holds the generator against the
   same code on the CPU, where every kernel is its plain version;
4. times each kernel, its plain version and one PyTorch library call at
   those shapes (CUDA events, L2 flushed before each launch), computes each
   kernel's bound, and times sampling in images/s.

Weights are random, from a seed.  It prints the card's name and power limit
and a ``{"kernels": [...]}`` line, writes the full report to
``chiprun_out/chip_smoke.json``, and ends with
``{"ok": true, "device": {...}}``.  Any failure raises: no result line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 64
# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version: bf16 outputs may differ by a rounding flip
# (1 ulp = 2^-7 relative) after f32 sums taken in another order; f32 by the
# sum order only
TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
BN_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-5, 1e-5)}
# whole generator, GPU kernels vs the CPU plain path (train-mode BN over
# the batch; bf16 rounds at every layer)
G_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# (B, H, W, Cin) → Co, act: the 64 px generator's deconv calls
DECONV_SHAPES = [((BATCH, 4, 4, 1024), 512, "relu"),
                 ((BATCH, 8, 8, 512), 256, "relu"),
                 ((BATCH, 16, 16, 256), 128, "relu"),
                 ((BATCH, 32, 32, 128), 3, "tanh")]
# the BN inputs that the bn_act calls see
BN_SHAPES = [(BATCH, 4, 4, 1024), (BATCH, 8, 8, 512), (BATCH, 16, 16, 256),
             (BATCH, 32, 32, 128)]
# off the main path: ragged channels and odd maps, so that every code path
# of each kernel is held against its plain version too
ODD_DECONV_SHAPES = [((2, 5, 7, 12), 20, "lrelu"), ((3, 8, 8, 8), 16, "none"),
                     ((2, 5, 7, 6), 3, "tanh"), ((2, 4, 4, 16), 2, "relu")]
ODD_BN_SHAPES = [((3, 5, 7, 20), "tanh"), ((2, 3, 3, 200), "lrelu")]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(got, ref, atol, rtol, what):
    err = (got.float() - ref.float()).abs()
    bad = err > atol + rtol * ref.float().abs()
    max_err = float(err.max())
    log(f"  {what}: max|err| {max_err:.3e} (tol {atol:g} + {rtol:g}·|ref|)"
        f" {'ok' if not bad.any() else 'FAIL'}")
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements out of "
                               f"tolerance, max|err| {max_err:.3e}")
    return max_err


class L2Flush:
    """Evicts the 50 MB L2 by writing a larger buffer."""

    def __init__(self, device):
        self.buf = torch.empty(96 * 2**20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.fill_(1)


def time_ms(fn, flush, iters=20, warmup=3):
    """Median device time of fn() over `iters` launches, each measured
    with CUDA events after an L2 flush.  A spin of ~0.1 ms on the device
    after the flush keeps the host's launch overhead out of the window."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return times[len(times) // 2]


def bound(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------

def deconv_inputs(shape, co, dtype, device, gen):
    cin = shape[-1]
    x = torch.relu(torch.randn(shape, generator=gen)).to(dtype)
    w = (torch.randn(5, 5, cin, co, generator=gen) * 0.02).to(dtype)
    s = 1.0 + 0.1 * torch.randn(co, generator=gen)
    t = 0.1 * torch.randn(co, generator=gen)
    return [v.to(device) for v in (x, w, s, t)]


def bn_inputs(shape, dtype, device, gen):
    c = shape[-1]
    x = torch.randn(shape, generator=gen).to(dtype)
    a = 1.0 + 0.1 * torch.randn(c, generator=gen)
    b = 0.1 * torch.randn(c, generator=gen)
    return [v.to(device) for v in (x, a, b)]


def phase_kernels(device):
    """Each kernel against its plain version at every main-path shape."""
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    gen = torch.Generator().manual_seed(SEED)
    errs = {"deconv5x5_s2": {}, "bn_act": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for shape, co, act in DECONV_SHAPES:
            x, w, s, t = deconv_inputs(shape, co, dtype, device, gen)
            got = conv.deconv5x5_s2(x, w, s, t, act)
            ref = conv.deconv5x5_s2_plain(x, w, s, t, act)
            torch.cuda.synchronize()
            check(got.shape == ref.shape, f"deconv shape {got.shape}")
            errs["deconv5x5_s2"][(dtype, shape)] = compare(
                got, ref, *TOL[dtype],
                f"deconv5x5_s2 {str(dtype)[6:]} {shape}->{co} {act}")
        for shape in BN_SHAPES:
            x, a, b = bn_inputs(shape, dtype, device, gen)
            got = fused.bn_act(x, a, b, "relu")
            ref = fused.bn_act_plain(x, a, b, "relu")
            torch.cuda.synchronize()
            errs["bn_act"][(dtype, shape)] = compare(
                got, ref, *BN_TOL[dtype], f"bn_act {str(dtype)[6:]} {shape} relu")
        for shape, co, act in ODD_DECONV_SHAPES:
            x, w, s, t = deconv_inputs(shape, co, dtype, device, gen)
            compare(conv.deconv5x5_s2(x, w, s, t, act),
                    conv.deconv5x5_s2_plain(x, w, s, t, act), *TOL[dtype],
                    f"deconv5x5_s2 {str(dtype)[6:]} {shape}->{co} {act} (odd)")
        for shape, act in ODD_BN_SHAPES:
            x, a, b = bn_inputs(shape, dtype, device, gen)
            compare(fused.bn_act(x, a, b, act), fused.bn_act_plain(x, a, b, act),
                    *BN_TOL[dtype], f"bn_act {str(dtype)[6:]} {shape} {act} (odd)")
    return errs


def flagship_config():
    from text_to_image_tpu_torch.config import Config, DataConfig
    return Config(model="gancls", dtype="bfloat16", seed=SEED,
                  data=DataConfig(dataset_name="synthetic", image_size=64))


def phase_main_path(device):
    """The sampling path at flagship widths, with the launch counts."""
    from text_to_image_tpu_torch.data import get_dataset
    from text_to_image_tpu_torch.eval import sampler
    from text_to_image_tpu_torch.models.registry import get_model
    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    from text_to_image_tpu_torch.utils import prng

    cfg = flagship_config()
    bundle = get_model(cfg)
    policy = L.Policy.from_str(cfg.dtype)
    params32, state = bundle.init(cfg.seed, device)
    ts = sampler.GeneratorState(L.cast_weights(params32, policy), state)
    gen = sampler.make_generator_fn(cfg, device=device)
    emb = get_dataset(cfg).test_embeddings(BATCH)
    g = prng.generator(prng.fold_in(cfg.seed, 1))
    z = torch.randn(BATCH, cfg.gan.z_dim, generator=g)
    rows = min(8, BATCH // 2)   # as main.evaluate: 8 captions × 8 steps
    z1, z2, zt = (torch.randn(rows, cfg.gan.z_dim, generator=g)
                  for _ in range(3))

    counters = (conv.deconv5x5_s2, fused.bn_act)
    for k in counters:
        k.launches = 0
    grid = sampler.sample_grid(gen, ts, cfg, emb, z=z)
    zgrid, zshape = sampler.latent_interpolation_grid(
        gen, ts, cfg, emb[:rows], 8, z1=z1, z2=z2)
    tgrid, tshape = sampler.text_interpolation_grid(
        gen, ts, cfg, emb[:rows], emb[rows:2 * rows], 8, z=zt)
    with torch.inference_mode():
        folded = bundle.gen_apply_inference(
            ts.g_params, ts.g_state, z.to(device), torch.as_tensor(emb).to(device),
            policy).float().cpu()
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in counters}
    log(f"  main-path launches: {launches}")
    # 3 train-mode forwards (4 deconv + 4 bn_act each) + the folded
    # forward (4 deconv + 1 bn_act for its stem)
    check(launches == {"deconv5x5_s2": 16, "bn_act": 13},
          f"unexpected launch counts {launches}")

    for name, imgs in (("sample grid", grid), ("z interpolation", zgrid),
                       ("text interpolation", tgrid),
                       ("folded generator", folded.numpy())):
        imgs = torch.as_tensor(imgs)
        check(tuple(imgs.shape)[1:] == (64, 64, 3), f"{name} {imgs.shape}")
        check(bool(torch.isfinite(imgs).all()), f"{name}: non-finite")
        check(float(imgs.abs().max()) <= 1.0, f"{name}: outside [-1, 1]")
        log(f"  {name}: {tuple(imgs.shape)} finite, in [-1, 1], "
            f"std {float(imgs.std()):.4f}")
    check(zshape == tshape == (rows, 8), "grid shapes")

    # the whole generator against the same code on the CPU (plain versions)
    cpu32 = {k: {n: t.cpu() for n, t in v.items()} for k, v in params32.items()}
    cpu_state = {k: {n: t.cpu() for n, t in v.items()} for k, v in state.items()}
    emb_t = torch.as_tensor(emb)
    g_err = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            pol = L.Policy(compute_dtype=dtype)
            dev_img, _ = bundle.gen_apply(L.cast_weights(params32, pol), state,
                                          z.to(device), emb_t.to(device),
                                          True, pol)
            ref_img, _ = bundle.gen_apply(L.cast_weights(cpu32, pol),
                                          cpu_state, z, emb_t, True, pol)
            g_err[f"train {str(dtype)[6:]}"] = compare(
                dev_img.cpu(), ref_img, G_TOL[dtype], 0,
                f"generator (train mode) {str(dtype)[6:]} vs CPU plain path")
        ref_fold = bundle.gen_apply_inference(L.cast_weights(cpu32, policy),
                                              cpu_state, z, emb_t, policy)
        g_err["folded bfloat16"] = compare(
            folded, ref_fold, G_TOL[torch.bfloat16], 0,
            "folded generator bfloat16 vs CPU plain path")
    return cfg, bundle, ts, gen, z, emb, launches, g_err


def phase_timing(device, cfg, bundle, ts, gen, z, emb):
    import torch.nn.functional as F

    from text_to_image_tpu_torch.ops import layers as L
    from text_to_image_tpu_torch.ops.kernels import conv, fused
    flush = L2Flush(device)
    gen_ = torch.Generator().manual_seed(SEED + 1)
    dtype = torch.bfloat16
    rows = {"deconv5x5_s2": [], "bn_act": []}
    for shape, co, act in DECONV_SHAPES:
        x, w, s, t = deconv_inputs(shape, co, dtype, device, gen_)
        y = conv.deconv5x5_s2(x, w, s, t, act)
        b, h, wd, cin = shape
        # one library call: cuDNN's transposed conv (no epilogue) with the
        # kernel flipped, padding 1, cropped to 2H×2W; NHWC via channels_last
        x_cl = x.permute(0, 3, 1, 2)
        w_t = w.permute(2, 3, 0, 1).flip(2, 3).contiguous()

        def lib():
            return F.conv_transpose2d(x_cl, w_t, stride=2, padding=1)
        lib_y = lib()[:, :, :2 * h, :2 * wd].permute(0, 2, 3, 1)
        plain = conv.deconv5x5_s2_plain(x, w, s, t, "none")
        lib_err = float(((lib_y.float() * s + t) - plain.float()).abs().max())
        flops = 2 * 25 * b * h * wd * cin * co
        bms, by = bound(nbytes(x, w, s, t, y), flops, dtype)
        r = {"shape": [list(shape), co, act],
             "ms": time_ms(lambda: conv.deconv5x5_s2(x, w, s, t, act), flush),
             "plain_ms": time_ms(
                 lambda: conv.deconv5x5_s2_plain(x, w, s, t, act), flush, 5),
             "library_ms": time_ms(lib, flush),
             "bound_ms": bms, "bound_by": by,
             "library_max_abs_err_vs_plain": lib_err}
        r["tflops"] = flops / r["ms"] / 1e9
        rows["deconv5x5_s2"].append(r)
        log(f"  deconv5x5_s2 {shape}->{co}: {r['ms']:.4f} ms (bound "
            f"{bms:.4f} by {by}, {r['tflops']:.1f} TFLOP/s), plain "
            f"{r['plain_ms']:.4f}, cuDNN {r['library_ms']:.4f} ms")
    for shape in BN_SHAPES:
        x, a, b = bn_inputs(shape, dtype, device, gen_)
        y = fused.bn_act(x, a, b, "relu")
        a16, b16 = a.to(dtype), b.to(dtype)
        bms, by = bound(nbytes(x, a, b, y), 2 * x.numel(), torch.float32)
        r = {"shape": [list(shape), "relu"],
             "ms": time_ms(lambda: fused.bn_act(x, a, b, "relu"), flush),
             "plain_ms": time_ms(lambda: fused.bn_act_plain(x, a, b, "relu"),
                                 flush),
             # eager torch: addcmul + in-place relu (two launches)
             "library_ms": time_ms(
                 lambda: torch.addcmul(b16, x, a16).relu_(), flush),
             "bound_ms": bms, "bound_by": by}
        r["gbytes_per_s"] = nbytes(x, a, b, y) / r["ms"] / 1e6
        rows["bn_act"].append(r)
        log(f"  bn_act {shape}: {r['ms']:.4f} ms (bound {bms:.4f} by {by},"
            f" {r['gbytes_per_s']:.0f} GB/s), plain {r['plain_ms']:.4f}, "
            f"torch {r['library_ms']:.4f} ms")

    # sampling throughput at batch 64 (device-resident z, emb; host clock
    # around synchronised windows)
    policy = L.Policy.from_str(cfg.dtype)
    zd, ed = z.to(device), torch.as_tensor(emb).to(device)
    fold = torch.inference_mode()(
        lambda: bundle.gen_apply_inference(ts.g_params, ts.g_state, zd, ed,
                                           policy))
    rates = {}
    for name, fn in (("train_mode", lambda: gen(ts.g_params, ts.g_state,
                                                zd, ed)),
                     ("folded", fold)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        samples = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            samples.append(20 * BATCH / (time.perf_counter() - t0))
        rates[name] = sorted(samples)[2]
        log(f"  sampling {name}: {rates[name]:.1f} images/s (median of 5 "
            f"windows of 20 batches of {BATCH})")
    return rows, rates


def kernel_family(name: str) -> str:
    for key, fam in (("deconv5x5_s2", "deconv5x5_s2 (CUDA)"),
                     ("bn_act", "bn_act (Triton)"), ("gemm", "linear (cuBLAS)"),
                     ("reduce", "BN statistics (torch reductions)")):
        if key in name.lower():
            return fam
    return "other torch elementwise / copies"


def phase_profile(gen, ts, z, emb, device, rate):
    """Device time per train-mode forward by kernel family (torch.profiler,
    CUPTI), and the device's busy share of the unprofiled forward time."""
    from torch.profiler import ProfilerActivity, profile
    zd, ed = z.to(device), torch.as_tensor(emb).to(device)
    for _ in range(3):
        gen(ts.g_params, ts.g_state, zd, ed)
    torch.cuda.synchronize()
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            gen(ts.g_params, ts.g_state, zd, ed)
        torch.cuda.synchronize()
    fams: dict = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = kernel_family(e.key)
        fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3 / n
        launches += e.count
    busy = sum(fams.values())
    wall = BATCH / rate * 1e3
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log(f"  {fam}: {ms:.4f} ms per forward ({ms / busy:.1%} of device time)")
    log(f"  device busy {busy:.4f} ms of {wall:.4f} ms per forward "
        f"(idle share {1 - busy / wall:.1%}); {launches / n:.0f} kernel "
        f"launches per forward")
    return {"ms_per_forward_by_family": fams, "device_busy_ms": busy,
            "forward_ms": wall, "idle_share": 1 - busy / wall,
            "kernels_per_forward": launches / n}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from text_to_image_tpu_torch.ops.kernels import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.build(_build.sources())
    log(f"  nvcc built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("phase 2: kernels vs plain versions at the main-path shapes")
    t0 = time.perf_counter()
    errs = phase_kernels(device)
    log(f"  ({time.perf_counter() - t0:.1f} s, Triton compile included)")

    log("phase 3: sampling path at flagship widths, batch 64, bf16")
    cfg, bundle, ts, gen, z, emb, launches, g_err = phase_main_path(device)

    log("phase 4: timing")
    rows, rates = phase_timing(device, cfg, bundle, ts, gen, z, emb)

    log("phase 5: where a train-mode forward's device time goes")
    profile = phase_profile(gen, ts, z, emb, device, rates["train_mode"])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]

    src = "text_to_image_tpu_torch/"
    meta = {
        "deconv5x5_s2": ("cuda", src + "csrc/deconv5x5_s2.cu",
                         "text_to_image_tpu/ops/pallas/conv.py:146"),
        "bn_act": ("triton", src + "ops/kernels/fused.py",
                   "text_to_image_tpu/ops/pallas/fused.py:259"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        per = rows[name]
        ops_share = sum(r["bound_ms"] for r in per if r["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v for (dt, _), v in errs[name].items()
                               if dt == torch.bfloat16),
            # one generator forward's worth: the sum over the four shapes
            "ms": sum(r["ms"] for r in per),
            "plain_ms": sum(r["plain_ms"] for r in per),
            "bound_ms": sum(r["bound_ms"] for r in per),
            "bound_by": ("operations" if ops_share * 2 > sum(
                r["bound_ms"] for r in per) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in per),
            "shapes": per,
        })

    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "kernels": kernels,
              "kernel_errors": {f"{n} {str(dt)[6:]} {list(s)}": v
                                for n, d in errs.items()
                                for (dt, s), v in d.items()},
              "generator_errors": g_err, "sampling_images_per_s": rates,
              "profile": profile}
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
