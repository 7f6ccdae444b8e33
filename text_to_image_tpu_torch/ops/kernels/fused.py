"""Train-mode batch norm, ``bn_act`` and ``conditioning_join``: the fused
BN and text-join kernels (counterpart of ``text_to_image_tpu/ops/pallas/
fused.py`` and of the BN statistics around its ``bn_act``).

``batch_norm_train(x, γ, β, mean, var, streams, act)``: train-mode BN +
activation over x's S contiguous streams, each with its own f32 batch
statistics.  Replaces `bn_act` (Pallas body `_bn_act_kernel` via
`_bn_act_core`) with the XLA statistics and backward around it; the CUDA
kernels, their bound and design are in ``csrc/batch_norm.cu``: `bn_stats`
(Welford statistics, a, b and the running state in one launch) and `bn_act`
(the apply pass) forward, `bn_bwd_reduce` and `bn_bwd_apply` backward, each
with its plain PyTorch version (``*_plain``) and launch counter, on one grid
(`bn_plan`, the mirror of the C plan).  In the data-parallel tick the
statistics are the global batch's, as the JAX package's under data
parallelism: `bn_partials` (each rank's Welford state) and `bn_finish` (the
ranks' states merged) take `bn_stats`' place around an all-gather.
``bn_act(x, a, b, act) = act(x·a + b)`` alone is the public op of eval-mode
BN and the folded stem.

``conditioning_join(x, t, wx, wt, bias, act) = act(x·wx + t·wt + bias)``:
the discriminator's ``conv1x1(concat(x, tile(t)))`` without the concat.
Replaces `conditioning_join` (Pallas body `_join_kernel` via `_join_core`);
the CUDA kernel and its bound are in ``csrc/conditioning_join.cu``: one
launch that folds the text term into the GEMM's K, rows ``[x ; t]`` against
``[wx ; wt]`` (`join_path`: the convolution's wgmma main loop with two taps
for aligned bf16, a simple f32-FMA tile otherwise).

All are differentiable (`torch.autograd.Function`).  The backwards of
`bn_act` and the join are the JAX package's `_bn_act_bwd` and `_join_bwd` in
plain torch; every activation derivative is recovered from the saved
output, so no pre-activation tensor is kept.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from text_to_image_tpu_torch.ops.kernels import _build
from text_to_image_tpu_torch.parallel import collectives
from text_to_image_tpu_torch.utils import profiling

ACT_CODES = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}
_DTYPES = (torch.bfloat16, torch.float32)


def apply_act(y: torch.Tensor, act: str) -> torch.Tensor:
    """The JAX package's `_ACTS`: none, relu, lrelu (x >= 0, slope 0.2), tanh."""
    if act == "none":
        return y
    if act == "relu":
        return torch.relu(y)
    if act == "lrelu":
        return torch.where(y >= 0, y, 0.2 * y)
    if act == "tanh":
        return torch.tanh(y)
    raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")


def acc(t: torch.Tensor) -> torch.Tensor:
    """t in the type the plain versions compute in: f32, or f64 for f64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def act_grad_from_output(act: str, y: torch.Tensor) -> torch.Tensor:
    """d act(p)/dp from y = act(p), in f32 (`_act_grad_from_output`; f64
    for f64 y): valid because every activation here is monotone with
    sign(y) = sign(p)."""
    y32 = acc(y)
    if act == "none":
        return torch.ones_like(y32)
    if act == "relu":
        return (y32 > 0).to(y32.dtype)
    if act == "lrelu":   # the slope as a scalar of y's type: no fill pass
        return torch.where(y32 >= 0, 1.0, torch.tensor(0.2, dtype=y32.dtype))
    if act == "tanh":
        return 1.0 - y32 * y32
    raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")


def needs_grad(*ts: torch.Tensor) -> bool:
    """True when autograd must record this call."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ============================== batch norm ===================================
# csrc/batch_norm.cu: the train-mode batch norm of a call is bn_stats + bn_act
# forward and bn_bwd_reduce + bn_bwd_apply backward; bn_act alone is the
# public op (eval-mode BN, the folded stem).  x is NHWC seen as [S·R, C]: S
# contiguous streams of R rows, each with its own batch statistics.

# the constants of csrc/batch_norm.cu's plan
BN_THREADS = 256
BN_VEC = 8             # channels a thread owns
BN_TPR = 8             # most threads a row: a CTA covers 64 channels
BN_UNROLL = 4          # rows in flight a lane
BN_CTAS_PER_SM = 2
BN_MAX_CHUNKS = 4096   # ticket counters at the head of the workspace
BN_SLOT = 1 + 2 * BN_TPR * BN_VEC   # floats of one CTA's partial


class BnPlan(NamedTuple):
    """The grid of every batch-norm launch over one x (csrc `Plan`)."""

    vec: int        # 1: 16-byte vectors (C % 8 == 0, aligned); 0: elements
    groups: int     # groups of 8 channels, ceil(C / 8)
    tpr: int        # groups a CTA covers (threads a row)
    chunks: int     # channel slices, ceil(groups / tpr): the grid's x
    lanes: int      # row lanes of a CTA, 256 // tpr
    bands: int      # CTAs per stream and slice: the grid's y is S·bands
    band_rows: int  # rows of a band
    ws_bytes: int   # the workspace bn_stats and bn_bwd_reduce need


@functools.lru_cache(maxsize=4096)
def bn_plan(rows: int, streams: int, c: int, aligned: bool = True,
            sms: int = 132) -> BnPlan:
    """The Python mirror of `make_plan` in csrc/batch_norm.cu: x of `rows`
    rows of `c` channels in `streams` streams on a card of `sms` SMs.

    A thread owns 8 channels, a CTA 64 (or C below that) and 256 // tpr row
    lanes; each stream's R rows are cut into bands, as many as give
    BN_CTAS_PER_SM CTAs an SM over the whole grid but no fewer than
    BN_UNROLL rows a lane.  Raises ValueError where no launch is made."""
    if streams < 1 or c < 1 or rows < streams or rows % streams or sms < 1:
        raise ValueError(f"{streams} streams do not divide {rows} rows "
                         f"(C = {c}, {sms} SMs)")
    r = rows // streams
    groups = -(-c // BN_VEC)
    tpr = min(groups, BN_TPR)
    chunks = -(-groups // tpr)
    if chunks > BN_MAX_CHUNKS:
        raise ValueError(f"C = {c} over the kernel's {BN_MAX_CHUNKS} slices")
    lanes = BN_THREADS // tpr
    fill = BN_CTAS_PER_SM * sms // (chunks * streams)
    most = -(-r // (lanes * BN_UNROLL))
    band_rows = -(-r // max(1, min(fill, most)))
    bands = -(-r // band_rows)
    if bands > 65535 // streams:
        raise ValueError(f"{streams}×{bands} bands over the grid's 65535")
    return BnPlan(int(c % BN_VEC == 0 and aligned), groups, tpr, chunks,
                  lanes, bands, band_rows,
                  4 * BN_MAX_CHUNKS + 4 * BN_SLOT * chunks * streams * bands)


def _bn_lib() -> ctypes.CDLL:
    ptr, integer, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
    return _build.bind("batch_norm", {
        # x, p1, p2, p3; rows, S, C, sms; out[8]
        "t2i_bn_plan": [ptr] * 4 + [i64] + [integer] * 3 + [ptr],
        # x, gamma, beta, run_mean, run_var, out, ws; ws_bytes, rows; S, C,
        # bf16; momentum, 1 - momentum, eps; sms; stream
        "t2i_bn_stats": [ptr] * 7 + [i64, i64] + [integer] * 3 + [f32] * 3
                        + [integer, ptr],
        # x, a, b, y; rows; S, C, act, bf16, sms; stream
        "t2i_bn_act": [ptr] * 4 + [i64] + [integer] * 5 + [ptr],
        # g, y, x, mean, rstd, out, ws; ws_bytes, rows; S, C, act, bf16,
        # sms; stream
        "t2i_bn_bwd_reduce": [ptr] * 7 + [i64, i64] + [integer] * 5 + [ptr],
        # g, y, x, mean, rstd, gamma, sga, sgx, dx; rows, count; S, C, act,
        # bf16, sms; stream
        "t2i_bn_bwd_apply": [ptr] * 9 + [i64, i64] + [integer] * 5 + [ptr],
        # x, out, ws; ws_bytes, rows; S, C, bf16, sms; stream
        "t2i_bn_partials": [ptr] * 3 + [i64, i64] + [integer] * 4 + [ptr],
        # parts; D; gamma, beta, run_mean, run_var, out; S, C; momentum,
        # 1 - momentum, eps; stream
        "t2i_bn_finish": [ptr, integer] + [ptr] * 5 + [integer] * 2
                         + [f32] * 3 + [ptr]})


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def bn_plan_on_card(x: torch.Tensor, streams: int, *others) -> BnPlan:
    """The plan the C entry point itself makes for x and the call's other
    full-size tensors (None where absent)."""
    c = x.shape[-1]
    out = (ctypes.c_longlong * 8)()
    ptrs = [t.data_ptr() if t is not None else None for t in others]
    rc = _bn_lib().t2i_bn_plan(x.data_ptr(), *(ptrs + [None] * 3)[:3],
                               x.numel() // c, streams, c,
                               _sms(x.device.index), out)
    if rc != 0:
        raise ValueError(f"no batch-norm launch takes x {tuple(x.shape)} in "
                         f"{streams} streams")
    return BnPlan(*out)


_BN_WS: Dict[int, torch.Tensor] = {}


def _bn_workspace(device: torch.device, nbytes: int) -> torch.Tensor:
    """The device's workspace of bn_stats and bn_bwd_reduce: the ticket
    counters, then the CTAs' partials.  Allocated zeroed on first use and
    again when a call needs more; every launch leaves its counters at 0, and
    the launches on one stream run in order, so all calls share it."""
    ws = _BN_WS.get(device.index)
    if ws is None or ws.numel() < nbytes:
        ws = torch.zeros(max(nbytes, 1 << 20), dtype=torch.uint8, device=device)
        _BN_WS[device.index] = ws
    return ws


def _bn_check(x: torch.Tensor, streams: int, act: str, per_channel=(),
              per_stream=()) -> None:
    """What every batch-norm launch needs: x bf16 or f32, contiguous, its
    batch cut into `streams` equal streams; each (name, tensor) of
    `per_channel` f32 [C] and of `per_stream` f32 [S, C], contiguous, on
    x's device."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"batch norm takes bf16 or f32 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if (x.dim() < 2 or streams < 1 or x.shape[0] % streams
            or x.numel() < streams * x.shape[-1]):
        raise ValueError(f"{streams} streams do not divide the batch of "
                         f"{tuple(x.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")
    c = x.shape[-1]
    for (name, v), want in ([(nv, (c,)) for nv in per_channel]
                            + [(nv, (streams, c)) for nv in per_stream]):
        if v.dtype != torch.float32 or tuple(v.shape) != want:
            raise ValueError(f"{name} must be float32 {list(want)}, got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _on_card(x: torch.Tensor, op: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for CUDA."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {x.device}")
    return True


def _rc(rc: int, op: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")


def _streamed(t: torch.Tensor, streams: int) -> torch.Tensor:
    """[S·R, …, C] → [S, R·…, C] in the plain versions' type."""
    return acc(t).reshape(streams, -1, t.shape[-1])


# --- bn_stats -------------------------------------------------------------

def bn_stats_plain(x: torch.Tensor, streams: int, gamma: torch.Tensor,
                   beta: torch.Tensor, run_mean: torch.Tensor,
                   run_var: torch.Tensor, momentum: float = 0.9,
                   eps: float = 1e-5):
    """The plain PyTorch version of `bn_stats`: per stream the f32 batch
    mean and biased variance, rstd = rsqrt(var + eps), a = γ·rstd and
    b = β − mean·a; the new running state is the mean over streams of
    ``momentum·old + (1 − momentum)·batch``."""
    var, mean = torch.var_mean(_streamed(x, streams), dim=1, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    a = rstd * acc(gamma)
    b = acc(beta) - mean * a
    new_mean = (momentum * acc(run_mean) + (1.0 - momentum) * mean).mean(0)
    new_var = (momentum * acc(run_var) + (1.0 - momentum) * var).mean(0)
    return mean, rstd, a, b, new_mean, new_var


@profiling.spanned("kernels.bn_stats")
def bn_stats(x: torch.Tensor, streams: int, gamma: torch.Tensor,
             beta: torch.Tensor, run_mean: torch.Tensor,
             run_var: torch.Tensor, momentum: float = 0.9, eps: float = 1e-5):
    """(mean, rstd, a, b) f32 [S, C] and the new running (mean, var) f32 [C]
    of x's S streams, in one launch.  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if not _on_card(x, "bn_stats"):
        return bn_stats_plain(x, streams, gamma, beta, run_mean, run_var,
                              momentum, eps)
    _bn_check(x, streams, "none", (("gamma", gamma), ("beta", beta),
                                   ("run_mean", run_mean),
                                   ("run_var", run_var)))
    c = x.shape[-1]
    rows = x.numel() // c
    sc = streams * c
    sms = _sms(x.device.index)
    ws = _bn_workspace(x.device, bn_plan(rows, streams, c, sms=sms).ws_bytes)
    out = torch.empty(4 * sc + 2 * c, dtype=torch.float32, device=x.device)
    _rc(_bn_lib().t2i_bn_stats(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), run_mean.data_ptr(),
        run_var.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), rows,
        streams, c, int(x.dtype == torch.bfloat16), momentum, 1.0 - momentum,
        eps, sms, torch.cuda.current_stream(x.device).cuda_stream), "bn_stats")
    bn_stats.launches += 1
    return (*out[:4 * sc].view(4, streams, c), out[4 * sc:4 * sc + c],
            out[4 * sc + c:])


bn_stats.launches = 0


# --- bn_partials, bn_finish: the statistics over a batch group -------------

def bn_partials_plain(x: torch.Tensor, streams: int) -> torch.Tensor:
    """The plain PyTorch version of `bn_partials`: per stream its row count
    n (repeated over the channels), mean and M2 = n·(biased variance), f32
    [3, S, C]."""
    xs = _streamed(x, streams)
    var, mean = torch.var_mean(xs, dim=1, unbiased=False)
    n = torch.full_like(mean, xs.shape[1])
    return torch.stack([n, mean, var * n])


@profiling.spanned("kernels.bn_partials")
def bn_partials(x: torch.Tensor, streams: int) -> torch.Tensor:
    """Each stream's Welford state (n, mean, M2) f32 [3, S, C] in one
    launch: `bn_stats` stopping before the statistics, for `bn_finish` to
    merge with the other ranks' partials.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not _on_card(x, "bn_partials"):
        return bn_partials_plain(x, streams)
    _bn_check(x, streams, "none")
    c = x.shape[-1]
    rows = x.numel() // c
    sms = _sms(x.device.index)
    ws = _bn_workspace(x.device, bn_plan(rows, streams, c, sms=sms).ws_bytes)
    out = torch.empty(3, streams, c, dtype=torch.float32, device=x.device)
    _rc(_bn_lib().t2i_bn_partials(
        x.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), rows,
        streams, c, int(x.dtype == torch.bfloat16), sms,
        torch.cuda.current_stream(x.device).cuda_stream), "bn_partials")
    bn_partials.launches += 1
    return out


bn_partials.launches = 0


def bn_finish_plain(parts: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, run_mean: torch.Tensor,
                    run_var: torch.Tensor, momentum: float = 0.9,
                    eps: float = 1e-5):
    """The plain PyTorch version of `bn_finish`: the D partials [D, 3, S, C]
    merged by Chan's formula in rank order, then `bn_stats_plain`'s
    formulas."""
    n, mean, m2 = (torch.zeros_like(p) for p in acc(parts[0]))
    for nb, mb, m2b in acc(parts):      # every partial holds n >= 1 rows
        nt = n + nb
        fb = nb / nt
        cross = n * fb
        delta = mb - mean
        mean = mean + delta * fb
        m2 = m2 + (m2b + delta * delta * cross)
        n = nt
    var = m2 / n
    rstd = torch.rsqrt(var + eps)
    a = rstd * acc(gamma)
    b = acc(beta) - mean * a
    new_mean = (momentum * acc(run_mean) + (1.0 - momentum) * mean).mean(0)
    new_var = (momentum * acc(run_var) + (1.0 - momentum) * var).mean(0)
    return mean, rstd, a, b, new_mean, new_var


@profiling.spanned("kernels.bn_finish")
def bn_finish(parts: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              run_mean: torch.Tensor, run_var: torch.Tensor,
              momentum: float = 0.9, eps: float = 1e-5):
    """`bn_stats`' outputs, (mean, rstd, a, b) f32 [S, C] and the new
    running (mean, var) f32 [C], of the batch whose D pieces gave the
    partials `parts` f32 [D, 3, S, C] (`bn_partials` of each rank, in rank
    order), in one launch.  The merge order is fixed, so every rank gets the
    same bits.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if not _on_card(parts, "bn_finish"):
        return bn_finish_plain(parts, gamma, beta, run_mean, run_var,
                               momentum, eps)
    if (parts.dtype != torch.float32 or parts.dim() != 4
            or parts.shape[1] != 3 or not parts.is_contiguous()):
        raise ValueError(f"parts must be contiguous float32 [D, 3, S, C], got "
                         f"{parts.dtype} {tuple(parts.shape)}")
    d, _, streams, c = parts.shape
    for name, v in (("gamma", gamma), ("beta", beta), ("run_mean", run_mean),
                    ("run_var", run_var)):
        if (v.dtype != torch.float32 or tuple(v.shape) != (c,)
                or v.device != parts.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 [{c}] on "
                             f"{parts.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")
    sc = streams * c
    out = torch.empty(4 * sc + 2 * c, dtype=torch.float32,
                      device=parts.device)
    _rc(_bn_lib().t2i_bn_finish(
        parts.data_ptr(), d, gamma.data_ptr(), beta.data_ptr(),
        run_mean.data_ptr(), run_var.data_ptr(), out.data_ptr(), streams, c,
        momentum, 1.0 - momentum, eps,
        torch.cuda.current_stream(parts.device).cuda_stream), "bn_finish")
    bn_finish.launches += 1
    return (*out[:4 * sc].view(4, streams, c), out[4 * sc:4 * sc + c],
            out[4 * sc + c:])


bn_finish.launches = 0


# --- bn_act -----------------------------------------------------------------

def bn_act_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 act: str = "relu") -> torch.Tensor:
    """The plain PyTorch version: f32 affine + activation, cast back; a and
    b are [C], or [S, C] for S streams of x."""
    c = x.shape[-1]
    a2, b2 = acc(a).reshape(-1, 1, c), acc(b).reshape(-1, 1, c)
    y = apply_act(_streamed(x, a2.shape[0]) * a2 + b2, act)
    return y.reshape(x.shape).to(x.dtype)


def _check(x, a, b, act):
    """The checks of the public `bn_act`: a and b f32 [C] or [S, C]."""
    ab = (("a", a), ("b", b))
    if a.dim() == 2:
        _bn_check(x, a.shape[0], act, per_stream=ab)
    else:
        _bn_check(x, 1, act, per_channel=ab)


@profiling.spanned("kernels.bn_act")
def _bn_act_forward(x, a, b, act):
    if not _on_card(x, "bn_act"):
        return bn_act_plain(x, a, b, act)
    _check(x, a, b, act)
    c = x.shape[-1]
    streams = a.shape[0] if a.dim() == 2 else 1
    y = torch.empty_like(x)
    _rc(_bn_lib().t2i_bn_act(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        x.numel() // c, streams, c, ACT_CODES[act],
        int(x.dtype == torch.bfloat16), _sms(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream), "bn_act")
    bn_act.launches += 1
    return y


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, act):
        y = _bn_act_forward(x, a, b, act)
        ctx.act = act
        ctx.save_for_backward(x, a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _bn_act_bwd per stream: dx = g·act'·a, da = Σ g·act'·x, db = Σ g·act'
        x, a, y = ctx.saved_tensors
        streams = a.shape[0] if a.dim() == 2 else 1
        ga = _streamed(g.float() * act_grad_from_output(ctx.act, y), streams)
        a2 = a.reshape(streams, 1, -1)
        dx = (ga * a2).reshape(x.shape).to(x.dtype)
        da = ((ga * _streamed(x, streams)).sum(1).reshape(a.shape)
              if ctx.needs_input_grad[1] else None)
        db = ga.sum(1).reshape(a.shape) if ctx.needs_input_grad[2] else None
        return dx, da, db, None


def bn_act(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           act: str = "relu") -> torch.Tensor:
    """``act(x·a + b)`` over channels-last x with per-channel f32 a, b ([C],
    or [S, C] for S streams of x): one read and one write of x.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    Differentiable in x, a, b."""
    if needs_grad(x, a, b):
        return _BnAct.apply(x, a, b, act)
    return _bn_act_forward(x, a, b, act)


bn_act.launches = 0


# --- the backward: bn_bwd_reduce, bn_bwd_apply ---------------------------------

def _grad_act(g, y, act, streams):
    """ga = g·act'(y) in f32 [S, R, C] (act' from the saved output)."""
    ga = acc(g) if act == "none" else acc(g) * act_grad_from_output(act, y)
    return _streamed(ga, streams)


def _xhat(x, mean, rstd, streams):
    return (_streamed(x, streams) - mean[:, None]) * rstd[:, None]


def bn_bwd_reduce_plain(g: torch.Tensor, y, x: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, streams: int,
                        act: str):
    """The plain PyTorch version of `bn_bwd_reduce`: per stream Σ ga and
    Σ ga·x̂ [S, C] (ga = g·act'(y), x̂ = (x − mean)·rstd), then dγ and dβ
    [C], their sums over the streams."""
    ga = _grad_act(g, y, act, streams)
    sga = ga.sum(1)
    sgx = (ga * _xhat(x, mean, rstd, streams)).sum(1)
    return sga, sgx, sgx.sum(0), sga.sum(0)


@profiling.spanned("kernels.bn_bwd_reduce")
def bn_bwd_reduce(g: torch.Tensor, y, x: torch.Tensor, mean: torch.Tensor,
                  rstd: torch.Tensor, streams: int, act: str):
    """(Σ ga, Σ ga·x̂) f32 [S, C] and (dγ, dβ) f32 [C] in one launch; y (the
    saved output) may be None for act "none".  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if not _on_card(x, "bn_bwd_reduce"):
        return bn_bwd_reduce_plain(g, y, x, mean, rstd, streams, act)
    _bwd_check(g, y, x, mean, rstd, streams, act)
    c = x.shape[-1]
    rows = x.numel() // c
    sc = streams * c
    ws = _bn_workspace(x.device, bn_plan(rows, streams, c,
                                         sms=_sms(x.device.index)).ws_bytes)
    out = torch.empty(2 * sc + 2 * c, dtype=torch.float32, device=x.device)
    _rc(_bn_lib().t2i_bn_bwd_reduce(
        g.data_ptr(), y.data_ptr() if act != "none" else None, x.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), out.data_ptr(), ws.data_ptr(),
        ws.numel(), rows, streams, c, ACT_CODES[act],
        int(x.dtype == torch.bfloat16), _sms(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream), "bn_bwd_reduce")
    bn_bwd_reduce.launches += 1
    return (*out[:2 * sc].view(2, streams, c), out[2 * sc:2 * sc + c],
            out[2 * sc + c:])


bn_bwd_reduce.launches = 0


def bn_bwd_apply_plain(g: torch.Tensor, y, x: torch.Tensor,
                       mean: torch.Tensor, rstd: torch.Tensor,
                       gamma: torch.Tensor, sga: torch.Tensor,
                       sgx: torch.Tensor, streams: int, act: str,
                       count: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of `bn_bwd_apply`: the exact gradient
    through the batch statistics, dx = γ·rstd·(ga − Σga/R − x̂·Σ(ga·x̂)/R)
    per stream, in x's dtype; R = `count` (default: x's rows a stream)."""
    ga = _grad_act(g, y, act, streams)
    r = ga.shape[1] if count is None else count
    dx = (acc(gamma) * rstd)[:, None] * (
        ga - (sga / r)[:, None] - _xhat(x, mean, rstd, streams)
        * (sgx / r)[:, None])
    return dx.reshape(x.shape).to(x.dtype)


@profiling.spanned("kernels.bn_bwd_apply")
def bn_bwd_apply(g: torch.Tensor, y, x: torch.Tensor, mean: torch.Tensor,
                 rstd: torch.Tensor, gamma: torch.Tensor, sga: torch.Tensor,
                 sgx: torch.Tensor, streams: int, act: str,
                 count: Optional[int] = None) -> torch.Tensor:
    """dx of the train-mode BN in one launch (g, y, x read once, dx
    written); the sums are over `count` rows a stream (default: x's; the
    global rows when they were all-reduced over a batch group).  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if not _on_card(x, "bn_bwd_apply"):
        return bn_bwd_apply_plain(g, y, x, mean, rstd, gamma, sga, sgx,
                                  streams, act, count)
    _bwd_check(g, y, x, mean, rstd, streams, act, (("gamma", gamma),),
               (("sga", sga), ("sgx", sgx)))
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x)
    _rc(_bn_lib().t2i_bn_bwd_apply(
        g.data_ptr(), y.data_ptr() if act != "none" else None, x.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), gamma.data_ptr(), sga.data_ptr(),
        sgx.data_ptr(), dx.data_ptr(), rows,
        rows // streams if count is None else count, streams, c,
        ACT_CODES[act], int(x.dtype == torch.bfloat16), _sms(x.device.index),
        torch.cuda.current_stream(x.device).cuda_stream), "bn_bwd_apply")
    bn_bwd_apply.launches += 1
    return dx


bn_bwd_apply.launches = 0


def _bwd_check(g, y, x, mean, rstd, streams, act, per_channel=(),
               per_stream=()):
    _bn_check(x, streams, act, per_channel,
              (("mean", mean), ("rstd", rstd), *per_stream))
    for name, t in (("g", g), ("y", y if act != "none" else x)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name} must match x ({tuple(x.shape)} "
                             f"{x.dtype}), got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# --- the train-mode batch norm ----------------------------------------------

def _bn_train_forward(x, gamma, beta, run_mean, run_var, streams, act,
                      momentum, eps, sync):
    """bn_stats then bn_act over its a and b: two launches, nothing else.
    Over a batch group (`sync`): bn_partials, their all-gather, bn_finish,
    then bn_act."""
    if sync is None:
        stats = bn_stats(x, streams, gamma, beta, run_mean, run_var,
                         momentum, eps)
    else:
        parts = collectives.all_gather(bn_partials(x, streams), sync)
        stats = bn_finish(parts, gamma, beta, run_mean, run_var, momentum,
                          eps)
    mean, rstd, a, b, new_mean, new_var = stats
    return _bn_act_forward(x, a, b, act), mean, rstd, new_mean, new_var


class _BatchNormAct(torch.autograd.Function):
    """Train-mode BN + activation of S streams: bn_stats + bn_act forward,
    bn_bwd_reduce + bn_bwd_apply backward (the exact gradient through the
    statistics).  The running state is an output without gradient.  Nothing
    differentiates a batch norm twice (WGAN-CLS's critic uses layer norm).

    Over a batch group the backward all-reduces bn_bwd_reduce's per-stream
    sums and bn_bwd_apply divides by the global rows of a stream, so each
    rank's dx is the gradient of the sum of every rank's loss (the sum the
    tick's gradient all-reduce averages); dγ and dβ stay this rank's and
    are averaged with the other parameter gradients."""

    @staticmethod
    def forward(ctx, x, gamma, beta, run_mean, run_var, streams, act,
                momentum, eps, sync):
        y, mean, rstd, new_mean, new_var = _bn_train_forward(
            x, gamma, beta, run_mean, run_var, streams, act, momentum, eps,
            sync)
        ctx.streams, ctx.act, ctx.sync = streams, act, sync
        ctx.save_for_backward(x, gamma, y if act != "none" else None, mean,
                              rstd)
        ctx.mark_non_differentiable(new_mean, new_var)
        ctx.set_materialize_grads(False)   # no zero fills for the state
        return y, new_mean, new_var

    @staticmethod
    @once_differentiable
    def backward(ctx, g, _mean_grad, _var_grad):
        if g is None:
            return (None,) * 10
        x, gamma, y, mean, rstd = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        sga, sgx, dgamma, dbeta = bn_bwd_reduce(g, y, x, mean, rstd,
                                                ctx.streams, ctx.act)
        count = None
        if ctx.sync is not None:
            sga, sgx = collectives.all_reduce_sum(torch.stack([sga, sgx]),
                                                  ctx.sync)
            count = x.numel() // x.shape[-1] // ctx.streams * ctx.sync.size
        need = ctx.needs_input_grad
        dx = (bn_bwd_apply(g, y, x, mean, rstd, gamma, sga, sgx, ctx.streams,
                           ctx.act, count) if need[0] else None)
        return (dx, dgamma if need[1] else None, dbeta if need[2] else None,
                None, None, None, None, None, None, None)


def batch_norm_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     run_mean: torch.Tensor, run_var: torch.Tensor,
                     streams: int = 1, act: str = "none",
                     momentum: float = 0.9, eps: float = 1e-5):
    """Train-mode batch norm + activation over x's S contiguous streams (each
    with its own f32 batch statistics, biased variance): returns (y, new
    running mean, new running var), the state the mean over streams of each
    stream's ``momentum·old + (1 − momentum)·batch``.  γ (`gamma`), β and the
    running state are f32 [C].  On the card two launches forward (bn_stats,
    bn_act) and two backward (bn_bwd_reduce, bn_bwd_apply); CPU tensors take
    the plain versions.  Differentiable in x, γ and β.

    Inside `collectives.batch_sync` (the data-parallel tick) x is this
    rank's piece of every stream and the statistics are the whole stream's
    over the batch group: three launches forward (bn_partials, bn_finish
    around an all-gather, bn_act), two backward around an all-reduce."""
    sync = collectives.active()
    if needs_grad(x, gamma, beta):
        return _BatchNormAct.apply(x, gamma, beta, run_mean, run_var,
                                   streams, act, momentum, eps, sync)
    y, _, _, new_mean, new_var = _bn_train_forward(
        x, gamma, beta, run_mean, run_var, streams, act, momentum, eps, sync)
    return y, new_mean, new_var


# ========================== conditioning join ================================

def conditioning_join_plain(x: torch.Tensor, t: torch.Tensor,
                            wx: torch.Tensor, wt: torch.Tensor,
                            bias: torch.Tensor, act: str = "none"
                            ) -> torch.Tensor:
    """The plain PyTorch version: the image GEMM plus the per-example text
    row ``t·wt + bias``, in f32, cast back to x's dtype."""
    u = t.float() @ wt.float() + bias.float()                   # [B, Co]
    y = x.float() @ wx.float() + u[:, None, None, :]
    return apply_act(y, act).to(x.dtype)


def _join_lib() -> ctypes.CDLL:
    ptr, integer = ctypes.c_void_p, ctypes.c_int
    return _build.bind("conditioning_join", {
        # x, t, wx, wt, bias, y; B, HW, Cx, E, Co, act, bf16; stream
        "t2i_conditioning_join": [ptr] * 6 + [integer] * 7 + [ptr],
        # x, t, wx, wt, y; Cx, E, Co, bf16
        "t2i_conditioning_join_path": [ptr] * 5 + [integer] * 4})


# The kernel's code paths in the order of the C entry point's codes
# (csrc/conditioning_join.cu `Path`); both make one launch.
JOIN_PATHS = ("simple", "wgmma")


def join_path(cx: int, e: int, co: int, dtype: torch.dtype,
              aligned: bool = True) -> str:
    """The Python mirror of `join_path` in csrc/conditioning_join.cu."""
    ok = (dtype == torch.bfloat16 and aligned and cx > 0 and e > 0
          and cx % 64 == 0 and e % 64 == 0 and co % 64 == 0)
    return "wgmma" if ok else "simple"


def join_path_on_card(x, t, wx, wt, y) -> str:
    """The path the C entry point itself reports for these tensors."""
    return JOIN_PATHS[_join_lib().t2i_conditioning_join_path(
        x.data_ptr(), t.data_ptr(), wx.data_ptr(), wt.data_ptr(),
        y.data_ptr(), x.shape[-1], t.shape[-1], wx.shape[-1],
        int(x.dtype == torch.bfloat16))]


def _join_check(x, t, wx, wt, bias, act):
    if x.dim() != 4 or t.dim() != 2 or t.shape[0] != x.shape[0]:
        raise ValueError(f"x must be [B,H,W,Cx] and t [B,E], got "
                         f"{tuple(x.shape)} and {tuple(t.shape)}")
    cx, e = x.shape[-1], t.shape[-1]
    if wx.dim() != 2 or wx.shape[0] != cx:
        raise ValueError(f"wx must be [{cx},Co], got {tuple(wx.shape)}")
    co = wx.shape[1]
    if tuple(wt.shape) != (e, co):
        raise ValueError(f"wt must be [{e},{co}], got {tuple(wt.shape)}")
    if x.dtype not in _DTYPES or any(v.dtype != x.dtype for v in (t, wx, wt)):
        raise TypeError(f"x, t, wx, wt must share a dtype in {_DTYPES}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (co,):
        raise ValueError(f"bias must be float32 [{co}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    for name, v in (("x", x), ("t", t), ("wx", wx), ("wt", wt),
                    ("bias", bias)):
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if act not in ACT_CODES:
        raise ValueError(f"act {act!r} not in {sorted(ACT_CODES)}")
    if x.numel() // cx * max(cx, co) >= 2**31:
        raise ValueError("tensor too large for the kernel's int32 extents")


@profiling.spanned("kernels.conditioning_join")
def _join_forward(x, t, wx, wt, bias, act):
    if x.device.type == "cpu":
        return conditioning_join_plain(x, t, wx, wt, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"conditioning_join runs on cuda or cpu, not {x.device}")
    _join_check(x, t, wx, wt, bias, act)
    b, h, w, cx = x.shape
    e, co = wt.shape
    y = torch.empty(b, h, w, co, dtype=x.dtype, device=x.device)
    rc = _join_lib().t2i_conditioning_join(
        x.data_ptr(), t.data_ptr(), wx.data_ptr(), wt.data_ptr(),
        bias.data_ptr(), y.data_ptr(), b, h * w, cx, e, co,
        ACT_CODES[act], int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conditioning_join kernel launch failed: CUDA "
                           f"error {rc}")
    conditioning_join.launches += 1
    return y


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, t, wx, wt, bias, act):
        y = _join_forward(x, t, wx, wt, bias, act)
        ctx.act = act
        ctx.save_for_backward(x, t, wx, wt, y)
        return y

    @staticmethod
    def backward(ctx, g):
        # _join_bwd: the image GEMM's two adjoints, the text row's through
        # the spatial sum of the gradient
        x, t, wx, wt, y = ctx.saved_tensors
        ga = g.float() * act_grad_from_output(ctx.act, y)       # [B,H,W,Co]
        ga_c = ga.to(x.dtype)
        ga_sum = ga.sum((1, 2))                                  # [B, Co]
        need = ctx.needs_input_grad
        dx = ga_c @ wx.t() if need[0] else None
        dt = ga_sum.to(t.dtype) @ wt.t() if need[1] else None
        dwx = (x.reshape(-1, x.shape[-1]).t()
               @ ga_c.reshape(-1, ga_c.shape[-1])) if need[2] else None
        dwt = t.t() @ ga_sum.to(t.dtype) if need[3] else None
        db = ga.sum((0, 1, 2)) if need[4] else None
        return dx, dt, dwx, dwt, db, None


def conditioning_join(x: torch.Tensor, t: torch.Tensor, wx: torch.Tensor,
                      wt: torch.Tensor, bias: torch.Tensor, act: str = "none"
                      ) -> torch.Tensor:
    """Fused ``act(conv1x1(concat(x, tile(t))))`` = ``act(x·wx + t·wt +
    bias)``.

    x [B,H,W,Cx], t [B,E], wx [Cx,Co], wt [E,Co] share a dtype (bf16 or
    f32); bias is f32 [Co].  (wx; wt) is the split of the 1×1 conv kernel
    over the [image; text] channel axis.  Returns [B,H,W,Co] in x's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise.  Differentiable in every tensor argument."""
    if needs_grad(x, t, wx, wt, bias):
        return _Join.apply(x, t, wx, wt, bias, act)
    return _join_forward(x, t, wx, wt, bias, act)


conditioning_join.launches = 0
