"""The port's train-mode batch norm on the CPU (``ops/kernels/fused.py``):
the plain versions of `bn_stats`, `bn_act`, `bn_bwd_reduce` and
`bn_bwd_apply` against the JAX layer (`batch_norm_act` / `batch_norm` per
stream, the new state the mean of the streams' states as the JAX D's
``vmap`` gives it) and against ``jax.vjp`` of it; the closed-form backward
against torch.autograd through the plain forward in f64; `_BatchNormAct`
end to end through ``layers.batch_norm_act(streams=3)``; the wrappers'
rejections; and the Python mirror of the kernels' plan, with a numpy
replica of the statistics kernel's order of sums.  The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text_to_image_tpu.ops import layers as JL
from text_to_image_tpu_torch.ops import layers as TL
from text_to_image_tpu_torch.ops.kernels import fused

BN_ACTS = ["none", "relu", "lrelu"]
# f32: the two packages differ in summation order only; bf16: x is the same
# bf16 array on both sides, y rounds to bf16 (one ulp at |y| < 4 is 1.6e-2)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
STATE_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
# gradients against jax.vjp (f32): 1e-5 of the largest gradient + 1e-5
# relative; against torch.autograd through the plain forward (f64): 1e-10
GRAD_TOL = 1e-5
F64_TOL = 1e-10


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": (rng.normal(size=c) * 0.2).astype(np.float32)}
    s = {"mean": (rng.normal(size=c) * 0.1).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return x, p, s


def _jax_layer(act):
    """The JAX layer of this act: `batch_norm` for none, else
    `batch_norm_act`; train mode."""
    if act == "none":
        return lambda p, s, x: JL.batch_norm(p, s, x, True)
    return lambda p, s, x: JL.batch_norm_act(p, s, x, True, act)


def _jax_streams(act, p, s, x, streams):
    """The JAX discriminator's per-stream BN: vmap over the streams, the new
    state the mean over them."""
    xs = x.reshape(streams, x.shape[0] // streams, *x.shape[1:])
    ys, states = jax.vmap(lambda xi: _jax_layer(act)(p, s, xi))(xs)
    return (ys.reshape(x.shape),
            {k: jnp.mean(v, axis=0) for k, v in states.items()})


def _t(v, dtype=torch.float32):
    return torch.from_numpy(np.asarray(v, np.float32)).to(dtype)


def _plain_forward(x, p, s, streams, act, momentum=0.9, eps=1e-5):
    mean, rstd, a, b, new_mean, new_var = fused.bn_stats_plain(
        x, streams, p["scale"], p["bias"], s["mean"], s["var"], momentum, eps)
    return fused.bn_act_plain(x, a, b, act), mean, rstd, new_mean, new_var


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", BN_ACTS)
@pytest.mark.parametrize("streams", [1, 3])
def test_stats_and_apply_plain_match_jax(streams, act, dtype):
    x, p, s = _inputs((3 * 2, 5, 3, 24))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ref_y, ref_s = _jax_streams(act, p, s, jx, streams)
    tx = _t(x, getattr(torch, dtype))
    tp = {k: _t(v) for k, v in p.items()}
    ts = {k: _t(v) for k, v in s.items()}
    y, mean, rstd, new_mean, new_var = _plain_forward(tx, tp, ts, streams, act)
    assert y.dtype == tx.dtype and y.shape == tx.shape
    assert mean.shape == rstd.shape == (streams, 24)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref_y.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for got, k in ((new_mean, "mean"), (new_var, "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_s[k]),
                                   rtol=STATE_TOL[dtype],
                                   atol=STATE_TOL[dtype], err_msg=k)


def _closed_form_grads(x, g, p, s, streams, act):
    """(dx, dγ, dβ) from bn_bwd_reduce_plain + bn_bwd_apply_plain."""
    y, mean, rstd, _, _ = _plain_forward(x, p, s, streams, act)
    sga, sgx, dgamma, dbeta = fused.bn_bwd_reduce_plain(
        g, y, x, mean, rstd, streams, act)
    dx = fused.bn_bwd_apply_plain(g, y, x, mean, rstd, p["scale"], sga, sgx,
                                  streams, act)
    return dx, dgamma, dbeta


@pytest.mark.parametrize("act", BN_ACTS)
@pytest.mark.parametrize("streams", [1, 3])
def test_backward_plain_matches_jax_vjp(streams, act):
    x, p, s = _inputs((3 * 2, 4, 5, 16), seed=1)
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jax_fn(x_, scale, bias):
        return _jax_streams(act, {"scale": scale, "bias": bias}, s, x_,
                            streams)[0]
    _, vjp = jax.vjp(jax_fn, x, p["scale"], p["bias"])
    ref = vjp(jnp.asarray(g))
    got = _closed_form_grads(_t(x), _t(g), {k: _t(v) for k, v in p.items()},
                             {k: _t(v) for k, v in s.items()}, streams, act)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("act", BN_ACTS + ["tanh"])
@pytest.mark.parametrize("streams", [1, 3])
def test_backward_closed_form_matches_autograd_f64(streams, act):
    """The exact gradient through the statistics: the two-pass closed form
    against torch.autograd through the plain forward (var_mean included)."""
    x, p, s = _inputs((3 * 2, 3, 4, 12), seed=3)
    g = torch.from_numpy(np.random.default_rng(4).normal(size=x.shape))
    f64 = torch.float64
    tx = _t(x, f64).requires_grad_(True)
    tp = {k: _t(v, f64).requires_grad_(True) for k, v in p.items()}
    ts = {k: _t(v, f64) for k, v in s.items()}
    y = _plain_forward(tx, tp, ts, streams, act)[0]
    ref = torch.autograd.grad(y, (tx, tp["scale"], tp["bias"]), g)
    with torch.no_grad():
        got = _closed_form_grads(tx, g, tp, ts, streams, act)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref):
        assert a.dtype == f64
        torch.testing.assert_close(a, r, rtol=F64_TOL,
                                   atol=F64_TOL * float(r.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_layer_with_streams_end_to_end(act):
    """`layers.batch_norm_act(streams=3)` on CPU tensors: `_BatchNormAct`
    forward (y, new state) and backward (x, γ, β) against the JAX D's vmap
    over streams and jax.vjp of it; no kernel launches."""
    x, p, s = _inputs((3 * 4, 4, 4, 32), seed=5)
    g = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    (ref_y, ref_s), vjp = jax.vjp(
        lambda x_, sc, bi: _jax_streams(act, {"scale": sc, "bias": bi}, s, x_,
                                        3), x, p["scale"], p["bias"])
    ref_g = vjp((jnp.asarray(g), {k: jnp.zeros_like(v)
                                  for k, v in ref_s.items()}))
    tx = _t(x).requires_grad_(True)
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    ts = {k: _t(v) for k, v in s.items()}
    counters = (fused.bn_stats, fused.bn_act, fused.bn_bwd_reduce,
                fused.bn_bwd_apply)
    before = [k.launches for k in counters]
    y, new_state = TL.batch_norm_act(tp, ts, tx, True, act, streams=3)
    assert y.grad_fn is not None
    assert not any(v.requires_grad for v in new_state.values())
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref_y),
                               rtol=TOL["float32"], atol=TOL["float32"])
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[k].numpy(), np.asarray(ref_s[k]),
                                   rtol=STATE_TOL["float32"],
                                   atol=STATE_TOL["float32"])
    got = torch.autograd.grad(y, (tx, tp["scale"], tp["bias"]),
                              torch.from_numpy(g))
    for name, a, r in zip(("dx", "dgamma", "dbeta"), got, ref_g):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)
    assert [k.launches for k in counters] == before


def test_eval_mode_uses_running_state():
    """Eval mode: act(x·a + b) from the running state, state unchanged, as
    the JAX layer in eval mode."""
    x, p, s = _inputs((4, 3, 3, 16), seed=7)
    ref_y, _ = JL.batch_norm_act(p, s, x, False, "lrelu")
    ts = {k: _t(v) for k, v in s.items()}
    y, state = TL.batch_norm_act({k: _t(v) for k, v in p.items()}, ts,
                                 _t(x), False, "lrelu", streams=2)
    assert state is ts
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=1e-5,
                               atol=1e-5)


def _good_args(shape=(6, 2, 2, 8), streams=3):
    x = torch.zeros(shape)
    c = shape[-1]
    # gamma, beta and the running state: f32 [C]; mean and rstd f32 [S, C]
    return x, streams, {"gamma": torch.ones(c), "beta": torch.zeros(c),
                        "run_mean": torch.zeros(c), "run_var": torch.ones(c)}, \
        {"mean": torch.zeros(streams, c), "rstd": torch.ones(streams, c)}


@pytest.mark.parametrize("bad", ["x_dtype", "x_noncontig", "streams",
                                 "streams_zero", "gamma_shape", "gamma_dtype",
                                 "mean_per_channel", "act"])
def test_bn_checks_reject(bad):
    """The checks every batch-norm wrapper makes before it launches."""
    x, streams, per, stream = _good_args()
    act = "relu"

    def call():
        fused._bn_check(x, streams, act, per.items(), stream.items())
    call()                                        # the good call passes
    if bad == "x_dtype":
        x = x.double()
    elif bad == "x_noncontig":
        x = x.transpose(1, 2)
    elif bad == "streams":
        streams = 4                               # 6 rows of the batch
    elif bad == "streams_zero":
        streams = 0
    elif bad == "gamma_shape":
        per["gamma"] = torch.ones(7)
    elif bad == "gamma_dtype":
        per["gamma"] = torch.ones(8, dtype=torch.bfloat16)
    elif bad == "mean_per_channel":               # mean is per stream
        stream["mean"] = torch.zeros(8)
    else:
        act = "gelu"
    with pytest.raises((ValueError, TypeError)):
        call()


def test_bwd_check_rejects_mismatched_cotangent():
    x, streams, _, _ = _good_args()
    mean = torch.zeros(streams, 8)
    fused._bwd_check(torch.zeros_like(x), x, x, mean, mean, streams, "relu")
    with pytest.raises(ValueError):
        fused._bwd_check(torch.zeros(6, 2, 2, 4), x, x, mean, mean, streams,
                         "relu")
    with pytest.raises(ValueError):
        fused._bwd_check(x.bfloat16(), x, x, mean, mean, streams, "relu")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(3, 2, 2, 8, device="meta")
    v = torch.zeros(8, device="meta")
    m = torch.zeros(3, 8, device="meta")
    calls = [lambda: fused.bn_stats(x, 3, v, v, v, v),
             lambda: fused.bn_bwd_reduce(x, x, x, m, m, 3, "relu"),
             lambda: fused.bn_bwd_apply(x, x, x, m, m, v, m, m, 3, "relu"),
             lambda: fused.batch_norm_train(x, v, v, v, v, 3, "relu")]
    for call in calls:
        with pytest.raises(ValueError):
            call()


# --- the plan ------------------------------------------------------------------
B = 64
# every train-mode BN input of every path: (shape, streams).  GAN-CLS G
# (stem and up-blocks); the 64 px D over the D step's 3 × 64 and the G
# step's 64 (down1-3, the join's output); StackGAN Stage-I's last up-block,
# Stage-II's encoder, join, residual blocks and up-blocks; the 256 px D
PATH_SHAPES = (
    [((B, 4, 4, 1024), 1), ((B, 8, 8, 512), 1), ((B, 16, 16, 256), 1),
     ((B, 32, 32, 128), 1)]
    + [((s * B, h, h, c), s) for s in (3, 1)
       for h, c in ((16, 128), (8, 256), (4, 512))]
    + [((B, 64, 64, 64), 1), ((B, 32, 32, 256), 1), ((B, 16, 16, 512), 1),
       ((B, 64, 64, 128), 1), ((B, 128, 128, 64), 1), ((B, 256, 256, 64), 1)]
    + [((s * B, h, h, c), s) for s in (3, 1)
       for h, c in ((64, 128), (32, 256), (16, 512), (8, 512), (4, 512))])
ODD_SHAPES = [((3, 5, 7, 20), 1), ((2, 3, 3, 200), 1), ((6, 5, 7, 20), 3)]


@pytest.mark.parametrize("shape,streams", PATH_SHAPES + ODD_SHAPES)
def test_plan_covers_every_row_once(shape, streams):
    """Each stream's rows fall in exactly one band, each CTA's lanes and
    channel slice fit its 256 threads, the grid fills about two CTAs an SM
    (fewer only where a lane would get under BN_UNROLL rows), and the
    workspace holds every partial.  Main-path shapes take the vector path,
    C = 20 and 200 the scalar path."""
    c = shape[-1]
    rows = int(np.prod(shape[:-1]))
    plan = fused.bn_plan(rows, streams, c, aligned=True)
    r = rows // streams
    assert plan.vec == int(c % 8 == 0)
    assert plan.tpr * plan.lanes <= fused.BN_THREADS
    assert plan.chunks * plan.tpr * fused.BN_VEC >= c
    assert (plan.bands - 1) * plan.band_rows < r <= plan.bands * plan.band_rows
    ctas = plan.chunks * streams * plan.bands
    if plan.band_rows < r:   # cut into bands: the card is filled, not over
        assert ctas <= fused.BN_CTAS_PER_SM * 132
    if plan.bands > 1 and ctas * 2 <= fused.BN_CTAS_PER_SM * 132:
        # under half full: every lane has rows to keep in flight
        assert plan.band_rows * 2 > plan.lanes * fused.BN_UNROLL
    assert plan.ws_bytes == (4 * fused.BN_MAX_CHUNKS
                             + 4 * fused.BN_SLOT * ctas)
    assert fused.bn_plan(rows, streams, c, aligned=False).vec == 0


@pytest.mark.parametrize("case,plan", [
    # (B, H, W, C), S → vec, groups, tpr, chunks, lanes, bands, band_rows
    (((64, 4, 4, 1024), 1), (1, 128, 8, 16, 32, 8, 128)),
    (((64, 32, 32, 128), 1), (1, 16, 8, 2, 32, 132, 497)),
    (((192, 16, 16, 128), 3), (1, 16, 8, 2, 32, 44, 373)),
    (((64, 64, 64, 64), 1), (1, 8, 8, 1, 32, 264, 993)),
    (((64, 256, 256, 64), 1), (1, 8, 8, 1, 32, 264, 15888)),
    (((2, 3, 3, 200), 1), (1, 25, 8, 4, 32, 1, 18)),
    (((3, 5, 7, 20), 1), (0, 3, 3, 1, 85, 1, 105)),
])
def test_plan_values(case, plan):
    """The plans of a few calls, written out: the numbers csrc/batch_norm.cu
    must report for them on a 132-SM card (chip_smoke.py reads each call's
    plan back from the C entry point)."""
    shape, streams = case
    rows = int(np.prod(shape[:-1]))
    assert tuple(fused.bn_plan(rows, streams, shape[-1]))[:7] == plan


@pytest.mark.parametrize("rows,streams,c", [(0, 1, 8), (7, 2, 8), (6, 0, 8),
                                            (4, 1, 0)])
def test_plan_rejects(rows, streams, c):
    with pytest.raises(ValueError):
        fused.bn_plan(rows, streams, c)


def _welford_replica(x, streams, plan):
    """numpy f32 replica of bn_stats_kernel's order: per (slice, stream,
    band) each row lane runs Welford over rows lane, lane + lanes, …; the
    lanes merge pairwise in the kernel's tree; the last CTA merges the
    bands, lane l taking bands l, l + lanes, … in turn, then the tree.
    Returns mean, var [S, C]."""
    f32 = np.float32
    rows, c = x.shape
    r = rows // streams
    width = plan.chunks * plan.tpr * 8
    xp = np.zeros((rows, width), f32)
    xp[:, :c] = x

    def merge(a, b):
        (na, ua, wa), (nb, ub, wb) = a, b
        if nb == 0:
            return a
        nt = f32(na + nb)
        fb = f32(nb / nt)
        cross = f32(na * fb)
        d = (ub - ua).astype(f32)
        return nt, (ua + d * fb).astype(f32), (wa + wb + d * d * cross).astype(f32)

    def tree(states):
        states = list(states)
        step = 1
        while step < len(states):
            for i in range(0, len(states), 2 * step):
                if i + step < len(states):
                    states[i] = merge(states[i], states[i + step])
            step *= 2
        return states[0]

    mean = np.zeros((streams, width), f32)
    var = np.zeros((streams, width), f32)
    for q in range(plan.chunks):
        cols = slice(q * plan.tpr * 8, (q + 1) * plan.tpr * 8)
        for s in range(streams):
            parts = []
            for band in range(plan.bands):
                lo = s * r + band * plan.band_rows
                hi = s * r + min((band + 1) * plan.band_rows, r)
                lanes = []
                for lane in range(plan.lanes):
                    n, u, w = f32(0), np.zeros(plan.tpr * 8, f32), np.zeros(
                        plan.tpr * 8, f32)
                    for row in range(lo + lane, hi, plan.lanes):
                        v = xp[row, cols]
                        n = f32(n + 1)
                        d = (v - u).astype(f32)
                        u = (u + d * f32(1 / n)).astype(f32)
                        w = (w + d * (v - u)).astype(f32)
                    lanes.append((n, u, w))
                parts.append(tree(lanes))
            gathered = []
            for lane in range(plan.lanes):
                acc = (f32(0), np.zeros(plan.tpr * 8, f32),
                       np.zeros(plan.tpr * 8, f32))
                for band in range(lane, plan.bands, plan.lanes):
                    acc = merge(acc, parts[band])
                gathered.append(acc)
            n, u, w = tree(gathered)
            assert n == r
            mean[s, cols], var[s, cols] = u, w / n
    return mean[:, :c], var[:, :c]


@pytest.mark.parametrize("rows,streams,c,sms", [
    (3 * 1100, 3, 16, 132),   # 3 bands a stream, 128 lanes, ragged last band
    (2 * 700, 2, 20, 4),      # scalar path: 3 groups, 85 lanes, 3 bands
    (1200, 1, 136, 132),      # three slices (the last of one group), 10 bands
    (2100, 1, 8, 2),          # one group: 256 lanes
    (6000, 1, 64, 132),       # 47 bands over 32 lanes: lanes take several
])
def test_kernel_order_of_sums_gives_the_statistics(rows, streams, c, sms):
    """The statistics kernel's bands, lanes, tree and Chan merges, replayed
    in numpy f32, give the per-stream mean and biased variance."""
    plan = fused.bn_plan(rows, streams, c, sms=sms)
    x = (np.random.default_rng(8).normal(size=(rows, c)) * 2 + 3).astype(
        np.float32)
    mean, var = _welford_replica(x, streams, plan)
    xs = x.reshape(streams, -1, c).astype(np.float64)
    np.testing.assert_allclose(mean, xs.mean(1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(var, xs.var(1), rtol=1e-5, atol=1e-5)
