"""The data-parallel batch norm's arithmetic on the CPU, in one process:
the batch cut into D pieces (one a rank), `bn_partials_plain` of each and
`bn_finish_plain` of the stacked partials against the JAX layer on the
whole batch (its statistics are the global batch's under data parallelism);
the synced backward (each piece's `bn_bwd_reduce_plain` sums added, as the
all-reduce adds them, then `bn_bwd_apply_plain` with the global row count)
against ``jax.vjp`` of the JAX layer on the whole batch; D = 1 against
`bn_stats_plain` bit for bit.  The CUDA `bn_partials` and `bn_finish` are
held against these plain versions on the card by ``chip_smoke.py`` (phase
11), and whole data-parallel ticks against the JAX package by
``tests/test_torch_parallel.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_batch_norm import (BN_ACTS, GRAD_TOL, STATE_TOL, TOL,
                                         _inputs, _jax_streams, _t)
from text_to_image_tpu_torch.ops.kernels import fused


def _pieces(x, streams, d):
    """Rank r's piece of x ([S·R, …]): rows r·R/d … (r+1)·R/d of every
    stream, the streams kept contiguous."""
    xs = x.reshape(streams, -1, *x.shape[1:])
    n = xs.shape[1] // d
    return [xs[:, r * n:(r + 1) * n].reshape(-1, *x.shape[1:]).contiguous()
            for r in range(d)]


def _whole(pieces, streams):
    """The inverse of `_pieces`."""
    return torch.cat([p.reshape(streams, -1, *p.shape[1:]) for p in pieces],
                     1).reshape(-1, *pieces[0].shape[1:])


def _synced_forward(x, p, s, streams, act, d):
    """Every rank's (y, mean, rstd) and the shared new state."""
    pieces = _pieces(x, streams, d)
    parts = torch.stack([fused.bn_partials_plain(q, streams) for q in pieces])
    assert parts.shape == (d, 3, streams, x.shape[-1])
    mean, rstd, a, b, new_mean, new_var = fused.bn_finish_plain(
        parts, p["scale"], p["bias"], s["mean"], s["var"])
    ys = [fused.bn_act_plain(q, a, b, act) for q in pieces]
    return pieces, ys, mean, rstd, new_mean, new_var


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", BN_ACTS)
@pytest.mark.parametrize("streams,d", [(1, 2), (3, 2), (3, 4), (1, 4)])
def test_merged_partials_match_jax_on_the_global_batch(streams, d, act,
                                                       dtype):
    x, p, s = _inputs((3 * 4, 5, 3, 24))
    jx = jnp.asarray(x, jnp.dtype(dtype))
    ref_y, ref_s = _jax_streams(act, p, s, jx, streams)
    tp = {k: _t(v) for k, v in p.items()}
    ts = {k: _t(v) for k, v in s.items()}
    _, ys, mean, rstd, new_mean, new_var = _synced_forward(
        _t(x, getattr(torch, dtype)), tp, ts, streams, act, d)
    assert mean.shape == rstd.shape == (streams, 24)
    tol = TOL[dtype]
    np.testing.assert_allclose(_whole(ys, streams).float().numpy(),
                               np.asarray(ref_y.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    for got, k in ((new_mean, "mean"), (new_var, "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_s[k]),
                                   rtol=STATE_TOL[dtype],
                                   atol=STATE_TOL[dtype], err_msg=k)


@pytest.mark.parametrize("act", BN_ACTS)
@pytest.mark.parametrize("streams,d", [(1, 2), (3, 2), (3, 4)])
def test_synced_backward_matches_jax_vjp_on_the_global_batch(streams, d,
                                                             act):
    """Rank r's dx from the all-reduced sums over the global row count is
    the gradient of the sum of every rank's loss with respect to its rows;
    dγ and dβ summed over the ranks are the whole batch's."""
    x, p, s = _inputs((3 * 4, 4, 5, 16), seed=1)
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jax_fn(x_, scale, bias):
        return _jax_streams(act, {"scale": scale, "bias": bias}, s, x_,
                            streams)[0]
    _, vjp = jax.vjp(jax_fn, x, p["scale"], p["bias"])
    ref = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    tp = {k: _t(v) for k, v in p.items()}
    pieces, ys, mean, rstd, _, _ = _synced_forward(
        _t(x), tp, {k: _t(v) for k, v in s.items()}, streams, act, d)
    gs = _pieces(_t(g), streams, d)
    sums = [fused.bn_bwd_reduce_plain(gr, y, xr, mean, rstd, streams, act)
            for gr, y, xr in zip(gs, ys, pieces)]
    sga, sgx, dgamma, dbeta = (sum(t[i] for t in sums) for i in range(4))
    count = x.shape[0] // streams * x.shape[1] * x.shape[2]
    dx = _whole([fused.bn_bwd_apply_plain(gr, y, xr, mean, rstd, tp["scale"],
                                          sga, sgx, streams, act, count)
                 for gr, y, xr in zip(gs, ys, pieces)], streams)
    for name, a, r in zip(("dx", "dgamma", "dbeta"), (dx, dgamma, dbeta),
                          ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("streams", [1, 3])
def test_one_partial_finishes_as_bn_stats(streams):
    """D = 1: the merge takes the partial as it is (n = 0 before it), so
    bn_finish gives bn_stats' statistics and state."""
    x, p, s = _inputs((3 * 2, 5, 3, 24), seed=5)
    tp = {k: _t(v) for k, v in p.items()}
    ts = {k: _t(v) for k, v in s.items()}
    tx = _t(x)
    ref = fused.bn_stats_plain(tx, streams, tp["scale"], tp["bias"],
                               ts["mean"], ts["var"])
    got = fused.bn_finish_plain(fused.bn_partials_plain(tx, streams)[None],
                                tp["scale"], tp["bias"], ts["mean"],
                                ts["var"])
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=2e-7)


def test_partials_hold_count_mean_and_m2():
    x = torch.arange(12.0).reshape(2, 3, 1, 2)      # 2 streams of 3 rows
    parts = fused.bn_partials_plain(x, 2)
    np.testing.assert_array_equal(parts[0].numpy(), np.full((2, 2), 3.0))
    np.testing.assert_allclose(parts[1].numpy(), [[2, 3], [8, 9]])
    np.testing.assert_allclose(parts[2].numpy(), np.full((2, 2), 8.0))


def test_finish_checks_its_partials_on_the_card_path():
    """A CUDA call is refused before any launch when the partials are not
    f32 [D, 3, S, C]; CPU tensors take the plain version."""
    parts = torch.zeros(2, 3, 1, 4, dtype=torch.float64)
    ones = torch.ones(4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused.bn_finish(parts.to("meta"), ones, ones, ones, ones)
    parts = torch.ones(2, 3, 1, 4)
    out = fused.bn_finish(parts, ones, ones, ones, ones)
    assert [tuple(t.shape) for t in out] == [(1, 4)] * 4 + [(4,)] * 2
