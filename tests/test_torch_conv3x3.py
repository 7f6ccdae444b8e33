"""The 3×3 stride-1 SAME conv of the port (`conv3x3_act`, its dx and dw,
csrc/conv3x3.cu).

On the CPU: the plain versions against ``F.conv2d`` and autograd in f64
(forward, gradcheck and gradgradcheck through the three Functions), the
route and its C mirror's rule, the plans, and the C-PGGAN critic's gradient
penalty through the new dispatch against the old composition (``F.conv2d``
then ``L.lrelu``) in f32.

Marked ``chip`` (skip without a card): the bf16 kernels against the f32
plain versions at every 3×3 shape of C-PGGAN 256 px (batches 32 and 96) and
StackGAN Stage-II, forward, dx, dw and the second order through
`_Conv3x3Dw`.  This file imports neither JAX nor the JAX package, so on a
machine with a card it runs without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m chip \\
        tests/test_torch_conv3x3.py
"""

from __future__ import annotations

import itertools
import re

import pytest
import torch
import torch.nn.functional as F

from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.models import pggan
from text_to_image_tpu_torch.ops import layers as L
from text_to_image_tpu_torch.ops.kernels import conv as C
from text_to_image_tpu_torch.ops.kernels.fused import apply_act
from text_to_image_tpu_torch.tools import bench_kernels
from text_to_image_tpu_torch.utils import profiling


def _lib_conv(x, w, b, act):
    """The composition the 3×3 convs ran before the kernels: F.conv2d over
    the padded NCHW input with its bias, then the activation."""
    y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)),
                 w.permute(3, 2, 0, 1), b).permute(0, 2, 3, 1)
    return apply_act(y, act)


def _f64(gen, *shape):
    return torch.randn(*shape, generator=gen, dtype=torch.float64)


# ------------------------------------------------------------------ CPU --

@pytest.fixture(autouse=True)
def one_thread(request):
    """One intra-op thread for the CPU tests, as a loaded test run's
    workers need: gradcheck's thousands of tiny convolutions otherwise
    spend their time in contended thread pools."""
    if request.node.get_closest_marker("chip"):
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("act", ["none", "lrelu"])
@pytest.mark.parametrize("hw", [(4, 4), (5, 5), (6, 3)])
def test_plain_matches_the_library_conv_under_autograd(act, hw):
    gen = torch.Generator().manual_seed(17 * hw[0] + hw[1])
    h, w_ = hw
    x = _f64(gen, 2, h, w_, 3).requires_grad_(True)
    w = _f64(gen, 3, 3, 3, 2).requires_grad_(True)
    b = _f64(gen, 2).requires_grad_(True)
    ours = lambda *a: C.conv3x3_act(*a, act)   # noqa: E731
    lib = lambda *a: _lib_conv(*a, act)        # noqa: E731
    torch.testing.assert_close(ours(x, w, b), lib(x, w, b), rtol=1e-12,
                               atol=1e-12)
    assert torch.autograd.gradcheck(ours, (x, w, b))
    assert torch.autograd.gradgradcheck(ours, (x, w, b))
    # first and second order against autograd through the library conv
    g = _f64(gen, 2, h, w_, 2)

    def orders(f):
        first = torch.autograd.grad(f(x, w, b), (x, w, b), g,
                                    create_graph=True)
        second = torch.autograd.grad(sum((v * v).sum() for v in first),
                                     (x, w, b), allow_unused=True)
        return first + tuple(torch.zeros_like(t) if v is None else v
                             for v, t in zip(second, (x, w, b)))
    torch.testing.assert_close(orders(ours), orders(lib), rtol=1e-10,
                               atol=1e-10)


def test_no_bias_is_a_zero_bias():
    """conv3x3_act with b None (the adjoints' convs, which launch no fill of
    a zero bias) is the conv with a zero bias, and differentiable alike."""
    gen = torch.Generator().manual_seed(23)
    x = _f64(gen, 2, 5, 4, 3).requires_grad_(True)
    w = _f64(gen, 3, 3, 3, 2).requires_grad_(True)
    zero = torch.zeros(2, dtype=torch.float64)
    torch.testing.assert_close(C.conv3x3_act(x, w, None, "lrelu"),
                               C.conv3x3_act_plain(x, w, zero, "lrelu"),
                               rtol=0, atol=0)
    assert torch.autograd.gradgradcheck(
        lambda a, b: C.conv3x3_act(a, b, None, "lrelu"), (x, w))


@pytest.mark.parametrize("hw", [(4, 4), (7, 5)])
def test_dx_and_dw_plain_are_the_adjoints(hw):
    gen = torch.Generator().manual_seed(7)
    h, w_ = hw
    x = _f64(gen, 3, h, w_, 4).requires_grad_(True)
    w = _f64(gen, 3, 3, 4, 5).requires_grad_(True)
    g = _f64(gen, 3, h, w_, 5)
    dx, dw = torch.autograd.grad(
        _lib_conv(x, w, torch.zeros(5, dtype=torch.float64), "none"), (x, w),
        g)
    torch.testing.assert_close(C.conv3x3_dx_plain(g, w), dx)
    torch.testing.assert_close(C.conv3x3_dw_plain(x, g, torch.float64), dw)
    # both Functions, first and second order
    gg = g.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(C.conv3x3_dx, (gg, w))
    assert torch.autograd.gradgradcheck(C.conv3x3_dx, (gg, w))
    dwf = lambda a, b: C.conv3x3_dw(a, b, torch.float64)   # noqa: E731
    assert torch.autograd.gradcheck(dwf, (x, gg))
    assert torch.autograd.gradgradcheck(dwf, (x, gg))


@pytest.mark.parametrize("case, want", [
    ((256, 256, 32, 32, torch.bfloat16), "kernel"),
    ((4, 4, 512, 512, torch.bfloat16), "kernel"),
    ((16, 16, 640, 512, torch.bfloat16), "kernel"),
    ((128, 128, 64, 96, torch.bfloat16), "kernel"),
    ((64, 64, 3, 128, torch.bfloat16), "library"),    # StackGAN's enc0
    ((256, 256, 128, 3, torch.bfloat16), "library"),  # StackGAN's out
    ((16, 16, 48, 64, torch.bfloat16), "library"),    # Cin not 32·n
    ((16, 16, 512, 512, torch.float32), "library"),
    ((24, 24, 64, 64, torch.bfloat16), "library"),    # no TMA box
    ((5, 5, 64, 64, torch.bfloat16), "library"),
])
def test_path_rule(case, want):
    h, w, cin, co, dtype = case
    assert C.conv3x3_path(h, w, cin, co, dtype) == want
    assert C.conv3x3_path(h, w, cin, co, dtype, aligned=False) == "library"


def test_path_mirrors_the_c_rule():
    """t2i_conv3x3_path's condition, as the source states it."""
    src = (C._build.CSRC / "conv3x3.cu").read_text()
    rule = src[src.index('extern "C" int t2i_conv3x3_path'):]
    rule = rule[:rule.index("}")]
    for term in ("Cin % 32 == 0", "Co % 32 == 0", "k3s1::maps(H, W)",
                 "(1ll << 31)", "aligned16(x)", "aligned16(w)",
                 "aligned16(y)", "bf16"):
        assert term in rule
    assert "dx90::boxes(H, W) && wgrad::boxes(H, W)" in src
    assert (C.K3_BM, C.K3_SLICE) == (128, 64)
    assert "constexpr int BM = 128;" in src and "SLICE = 64;" in src
    # a power-of-two map of more pixels than a tile, and fewer
    assert C.conv3x3_path(1, 64, 32, 32, torch.bfloat16) == "kernel"
    assert C.conv3x3_path(8, 8, 32, 32, torch.bfloat16, b=2**31 // 2048) \
        == "library"


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_act_grad_is_the_composition_and_its_adjoint(act):
    """act_grad's (gc, db) against act_backward and the f32 sum, and its
    Function's adjoint (ggc + gdb)·act′(y) by gradcheck, in f64."""
    gen = torch.Generator().manual_seed(13)
    y = _f64(gen, 3, 5, 4, 16)
    y[0, 0, 0, :4] = 0.0                        # the kink itself
    g = _f64(gen, 3, 5, 4, 16).requires_grad_(True)
    gc, db = C.act_grad(g, y, act)
    want = C.act_backward(act, g, y)
    torch.testing.assert_close(gc, want, rtol=0, atol=0)
    torch.testing.assert_close(db, want.sum((0, 1, 2)))
    assert torch.autograd.gradcheck(lambda t: C.act_grad(t, y, act), (g,))
    # its adjoint's adjoint is act_grad again: every order on the kernel
    assert torch.autograd.gradgradcheck(lambda t: C.act_grad(t, y, act),
                                        (g,))
    # bf16 rounds gc once, db sums the unrounded products in f32
    gb, yb = g.detach().bfloat16(), y.bfloat16()
    gc, db = C.act_grad(gb, yb, act)
    f = gb.float() * C.act_grad_from_output(act, yb)
    assert torch.equal(gc, f.bfloat16()) and db.dtype == torch.float32
    torch.testing.assert_close(db, f.sum((0, 1, 2)))


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_act_grad_double_backward_stays_on_its_functions(act):
    """The adjoint of act_grad under create_graph is `_ActGradAdjoint`
    (the kernel with gdb as its add), whose own backward is act_grad's
    Function: no order falls back to the composition."""
    gen = torch.Generator().manual_seed(29)
    y = _f64(gen, 2, 3, 4, 8)
    g = _f64(gen, 2, 3, 4, 8).requires_grad_(True)
    gc, db = C.act_grad(g, y, act)
    c = _f64(gen, 2, 3, 4, 8)
    d, = torch.autograd.grad((gc * c).sum() + db.square().sum(), g,
                             create_graph=True)
    assert type(d.grad_fn).__name__ == "_ActGradAdjointBackward"
    dd, = torch.autograd.grad(d.square().sum(), g)
    slope = C.act_grad_from_output(act, y)
    want_d = (c + 2 * db) * slope
    torch.testing.assert_close(d, want_d)
    # the same two orders by autograd through the composition
    gp = g.detach().requires_grad_(True)
    dp, = torch.autograd.grad(
        (gp * slope * c).sum() + (gp * slope).sum((0, 1, 2)).square().sum(),
        gp, create_graph=True)
    want_dd, = torch.autograd.grad(dp.square().sum(), gp)
    torch.testing.assert_close(dd, want_dd)


def test_act_grad_refuses_a_device_tensor_it_does_not_take():
    """Off the CPU a tensor the kernel does not take (here on the meta
    device) raises instead of running the composition unseen."""
    g = torch.empty(2, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="act_grad takes"):
        C._act_grad_forward(g, g, "lrelu")


@pytest.mark.parametrize("m, c", [(6_291_456, 32), (2048, 512),
                                  (512, 640), (7, 8), (393_216, 64)])
def test_act_grad_rows(m, c):
    """Whole iterations of the block's threads, at most AG_MAX_BLOCKS
    blocks and AG_PARTIALS partial sums for the last block to add; the C
    entry point refuses any other."""
    rows = C.act_grad_rows(m, c)
    step = C.AG_THREADS // (c // 8)
    assert rows % step == 0 and rows >= step
    blocks = -(-m // rows)
    assert blocks <= max(C.AG_MAX_BLOCKS, -(-m // step))
    assert blocks * c <= max(C.AG_PARTIALS, -(-m // step) * c)
    src = (C._build.CSRC / "conv3x3.cu").read_text()
    assert "rows % (k3s1::AG_THREADS / (C / 8))" in src
    assert "constexpr int AG_THREADS = 256;" in src


# every 3×3 call of C-PGGAN 256 px at stage 7 (bench_kernels.CONV3X3_SHAPES:
# critic at 96 and 32 rows, generator at 32) and of StackGAN Stage-II at
# 64: (b, h, w, cin, co)
MAIN_SHAPES = sorted(set(
    [(*shape, co) for shape, co in bench_kernels.CONV3X3_SHAPES]
    + [(64, 16, 16, 640, 512), (64, 16, 16, 512, 512)]))


@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_plans_are_launchable(shape):
    b, h, w, cin, co = shape
    assert C.conv3x3_path(h, w, cin, co, torch.bfloat16, b=b) == "kernel"
    for n, k in ((co, cin), (cin, co)):
        p = C.conv3x3_plan(b, h, w, n, k)
        assert p in C.conv3x3_candidates(b, h, w, n, k)
        assert n % p.tile_n == 0 and p.parts <= C._k3_items(k)
        assert (p.kernel == "rows") == (w % 128 == 0 and n <= 64)
    d = C.conv3x3_dw_plan(b, h, w, cin, co)
    slices = -(-b * h * w // C.K3_SLICE)
    assert co % d.tile_n == 0 and (d.tile_n == 32) == (co % 64 != 0)
    assert (d.kernel == "rows") == (w % 64 == 0 and cin % 64 == 0)
    assert d.cluster in C.K3_PARTS and d.cluster * d.groups <= slices
    assert d.groups == 1 or d.cluster == 8
    assert d.groups * 9 * cin * co * 4 <= C.K3_DW_WS_CAP


def _critic_gp(params, x, emb, cfg_gan):
    """The critic's gradient penalty at x and its parameter gradients."""
    x = x.clone().requires_grad_(True)
    d = pggan.discriminator_apply(params, x, emb, 3, 0.5, cfg_gan)
    g, = torch.autograd.grad(d.sum(), x, create_graph=True)
    gp = ((g.flatten(1).norm(dim=1) - 1.0) ** 2).mean()
    leaves = list(_leaves(params))
    grads = torch.autograd.grad(gp, leaves, allow_unused=True)
    return [gp.detach()] + [torch.zeros_like(t) if v is None else v
                            for v, t in zip(grads, leaves)]


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def test_critic_gradient_penalty_matches_the_library_composition(
        monkeypatch):
    gan = GanConfig(gf_dim=8, z_dim=8, embed_dim=32, compressed_embed_dim=16,
                    ca_dim=8)
    params, _ = pggan.discriminator_init(3, gan, 16)
    params = {k: {n: t.requires_grad_(True) for n, t in v.items()}
              for k, v in params.items()}
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(4, 16, 16, 3, generator=gen)
    emb = torch.randn(4, 32, generator=gen)
    calls = []
    real = C.conv3x3_act

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(L, "conv3x3_act", counted)
    new = _critic_gp(params, x, emb, gan)
    assert len(calls) == 5      # down3a, down3b, down2a, down2b, conv4
    monkeypatch.undo()

    old_conv2d = L.conv2d

    def library_conv2d(p, x, stride=2, padding="SAME", act="none"):
        if p["w"].shape[0] == 3:
            return _lib_conv(x, p["w"].to(x.dtype), p["b"].to(x.dtype), act)
        return old_conv2d(p, x, stride, padding, act)

    monkeypatch.setattr(L, "conv2d", library_conv2d)
    old = _critic_gp(params, x, emb, gan)
    for a, b in zip(new, old):
        torch.testing.assert_close(a, b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))


def test_a_pass_that_wants_x_alone_skips_dw(monkeypatch):
    """The gradient penalty's first backward asks for the input's gradient
    alone: the weight gradient is not computed there, as a library
    convolution skips it; a pass that wants w computes it."""
    calls = []
    real = C.conv3x3_dw
    monkeypatch.setattr(C, "conv3x3_dw",
                        lambda *a: calls.append(1) or real(*a))
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(2, 4, 4, 3, generator=gen, requires_grad=True)
    w0 = torch.randn(3, 3, 3, 5, generator=gen, requires_grad=True)
    b0 = torch.zeros(5, requires_grad=True)
    y = C.conv3x3_act(x * 1.0, w0 * 0.5, b0 * 1.0, "lrelu")
    gx, = torch.autograd.grad(y.sum(), x, create_graph=True)
    assert calls == []
    gw, = torch.autograd.grad(gx.square().sum(), w0)
    assert len(calls) == 1 and float(gw.abs().sum()) > 0
    y = C.conv3x3_act(x * 1.0, w0 * 0.5, b0 * 1.0, "lrelu")
    torch.autograd.grad(y.sum(), (x, w0))
    assert len(calls) == 2


def test_a_tick_calls_the_family_as_the_smoke_run_counts(monkeypatch):
    """One resident tick of a tiny C-PGGAN at stage 3 (mid-fade) calls the
    3×3 family's four entries (a launch each on the card) as often as
    `chip_smoke.pggan_conv3x3_launches` derives from the model's layers,
    the count the smoke run holds the stage-7 tick to."""
    import chip_smoke
    import numpy as np
    from text_to_image_tpu_torch.config import (Config, DataConfig,
                                                PgganConfig, TrainConfig)
    from text_to_image_tpu_torch.data import device as DD
    from text_to_image_tpu_torch.train.steps import (init_train_state,
                                                     make_resident_step)
    cfg = Config(model="pggan",
                 gan=GanConfig(gf_dim=4, z_dim=8, embed_dim=32,
                               compressed_embed_dim=8, ca_dim=4),
                 train=TrainConfig(batch_size=4, n_critic=2, g_steps=1),
                 data=DataConfig(dataset_name="synthetic", image_size=16,
                                 caption_window=2),
                 pggan=PgganConfig(stage=3, steps_per_stage=4),
                 dtype="float32", seed=3)
    rng = np.random.default_rng(0)
    perm, start, count = (torch.as_tensor(a) for a in
                          DD.class_tables(np.arange(12) % 3))
    data = DD.DeviceData(
        images=torch.as_tensor(rng.integers(0, 255, (12, 20, 20, 3),
                                            dtype=np.uint8)),
        embeddings=torch.as_tensor(rng.normal(size=(12, 3, 32))
                                   .astype(np.float32)),
        class_perm=perm, other_start=start, other_count=count)
    calls = dict.fromkeys(("conv3x3_act", "conv3x3_dx", "conv3x3_dw",
                           "act_grad"), 0)
    for name, attr in (("conv3x3_act", "_conv3x3_forward"),
                       ("conv3x3_dx", "_conv3x3_dx_forward"),
                       ("conv3x3_dw", "_conv3x3_dw_forward"),
                       ("act_grad", "_act_grad_forward")):
        def spy(*a, _real=getattr(C, attr), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(C, attr, spy)
    step = make_resident_step(cfg, 10, "cpu")
    ts = init_train_state(0, cfg, 10, "cpu")
    ts.step = 10
    step(ts, data)
    want = chip_smoke.pggan_conv3x3_launches(3, cfg)
    assert want.pop("conv3x3.library") == 0
    assert calls == want


# the kernels' demangled names, as a trace gives them
K3_NAMES = ("void k3s1::taps_kernel<256, 64, true>(k3s1::Params, "
            "CUtensorMap_st, CUtensorMap_st)",
            "void k3s1::rows_kernel<32, 32, false>(k3s1::Params, "
            "CUtensorMap_st, CUtensorMap_st)",
            "void k3s1::wt_kernel<128, 32, 64>(k3s1::WtParams, "
            "CUtensorMap_st, CUtensorMap_st)",
            "void k3s1::wrow_kernel<128>(k3s1::WtParams, CUtensorMap_st, "
            "CUtensorMap_st)",
            "k3s1::wt_sum_kernel(float const*, unsigned short*, int, "
            "long long)",
            "void k3s1::act_grad_kernel<2>(unsigned short const*, unsigned "
            "short const*, float const*, unsigned short*, float*, float*, "
            "unsigned int*, long long, int, long long)",
            "void k3s1::taps_kernel<32, 32, false>(k3s1::Params, "
            "CUtensorMap_st, CUtensorMap_st)")


@pytest.mark.parametrize("name", K3_NAMES)
def test_kernel_names_fall_in_no_frozen_family(name):
    """The benchmark's frozen table reads the new kernels as "other torch
    elementwise": none of the up-block's families, none of the library's;
    the program's own table (tools/ticks.py) names their family."""
    from benchmark.common import kernels as frozen
    from text_to_image_tpu_torch.tools import ticks
    assert frozen.kernel_family(name) == "other torch elementwise"
    assert ticks.kernel_family(name) == "conv3x3 (CUDA)"


def test_the_source_has_only_those_kernels():
    src = (C._build.CSRC / "conv3x3.cu").read_text()
    kernels = [re.search(r"(\w+_kernel)\(", part).group(1)
               for part in src.split("__global__")[1:]]
    assert kernels == ["taps_kernel", "rows_kernel", "wt_kernel",
                       "wt_sum_kernel", "wrow_kernel", "act_grad_kernel"]
    assert src.count("namespace k3s1 {") == 1


def test_the_forward_reads_w_as_it_lies():
    """The forward launches on w itself (HWIO, read N-major by the kernel):
    no transposed copy of the weights a call; act_grad is one launch."""
    import inspect
    fwd = inspect.getsource(C._conv3x3_forward.__wrapped__)
    assert "w.data_ptr()" in fwd and "permute" not in fwd
    src = (C._build.CSRC / "conv3x3.cu").read_text()
    entry = src[src.index('extern "C" int t2i_act_grad'):]
    assert entry.count("<<<") == 2          # lrelu or relu, one of them
    assert "weight_map<BN, BK, FWD>" in src


def test_counters_list_the_conv3x3_wrappers():
    got = profiling.counters()
    assert {"conv3x3_act", "conv3x3_dx", "conv3x3_dw"} <= set(got)


def test_cpu_takes_the_plain_version_uncounted(monkeypatch):
    """On the CPU every 3×3 call takes conv3x3_act's plain version; only a
    CUDA call the kernels do not take runs the library composition and
    counts ``conv3x3.library``."""
    calls = []
    real = C.conv3x3_act
    monkeypatch.setattr(L, "conv3x3_act",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    before = profiling.counters().get("conv3x3.library", 0)
    p = L.conv2d_init(0, 3, 4, 6)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 5, 5, 4).to(dtype)
        y = L.conv2d(p, x, stride=1, act="lrelu")
        want = C.conv3x3_act_plain(x, p["w"].to(dtype), p["b"], "lrelu")
        torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert calls == [torch.float32, torch.bfloat16]
    assert profiling.counters().get("conv3x3.library", 0) == before


# ----------------------------------------------------------------- chip --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# chip_smoke.py's tolerances of the 5×5 family: the forward within
# (atol, rtol) = (1e-2, 1e-2) of the f32 plain version rounded to bf16; a
# gradient within 1e-2 of its largest element (BWD_TOL)
FWD_TOL = (1e-2, 1e-2)
BWD_TOL = 1e-2


def _bf16(gen, device, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(
        torch.bfloat16).to(device)


def _within(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    assert err <= tol * top, f"{what}: max|err| {err:.3e} over {tol} x {top:.3e}"
    return err / max(top, 1e-30)


def check_act_grad(g, y, act, what, add=None):
    """act_grad on the card against its plain version (f32 on the same
    bf16 values): gc bit for bit (one rounding of the same f32 product), db
    within 1e-4 of its largest element (its f32 sums in another order),
    both alike twice; with `add`, the adjoint's kernel (no sums) bit for
    bit.  Returns db's relative error."""
    (gc, db), (gc2, db2) = (C.act_grad(g, y, act) for _ in range(2))
    want, wdb = C.act_grad_plain(g, y, act)
    assert torch.equal(gc, want), f"{what} {act} gc"
    assert torch.equal(gc, gc2) and torch.equal(db, db2), f"{what} twice"
    err = _within(db, wdb, 1e-4, f"{what} {act} db")
    if add is not None:
        dg, _ = C._act_grad_forward(g, y, act, add, False)
        assert torch.equal(dg, C.act_grad_plain(g, y, act, add)[0]), \
            f"{what} {act} adjoint"
    return err


def check_shape(shape, device, gen, second=True):
    """The kernels at one shape against the f32 plain versions on the same
    bf16 values: forward (lrelu), act_grad of its output, dx, dw, each bit
    for bit twice, and the second order through _Conv3x3Dw.  Returns the
    worst relative errors."""
    b, h, w, cin, co = shape
    scale = (9 * cin) ** -0.5
    x = _bf16(gen, device, b, h, w, cin)
    wt = _bf16(gen, device, 3, 3, cin, co, scale=scale)
    bias = torch.randn(co, generator=gen).to(device)
    g = _bf16(gen, device, b, h, w, co)
    out = {}
    y, y2 = (C.conv3x3_act(x, wt, bias, "lrelu") for _ in range(2))
    want = C.conv3x3_act_plain(x.float(), wt.float(), bias, "lrelu")
    assert torch.equal(y, y2), f"{shape}: two forwards differ"
    atol, rtol = FWD_TOL
    bad = (y.float() - want).abs() > atol + rtol * want.abs()
    assert not bool(bad.any()), f"{shape}: forward off at {int(bad.sum())}"
    out["fwd"] = float((y.float() - want).abs().max())
    out["act_grad_db"] = check_act_grad(g, y, "lrelu", f"{shape}")
    dx, dx2 = (C.conv3x3_dx(g, wt) for _ in range(2))
    assert torch.equal(dx, dx2), f"{shape}: two dx differ"
    out["dx"] = _within(dx, C.conv3x3_dx_plain(g.float(), wt.float()),
                        BWD_TOL, f"{shape} dx")
    dw, dw2 = (C.conv3x3_dw(x, g, torch.bfloat16) for _ in range(2))
    assert torch.equal(dw, dw2), f"{shape}: two dw differ"
    out["dw"] = _within(dw, C.conv3x3_dw_plain(x.float(), g.float(),
                                               torch.float32),
                        BWD_TOL, f"{shape} dw")
    if second:
        c = _bf16(gen, device, 3, 3, cin, co)

        def grads(fn, dt):
            xs = x.to(dt).requires_grad_(True)
            gs = g.to(dt).requires_grad_(True)
            return [v.float() for v in torch.autograd.grad(
                fn(xs, gs), (xs, gs), c.to(dt))]
        got = grads(lambda a, q: C.conv3x3_dw(a, q, torch.bfloat16),
                    torch.bfloat16)
        ref = grads(lambda a, q: C.conv3x3_dw_plain(a, q, torch.float32),
                    torch.float32)
        out["dw_adjoint"] = max(_within(u, v, BWD_TOL, f"{shape} dw adjoint")
                                for u, v in zip(got, ref))
    return out


@pytest.mark.chip
@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_kernels_match_the_plain_versions(shape, card):
    gen = torch.Generator().manual_seed(sum(shape))
    check_shape(shape, card, gen, second=shape[0] * shape[1] ** 2 <= 2**21)
    assert C.conv3x3_act.launches and C.conv3x3_dx.launches
    assert C.conv3x3_dw.launches


@pytest.mark.chip
def test_act_grad_kernel_matches_the_plain_version(card):
    """act_grad on the card against its plain version (`check_act_grad`)
    at maps of every size, with and without the adjoint's add; a CUDA
    tensor the kernel does not take raises; the third order (the adjoint
    under autograd) on the kernels against autograd through the plain
    version."""
    gen = torch.Generator().manual_seed(17)
    for shape in ((96, 256, 256, 32), (32, 16, 16, 512), (3, 5, 7, 640),
                  (2, 4, 4, 8)):
        g = _bf16(gen, card, *shape)
        y = _bf16(gen, card, *shape)
        for act in ("relu", "lrelu"):
            check_act_grad(g, y, act, f"{shape}",
                           add=torch.randn(shape[-1], generator=gen).to(card))
    with pytest.raises(ValueError, match="act_grad takes"):
        C.act_grad(g.float(), y.float(), "lrelu")
    g = _bf16(gen, card, 4, 8, 8, 64)
    y = _bf16(gen, card, 4, 8, 8, 64)
    c = _bf16(gen, card, 4, 8, 8, 64)

    def third(fn):
        t = g.clone().requires_grad_(True)
        gc, db = fn(t)
        d, = torch.autograd.grad((gc.float() * c.float()).sum()
                                 + db.square().sum(), t, create_graph=True)
        dd, = torch.autograd.grad(d.float().square().sum(), t)
        return d, dd
    before = C.act_grad.launches
    got = third(lambda t: C.act_grad(t, y, "lrelu"))
    # the forward, its adjoint, the adjoint's adjoint, and act_grad's
    # adjoint again for db's part of it
    assert C.act_grad.launches - before == 4
    want = third(lambda t: C.act_grad_plain(t, y, "lrelu"))
    for u, v, name in zip(got, want, ("d", "dd")):
        _within(u, v, BWD_TOL, f"act_grad third order {name}")


@pytest.mark.chip
def test_every_plan_matches(card):
    """Every taps plan and every dw plan shape at a few calls, each against
    the plain version."""
    gen = torch.Generator().manual_seed(3)
    for b, h, w, cin, co in ((2, 8, 8, 512, 512), (4, 16, 16, 64, 32),
                             (3, 4, 4, 96, 64), (2, 6, 128, 64, 64),
                             (1, 2, 256, 32, 32), (3, 4, 128, 96, 32),
                             (2, 4, 64, 128, 64)):
        x = _bf16(gen, card, b, h, w, cin)
        wt = _bf16(gen, card, 3, 3, cin, co, scale=(9 * cin) ** -0.5)
        bias = torch.randn(co, generator=gen).to(card)
        want = C.conv3x3_act_plain(x.float(), wt.float(), bias, "relu")
        for plan in C.conv3x3_candidates(b, h, w, co, cin):
            y = C._conv3x3_forward(x, wt, bias, "relu", plan)
            _within(y, want, 2 * FWD_TOL[1], f"{(b, h, w, cin, co)} {plan}")
        for groups, cluster, kernel in itertools.product(
                (1, 2, 3), (1, 2, 8), ("taps", "rows")):
            tn = 32 if co % 64 else 64
            plan = C.K3DwPlan(tn, cluster, groups, kernel)
            if (cluster * groups > -(-b * h * w // C.K3_SLICE) or (
                    kernel == "rows" and not C.k3_dw_rows(w, cin, co))):
                continue
            dw = C._conv3x3_dw_forward(x, x[..., :co].contiguous(),
                                       torch.bfloat16, plan)
            _within(dw, C.conv3x3_dw_plain(
                x.float(), x[..., :co].float(), torch.float32),
                BWD_TOL, f"dw {(b, h, w, cin, co)} {plan}")


@pytest.mark.chip
def test_the_function_at_second_order(card):
    check_second_order(card)


def check_second_order(card):
    """_Conv3x3 in bf16 with its gradient penalty's double backward against
    autograd through the f32 plain version; returns the worst error
    relative to each gradient's largest element."""
    gen = torch.Generator().manual_seed(5)
    worst = 0.0
    for b, h, w, cin, co in ((4, 16, 16, 64, 128), (8, 4, 4, 512, 512),
                             (2, 256, 256, 32, 32)):
        x0 = _bf16(gen, card, b, h, w, cin)
        w0 = _bf16(gen, card, 3, 3, cin, co, scale=(9 * cin) ** -0.5)
        b0 = torch.randn(co, generator=gen).to(card)

        def grads(fn, dt):
            x = x0.to(dt).requires_grad_(True)
            wt = w0.to(dt).requires_grad_(True)
            bb = b0.clone().requires_grad_(True)
            gx, = torch.autograd.grad(fn(x, wt, bb).float().square().sum(),
                                      x, create_graph=True)
            pen = gx.float().square().sum()
            return [v.float() for v in (gx, *torch.autograd.grad(
                pen, (x, wt, bb)))]
        got = grads(lambda *a: C.conv3x3_act(*a, "lrelu"), torch.bfloat16)
        ref = grads(lambda *a: C.conv3x3_act_plain(*a, "lrelu"),
                    torch.float32)
        for name, u, v in zip(("dx", "d2x", "d2w", "d2b"), got, ref):
            worst = max(worst, _within(u, v, BWD_TOL,
                                       f"{(b, h, w, cin, co)} {name}"))
    return worst
