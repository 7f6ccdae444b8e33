"""The port's kernel microbench (``tools/bench_kernels.py``) on the CPU:
its shape lists against the JAX package's ``scripts/bench_pallas.py`` and
the main paths, its bytes and operations against the tensors it builds,
the bound, the table writer, and that every row holds the kernel's output
against its plain version before timing it.  The timing itself (CUDA
events) and the paths read back from the C entry points run only on the
card (``chip_smoke.py`` phase 15)."""

import ast
import os

import pytest
import torch

from text_to_image_tpu_torch.ops.kernels import conv, fused
from text_to_image_tpu_torch.tools import bench_kernels as bk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as a loaded test run's workers need."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def bench_pallas_shapes():
    """The (b, h, w, cin, co) tuples of each `bench_*([...])` call in
    ``scripts/bench_pallas.py``'s command-line block, by branch: the
    default (deconv, conv, upconv), ``--upconv`` and ``--upconv --grad``;
    b = 64."""
    src = open(os.path.join(ROOT, "scripts", "bench_pallas.py")).read()
    main = src[src.index('if __name__ == "__main__":'):]
    out = {}
    for call in ast.walk(ast.parse(main)):
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                and call.func.id.startswith("bench_") and call.args
                and isinstance(call.args[0], ast.List)):
            shapes = [tuple(64 if isinstance(e, ast.Name) and e.id == "b"
                            else 3 * 64 if isinstance(e, ast.BinOp)
                            else e.value for e in t.elts)
                      for t in call.args[0].elts]
            out.setdefault(call.func.id, []).append(shapes)
    return out


def test_shapes_cover_bench_pallas_and_the_main_paths():
    jax = bench_pallas_shapes()
    deconv = {(*s, co) for s, co, _ in bk.DECONV_SHAPES}
    conv_ = {(*s, co) for s, co, _ in bk.CONV_SHAPES}
    upconv = {(*s, co) for s, co, _ in bk.UPCONV_SHAPES}
    grad = {(*s, co) for s, co in bk.UPCONV_GRAD_SHAPES}
    assert set(jax["bench_deconv"][0]) <= deconv
    assert set(jax["bench_conv"][0]) <= conv_
    for shapes in jax["bench_upconv"]:          # the default and --upconv
        assert set(shapes) <= upconv
    assert set(jax["bench_upconv_grad"][0]) <= grad
    # the main paths: the GAN-CLS generator's RGB layer, D's RGB layer at
    # both batches, the StackGAN generators' eight up-blocks (grad too)
    assert (64, 32, 32, 128, 3) in deconv
    assert {(192, 64, 64, 3, 64), (64, 64, 64, 3, 64)} <= conv_
    stackgan = {(*s, co) for s, co in bk.STACKGAN_UPCONV}
    assert len(stackgan) == 8 and stackgan <= upconv and stackgan <= grad
    assert len(bk.UPCONV_GRAD_SHAPES) == len(grad)      # no repeats
    # the dx and dw rows: every gradient shape and the C-PGGAN up-blocks
    # (chip_smoke.py holds the kernels at the same six)
    import chip_smoke
    bwd = {(*s, co) for s, co in bk.UPCONV_BWD_SHAPES}
    pggan = {(*s, co) for s, co in bk.PGGAN_UPCONV_SHAPES}
    assert grad <= bwd and pggan <= bwd and len(pggan) == 6
    assert len(bk.UPCONV_BWD_SHAPES) == len(bwd)
    assert chip_smoke.PGGAN_UPCONV_SHAPES == bk.PGGAN_UPCONV_SHAPES


def _inputs(shape, co, k, gen):
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    w = torch.randn(k, k, shape[-1], co, generator=gen).to(torch.bfloat16)
    return x, w


def _in_map_products(h, w, op):
    """(output pixel, tap) pairs of a one-channel op whose tap lands inside
    its input, counted by the plain version itself: the sum of its output
    for an all-ones input and weight."""
    ones = torch.ones(1, h, w, 1)
    w5, one, zero = torch.ones(5, 5, 1, 1), torch.ones(1), torch.zeros(1)
    if op == "conv":
        return int(conv.conv5x5_s2_act_plain(ones, w5, zero, "none").sum())
    return int(conv.deconv5x5_s2_plain(ones, w5, one, zero, "none").sum())


def _combined_taps(n):
    """upconv3x3's combined taps along an n-long axis that land inside it:
    the distinct input rows each of the 2n output rows reads."""
    return sum(len({(o + k - 1) // 2 for k in range(3)
                    if 0 <= o + k - 1 < 2 * n}) for o in range(2 * n))


@pytest.mark.parametrize("shape,co", [((2, 5, 7, 8), 16), ((3, 4, 4, 64), 3)])
def test_bytes_and_operations_match_the_tensors(shape, co):
    """Each input read once, each output written once (the bf16 tensors
    and the f32 per-channel vectors the bench builds), and 2 operations
    for each product whose tap lands inside the map (the pads' products
    are no work), counted by the plain versions."""
    gen = torch.Generator().manual_seed(0)
    b, h, w, cin = shape
    x, w5 = _inputs(shape, co, 5, gen)
    s = t = torch.ones(co)
    y = conv.deconv5x5_s2(x, w5, s, t, "relu")
    assert bk.deconv_work(shape, co) == (
        bk.nbytes(x, w5, s, t, y),
        2 * b * _in_map_products(h, w, "deconv") * cin * co)
    y = conv.conv5x5_s2_act(x, w5, t, "lrelu")
    assert bk.conv_work(shape, co) == (
        bk.nbytes(x, w5, t, y),
        2 * b * _in_map_products(h, w, "conv") * cin * co)
    x3, w3 = _inputs(shape, co, 3, gen)
    y = conv.upconv3x3_bias(x3, w3, t, "none")
    fwd = (bk.nbytes(x3, w3, t, y),
           2 * b * _combined_taps(h) * _combined_taps(w) * cin * co)
    assert bk.upconv_work(shape, co) == fwd
    # backward: g read, dx, dw, db written; x and w read again
    assert bk.upconv_grad_work(shape, co) == (
        fwd[0] + bk.nbytes(y, x3, x3, w3, w3) + 4 * co, 3 * fwd[1])
    # each backward kernel alone: dx reads g and w and writes dx; dw reads
    # x and g and writes dw; each as many multiply-adds as the forward
    g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
    dx = conv.upconv3x3_dx(g, w3, torch.bfloat16)
    dw = conv.upconv3x3_dw(x3, g, torch.bfloat16)
    assert bk.upconv_dx_work(shape, co) == (bk.nbytes(g, w3, dx), fwd[1])
    assert bk.upconv_dw_work(shape, co) == (bk.nbytes(x3, g, dw), fwd[1])
    e = 12
    tt = torch.randn(b, e, generator=gen).to(torch.bfloat16)
    wx = torch.randn(cin, co, generator=gen).to(torch.bfloat16)
    wt = torch.randn(e, co, generator=gen).to(torch.bfloat16)
    y = fused.conditioning_join(x, tt, wx, wt, t, "none")
    assert bk.join_work(shape, e, co) == (
        bk.nbytes(x, tt, wx, wt, t, y),
        2 * b * h * w * cin * co + 2 * b * e * co)


def test_backward_work_at_a_hand_computed_shape():
    """dx and dw of the 32²×256→128 up-block at batch 64, by hand: 2 bytes
    an element; each of the 64 output rows (and columns) reads 2 combined
    taps of x, less the one past each end: 126² products per (image, Cin,
    Co), not 16·32²."""
    shape, co = (64, 32, 32, 256), 128
    g_bytes = 2 * 64 * 64 * 64 * 128            # [64, 64, 64, 128]
    x_bytes = 2 * 64 * 32 * 32 * 256            # [64, 32, 32, 256]
    w_bytes = 2 * 9 * 256 * 128
    ops = 2 * 64 * 126 * 126 * 256 * 128        # 66.6 GFLOP
    assert ops == 66_588_770_304 and bk.up_taps(32) == 126
    assert bk.upconv_dx_work(shape, co) == (g_bytes + w_bytes + x_bytes, ops)
    assert bk.upconv_dw_work(shape, co) == (x_bytes + g_bytes + w_bytes, ops)
    ms, by = bk.bound(*bk.upconv_dw_work(shape, co), torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(ops / 989e12 * 1e3)


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = bk.bound(3.35e9, 1.0, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = bk.bound(1.0, 989e9, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    assert bk.bound(1.0, 67e9, torch.float32)[0] == pytest.approx(1.0)
    # the GAN-CLS generator's first deconv is bound by its operations: 17
    # of the 20 (output, tap) pairs of each axis of its 8² map land in it
    ms, by = bk.bound(*bk.deconv_work((64, 4, 4, 1024), 512), torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(
        2 * 64 * 17 * 17 * 1024 * 512 / 989e12 * 1e3)


def test_table_has_a_row_a_measurement():
    rows = [bk._row("deconv5x5_s2", "[64, 4, 4, 1024]->512 relu", "wgmma",
                    0.1, "cuDNN conv_transpose2d", 0.2,
                    bk.deconv_work((64, 4, 4, 1024), 512), torch.bfloat16,
                    0.0),
            bk._row("bn_act", "[64, 4, 4, 1024] S=1 relu", "plan 1 64 2",
                    0.03, "batch_norm_elemt", 0.0, (1e6, 1e6), torch.float32,
                    1e-3)]
    text = bk.table(rows).splitlines()
    assert len(text) == 2 + len(rows)
    assert text[0].startswith("| kernel | shape | path / plan | ms |")
    assert "| 0.50 |" in text[2]                  # kernel / library
    assert "| nan |" in text[3]                   # no library time
    assert text[2].endswith("| — |")              # no plain version timed
    rows[0]["plain_ms"] = 2.5
    assert bk.table(rows).splitlines()[2].endswith("| 2.5000 |")
    cells = [c.strip() for c in text[2].split("|")[1:-1]]
    assert len(cells) == text[0].count("|") - 1


def test_hold_raises_past_the_tolerance():
    ref = torch.tensor([1.0, -2.0, 4.0])
    assert bk.hold(ref + 0.01, ref, *bk.TOL, "ok") == pytest.approx(0.01,
                                                                  rel=1e-4)
    with pytest.raises(RuntimeError, match="1 elements out of tolerance"):
        bk.hold(ref + torch.tensor([0.0, 0.0, 0.1]), ref, *bk.TOL, "bad")
    # relative to the largest |ref|
    assert bk.hold(ref + 3e-4, ref, 1e-4, 0.0, "rel", rel_to_max=True) > 0
    with pytest.raises(RuntimeError):
        bk.hold(ref + 5e-4, ref, 1e-4, 0.0, "rel", rel_to_max=True)


@pytest.fixture
def cpu_bench(monkeypatch):
    """The bench's row functions on the CPU at small shapes: the timer and
    the C entry points' path read-back stubbed (the kernels' wrappers run
    their plain versions on CPU tensors); records what was timed."""
    timed = []

    def time_ms(fn, flush, iters=20, warmup=3, spin=0):
        timed.append(fn)
        fn()
        return 1.0
    monkeypatch.setattr(bk, "time_ms", time_ms)
    monkeypatch.setattr(conv, "deconv_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(conv, "upconv_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(bk, "DECONV_SHAPES", [((2, 4, 4, 16), 8, "relu")])
    monkeypatch.setattr(conv, "dx_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(conv, "dw_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(bk, "UPCONV_GRAD_SHAPES", [((2, 4, 4, 8), 8)])
    monkeypatch.setattr(bk, "UPCONV_BWD_SHAPES", [((2, 4, 4, 8), 8),
                                                  ((1, 3, 5, 64), 64)])
    return timed


def test_rows_hold_the_kernel_before_timing(cpu_bench, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_deconv("cpu", None, gen)
    assert len(rows) == 1 and len(cpu_bench) == 2    # kernel, library
    assert rows[0]["ratio"] == 1.0 and rows[0]["max_abs_err"] == 0.0
    plain = conv.deconv5x5_s2_plain
    monkeypatch.setattr(conv, "deconv5x5_s2",
                        lambda *a: plain(*a) * 1.1 + 0.05)
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="out of tolerance"):
        bk.bench_deconv("cpu", None, gen)
    assert cpu_bench == []                           # nothing timed


def test_upconv_grad_rows_hold_the_gradients_first(cpu_bench, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_upconv_grad("cpu", None, gen)
    assert len(rows) == 1 and rows[0]["kernel"] == "upconv3x3_bias fwd+bwd"
    assert rows[0]["max_abs_err"] < 1e-4 and len(cpu_bench) == 2
    # a backward that drops the bias gradient fails before any timing
    real = conv.upconv3x3_bias

    def no_db(x, w, b, act):
        return real(x, w, b.detach(), act) + 0 * b.sum()
    monkeypatch.setattr(conv, "upconv3x3_bias", no_db)
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="grad db"):
        bk.bench_upconv_grad("cpu", None, gen)
    assert cpu_bench == []


def test_backward_kernel_rows_hold_then_time_three_calls(cpu_bench,
                                                        monkeypatch):
    """A dx and a dw row a shape, each with the kernel's, the library
    call's and the plain version's ms, the work of its own kernel and
    its path; a wrong dw fails before anything is timed."""
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_upconv_bwd("cpu", None, gen)
    assert [r["kernel"] for r in rows] == ["upconv3x3_dx", "upconv3x3_dw"] * 2
    assert len(cpu_bench) == 3 * len(rows)
    for r in rows:
        assert r["plain_ms"] == 1.0 and r["ratio"] == 1.0
        assert r["max_abs_err"] == 0.0 and r["path"].startswith("plain")
    shape, co = bk.UPCONV_BWD_SHAPES[1]
    assert rows[2]["bound_ms"] == bk.bound(*bk.upconv_dx_work(shape, co),
                                           torch.bfloat16)[0]
    assert rows[3]["bound_ms"] == bk.bound(*bk.upconv_dw_work(shape, co),
                                           torch.bfloat16)[0]
    assert "library" in rows[1] and "conv2d_weight" in rows[1]["library"]
    plain = conv.upconv3x3_dw_plain
    monkeypatch.setattr(conv, "upconv3x3_dw",
                        lambda *a: plain(*a) * 1.1 + 0.05)
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="upconv3x3_dw"):
        bk.bench_upconv_bwd("cpu", None, gen)
    assert cpu_bench == []


def test_main_needs_a_gpu_and_pairs_upconv_with_grad(capsys):
    assert bk.main([]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
    for argv in (["--upconv"], ["--grad"]):
        with pytest.raises(SystemExit):
            bk.main(argv)


def test_every_kernel_of_the_main_paths_has_a_table():
    """Each kernel wrapper that the main paths launch (``chip_smoke.py``
    counts them; ``upconv3x3_bias`` counts on ``upconv3x3``) is a kernel of
    the default table, or one of the backward kernels of the ``--grad``
    tables."""
    import chip_smoke
    names = {c.__name__ for c in chip_smoke.all_counters()}
    assert {k.replace("upconv3x3_bias", "upconv3x3")
            for k in bk.KERNELS + bk.BACKWARD_KERNELS} == names
    assert set(bk.BACKWARD_KERNELS) <= {
        k for table in bk.GRAD_TABLES.values() for k in table}
    assert bk.GRAD_KERNELS == bk.GRAD_TABLES["upconv"]


def _conv_dx_on_cpu(monkeypatch):
    """conv5x5_s2_dx's C entry points as the card answers them: its route,
    and the modes of its last launch (the mirror's)."""
    monkeypatch.setattr(conv, "conv_dx_path_on_card", lambda *a: "plain")
    last = {}
    real = conv.conv5x5_s2_dx

    def dx(gc, w, h, wd, plan=None):
        last["modes"] = conv.conv_dx_modes(
            plan or conv.conv_dx_plan(gc.shape[0], h, wd, w.shape[2],
                                      w.shape[3]))
        return real(gc, w, h, wd, plan)
    monkeypatch.setattr(conv, "conv5x5_s2_dx", dx)
    monkeypatch.setattr(conv, "conv_dx_mode_on_card", lambda: last["modes"])
    return last


def _deconv_dx_on_cpu(monkeypatch):
    """deconv5x5_s2_dx's path read-back as the card answers it; records
    the plan of each launch."""
    monkeypatch.setattr(conv, "deconv_dx_path_on_card", lambda *a: "plain")
    plans = []
    real = conv.deconv5x5_s2_dx

    def dx(d, w, plan=None):
        plans.append(plan or conv.deconv_dx_plan(
            d.shape[0], d.shape[1] // 2, d.shape[2] // 2, w.shape[2],
            w.shape[3]))
        return real(d, w, plan)
    monkeypatch.setattr(conv, "deconv5x5_s2_dx", dx)
    return plans


@pytest.mark.parametrize("op", ["conv", "deconv"])
def test_conv5_grad_rows_hold_then_time(cpu_bench, monkeypatch, op):
    """``--conv --grad`` / ``--deconv --grad``: a forward + backward row
    (gradients held in f32 first), a dx row (the conv's on conv5x5_s2_dx,
    tagged with its plan and the modes its launch reports; the deconv's
    on deconv5x5_s2_dx, tagged with its path and plan) and a dw row a
    shape, each with its own work, the op and the batch; the dx and dw
    rows with the plain version's ms; a wrong dw fails before anything is timed (the Function's gradients are held
    first)."""
    monkeypatch.setattr(bk, "CONV_SHAPES", [((2, 8, 6, 64), 64, "lrelu")])
    monkeypatch.setattr(bk, "DECONV_SHAPES", [((2, 4, 3, 64), 64, "relu")])
    monkeypatch.setattr(conv, "conv_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(conv, "conv_dw_path_on_card", lambda *a: "plain")
    _conv_dx_on_cpu(monkeypatch)
    _deconv_dx_on_cpu(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_conv5_grad(op, "cpu", None, gen)
    assert [r["kernel"] for r in rows] == list(bk.GRAD_TABLES[op])
    plan = (conv.conv_dx_plan(2, 8, 6, 64, 64) if op == "conv"
            else conv.deconv_dx_plan(2, 4, 3, 64, 64))
    if op == "conv":
        assert rows[1]["path"].startswith(
            f"plain {plan.kernel} {plan.tile_m}x{plan.tile_n} parts "
            f"{plan.parts} (")
    else:
        assert rows[1]["path"] == (
            f"plain {plan.tile_m}x{plan.tile_n} parts {plan.parts}")
    assert len(cpu_bench) == 2 + 3 + 3
    shape, co, _ = (bk.CONV_SHAPES if op == "conv" else bk.DECONV_SHAPES)[0]
    b, h, w, cin = shape
    for r in rows:
        assert r["op"] == op and r["batch"] == b and r["ratio"] == 1.0
    assert "plain_ms" not in rows[0]
    assert rows[1]["plain_ms"] == rows[2]["plain_ms"] == 1.0
    assert rows[0]["max_abs_err"] < 1e-4
    assert rows[1]["max_abs_err"] == rows[2]["max_abs_err"] == 0.0
    if op == "conv":
        dw_work = bk.conv_dw_work(shape, co)
        assert rows[1]["bound_ms"] == bk.bound(*bk.conv_dx_work(shape, co),
                                               torch.bfloat16)[0]
    else:
        dw_work = bk.conv_dw_work((b, 2 * h, 2 * w, co), cin)
        assert rows[1]["bound_ms"] == bk.bound(
            *bk.deconv_dx_work(shape, co), torch.bfloat16)[0]
    assert rows[2]["bound_ms"] == bk.bound(*dw_work, torch.bfloat16)[0]
    assert "conv2d_weight" in rows[2]["library"]
    assert rows[2]["path"] == "plain parts 1 cluster 1 direct"
    plain = conv.conv5x5_s2_dw_plain
    monkeypatch.setattr(conv, "conv5x5_s2_dw",
                        lambda *a: plain(*a) * 1.1 + 0.05)
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="grad dw"):
        bk.bench_conv5_grad(op, "cpu", None, gen)
    assert cpu_bench == []


def test_conv_dx_rows_name_their_route(cpu_bench, monkeypatch):
    """The RGB layer's dx (Cin 3) keeps the transposed conv: its row is
    CONV_DX_VIA_DECONV with the deconv's path; a deep layer's launch whose
    modes are not its plan's fails before the dx row is timed (after the
    forward + backward row's two timings)."""
    monkeypatch.setattr(bk, "CONV_SHAPES", [((2, 8, 8, 3), 64, "lrelu")])
    monkeypatch.setattr(conv, "conv_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(conv, "conv_dw_path_on_card", lambda *a: "plain")
    monkeypatch.setattr(conv, "deconv_path_on_card", lambda *a: "thin")
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_conv5_grad("conv", "cpu", None, gen)
    assert [r["kernel"] for r in rows][1] == bk.CONV_DX_VIA_DECONV
    assert rows[1]["path"] == "thin" and rows[1]["max_abs_err"] == 0.0
    monkeypatch.setattr(bk, "CONV_SHAPES", [((2, 8, 6, 64), 64, "lrelu")])
    last = _conv_dx_on_cpu(monkeypatch)
    real = conv.conv_dx_mode_on_card
    monkeypatch.setattr(conv, "conv_dx_mode_on_card",
                        lambda: real() | {"patch"})
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="modes"):
        bk.bench_conv5_grad("conv", "cpu", None, gen)
    assert len(cpu_bench) == 2 and last


def test_deconv_dx_rows_name_their_route(cpu_bench, monkeypatch):
    """The deconv's dx at ragged channels keeps the conv of the flipped
    weight: its row is DECONV_DX_VIA_CONV with the conv's path; the RGB
    layer's (Co 3) is deconv5x5_s2_dx on its thin plan, launched once to
    hold it and then timed, its bound d and w read and dx written once."""
    monkeypatch.setattr(conv, "conv_path_on_card", lambda *a: "pipelined")
    monkeypatch.setattr(conv, "conv_dw_path_on_card", lambda *a: "plain")
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_conv5_grad("deconv", "cpu", None, gen)
    assert [r["kernel"] for r in rows][1] == bk.DECONV_DX_VIA_CONV
    assert rows[1]["path"] == "pipelined" and rows[1]["max_abs_err"] == 0.0
    monkeypatch.setattr(bk, "DECONV_SHAPES", [((2, 4, 3, 64), 3, "tanh")])
    plans = _deconv_dx_on_cpu(monkeypatch)
    rows = bk.bench_conv5_grad("deconv", "cpu", None, gen)
    thin = conv.DdxPlan("thin", 128, 64, 1)
    assert [r["kernel"] for r in rows][1] == "deconv5x5_s2_dx"
    assert rows[1]["path"] == "plain 128x64 parts 1"
    assert rows[1]["max_abs_err"] == 0.0 and plans[0] == thin
    assert rows[1]["bound_ms"] == bk.bound(
        2 * (2 * 8 * 6 * 3 + 25 * 64 * 3 + 2 * 4 * 3 * 64),
        2 * 2 * bk.s2_taps(8) * bk.s2_taps(6) * 64 * 3, torch.bfloat16)[0]


def test_conv_dw_rows_hold_then_time(cpu_bench, monkeypatch):
    """The dw table of ``--conv`` / ``--deconv --grad``: a row at every
    main-path call (CONV_DW_CALLS; the generator's deconvs in their own
    weight layout), the kernel and cuDNN's ``conv2d_weight`` timed, the
    work of x and g read and dw written once, the plan tagged with what
    the launch did; a launch whose modes are not the mirror's, or a wrong
    dw, fails."""
    monkeypatch.setattr(bk, "CONV_DW_CALLS", [((2, 8, 6, 8), 16, False),
                                              ((2, 8, 8, 3), 8, True)])
    monkeypatch.setattr(conv, "conv_dw_path_on_card", lambda *a: "plain")
    mirror = {}

    def modes():
        return mirror["modes"]
    monkeypatch.setattr(conv, "conv_dw_mode_on_card", modes)
    real_modes = conv.dw_modes

    def record(*a):
        mirror["modes"] = real_modes(*a)
        return mirror["modes"]
    monkeypatch.setattr(conv, "dw_modes", record)
    # the wrapper's launch reads the modes back after the call: the
    # mirror's, as the card's entry point reports them
    real_dw = conv.conv5x5_s2_dw

    def dw(x, g, w_dtype, flip=False):
        b, h, w, cin = x.shape
        plan = conv.conv_dw_plan(b, h, w, cin, g.shape[-1], x.dtype)
        mirror["modes"] = real_modes("plain", plan, 25, cin, *g.shape[1:3])
        return real_dw(x, g, w_dtype, flip)
    monkeypatch.setattr(conv, "conv5x5_s2_dw", dw)
    gen = torch.Generator().manual_seed(0)
    rows = bk.bench_conv_dw("cpu", None, gen)
    assert [r["kernel"] for r in rows] == ["conv5x5_s2_dw"] * 2
    assert len(cpu_bench) == 4
    assert rows[1]["shape"].endswith("(deconv layout)")
    for r, (shape, co, _) in zip(rows, bk.CONV_DW_CALLS):
        assert r["op"] == "dw" and r["batch"] == shape[0]
        assert r["max_abs_err"] == 0.0 and "conv2d_weight" in r["library"]
        assert r["bound_ms"] == bk.bound(*bk.conv_dw_work(shape, co),
                                         torch.bfloat16)[0]
        assert r["path"] == "plain parts 1 cluster 1 direct"
    mirror_modes = real_modes
    monkeypatch.setattr(conv, "dw_modes",
                        lambda *a: mirror_modes(*a) | {"workspace"})
    cpu_bench.clear()
    with pytest.raises(RuntimeError, match="modes"):
        bk.bench_conv_dw("cpu", None, gen)
    assert cpu_bench == []


def test_conv5_work_at_a_hand_computed_shape():
    """x [2,8,8,4] → 4×4×6: along each axis the four outputs' taps land in
    x 4 + 5 + 5 + 3 = 17 times (pads 1 and 2), so 2·2·17²·4·6 = 27744
    operations for dx and for dw; bytes of x (512), g (192) and w (600)
    elements of 2 bytes."""
    assert bk.s2_taps(8) == 17
    assert bk.conv_dw_work((2, 8, 8, 4), 6) == (2 * (512 + 192 + 600), 27744)
    assert bk.conv_dx_work((2, 8, 8, 4), 6) == (2 * (192 + 600 + 512), 27744)
    fb, fo = bk.conv_work((2, 8, 8, 4), 6)
    assert bk.conv5_grad_work((2, 8, 8, 4), 6) == (
        fb + 2 * (192 + 2 * 512 + 2 * 600) + 24, 3 * fo)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (7, 8), (16, 16), (33, 5)])
def test_in_map_taps_are_the_plain_versions_products(h, w):
    """s2_taps and up_taps, the products a bound counts, against the plain
    versions (5×5: the sum of an all-ones conv and deconv; upconv3x3: the
    distinct input rows each output row reads)."""
    assert bk.s2_taps(h) * bk.s2_taps(w) == _in_map_products(h, w, "conv")
    assert (bk.s2_taps(2 * h) * bk.s2_taps(2 * w)
            == _in_map_products(h, w, "deconv"))
    assert bk.up_taps(h) * bk.up_taps(w) == (_combined_taps(h)
                                             * _combined_taps(w))


def test_deconv_dx_work_matches_the_tensors():
    """The deconv's dx: d and w read once, dx written once, the deconv's
    products (no bias: the route has none)."""
    gen = torch.Generator().manual_seed(0)
    shape, co = (2, 3, 5, 64), 8
    d = torch.randn(2, 6, 10, co, generator=gen).to(torch.bfloat16)
    w = torch.randn(5, 5, 64, co, generator=gen).to(torch.bfloat16)
    dx = conv.deconv5x5_s2_dx(d, w)
    assert bk.deconv_dx_work(shape, co) == (bk.nbytes(d, w, dx),
                                            bk.deconv_work(shape, co)[1])
