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


def _inputs(shape, co, k, gen):
    x = torch.randn(shape, generator=gen).to(torch.bfloat16)
    w = torch.randn(k, k, shape[-1], co, generator=gen).to(torch.bfloat16)
    return x, w


@pytest.mark.parametrize("shape,co", [((2, 5, 7, 8), 16), ((3, 4, 4, 64), 3)])
def test_bytes_and_operations_match_the_tensors(shape, co):
    """Each input read once, each output written once (the bf16 tensors
    and the f32 per-channel vectors the bench builds), and the
    multiply-adds of each kernel counted by hand."""
    gen = torch.Generator().manual_seed(0)
    b, h, w, cin = shape
    x, w5 = _inputs(shape, co, 5, gen)
    s = t = torch.ones(co)
    y = conv.deconv5x5_s2(x, w5, s, t, "relu")
    assert bk.deconv_work(shape, co) == (bk.nbytes(x, w5, s, t, y),
                                         2 * 25 * b * h * w * cin * co)
    y = conv.conv5x5_s2_act(x, w5, t, "lrelu")
    assert bk.conv_work(shape, co) == (
        bk.nbytes(x, w5, t, y),
        2 * 25 * y.shape[0] * y.shape[1] * y.shape[2] * cin * co)
    x3, w3 = _inputs(shape, co, 3, gen)
    y = conv.upconv3x3_bias(x3, w3, t, "none")
    fwd = (bk.nbytes(x3, w3, t, y), 2 * 16 * b * h * w * cin * co)
    assert bk.upconv_work(shape, co) == fwd
    # backward: g read, dx, dw, db written; x and w read again
    assert bk.upconv_grad_work(shape, co) == (
        fwd[0] + bk.nbytes(y, x3, x3, w3, w3) + 4 * co, 3 * fwd[1])
    e = 12
    tt = torch.randn(b, e, generator=gen).to(torch.bfloat16)
    wx = torch.randn(cin, co, generator=gen).to(torch.bfloat16)
    wt = torch.randn(e, co, generator=gen).to(torch.bfloat16)
    y = fused.conditioning_join(x, tt, wx, wt, t, "none")
    assert bk.join_work(shape, e, co) == (
        bk.nbytes(x, tt, wx, wt, t, y),
        2 * b * h * w * cin * co + 2 * b * e * co)


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = bk.bound(3.35e9, 1.0, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = bk.bound(1.0, 989e9, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    assert bk.bound(1.0, 67e9, torch.float32)[0] == pytest.approx(1.0)
    # the GAN-CLS generator's first deconv is bound by its operations
    ms, by = bk.bound(*bk.deconv_work((64, 4, 4, 1024), 512), torch.bfloat16)
    assert by == "operations" and ms == pytest.approx(
        2 * 25 * 64 * 16 * 1024 * 512 / 989e12 * 1e3)


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
    monkeypatch.setattr(bk, "UPCONV_GRAD_SHAPES", [((2, 4, 4, 8), 8)])
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


def test_main_needs_a_gpu_and_pairs_upconv_with_grad(capsys):
    assert bk.main([]) == 2
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
    for argv in (["--upconv"], ["--grad"]):
        with pytest.raises(SystemExit):
            bk.main(argv)


def test_every_kernel_of_the_main_paths_has_a_table():
    """Each kernel wrapper that the main paths launch (``chip_smoke.py``
    counts them; ``upconv3x3_bias`` counts on ``upconv3x3``) is a kernel of
    the default table."""
    import chip_smoke
    names = {c.__name__ for c in chip_smoke.all_counters()}
    assert {k.replace("upconv3x3_bias", "upconv3x3")
            for k in bk.KERNELS} == names
