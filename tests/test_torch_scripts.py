"""The port's scripts (``text_to_image_tpu_torch/scripts``) on the CPU,
held against the JAX package's ``scripts/`` where those run here: the same
configs from every config function, the same ``_saturation`` of one
``train.jsonl``, the same best-record sequence of the trajectory hook, the
same classifier ``.npz`` from one torchvision checkpoint.  The three
repairs of the StackGAN chain (a NaN trajectory, the resumed seed, a
replayed eval step) each have a test that fails without them.  Every
training journey runs whole at tiny widths (its config function shrunk, as
``tests/helpers.tiny_config`` shrinks the JAX ones), the kernels' plain
versions standing in on the CPU."""

import dataclasses
import importlib.util
import json
import math
import os
import runpy
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from text_to_image_tpu_torch import scripts
from text_to_image_tpu_torch.config import GanConfig
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.eval import inception_v3 as iv3
from text_to_image_tpu_torch.eval import synthetic_quality as sq
from text_to_image_tpu_torch.eval.inception import load_classifier
from text_to_image_tpu_torch.scripts import (chained_stackgan,
                                             convergence_check,
                                             convert_inception,
                                             pggan_progression, profile_step,
                                             serve_profile, stage2_dynamics)
from text_to_image_tpu_torch.train.checkpoint import CheckpointManager
from text_to_image_tpu_torch.train.optim import flatten
from text_to_image_tpu_torch.train.steps import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GAN = GanConfig(gf_dim=8, df_dim=8, z_dim=8, embed_dim=32,
                     compressed_embed_dim=16, ca_dim=8, res_blocks=1)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tiny runs are many small ops, which a
    thread pool per worker of a loaded test run slows many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def jax_script(name, monkeypatch):
    """The JAX package's ``scripts/<name>.py`` as a module (its imports of
    the JAX package and its ``sys.path`` edits undone after the test)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shrink(cfg, size=None, batch=4):
    """`cfg` at tiny widths, f32, a metric record every step."""
    cfg = cfg.replace(gan=TINY_GAN, dtype="float32",
                      train=dataclasses.replace(cfg.train, batch_size=batch,
                                                summary_interval=1))
    if size:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, image_size=size))
    return cfg


def tiny_chain(monkeypatch, module=chained_stackgan):
    """Stage-I at 8 px and Stage-II at 32 px over a 32-example split."""
    orig = chained_stackgan._cfg
    monkeypatch.setattr(module, "_cfg", lambda model, size, *a, **k: shrink(
        orig(model, size, *a, **k), size // 8))
    monkeypatch.setattr(module, "_dataset", lambda size, d="synthetic":
                        SyntheticDataset(num_examples=32,
                                         image_size=size // 8, embed_dim=32,
                                         num_classes=4, seed=0))


def fake_evaluate(values, calls=None):
    """An `evaluate` that returns the next of `values` (dicts)."""
    it = iter(values)

    def evaluate(*args, **kw):
        if calls is not None:
            calls.append(args[1])
        return {"r": 0.5, "clf_acc": 1.0, "cond_acc": 0.5, "is_std": 0.1,
                **next(it)}
    return evaluate


def result(printed, tag):
    line = [ln for ln in printed.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line[len(tag) + 1:])


# --- the config functions and _saturation against the JAX scripts ----------

@pytest.mark.parametrize("model,dataset", [
    ("gancls", "synthetic"), ("gancls_int", "synthetic"),
    ("wgancls", "synthetic"), ("wgancls", "natural"), ("pggan", "synthetic")])
def test_convergence_config_matches_jax(model, dataset, monkeypatch):
    jax_cc = jax_script("convergence_check", monkeypatch)
    assert (dataclasses.asdict(convergence_check._config(model, dataset))
            == dataclasses.asdict(jax_cc._config(model, dataset)))


@pytest.mark.parametrize("args", [
    ("stackgan_stage1", 64, "runs/c", "synthetic", 0.0, 1),
    ("stackgan_stage2", 256, "runs/c", "natural", 0.999, 2)])
def test_chained_config_matches_jax(args, monkeypatch):
    jax_cs = jax_script("chained_stackgan", monkeypatch)
    assert (dataclasses.asdict(chained_stackgan._cfg(*args))
            == dataclasses.asdict(jax_cs._cfg(*args)))


@pytest.mark.parametrize("variant", ["base", "smooth", "g2", "dlr", "dthin",
                                     "smooth+g2", "dlr+dthin"])
def test_stage2_variant_config_matches_jax(variant, monkeypatch):
    jax_sd = jax_script("stage2_dynamics", monkeypatch)
    base = ("stackgan_stage2", 256, "runs/v", "natural")
    assert (dataclasses.asdict(stage2_dynamics._variant_cfg(
        chained_stackgan._cfg(*base), variant))
        == dataclasses.asdict(jax_sd._variant_cfg(jax_sd._cfg(*base),
                                                  variant)))


def test_stage2_variant_refuses_unknown_part():
    with pytest.raises(SystemExit):
        stage2_dynamics._variant_cfg(
            chained_stackgan._cfg("stackgan_stage2", 256, "r"), "g2+wide")


@pytest.mark.parametrize("args", [(3000, 256, "runs/p", "synthetic", 0.0, 0.0),
                                  (50, 64, "runs/p", "natural", 0.999, 10.0)])
def test_pggan_config_matches_jax(args, monkeypatch):
    jax_pp = jax_script("pggan_progression", monkeypatch)
    assert (dataclasses.asdict(pggan_progression._cfg(*args))
            == dataclasses.asdict(jax_pp._cfg(*args)))


def test_saturation_matches_jax(tmp_path, monkeypatch):
    """The same dict from one written ``train.jsonl`` (records without
    d_loss skipped; the tail from the half-way record on)."""
    jax_sd = jax_script("stage2_dynamics", monkeypatch)
    path = tmp_path / "stackgan_stage2" / "synthetic"
    path.mkdir(parents=True)
    rng = np.random.default_rng(0)
    with open(path / "train.jsonl", "w") as f:
        for step in range(1, 24):
            rec = {"step": step, "g_loss": float(rng.normal())}
            if step % 5:
                rec["d_loss"] = float(10.0 ** rng.uniform(-6, 0.5))
            f.write(json.dumps(rec) + "\n")
    got = stage2_dynamics._saturation(str(tmp_path), "stackgan_stage2",
                                      "synthetic")
    assert got == jax_sd._saturation(str(tmp_path), "stackgan_stage2",
                                     "synthetic")
    assert 0 < got["d_sat_frac_tail"] < 1


# --- the trajectory hook ------------------------------------------------------

def _hook_fixture(tmp_path, monkeypatch, values, ckpt=None):
    cfg = shrink(chained_stackgan._cfg("gancls", 16, str(tmp_path)), 16)
    monkeypatch.setattr(sq, "evaluate", fake_evaluate(values))
    saved = []
    trainer = types.SimpleNamespace(
        ts=init_train_state(0, cfg, 8, "cpu"),
        save_samples=lambda step: saved.append(step))
    return cfg, trainer, saved


def test_traj_hook_persists_best_json_like_jax(tmp_path, monkeypatch):
    """The sequence of ``tests/test_trainer.py``'s hook test: best.json
    written on each new IS peak and only then, the best checkpoint the
    peak's step."""
    cfg, trainer, saved = _hook_fixture(
        tmp_path, monkeypatch, [{"is_mean": 5.0, "cond_acc": 0.5},
                                {"is_mean": 4.0, "cond_acc": 0.9},
                                {"is_mean": 6.0, "cond_acc": 0.7}])
    mgr = CheckpointManager(str(tmp_path / "best"), max_to_keep=1)
    points, state = [], {"ckpt": mgr}
    hook = chained_stackgan._traj_hook(cfg, types.SimpleNamespace(
        num_classes=4), points, state, "cpu")
    best_json = os.path.join(mgr.directory, "best.json")
    hook(trainer, 1)
    assert json.load(open(best_json))["step"] == 1
    hook(trainer, 2)               # worse IS: best.json untouched
    assert json.load(open(best_json))["step"] == 1
    hook(trainer, 3)
    rec = json.load(open(best_json))
    assert rec["step"] == 3 and rec["is_mean"] == 6.0
    assert mgr.all_steps() == [3] and saved == [1, 3]
    assert [p["step"] for p in points] == [1, 2, 3]


class RefusingManager:
    """A best manager that, like Orbax's, refuses a step it holds."""

    def __init__(self, directory, held):
        self.directory, self.saved = str(directory), list(held)
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step, ts):
        if step in self.saved:
            raise ValueError(f"step {step} already exists")
        self.saved.append(step)


def test_replayed_eval_step_does_not_save_again(tmp_path, monkeypatch):
    """Repair (JAX ``chained_stackgan.py:111``): after ``--resume`` the
    trajectory replays evals at or before the best record's step; even a
    better replayed eval neither saves the best checkpoint again nor
    replaces the record beside it.  The next new step still can."""
    cfg, trainer, saved = _hook_fixture(
        tmp_path, monkeypatch, [{"is_mean": 9.0}, {"is_mean": 9.5},
                                {"is_mean": 7.0}])
    seeded = {"is_mean": 5.0, "r": 0.9, "step": 4}
    mgr = RefusingManager(tmp_path / "best", held=[4])
    points, state = [dict(seeded, resumed_seed=True)], {"ckpt": mgr,
                                                        "best": seeded}
    hook = chained_stackgan._traj_hook(cfg, types.SimpleNamespace(
        num_classes=4), points, state, "cpu")
    hook(trainer, 2)
    hook(trainer, 4)
    assert state["best"] == seeded and mgr.saved == [4] and saved == []
    assert not os.path.exists(os.path.join(mgr.directory, "best.json"))
    hook(trainer, 6)
    assert state["best"]["step"] == 6 and mgr.saved == [4, 6]
    assert [p["step"] for p in points] == [4, 2, 4, 6]


def test_all_nan_trajectory_still_prints_the_result(tmp_path, monkeypatch,
                                                     capsys):
    """Repair (JAX ``:214``): every trajectory eval has a NaN IS, so no best
    record is ever set; the run still prints CHAINED RESULT (without
    ``stage2_best``) and FAIL, where the JAX script raises KeyError."""
    tiny_chain(monkeypatch)
    nan = {"is_mean": float("nan"), "r": float("nan")}
    monkeypatch.setattr(sq, "evaluate", fake_evaluate([nan] * 4))
    rc = chained_stackgan.main(1, 2, root=str(tmp_path / "run"),
                               traj_interval=1, device="cpu")
    out = capsys.readouterr().out
    res = result(out, "CHAINED RESULT")
    assert rc == 1 and "CHAINED FAIL" in out
    assert "stage2_best" not in res and len(res["stage2_traj"]) == 2
    assert math.isnan(res["stage2"]["is_mean"])


def test_resumed_final_eval_drops_the_seed_mark_and_keeps_the_ema_ab(
        tmp_path, monkeypatch, capsys):
    """Repair (JAX ``:205``): a resumed run whose seeded best is the final
    step takes its result from that record without the ``resumed_seed``
    mark, and with the generator EMA still reports the live params' IS
    and r beside it."""
    tiny_chain(monkeypatch)
    root = str(tmp_path / "run")
    good = {"is_mean": 6.0, "r": 0.95}
    calls = []
    # Stage-I EMA and live, Stage-II's trajectory eval and live A/B; then
    # resumed: Stage-I EMA and live, Stage-II's live A/B
    monkeypatch.setattr(sq, "evaluate", fake_evaluate(
        [good, {"is_mean": 5.0}, good, {"is_mean": 5.5, "r": 0.8},
         {"is_mean": 4.5}, {"is_mean": 4.0}, {"is_mean": 5.5, "r": 0.7}],
        calls))
    kw = dict(root=root, traj_interval=2, ema_decay=0.999, device="cpu")
    assert chained_stackgan.main(1, 2, **kw) == 0
    capsys.readouterr()
    # resumed: both stages restore their step; the seeded best is step 2
    assert chained_stackgan.main(1, 2, resume=True, **kw) == 0
    res = result(capsys.readouterr().out, "CHAINED RESULT")
    assert res["stage2"] == {"r": 0.95, "clf_acc": 1.0, "cond_acc": 0.5,
                             "is_std": 0.1, "is_mean": 6.0,
                             "live_is_mean": 5.5, "live_r": 0.7}
    assert res["stage2_traj"][0]["resumed_seed"] is True
    # the A/B's eval was of the live params (no EMA average in its aux)
    assert "ema_g_params" not in calls[-1].aux
    assert "ema_g_params" in calls[-3].aux


# --- the journeys whole at tiny widths ---------------------------------------

def test_chained_stackgan_traj_then_resume(tmp_path, monkeypatch, capsys):
    """The real protocol at tiny widths: Stage-I, Stage-II with a
    trajectory, then a resume after an interruption before Stage-II's first
    snapshot (its checkpoints removed): the evals at or before the best
    step are replayed, and best.json still names the checkpoint beside
    it."""
    tiny_chain(monkeypatch)
    root = tmp_path / "run"
    rc = chained_stackgan.main(2, 2, root=str(root), traj_interval=1,
                               device="cpu")
    first = result(capsys.readouterr().out, "CHAINED RESULT")
    assert rc in (0, 1)
    assert [p["step"] for p in first["stage2_traj"]] == [1, 2]
    ck = root / "ck" / "stackgan_stage2"
    shutil.rmtree(ck / "synthetic")
    chained_stackgan.main(2, 3, root=str(root), traj_interval=1, resume=True,
                          device="cpu")
    out = capsys.readouterr().out
    again = result(out, "CHAINED RESULT")
    assert "resume: seeded best" in out
    assert [p["step"] for p in again["stage2_traj"]] == [
        first["stage2_best"]["step"], 1, 2, 3]
    best = json.load(open(ck / "synthetic_best" / "best.json"))
    assert CheckpointManager(str(ck / "synthetic_best")).all_steps() == [
        best["step"]]
    assert best == again["stage2_best"]
    assert (root / "samples" / "stackgan_stage2" / "synthetic" /
            "train_00000003.png").exists()


def test_stage2_dynamics_reuses_one_stage1(tmp_path, monkeypatch, capsys):
    tiny_chain(monkeypatch, stage2_dynamics)
    root = str(tmp_path / "s2ab")
    assert stage2_dynamics.main(2, 2, ["smooth+g2"], "synthetic",
                                root=root, device="cpu") == 0
    rows = result(capsys.readouterr().out, "S2AB RESULT")
    assert set(rows) == {"smooth+g2"}
    assert all(0 <= q["d_sat_frac_tail"] <= 1 for q in rows.values())
    assert stage2_dynamics.main(2, 2, ["dthin"], "synthetic",
                                keep_stage1=True, root=root,
                                device="cpu") == 0
    assert "reusing checkpoint" in capsys.readouterr().out


def test_convergence_check_runs_and_writes_the_class_grid(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    orig = convergence_check._config
    monkeypatch.setattr(convergence_check, "_config",
                        lambda m, d="synthetic": shrink(orig(m, d), 16))
    monkeypatch.setattr(convergence_check, "_dataset",
                        lambda d="synthetic": SyntheticDataset(
                            num_examples=64, image_size=16, embed_dim=32,
                            num_classes=4, seed=0))
    grid = tmp_path / "grid.png"
    rc = convergence_check.main(3, "gancls", "synthetic", str(grid),
                                device="cpu")
    out = capsys.readouterr().out
    res = result(out, "CONVERGENCE RESULT")
    assert rc == (0 if "CONVERGENCE PASS" in out else 1)
    assert all(math.isfinite(v) for v in res.values())
    assert set(res) >= {"margin", "r", "cond_acc", "is_mean", "clf_acc"}
    head = open(grid, "rb").read(24)
    # 8 images a class in a row, one row a class, 16 px each
    assert (int.from_bytes(head[16:20], "big"),
            int.from_bytes(head[20:24], "big")) == (8 * 16, 4 * 16)


def test_pggan_progression_and_resume(tmp_path, monkeypatch, capsys):
    orig = pggan_progression._cfg
    monkeypatch.setattr(pggan_progression, "_cfg",
                        lambda *a, **k: shrink(orig(*a, **k)))
    root = str(tmp_path / "pg")
    rc = pggan_progression.main(1, 16, root=root, ema_decay=0.999,
                                ema_rampup=10.0, device="cpu")
    out = capsys.readouterr().out
    assert rc in (0, 1) and "[pggan] stage 3/3 (16 px" in out
    assert "LIVE-params eval" in out
    assert set(result(out, "PGGAN256 RESULT")) >= {"r", "is_mean"}
    assert os.path.exists(os.path.join(root, "samples",
                                       "pggan_16px_synthetic_grid.png"))
    pggan_progression.main(1, 16, root=root, resume=True, ema_decay=0.999,
                           ema_rampup=10.0, device="cpu")
    out = capsys.readouterr().out
    assert "covers stages 1..2: resuming at stage 3/3" in out
    assert "[pggan] restored step 3" in out


def test_profile_step_writes_a_trace(tmp_path, monkeypatch, capsys):
    orig = profile_step.profile
    monkeypatch.setattr(profile_step, "profile", lambda cfg, *a, **k: orig(
        shrink(cfg, 16), *a, **k))
    out = tmp_path / "trace"
    assert profile_step.main(["--steps", "2", "--out", str(out), "--device",
                              "cpu"]) == 0
    traces = [f for f in os.listdir(out) if f.endswith(".json")]
    assert len(traces) == 1 and "ms/step" in capsys.readouterr().out


def test_serve_profile_one_column_seven_stages(monkeypatch, capsys):
    orig = serve_profile.base_config
    monkeypatch.setattr(serve_profile, "base_config",
                        lambda b=32: shrink(orig(b), batch=b))
    assert serve_profile.main(2, device="cpu", iters=1) == 0
    res = result(capsys.readouterr().out, "SERVE RESULT")
    assert res["device"] == "cpu" and len(res["cum_ms"]) == 7
    assert np.allclose(np.cumsum(res["delta_ms"]), res["cum_ms"])


# --- the converter against the JAX script -------------------------------------

def test_convert_inception_matches_jax_script(tmp_path, monkeypatch):
    """One torchvision-layout checkpoint, nested under ``state_dict`` with
    ``module.`` keys, through both packages' converters: the same tree in
    both ``.npz``, which the port's `load_classifier` reads."""
    params = iv3.init(0, 10)
    pth = tmp_path / "ft.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               iv3.export_torchvision_state_dict(
                                   params).items()}}, str(pth))
    ours, theirs = tmp_path / "port.npz", tmp_path / "jax.npz"
    assert convert_inception.main(["--pth", str(pth), "--out",
                                   str(ours)]) == 0
    monkeypatch.setattr(sys, "argv", ["convert_inception.py", "--pth",
                                      str(pth), "--out", str(theirs)])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(os.path.join(ROOT, "scripts", "convert_inception.py"),
                   run_name="__main__")
    trees = [dict(flatten(np.load(p, allow_pickle=True)["params"].item()))
             for p in (ours, theirs)]
    assert trees[0].keys() == trees[1].keys()
    for k, v in trees[1].items():
        assert np.array_equal(trees[0][k], v), k
    want = dict(flatten(params))
    assert all(np.array_equal(trees[0][k], want[k].numpy()) for k in want)
    logits = load_classifier(str(ours), "cpu")(
        torch.rand(2, 64, 64, 3) * 2 - 1)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())


# --- the command lines ----------------------------------------------------------

@pytest.mark.parametrize("module,argv,want", [
    (chained_stackgan, ["100", "200", "natural", "--ema", "--traj=50",
                        "--resume", "--s2-g2", "--device", "cpu"],
     {"stage1_steps": 100, "stage2_steps": 200, "dataset": "natural",
      "ema_decay": 0.999, "traj_interval": 50, "resume": True,
      "stage2_g_steps": 2, "device": "cpu"}),
    (chained_stackgan, ["--traj", "--ema=0.99"],
     {"traj_interval": 1000, "ema_decay": 0.99, "device": "cuda"}),
    (convergence_check, ["1500", "wgancls", "synthetic", "g.png", "--iv3",
                         "--device=cpu"],
     {"steps": 1500, "model": "wgancls", "dataset": "synthetic",
      "grid_path": "g.png", "with_iv3": True, "device": "cpu"}),
    (pggan_progression, ["10", "64", "--ema-rampup", "--ema=0.9",
                         "--resume"],
     {"steps_per_stage": 10, "image_size": 64, "ema_rampup": 10.0,
      "ema_decay": 0.9, "resume": True, "device": "cuda"}),
    (stage2_dynamics, ["5", "6", "base,g2", "--dataset=synthetic",
                       "--keep-stage1"],
     {"stage1_steps": 5, "stage2_steps": 6, "variants": ["base", "g2"],
      "dataset": "synthetic", "keep_stage1": True, "device": "cuda"}),
    (serve_profile, ["16", "--device", "cpu"],
     {"batch": 16, "device": "cpu"}),
])
def test_command_lines_parse_as_the_jax_scripts(module, argv, want):
    assert module.parse_argv(argv) == want


def test_device_flag_needs_a_value():
    with pytest.raises(SystemExit):
        scripts.split_device(["1", "--device"])
