"""The port's end-to-end demo and parity runbook (Python counterparts of the
JAX package's ``scripts/e2e_demo.sh`` and ``scripts/parity_runbook.sh``)
run whole on the CPU at 2 steps and tiny widths: the raw JPGs (Pillow), the
preprocessing, the InceptionV3 conversion, ``main.py --train`` and
``--eval-is``, each a ``python -m`` process of its own.  The runbook's
stand-in classifier ``.npz`` is held against the JAX script's conversion of
the same ``.pth``."""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from text_to_image_tpu_torch.scripts import e2e_demo, parity_runbook
from text_to_image_tpu_torch.train.optim import flatten

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --set pairs for both main.py runs: tiny widths at the datasets' 64 px
SMALL = ["gan.gf_dim=8", "gan.df_dim=8", "gan.z_dim=8",
         "gan.compressed_embed_dim=16", "train.batch_size=4",
         "dtype=float32"]
IS_IMAGES = 20          # two images a split of the IS's ten


def _result(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread here and in the scripts' processes: their tiny
    runs are many small ops, which a thread pool per worker of a loaded
    test run slows many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The demo run whole once: (its work directory, what it printed)."""
    work = tmp_path_factory.mktemp("e2e") / "work"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = e2e_demo.main(str(work), steps=2, is_images=IS_IMAGES,
                           device="cpu", overrides=SMALL)
    assert rc == 0
    return work, out.getvalue()


def test_e2e_demo_runs_whole(demo):
    work, out = demo
    assert "e2e demo OK" in out
    res = _result(out, "E2E RESULT")
    assert 1.0 <= res["is_mean"] <= 6.0
    assert [os.path.basename(g) for g in res["grids"]] == [
        "eval_grid_2.png", "t_interp_2.png", "z_interp_2.png"]
    # the split preprocess wrote from the 48 raw images
    assert {p.name for p in (work / "data" / "train").iterdir()} >= {
        "76images.pickle", "304images.pickle", "class_info.pickle",
        "char-CNN-RNN-embeddings.pickle", "filenames.pickle"}
    ck = work / "run" / "ck" / "gancls" / "demo"
    assert sorted(os.listdir(ck)) == ["step_2.pt"]


def test_parity_runbook_runs_whole(tmp_path, capsys, monkeypatch):
    work = tmp_path / "parity"
    assert parity_runbook.main("synthetic", str(work), steps=2,
                               is_images=IS_IMAGES, device="cpu",
                               overrides=SMALL) == 0
    out = capsys.readouterr().out
    assert "parity runbook OK" in out and "2.66 ± .03" in out
    assert "using converted classifier checkpoint" in out
    res = _result(out, "PARITY RESULT")
    assert 1.0 <= res["is_mean"] <= parity_runbook.NCLS
    # the stand-in classifier converted as the JAX script converts it
    theirs = tmp_path / "jax.npz"
    monkeypatch.setattr(sys, "argv", [
        "convert_inception.py", "--pth",
        str(work / "finetuned_inception.pth"), "--out", str(theirs)])
    monkeypatch.setattr(sys, "path", list(sys.path))
    runpy.run_path(os.path.join(ROOT, "scripts", "convert_inception.py"),
                   run_name="__main__")
    a, b = (dict(flatten(np.load(p, allow_pickle=True)["params"].item()))
            for p in (work / "data" / "inception.npz", theirs))
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_parity_runbook_refuses_the_flowers_mode(tmp_path):
    with pytest.raises(SystemExit, match="only the synthetic mode"):
        parity_runbook.main("flowers", str(tmp_path))
