"""The port's data layer against the JAX package on the CPU: the StackGAN
pickle reader serves the same batches from the same seed (native and numpy
helpers), the torch7 reader and the preprocessing write the same bytes, the
natural-photo dataset is the same, and the device-resident tier's assembly
gives JAX's batch exactly when fed JAX's draws; its own draws keep the
tier's sampling laws (wrong pairs uniform over the other classes, distinct
captions)."""

import filecmp
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from tests.test_preprocess import _make_cub_raw, _make_raw, _T7Writer
from text_to_image_tpu.data import device as jdevice
from text_to_image_tpu.data import native as jnative
from text_to_image_tpu.data import natural as jnatural
from text_to_image_tpu.data import preprocess as jpreprocess
from text_to_image_tpu.data import t7 as jt7
from text_to_image_tpu.data.synthetic import SyntheticDataset as JSynthetic
from text_to_image_tpu.data.textdataset import TextDataset as JTextDataset
from text_to_image_tpu_torch.data import device as pdevice
from text_to_image_tpu_torch.data import native as pnative
from text_to_image_tpu_torch.data import natural as pnatural
from text_to_image_tpu_torch.data import preprocess as ppreprocess
from text_to_image_tpu_torch.data import t7 as pt7
from text_to_image_tpu_torch.data.pipeline import InputPipeline
from text_to_image_tpu_torch.data.synthetic import SyntheticDataset
from text_to_image_tpu_torch.data.textdataset import TextDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_split(root, split="train", n=24, src=76, captions=5, embed=32,
                classes=4, seed=0):
    """A StackGAN-format split as the reference's pickles hold it (images
    as a list of arrays)."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, split)
    os.makedirs(base, exist_ok=True)
    for fname, obj in [
            (f"{src}images.pickle",
             list(rng.integers(0, 255, (n, src, src, 3), dtype=np.uint8))),
            ("char-CNN-RNN-embeddings.pickle",
             rng.normal(size=(n, captions, embed)).astype(np.float32)),
            ("filenames.pickle", [f"img_{i}" for i in range(n)]),
            ("class_info.pickle", [int(c) for c in
                                   rng.integers(0, classes, n)])]:
        with open(os.path.join(base, fname), "wb") as f:
            pickle.dump(obj, f)
    return str(root)


@pytest.mark.parametrize("helpers", ["native", "numpy"])
@pytest.mark.parametrize("raw_uint8,window,crop,flip",
                         [(True, 2, True, True), (False, 5, True, True),
                          (True, 3, False, False)])
def test_textdataset_batches_equal_jax(tmp_path, monkeypatch, helpers,
                                       raw_uint8, window, crop, flip):
    """Same pickles, same seed: the same batches, byte for byte, through
    the C++ helpers (each package's own build) and through numpy."""
    if helpers == "numpy":
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
        monkeypatch.setattr(pnative, "get_lib", lambda: None)
    else:
        assert pnative.available() and jnative.available()
    root = write_split(tmp_path)
    kw = dict(image_size=64, embed_dim=32, random_crop=crop,
              random_flip=flip, seed=11, raw_uint8=raw_uint8)
    ref = JTextDataset(root, "train", **kw)
    got = TextDataset(root, "train", **kw)
    for _ in range(3):
        a, b = ref.next_batch(6, window), got.next_batch(6, window)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(got.test_embeddings(4),
                                  ref.test_embeddings(4))
    a, b = ref.spawn(5).next_batch(4, window), got.spawn(5).next_batch(4, window)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_from_arrays_serves_like_jax():
    rng = np.random.default_rng(2)
    images = rng.integers(0, 255, (12, 76, 76, 3), dtype=np.uint8)
    emb = rng.normal(size=(12, 4, 8)).astype(np.float32)
    cls = np.arange(12) % 3
    a = JTextDataset.from_arrays(images, emb, cls, seed=4).next_batch(5)
    b = TextDataset.from_arrays(images, emb, cls, seed=4).next_batch(5)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_native_library_builds_outside_the_source_tree():
    """The port builds ``csrc/augment.cpp`` into ``build/torch_native``;
    the JAX loader's ``csrc/libt2i_augment.so`` is not its."""
    assert pnative.SOURCE == os.path.join(ROOT, "csrc", "augment.cpp")
    assert pnative.LIBRARY == os.path.join(ROOT, "build", "torch_native",
                                           "libt2i_augment.so")
    assert pnative.available() and os.path.isfile(pnative.LIBRARY)


def test_missing_crop_source_raises_naming_preprocess(tmp_path):
    root = write_split(tmp_path)
    with pytest.raises(FileNotFoundError,
                       match="text_to_image_tpu_torch.data.preprocess"):
        TextDataset(root, "train", image_size=256, embed_dim=32)
    with pytest.raises(ValueError, match="embedding dim"):
        TextDataset(root, "train", image_size=64, embed_dim=16)


@pytest.mark.parametrize("obj", [
    "tensor", "table", "array_of_tensors", "scalars"])
def test_t7_reader_equals_jax(tmp_path, obj):
    rng = np.random.default_rng(0)
    value = {
        "tensor": rng.normal(size=(3, 2, 5)).astype(np.float32),
        "table": {"fea_txt": rng.normal(size=(4, 6)),
                  "name": "flowers", "n": 4},
        "array_of_tensors": [rng.integers(0, 9, (2, 3)).astype(np.int64),
                             rng.integers(0, 255, (4,)).astype(np.uint8)],
        "scalars": {"a": 1.5, "b": True, "c": None, "d": 7},
    }[obj]
    path = str(tmp_path / "x.t7")
    _T7Writer().save(path, value)

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
        elif isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a == b

    same(pt7.load_t7(path), jt7.load_t7(path))
    with open(path, "rb") as f:
        cut = f.read()[:-3]
    with open(path, "wb") as f:
        f.write(cut)
    with pytest.raises(pt7.T7ReadError, match="truncated"):
        pt7.load_t7(path)


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert sorted(cmp.left_list) == sorted(cmp.right_list)
    for sub in cmp.common_dirs:
        _same_tree(os.path.join(a, sub), os.path.join(b, sub))
    for f in cmp.common_files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False), f


@pytest.mark.parametrize("kind", ["generic", "flowers", "birds"])
def test_preprocess_writes_jax_bytes(tmp_path, kind):
    """The three converters write the JAX package's pickles byte for byte
    (PIL's resize, scipy's .mat reader and the t7 reader behind them)."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.default_rng(3)
    if kind == "generic":
        img_dir, emb, class_map, split_map = _make_raw(tmp_path)
        run = [(m.preprocess, (img_dir, emb, None, class_map, split_map))
               for m in (jpreprocess, ppreprocess)]
    else:
        if kind == "flowers":
            raw = tmp_path / "raw"
            (raw / "jpg").mkdir(parents=True)
            for i in range(1, 9):
                Image.fromarray(rng.integers(0, 255, (60, 70, 3),
                                             dtype=np.uint8)).save(
                    raw / "jpg" / f"image_{i:05d}.jpg")
            savemat(raw / "setid.mat", {"trnid": np.arange(1, 4)[None],
                                        "valid": np.arange(4, 6)[None],
                                        "tstid": np.arange(6, 9)[None]})
            savemat(raw / "imagelabels.mat",
                    {"labels": (np.arange(8) % 3 + 1)[None]})
        else:
            raw = _make_cub_raw(tmp_path)
        emb = str(tmp_path / "emb.t7")
        _T7Writer().save(emb, rng.normal(size=(8, 2, 32)).astype(np.float32))
        fn = "preprocess_" + kind
        run = [(getattr(m, fn), (str(raw), emb, None))
               for m in (jpreprocess, ppreprocess)]
    outs = []
    for i, (fn, args) in enumerate(run):
        out = str(tmp_path / f"out{i}")
        args = list(args)
        args[2] = out
        fn(*args)
        outs.append(out)
    _same_tree(*outs)
    np.testing.assert_array_equal(
        ppreprocess._cub_bbox_crop(np.arange(600).reshape(10, 20, 3).astype(
            np.uint8), [2, 3, 6, 4]),
        jpreprocess._cub_bbox_crop(np.arange(600).reshape(10, 20, 3).astype(
            np.uint8), [2, 3, 6, 4]))


@pytest.mark.parametrize("anchors", ["ANCHORS", "ANCHORS16"])
def test_natural_equals_jax(anchors):
    if not (jnatural.available(getattr(jnatural, anchors))
            and pnatural.available(getattr(pnatural, anchors))):
        pytest.skip("the packages that bundle the photographs are not "
                    "installed")
    kw = dict(examples_per_class=3, image_size=16, embed_dim=8, seed=2)
    ref = jnatural.NaturalPhotoDataset(anchors=getattr(jnatural, anchors), **kw)
    got = pnatural.NaturalPhotoDataset(anchors=getattr(pnatural, anchors), **kw)
    for k in ("images", "embeddings", "class_ids"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), k)
    a, b = ref.next_batch(5, 2), got.next_batch(5, 2)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert pnatural.source_paths(["china", "sky"]) == jnatural.source_paths(
        ["china", "sky"])


@pytest.mark.parametrize("class_ids", [
    [0, 1, 0, 2, 1, 0], [5, 5, 3, 3, 3, 9, 9, 9, 9], list(range(7)),
    [2, 1]])
def test_class_tables_equal_jax(class_ids):
    ref = jdevice.class_tables(np.asarray(class_ids))
    got = pdevice.class_tables(np.asarray(class_ids))
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="whole dataset"):
        pdevice.class_tables(np.zeros(4, int))


def test_stage_and_nbytes_equal_jax():
    ds = SyntheticDataset(num_examples=20, image_size=16, embed_dim=8, seed=3)
    jds = JSynthetic(num_examples=20, image_size=16, embed_dim=8, seed=3)
    assert pdevice.nbytes(ds) == jdevice.nbytes(jds)
    got, ref = pdevice.stage(ds, "cpu"), jdevice.stage(jds)
    for f in ("images", "embeddings", "class_perm", "other_start",
              "other_count"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    assert got.images.dtype == torch.uint8
    assert got.embeddings.dtype == torch.float32


def jax_draws(data, key, n_critic, batch, size, window, crop, flip):
    """The random variables JAX's `sample_stacked` draws from `key`,
    replayed key by key (one `sample_batch` per critic update), in the
    port's `draw` layout."""
    n, src = data.images.shape[:2]
    c = data.embeddings.shape[1]
    parts = {k: [] for k in ("idx", "u", "real_off", "real_flip",
                             "wrong_off", "wrong_flip", "cap_keys")}
    for k in jax.random.split(key, n_critic):
        kidx, kw, kreal, kwrong, kcap = jax.random.split(k, 5)
        idx = jax.random.randint(kidx, (batch,), 0, n)
        parts["idx"].append(idx)
        parts["u"].append(jax.random.randint(kw, (batch,), 0,
                                             data.other_count[idx]))
        for s, ks in (("real", kreal), ("wrong", kwrong)):
            kc, kf = jax.random.split(ks)
            parts[f"{s}_off"].append(
                jax.random.randint(kc, (2, batch), 0, src - size + 1))
            parts[f"{s}_flip"].append(jax.random.bernoulli(kf, 0.5, (batch,)))
        parts["cap_keys"].append(jax.random.uniform(kcap, (batch, c)))
    out = {}
    for k, v in parts.items():
        a = np.stack([np.asarray(x) for x in v])
        if k.endswith("_off"):
            a = np.moveaxis(a, 1, 0)             # [2, K, B]
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu"
                                  else a)
    if not (crop and src != size):
        out["real_off"] = out["wrong_off"] = None
    if not flip:
        out["real_flip"] = out["wrong_flip"] = None
    if window >= c:
        out["cap_keys"] = None
    return out


@pytest.mark.parametrize("window,crop,flip,src", [
    (2, True, True, 20), (5, False, False, 20), (3, True, False, 20),
    (1, False, True, 16), (4, True, True, 16)])
def test_resident_assembly_of_jax_draws_equals_jax(window, crop, flip, src):
    """JAX's `sample_stacked` from a key, and the port's `assemble` of the
    draws JAX made from that key: the same batch, bit for bit."""
    ds = JSynthetic(num_examples=40, image_size=src, embed_dim=16,
                    num_classes=4, captions_per_image=5, seed=1)
    jdata = jdevice.stage(ds)
    key = jax.random.PRNGKey(7)
    ref = jdevice.sample_stacked(jdata, key, 2, 6, 16, window, crop, flip)
    got = pdevice.assemble(pdevice.stage(ds, "cpu"),
                           jax_draws(jdata, key, 2, 6, 16, window, crop,
                                     flip), 16, window)
    assert ref.keys() == got.keys()
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].dtype == {"real": torch.uint8, "wrong": torch.uint8,
                                "emb": torch.float32}[k]
        np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)


def test_resident_draws_keep_the_sampling_laws():
    """The port's own draws: the wrong example is always of another class
    and uniform over those (χ² at a fixed seed), the window's captions are
    distinct, crops lie inside the source and flips mirror."""
    n, k_classes = 30, 3
    cls = np.repeat(np.arange(k_classes), [5, 10, 15])
    rng = np.random.default_rng(0)
    ds = TextDataset.from_arrays(
        rng.integers(0, 255, (n, 20, 20, 3), dtype=np.uint8),
        rng.normal(size=(n, 6, 4)).astype(np.float32), cls, image_size=16)
    data = pdevice.stage(ds, "cpu")
    g = torch.Generator().manual_seed(3)
    d = pdevice.draw(data, g, (40, 500), 16, 3, True, True)
    idx, u = d["idx"], d["u"]
    wrong = data.class_perm[(data.other_start[idx] + u) % n]
    assert not bool((torch.from_numpy(cls)[wrong]
                     == torch.from_numpy(cls)[idx]).any())
    # given the real example's class, every other-class example is as likely
    from scipy.stats import chisquare
    for c in range(k_classes):
        picked = wrong[torch.from_numpy(cls)[idx] == c]
        others = np.flatnonzero(cls != c)
        counts = np.bincount(picked.numpy(), minlength=n)[others]
        assert counts.sum() == len(picked)
        assert chisquare(counts).pvalue > 1e-3, (c, counts)
    assert bool((u >= 0).all()) and bool((u < data.other_count[idx]).all())
    picks = torch.argsort(d["cap_keys"], dim=-1)[..., :3]
    assert bool((picks.sort(-1).values.diff(dim=-1) > 0).all())
    assert int(d["real_off"].min()) >= 0 and int(d["real_off"].max()) <= 4
    assert 0.45 < float(d["real_flip"].float().mean()) < 0.55
    batch = pdevice.assemble(data, d, 16, 3)
    i, (y, x) = 7, d["real_off"][:, 0, 7]
    want = ds.images[int(idx[0, i]), int(y):int(y) + 16, int(x):int(x) + 16]
    if bool(d["real_flip"][0, i]):
        want = want[:, ::-1]
    np.testing.assert_array_equal(batch["real"][0, i].numpy(), want)


def test_sample_stacked_is_a_function_of_the_key():
    ds = SyntheticDataset(num_examples=32, image_size=20, embed_dim=8, seed=0)
    data = pdevice.stage(ds, "cpu")
    a, b, c = (pdevice.sample_stacked(data, pdevice.batch_key(0, s), 2, 4,
                                      16, 3, True, True) for s in (5, 5, 6))
    for k in a:
        assert a[k].shape[:2] == (2, 4)
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["real"], c["real"])


def test_host_pipeline_stacks_the_dataset_stream():
    """The host tier: [K, B, …] tensors, the dataset's own next_batch
    stream in order (one worker)."""
    ds = SyntheticDataset(num_examples=32, image_size=16, embed_dim=8, seed=0)
    ref = SyntheticDataset(num_examples=32, image_size=16, embed_dim=8, seed=0)
    pipe = InputPipeline(ds, 4, "cpu", window=3, batches_per_step=2,
                         prefetch=2)
    try:
        for _ in range(3):
            got = next(pipe)
            want = [ref.next_batch(4, 3) for _ in range(2)]
            for k in want[0]:
                assert isinstance(got[k], torch.Tensor)
                np.testing.assert_array_equal(
                    got[k].numpy(), np.stack([w[k] for w in want]), k)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()
