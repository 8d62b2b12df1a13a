"""The port's data path against the JAX package's, on the CPU, with the same
seeds: each augmentation, `FramesDataset` over frame directories, a PNG
strip and a GIF (train and test, with and without `id_sampling`),
`DatasetRepeater`, `BatchLoader`'s order for one and three workers, and
`PairedDataset` (random pairs and a CSV list). Both datasets read PNG
frames through their native codecs when those are built; here the JAX one
reads them through imageio and the port's through its own PNG reader, which
convert to float as imageio's route does (tests/test_torch_native.py holds
the codecs against each other)."""
import sys
import threading

import numpy as np
import pytest

import mrfa_tpu.data.augmentation as jaug
import mrfa_tpu.data.dataset as jdata
import mrfa_tpu_torch.data.augmentation as aug
import mrfa_tpu_torch.data.dataset as data

FRAME = 32
AUG_PARAMS = {
    "flip_param": {"horizontal_flip": True, "time_flip": True},
    "rotation_param": {"degrees": 10},
    "resize_param": {"ratio": [0.9, 1.1]},
    "crop_param": {"size": [28, 28]},
    "jitter_param": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0.1},
}


@pytest.fixture(autouse=True)
def jax_reads_through_imageio(monkeypatch):
    monkeypatch.setattr(jdata, "_read_frames_native", lambda paths: None)
    monkeypatch.setattr(data.native, "available", lambda: False)


def _clip(seed, n=2, size=FRAME):
    return list(np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32))


def _same(got, want):
    assert type(got) is type(want) or isinstance(got, (list, np.ndarray))
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)) and want and isinstance(want[0], np.ndarray):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", ["flip", "jitter", "rotation", "resize", "crop", "all"])
def test_augmentation_matches_jax(name):
    build = {
        "flip": lambda m, r: m.RandomFlip(r, **AUG_PARAMS["flip_param"]),
        "jitter": lambda m, r: m.ColorJitter(r, **AUG_PARAMS["jitter_param"]),
        "rotation": lambda m, r: m.RandomRotation(r, **AUG_PARAMS["rotation_param"]),
        "resize": lambda m, r: m.RandomResize(r, **AUG_PARAMS["resize_param"]),
        "crop": lambda m, r: m.RandomCrop(r, **AUG_PARAMS["crop_param"]),
        "all": lambda m, r: m.AllAugmentationTransform(r, **AUG_PARAMS),
    }[name]
    for seed in range(6):
        got = build(aug, np.random.RandomState(seed))(_clip(seed))
        want = build(jaug, np.random.RandomState(seed))(_clip(seed))
        _same(got, want)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """train/ and test/ splits of 32 px videos: frame directories (two clips
    of one identity), a PNG strip and a GIF."""
    import imageio.v2 as imageio

    base = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        for name, n in (("idA#1", 4), ("idA#2", 3), ("idB#1", 5)):
            d = base / split / name
            d.mkdir(parents=True)
            for t in range(n):
                frame = (rng.rand(FRAME, FRAME, 3) * 255).astype(np.uint8)
                imageio.imwrite(d / f"{t:03d}.png", frame)
        frames = (rng.rand(4, FRAME, FRAME, 3) * 255).astype(np.uint8)
        imageio.imwrite(base / split / "strip.png", np.concatenate(list(frames), axis=1))
        imageio.mimsave(base / split / "anim.gif", list(frames[:3]))
    return str(base)


@pytest.mark.parametrize("is_train,id_sampling", [(True, False), (True, True), (False, False)],
                         ids=["train", "train_id_sampling", "test"])
def test_frames_dataset_matches_jax(root, is_train, id_sampling):
    kw = dict(root_dir=root, frame_shape=(FRAME, FRAME, 3), is_train=is_train,
              id_sampling=id_sampling, augmentation_params=AUG_PARAMS, seed=3)
    got_ds, want_ds = data.FramesDataset(**kw), jdata.FramesDataset(**kw)
    assert got_ds.videos == want_ds.videos and len(got_ds) == len(want_ds) >= 3
    for _ in range(2):  # a second pass continues the shared random state
        for i in range(len(want_ds)):
            _same(got_ds[i], want_ds[i])
    state = (got_ds.rng.get_state(), want_ds.rng.get_state())
    np.testing.assert_array_equal(state[0][1], state[1][1])


def test_read_video_matches_jax_and_names_imageio_when_missing(root, monkeypatch):
    for name in ("test/idB#1", "test/strip.png", "test/anim.gif"):
        for first in (False, True):
            path = f"{root}/{name}"
            _same(data.read_video(path, (FRAME, FRAME, 3), first),
                  jdata.read_video(path, (FRAME, FRAME, 3), first))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    # PNG frame directories and strips need no imageio (the port's PNG
    # reader); a GIF does, and the error says so
    for name in ("test/idB#1", "test/strip.png"):
        _same(data.read_video(f"{root}/{name}", (FRAME, FRAME, 3)),
              jdata.read_video(f"{root}/{name}", (FRAME, FRAME, 3)))
    with pytest.raises(ImportError, match="imageio"):
        data.read_video(f"{root}/test/anim.gif")


def test_dataset_repeater_matches_jax(root):
    kw = dict(root_dir=root, frame_shape=(FRAME, FRAME, 3), is_train=False)
    got, want = data.DatasetRepeater(data.FramesDataset(**kw), 3), jdata.DatasetRepeater(
        jdata.FramesDataset(**kw), 3)
    assert len(got) == len(want) == 15
    for i in (0, 4, 7, 14):
        _same(got[i], want[i])


class _Indexed:
    """Items that are a function of the index alone."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        x = np.full((4, 4, 3), i, np.float32)
        return {"source": x, "driving": -x, "name": f"v{i}"}


@pytest.mark.parametrize("workers", [1, 3])
def test_batch_loader_order_matches_jax(workers):
    ds = _Indexed()
    got_loader = data.BatchLoader(ds, batch_size=3, seed=5, num_workers=workers)
    want_loader = jdata.BatchLoader(ds, batch_size=3, seed=5, num_workers=workers)
    assert len(got_loader) == len(want_loader) == 3
    for epoch in (0, 1):
        got, want = list(got_loader.epoch(epoch)), list(want_loader.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _same(g, w)
    # the first batches only, and an epoch left early stops its workers
    threads = threading.active_count()
    assert [b["name"] for b in got_loader.epoch(2, num_batches=2)] == [
        b["name"] for b in list(want_loader.epoch(2))[:2]]
    batches = got_loader.epoch(3)
    next(batches)
    batches.close()
    assert threading.active_count() == threads


@pytest.mark.parametrize("source", ["random", "csv"])
def test_paired_dataset_matches_jax(root, tmp_path, source):
    kw = dict(root_dir=root, frame_shape=(FRAME, FRAME, 3), is_train=False)
    if source == "csv":
        csv = tmp_path / "pairs.csv"
        csv.write_text("distance,source,driving\n0,idB#1,idA#1\n1,missing,idA#2\n"
                       "2,strip.png,anim.gif\n3,idA#2,idB#1\n")
        kw["pairs_list"] = str(csv)
    got = data.PairedDataset(data.FramesDataset(**kw), number_of_pairs=4, seed=2)
    want = jdata.PairedDataset(jdata.FramesDataset(**kw), number_of_pairs=4, seed=2)
    assert len(got) == len(want) == (3 if source == "csv" else 4)
    np.testing.assert_array_equal(np.asarray(got.pairs), np.asarray(want.pairs))
    for i in range(len(want)):
        _same(got[i], want[i])
