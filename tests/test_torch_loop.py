"""The port's training loop, logger, image writers and CLI on the CPU: the
phase schedule and checkpoint cadence against the JAX loop's formulas,
`Logger`'s log lines and images and `Visualizer`'s grids against
`mrfa_tpu.utils.logger`, the PNG writer read back by imageio, the JAX loop's
`clip_grad` default, and `python -m mrfa_tpu_torch.cli.run --device cpu` in
all three modes over a PNG dataset."""
import contextlib
import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from mrfa_tpu_torch.train.loop import epoch_phase, is_checkpoint_epoch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    loop_config, one_torch_thread, write_png_videos,
)


def _jax_phase(tp, epoch):
    """mrfa_tpu/train/loop.py's per-epoch phase, as written there."""
    num_epochs, bg_start, prior_model = tp["num_epochs"], tp["bg_start"], tp["prior_model"]
    use_bg = epoch >= bg_start and bg_start < num_epochs
    if prior_model == "tpsm" and epoch < tp.get("dropout_epoch", 0):
        dropout_flag = True
        dropout_p = min(
            epoch / tp["dropout_inc_epoch"] * tp["dropout_maxp"] + tp["dropout_startp"],
            tp["dropout_maxp"],
        )
    else:
        dropout_flag = False
        dropout_p = 0.0
    return use_bg, dropout_flag, dropout_p


@pytest.mark.parametrize("cfg_name", ["vox1", "celebvhq", "bg_late", "tpsm"])
def test_phase_schedule_and_checkpoint_cadence_match_jax(cfg_name):
    path = {"vox1": "config/vox1.yaml"}.get(cfg_name, "config/celebvhq.yaml")
    with open(os.path.join(os.path.dirname(__file__), "..", path)) as f:
        tp = yaml.safe_load(f)["train_params"]
    if cfg_name == "bg_late":
        tp["bg_start"] = 37
    if cfg_name == "tpsm":
        tp["prior_model"] = "tpsm"
    freqs = (1, 7, tp.get("checkpoint_freq", 100))
    for epoch in range(tp["num_epochs"]):
        assert epoch_phase(tp, epoch) == _jax_phase(tp, epoch)
        for freq in freqs:  # the JAX loop's cadence (loop.py:263)
            want = (epoch + 1) % freq == 0 or epoch == tp["num_epochs"] - 1
            assert is_checkpoint_epoch(epoch, tp["num_epochs"], freq) == want
    phases = [epoch_phase(tp, e)[0] for e in range(tp["num_epochs"])]
    assert phases == [e >= tp["bg_start"] and tp["bg_start"] < tp["num_epochs"]
                      for e in range(tp["num_epochs"])]


def _vis_inputs(seed=0, b=1, size=24):
    rng = np.random.RandomState(seed)
    img = lambda: rng.rand(b, size, size, 3).astype(np.float32)  # noqa: E731
    kp = lambda: np.tanh(rng.randn(b, 10, 2)).astype(np.float32)  # noqa: E731
    return {"source": img(), "driving": img(), "out": np.concatenate([img(), img()], axis=2),
            "kp_s": kp(), "kp_d": kp()}


@pytest.mark.parametrize("border", [False, True])
def test_visualizer_matches_jax(border):
    from mrfa_tpu.utils.logger import Visualizer as JVisualizer
    from mrfa_tpu_torch.utils.logger import Visualizer

    port, jax_vis = Visualizer(draw_border=border), JVisualizer(draw_border=border)
    for i in range(10):
        np.testing.assert_array_equal(port.colormap(i / 10),
                                      np.asarray(jax_vis.colormap(i / 10))[:3])
    for keep in (("source", "driving"), ("source", "driving", "out", "kp_s", "kp_d")):
        x = {k: v for k, v in _vis_inputs(seed=len(keep), b=2).items() if k in keep}
        got, want = port.visualize(**x), jax_vis.visualize(**x)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="colormap"):
        Visualizer(colormap="viridis")


def test_logger_matches_jax(tmp_path):
    import imageio.v2 as imageio

    from mrfa_tpu.utils.logger import Logger as JLogger
    from mrfa_tpu_torch.utils.logger import Logger

    rng = np.random.RandomState(1)
    loggers = [Logger(str(tmp_path / "port"), visualizer_params={"draw_border": True}),
               JLogger(str(tmp_path / "jax"), visualizer_params={"draw_border": True})]
    for epoch in range(2):
        steps = [{"perceptual": rng.rand(), "equivariance": rng.rand(), "bg": rng.rand()}
                 for _ in range(3)]
        x = _vis_inputs(seed=epoch)
        for logger in loggers:
            for m in steps:
                logger.log_iter(m)
            logger.log_epoch(epoch, inp={"source": x["source"], "driving": x["driving"]},
                             out={"rec": x["out"], "kp_s": x["kp_s"], "kp_d": x["kp_d"]})
    port_log, jax_log = ((tmp_path / d / "log.txt").read_text() for d in ("port", "jax"))
    assert port_log == jax_log and len(port_log.splitlines()) == 2
    for epoch in range(2):
        name = f"train-vis/{epoch:08d}-rec.png"
        np.testing.assert_array_equal(imageio.imread(tmp_path / "port" / name),
                                      imageio.imread(tmp_path / "jax" / name))


@pytest.mark.parametrize("shape", [(5, 7, 3), (64, 1, 3), (1, 1, 3)],
                         ids=["rgb", "column", "pixel"])
def test_png_writer_reads_back(tmp_path, shape):
    import imageio.v2 as imageio

    from mrfa_tpu_torch.utils.video import save_image

    image = np.random.RandomState(2).randint(0, 256, shape).astype(np.uint8)
    save_image(str(tmp_path / "x.png"), image)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "x.png"), image)
    for bad in (image.astype(np.float32), image[..., 0]):
        with pytest.raises(ValueError, match="uint8"):
            save_image(str(tmp_path / "y.png"), bad)


def test_save_video_falls_back_to_png_frames(tmp_path, monkeypatch):
    import imageio.v2 as imageio

    from mrfa_tpu_torch.utils.video import save_video

    frames = [np.full((6, 8, 3), 40 * i, np.uint8) for i in range(3)]
    assert save_video(str(tmp_path / "a.gif"), frames) == str(tmp_path / "a.gif")
    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(sys.modules, name, None)
    out = save_video(str(tmp_path / "b.mp4"), frames)
    assert out == str(tmp_path / "b_frames")
    monkeypatch.undo()
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(imageio.imread(os.path.join(out, f"{i:06d}.png")), f)


@pytest.mark.parametrize("clip_grad", [None, False, True], ids=["absent", "false", "true"])
def test_loop_passes_the_jax_clip_grad_default(tmp_path, clip_grad):
    """The JAX loop clips only when the config says so (`clip_grad` absent:
    no clipping), although `Trainer` alone defaults to clipping."""
    from mrfa_tpu_torch.train.loop import train

    cfg = loop_config(str(tmp_path))
    cfg["train_params"]["num_epochs"] = 0
    del cfg["train_params"]["clip_grad"]
    if clip_grad is not None:
        cfg["train_params"]["clip_grad"] = clip_grad
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        trainer = train(cfg, None, str(tmp_path / "log"), [], device="cpu")
    assert trainer.clip == (10 if clip_grad else None)
    assert "clip_grad" not in cfg["train_params"] or cfg["train_params"]["clip_grad"] == clip_grad


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One 2-epoch training run through the CLI, then both eval modes from
    its checkpoint; yields (config path, training log dir), and removes
    them after the module."""
    from mrfa_tpu_torch.cli.run import main

    base = tmp_path_factory.mktemp("cli")
    root = str(base / "data")
    write_png_videos(root, n_train=2, n_test=2, frames=6)  # one step an epoch
    cfg = loop_config(root)
    cfg["reconstruction_params"] = {"num_videos": None, "format": ".mp4", "frame_batch": 4}
    cfg["animate_params"] = {"num_pairs": 2, "format": ".mp4", "normalization_params": {
        "adapt_movement_scale": False, "use_relative_movement": True,
        "use_relative_jacobian": True}}
    config = str(base / "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        main(["--config", config, "--mode", "train", "--log_dir", str(base / "log"),
              "--device", "cpu"])
    (log_dir,) = glob.glob(str(base / "log" / "tiny *"))
    for mode in ("reconstruction", "animate"):
        with (pytest.warns(UserWarning, match="LPIPS") if mode == "reconstruction"
              else contextlib.nullcontext()):
            main(["--config", config, "--mode", mode, "--checkpoint",
                  os.path.join(log_dir, "ckpt"), "--device", "cpu"])
    yield config, log_dir
    shutil.rmtree(base, ignore_errors=True)  # ~1.8 GB of checkpoints


def test_cli_train_writes_logs_and_checkpoints(cli_run):
    config, log_dir = cli_run
    assert os.path.exists(os.path.join(log_dir, "tiny.yaml"))
    lines = open(os.path.join(log_dir, "log.txt")).read().splitlines()
    assert [line.split(")")[0] for line in lines] == ["00000000", "00000001"]
    for line in lines:
        names = [t.split(" - ")[0] for t in line.split(") ", 1)[1].split("; ")]
        assert names == ["perceptual", "equivariance", "equivariance_jacobian", "bg"]
        assert all(np.isfinite(float(t.split(" - ")[1])) for t in line.split("; "))
    assert sorted(os.listdir(os.path.join(log_dir, "ckpt"))) == ["0", "1"]
    assert sorted(os.listdir(os.path.join(log_dir, "train-vis"))) == [
        "00000000-rec.png", "00000001-rec.png"]


def test_cli_reconstruction_equals_evals_on_the_checkpoint(cli_run, tmp_path):
    """The CLI's reconstruction from the checkpoint: the same strips as
    `evals.reconstruction` on the checkpoint's model (which
    tests/test_torch_evals.py holds to the JAX package's)."""
    import imageio.v2 as imageio

    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.config import load_config, model_config
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import restore_checkpoint

    config, log_dir = cli_run
    cfg = load_config(config)
    model = MRFA(model_config(cfg), device="cpu")
    model.load_state_dict(restore_checkpoint(os.path.join(log_dir, "ckpt"))[0]["trainer"]["model"])
    dataset = FramesDataset(is_train=False, **cfg["dataset_params"])
    with pytest.warns(UserWarning, match="LPIPS"):
        results = evals.reconstruction(cfg, model, str(tmp_path), dataset, device="cpu")
    assert results["frames"] == 12 and all(np.isfinite(results[k]) for k in ("l1", "lpips", "psnr"))
    for name in dataset.videos:
        got = imageio.imread(os.path.join(log_dir, "reconstruction", "png", name + ".png"))
        want = imageio.imread(os.path.join(str(tmp_path), "reconstruction", "png", name + ".png"))
        assert got.shape == (64, 6 * 64, 3)
        np.testing.assert_array_equal(got, want)
        assert os.path.exists(os.path.join(log_dir, "reconstruction", name + ".mp4"))


def test_cli_animate_writes_one_video_per_pair(cli_run):
    _, log_dir = cli_run
    videos = sorted(os.listdir(os.path.join(log_dir, "animation")))
    assert len(videos) == 2 and all(v.endswith(".mp4") for v in videos)

