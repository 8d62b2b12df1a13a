"""The port's demo and conversion CLIs against the JAX package's, on the CPU.

- `convert_backbones`: both CLIs on the same random torchvision-shaped
  VGG19 / VGG16 state dicts and LPIPS lin weights write npz files with the
  same keys and bit-equal arrays.
- `convert`: a reference `.pth` (random weights from a seed, one key left
  out, one extra) through both CLIs; the JAX orbax output carried into the
  port by `load_jax_variables` equals the port's checkpoint bit for bit, with
  the same missing and unused lists; the output restores through
  `cli/run.py --checkpoint` and the demo.
- `demo`: both demos on the same `.pth`, a 64 px config and PNG inputs (a
  128 px source, a strip of 256 px driving frames), with `--relative
  --adapt_scale --find_best_frame`: the frames within 1e-4. One JAX
  eval-mode `Animator` is compiled; neither CLI compiles a JAX train-mode
  forward (the JAX CLIs' `init_model_variables` is replaced by the port's
  initial weights carried over).
- `resize_frame` against a box average and the JAX demo's own resize, which
  is cv2's INTER_AREA when cv2 is installed (the test needs cv2: PIL's
  resize, the JAX demo's other route, is another filter).
"""
import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

import mrfa_tpu.animate as janimate
import mrfa_tpu.cli.convert as jconvert
import mrfa_tpu.cli.convert_backbones as jconvert_backbones
import mrfa_tpu.cli.demo as jdemo
import mrfa_tpu.train.loop as jloop
from mrfa_tpu.utils.torch_convert import convert_state_dict
from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.cli import convert, convert_backbones, demo
from mrfa_tpu_torch.config import load_config, model_config
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.utils.checkpoint import restore_checkpoint
from mrfa_tpu_torch.utils.convert import flax_path, load_jax_variables
from mrfa_tpu_torch.utils.video import save_image
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    one_torch_thread, reference_pth, smooth_image, torchvision_backbone_files, write_cli_inputs,
    write_png_videos,
)

DEMO_FRAMES = 6
TOL = 1e-4  # f32 frames, as tests/test_torch_frame.py


def test_convert_backbones_matches_jax(tmp_path):
    paths = torchvision_backbone_files(str(tmp_path), seed=0)
    vgg19 = torch.load(paths["vgg19"], weights_only=True)
    vgg16 = torch.load(paths["vgg16"], weights_only=True)
    assert set(convert_backbones.VGG19_CONV_IDX) <= {int(k.split(".")[1]) for k in vgg19}
    assert set(convert_backbones.VGG16_CONV_IDX) <= {int(k.split(".")[1]) for k in vgg16}
    argv = [f"--{k}={v}" for k, v in paths.items()]
    convert_backbones.main(argv + [f"--out_dir={tmp_path / 'port'}"])
    jconvert_backbones.main(argv + [f"--out_dir={tmp_path / 'jax'}"])
    for fname in ("vgg19_imagenet.npz", "lpips_vgg16.npz"):
        got, want = np.load(tmp_path / "port" / fname), np.load(tmp_path / "jax" / fname)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])
    # the port's weights module reads what it wrote into a model
    from mrfa_tpu_torch import weights as W
    from mrfa_tpu_torch.nn.vgg import Vgg19

    tree = W.load_tree(str(tmp_path / "port" / "vgg19_imagenet.npz"))
    vgg = Vgg19()
    load_jax_variables(vgg, {"params": tree})
    np.testing.assert_array_equal(vgg.features_28.weight.numpy(),
                                  vgg19["features.28.weight"].numpy())
    with pytest.raises(SystemExit):
        convert_backbones.main([f"--vgg16={paths['vgg16']}", f"--out_dir={tmp_path}"])


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """The shared 64 px config and a reference `.pth` from seed 0, removed
    after the module."""
    root = tmp_path_factory.mktemp("cli")
    config_path, pth_path, state = write_cli_inputs(str(root), seed=0)
    yield root, config_path, pth_path, state
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture()
def jax_init_from_port(monkeypatch):
    """The JAX CLIs' initial variables: the port's initial weights (seed 0)
    carried over, in place of a jitted train-mode `model.init`."""
    def init(model, cfg, seed=0):
        torch.manual_seed(seed)
        return convert_state_dict(MRFA(model_config(dict(cfg)), device="cpu").state_dict())

    monkeypatch.setattr(jloop, "init_model_variables", init)


def test_convert_matches_jax(cli_inputs, tmp_path, jax_init_from_port, capsys):
    root, config_path, _, state = cli_inputs
    missing_key = "dense_motion.mask.bias"
    pth = str(tmp_path / "partial.pth")
    reference_pth(state, pth, drop=(missing_key,),
                  extra={"module.decoder.extra_leaf": torch.zeros(2)})
    args = [f"--config={config_path}", f"--checkpoint={pth}", "--report"]
    missing, unexpected = convert.main(args + [f"--out={tmp_path / 'port'}", "--device=cpu"])
    port_out = capsys.readouterr().out
    jconvert.main(args + [f"--out={tmp_path / 'jax'}"])
    jax_out = capsys.readouterr().out
    assert missing == [missing_key] and unexpected == ["decoder.extra_leaf"]
    assert f"MISSING (kept init): {missing_key}" in port_out
    assert "UNUSED .pth leaf:    decoder.extra_leaf" in port_out
    coll, path = flax_path(missing_key, 1)
    assert f"MISSING (kept init): {'/'.join((coll,) + path)}" in jax_out
    assert "UNUSED .pth leaf:    params/decoder/extra_leaf" in jax_out

    from mrfa_tpu.utils.checkpoint import restore_checkpoint as jrestore

    cfg = model_config(load_config(config_path))
    torch.manual_seed(0)
    target = convert_state_dict(MRFA(cfg, device="cpu").state_dict())
    jtree, _ = jrestore(str(tmp_path / "jax"), {k: target[k] for k in ("params", "batch_stats")})
    via_jax = MRFA(cfg, device="cpu")
    load_jax_variables(via_jax, jtree)
    got, step = restore_checkpoint(str(tmp_path / "port"))
    assert step == 0 and list(got) == ["trainer"]
    want = via_jax.state_dict()
    assert list(got["trainer"]["model"]) == list(want)
    for key, value in want.items():
        assert torch.equal(got["trainer"]["model"][key], value), key
    for key, value in state.items():  # every leaf from the .pth, the missing one at its init
        if key != missing_key and not key.endswith("num_batches_tracked"):
            assert torch.equal(got["trainer"]["model"][key], value), key


def test_converted_checkpoint_restores_through_run_and_demo(cli_inputs, tmp_path, monkeypatch):
    root, config_path, pth, state = cli_inputs
    convert.main([f"--config={config_path}", f"--checkpoint={pth}",
                  f"--out={tmp_path / 'log' / 'ckpt'}", "--device=cpu"])
    monkeypatch.chdir(tmp_path)
    write_png_videos(str(tmp_path / "data"), n_train=1, n_test=1, frames=2)
    seen = {}
    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.cli import run

    monkeypatch.setattr(evals, "reconstruction",
                        lambda config, model, *a, **k: seen.update(run=model.state_dict()))
    run.main([f"--config={config_path}", "--mode=reconstruction",
              f"--checkpoint={tmp_path / 'log' / 'ckpt'}", "--device=cpu"])
    monkeypatch.setattr(Animator, "make_animation",
                        lambda self, *a, **k: seen.update(demo=self.model.state_dict()) or [])
    save_image(str(tmp_path / "src.png"), np.zeros((64, 64, 3), np.uint8))
    demo.main([f"--config={config_path}", f"--checkpoint={tmp_path / 'log' / 'ckpt'}",
               "--source_image=src.png", "--driving_video=data/test/id00#0",
               "--img_shape=64,64", f"--result_video={tmp_path / 'out.mp4'}", "--device=cpu"])
    for key, value in state.items():
        assert torch.equal(seen["run"][key], value), key
        assert torch.equal(seen["demo"][key], value), key


def _demo_inputs(root):
    """A 128 px PNG source image and a PNG strip of DEMO_FRAMES driving
    frames at 256 px (the demo's default frame shape for a strip)."""
    source = (255 * smooth_image(1, 128, seed=5)[0]).astype(np.uint8)
    driving = (255 * smooth_image(DEMO_FRAMES, 256, seed=6)).astype(np.uint8)
    save_image(os.path.join(root, "source.png"), source)
    save_image(os.path.join(root, "driving.png"), np.concatenate(list(driving), axis=1))
    return os.path.join(root, "source.png"), os.path.join(root, "driving.png")


def test_demo_matches_jax(cli_inputs, tmp_path, jax_init_from_port, monkeypatch):
    root, config_path, pth, state = cli_inputs
    source, driving = _demo_inputs(str(tmp_path))
    args = [f"--config={config_path}", f"--checkpoint={pth}", f"--source_image={source}",
            f"--driving_video={driving}", "--img_shape=64,64", "--relative", "--adapt_scale",
            "--find_best_frame"]
    recorded = {}

    class Recording(janimate.Animator):
        def make_animation_from_best_frame(self, *a, **k):
            recorded["jax"] = super().make_animation_from_best_frame(*a, **k)
            return recorded["jax"]

    monkeypatch.setattr(janimate, "Animator", Recording)
    with contextlib.redirect_stdout(io.StringIO()):
        jdemo.main(args + [f"--result_video={tmp_path / 'jax.mp4'}"])
        got, written = demo.main(args + [f"--result_video={tmp_path / 'port.mp4'}",
                                         "--device=cpu"])
    want = recorded["jax"]
    assert len(got) == len(want) == DEMO_FRAMES
    for g, w in zip(got, want):
        assert g.shape == (64, 64, 3)
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL)
    assert os.path.exists(written)

    # without --find_best_frame: the port demo is Animator.make_animation
    plain, _ = demo.main([a for a in args if a != "--find_best_frame"]
                         + [f"--result_video={tmp_path / 'plain.mp4'}", "--device=cpu"])
    cfg = model_config(load_config(config_path))
    animator = Animator(MRFA(cfg, device="cpu"), state, device="cpu")
    from mrfa_tpu_torch.data.dataset import read_image, read_video

    want = animator.make_animation(
        demo.resize_frame(read_image(source), (64, 64)),
        np.stack([demo.resize_frame(f, (64, 64)) for f in read_video(driving)]),
        adapt_movement_scale=True)
    for g, w in zip(plain, want):
        np.testing.assert_array_equal(g, w)


def test_resize_frame_box_average_and_jax():
    rng = np.random.RandomState(0)
    frame = rng.rand(512, 256, 3).astype(np.float32)
    for f in (2, 4):
        box = frame.reshape(512 // f, f, 256 // f, f, 3).mean(axis=(1, 3))
        np.testing.assert_allclose(demo.resize_frame(frame, (512 // f, 256 // f)), box,
                                   atol=1e-6, rtol=0)
    np.testing.assert_array_equal(demo.resize_frame(frame, (512, 256)), frame)
    import cv2  # noqa: F401 (the JAX demo resizes with cv2 where it is installed)

    # the JAX demo's resize (cv2's INTER_AREA) at non-integer
    # factors, shrinking, enlarging and both: within 2e-7 (measured 1.8e-7)
    for shape in ((300, 200), (200, 100), (700, 300), (600, 128)):
        got = demo.resize_frame(frame, shape)
        want = jdemo.resize_frame(frame, shape)
        assert got.shape == want.shape == shape + (3,)
        np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
