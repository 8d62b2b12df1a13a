"""The port's evaluation modes and metrics against the JAX package's, on
the CPU: `LpipsVgg` against flax (learned and uniform channel weights, with
and without `normalize`), `l1` and `psnr`, `evals.reconstruction`'s numbers,
strips and frame count against `mrfa_tpu.evals.reconstruction` (the MTIA
model at 64 px, 3-block hourglasses, a 1-layer TokenPose, in eval mode; one
video of 6 frames in chunks of 4, the second padded), and `evals.animate`'s
frames equal to `Animator.make_animation` on the same pair."""
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu_torch import evals
from mrfa_tpu_torch.utils.convert import load_jax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    image, jax_apply, jax_init, mtia_cfg, nchw, one_torch_thread, perturbed, write_png_videos,
)

SIZE = 64


@pytest.mark.parametrize("linear,normalize", [(True, False), (False, True)],
                         ids=["lin-raw", "uniform-normalize"])
def test_lpips_matches_flax(linear, normalize):
    """Both weight modes and both `normalize` values, one compile each."""
    from mrfa_tpu.metrics import LpipsVgg as JLpips
    from mrfa_tpu_torch.metrics import LpipsVgg

    x, y = image(2, 32, seed=1), image(2, 32, seed=2)
    jmod = JLpips(use_linear_weights=linear, normalize=normalize)
    v = perturbed(_lpips_init(), seed=3)
    if not linear:
        v["params"] = {k: w for k, w in v["params"].items() if not k.startswith("lin")}
    want = jax_apply(jmod, v, jnp.asarray(x), jnp.asarray(y))
    port = LpipsVgg(use_linear_weights=linear, normalize=normalize)
    load_jax_variables(port, v)
    with torch.no_grad():
        got = port(nchw(x), nchw(y))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _lpips_init():
    """JAX LPIPS variables with the learned weights, initialized once (the
    network's shapes do not depend on the image size)."""
    from mrfa_tpu.metrics import LpipsVgg as JLpips

    x = jnp.zeros((1, 32, 32, 3))
    return jax_init(JLpips(use_linear_weights=True), x, x)


def test_l1_and_psnr_match_jax():
    from mrfa_tpu.metrics import l1 as jl1
    from mrfa_tpu.metrics import psnr as jpsnr
    from mrfa_tpu_torch.metrics import l1, psnr

    a, b = image(2, 16, seed=4), image(2, 16, seed=5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(float(l1(ta, tb)), float(jl1(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(psnr(ta, tb)), float(jpsnr(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


def _eval_config(root):
    cfg = mtia_cfg(SIZE, blocks=3, depth=1)
    cfg.update(
        dataset_params={"root_dir": root, "frame_shape": [SIZE, SIZE, 3]},
        reconstruction_params={"num_videos": None, "format": ".mp4", "frame_batch": 4},
        animate_params={"num_pairs": 1, "normalization_params": {
            "adapt_movement_scale": False, "use_relative_movement": True,
            "use_relative_jacobian": True}},
        visualizer_params={"draw_border": True, "colormap": "gist_rainbow"},
    )
    return cfg


@pytest.fixture(scope="module")
def eval_case(tmp_path_factory):
    """A port model whose weights are JAX-layout variables moved off their
    init (carried both ways), a one-video test split and LPIPS variables."""
    from mrfa_tpu.utils.torch_convert import convert_state_dict
    from mrfa_tpu_torch.models.mrfa import MRFA

    base = tmp_path_factory.mktemp("evals")
    root = str(base / "data")
    write_png_videos(root, n_train=0, n_test=1, frames=6, seed=3)
    cfg = _eval_config(root)
    torch.manual_seed(0)
    model = MRFA(cfg, device="cpu")
    variables = perturbed(convert_state_dict(model.state_dict()), seed=1)
    load_jax_variables(model, variables)
    lpips = perturbed(_lpips_init(), seed=2)
    return {"cfg": cfg, "model": model, "variables": variables, "lpips": lpips, "base": base}


def test_reconstruction_matches_jax(eval_case):
    import imageio.v2 as imageio

    from mrfa_tpu.data.dataset import FramesDataset as JFrames
    from mrfa_tpu.evals import reconstruction as jreconstruction
    from mrfa_tpu.models.mrfa import MRFA as JMRFA
    from mrfa_tpu_torch.data.dataset import FramesDataset

    cfg, base = eval_case["cfg"], eval_case["base"]
    want = jreconstruction(cfg, JMRFA(cfg), eval_case["variables"], str(base / "jax"),
                           JFrames(is_train=False, **cfg["dataset_params"]),
                           lpips_variables=eval_case["lpips"])
    got = evals.reconstruction(cfg, eval_case["model"], str(base / "port"),
                               FramesDataset(is_train=False, **cfg["dataset_params"]),
                               lpips_weights=eval_case["lpips"], device="cpu")
    assert got["frames"] == want["frames"] == 6
    assert set(got["phase_wall"]) == set(want["phase_wall"])
    for k in ("l1", "lpips", "psnr"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    name = "id00#0"
    strips = [imageio.imread(base / side / "reconstruction" / "png" / f"{name}.png")
              for side in ("port", "jax")]
    assert strips[0].shape == (SIZE, 6 * SIZE, 3)
    # uint8 of frames within 1e-4 (tests/test_torch_frame.py): one level apart at most
    assert int(np.abs(strips[0].astype(int) - strips[1]).max()) <= 1
    assert os.path.exists(base / "port" / "reconstruction" / f"{name}.mp4")


def test_animate_frames_equal_make_animation(eval_case, monkeypatch):
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.data.dataset import FramesDataset, PairedDataset

    frames = []

    class Recording(Animator):
        def animate_frame(self, clip_state, driving_frame):
            out = super().animate_frame(clip_state, driving_frame)
            frames.append(out[0][0].numpy())
            return out

    monkeypatch.setattr(evals, "Animator", Recording)
    cfg, model = eval_case["cfg"], eval_case["model"]
    dataset = FramesDataset(is_train=False, **cfg["dataset_params"])
    written = evals.animate(cfg, model, str(eval_case["base"] / "port"), dataset, device="cpu")
    assert written == [str(eval_case["base"] / "port" / "animation" / "id00#0-id00#0.mp4")]
    pair = PairedDataset(dataset, number_of_pairs=1)[0]
    want = Animator(model, model.state_dict(), device="cpu").make_animation(
        pair["source_video"][0], pair["driving_video"])
    assert len(frames) == len(want) == 6
    for g, w in zip(frames, want):
        np.testing.assert_array_equal(g, w)

