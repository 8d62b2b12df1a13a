"""The vendored backbone weights in the port against the JAX package, on the
CPU.

Neither converted file is in the repository, so random trees in the files'
layout are written under a temporary directory and both packages' path
globals point there: the port's VGG19 after `overlay_vgg19` against JAX
`Vgg19` with `mrfa_tpu.weights.overlay_vgg19`'s variables, the port's LPIPS
from `lpips_variables()` against JAX `metrics.LpipsVgg` with the same
variables, and a CPU `loop.train` whose VGG19 must equal the file (and whose
reconstruction eval then scores with the vendored LPIPS). No JAX train step
is compiled.
"""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrfa_tpu.weights as jweights
import mrfa_tpu_torch.weights as weights
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    jax_init, loop_config, nchw, one_torch_thread, smooth_image, to_nhwc, write_png_videos,
)

SIZE = 64
# VGG features and LPIPS distances at f32 through up to 16 convolutions,
# activations O(1) under the trees' He-scaled kernels
ATOL = 1e-5


def _random_tree(shapes, seed):
    """A flax-named tree of `shapes`' structure: He-scaled kernels, small
    biases, other leaves (LPIPS's `lin` weights) positive."""
    rng = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        shape = np.shape(node)
        if len(shape) == 4:
            return (rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32)
        if len(shape) == 1 and shape[0] > 1:
            return (0.01 * rng.randn(*shape)).astype(np.float32)
        return rng.rand(*shape).astype(np.float32)

    return fill(jax.tree_util.tree_map(np.asarray, dict(shapes)))


@functools.lru_cache(maxsize=None)
def _trees():
    """Random VGG19 and LPIPS parameter trees, made once for the module."""
    from mrfa_tpu.metrics import LpipsVgg as JLpips
    from mrfa_tpu.nn.vgg import Vgg19 as JVgg

    x = jnp.zeros((1, SIZE, SIZE, 3))
    return (_random_tree(jax_init(JVgg(), x)["params"], seed=0),
            _random_tree(jax_init(JLpips(use_linear_weights=True), x, x)["params"], seed=1))


@pytest.fixture
def vendored(tmp_path, monkeypatch):
    """Random VGG19 and LPIPS trees saved by the port's `save_tree`, and
    both packages' paths pointed at them."""
    vgg, lpips = _trees()
    paths = {"VGG19_FILE": str(tmp_path / "vgg19_imagenet.npz"),
             "LPIPS_FILE": str(tmp_path / "lpips_vgg16.npz")}
    weights.save_tree(paths["VGG19_FILE"], vgg)
    weights.save_tree(paths["LPIPS_FILE"], lpips)
    for module in (weights, jweights):
        for name, path in paths.items():
            monkeypatch.setattr(module, name, path)
    return vgg, lpips


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_one_file_serves_both_packages(vendored):
    vgg, lpips = vendored
    _equal_trees(weights.vgg19_params(), vgg)
    _equal_trees(jweights.vgg19_params(), vgg)
    _equal_trees(weights.lpips_variables()["params"], jweights.lpips_variables()["params"])


def test_vgg19_overlay_matches_jax(vendored):
    from mrfa_tpu.nn.vgg import Vgg19 as JVgg
    from mrfa_tpu_torch.nn.vgg import Vgg19

    x = smooth_image(2, SIZE, seed=2)
    init = jax.tree_util.tree_map(np.zeros_like, _trees()[0])  # the model's own vgg
    variables = jweights.overlay_vgg19({"params": {"vgg": init}})
    want = jax.jit(JVgg().apply)({"params": variables["params"]["vgg"]}, jnp.asarray(x))
    holder = torch.nn.Module()
    holder.vgg = Vgg19()
    assert weights.overlay_vgg19(holder)
    with torch.no_grad():
        got = holder.vgg(nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert 0.1 < float(np.abs(np.asarray(w)).max()) < 100  # O(1) activations
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), atol=ATOL)


def test_lpips_from_the_vendored_file_matches_jax(vendored):
    from mrfa_tpu.metrics import LpipsVgg as JLpips
    from mrfa_tpu_torch.evals import _lpips_module

    a, b = smooth_image(2, SIZE, seed=3), smooth_image(2, SIZE, seed=4)
    want = jax.jit(JLpips(use_linear_weights=True).apply)(
        jweights.lpips_variables(), jnp.asarray(a), jnp.asarray(b))
    module = _lpips_module(weights.lpips_variables(), torch.device("cpu"))
    assert module.use_linear_weights
    with torch.no_grad():
        got = module(nchw(a), nchw(b))
    assert float(got.min()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_overlay_warns_without_the_file_and_skips_a_model_without_vgg(tmp_path, monkeypatch):
    from mrfa_tpu_torch.nn.vgg import Vgg19

    monkeypatch.setattr(weights, "VGG19_FILE", str(tmp_path / "absent.npz"))
    assert weights.vgg19_params() is None
    holder = torch.nn.Module()
    holder.vgg = Vgg19()
    before = {k: v.clone() for k, v in holder.state_dict().items()}
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        assert not weights.overlay_vgg19(holder)
    for k, v in holder.state_dict().items():
        assert torch.equal(v, before[k])
    assert not weights.overlay_vgg19(torch.nn.Linear(2, 2))


def test_loop_train_overlays_the_vendored_vgg19(vendored, tmp_path):
    """One epoch of one step: the trained model's VGG19 is the file's, and
    its reconstruction eval scores with the vendored LPIPS."""
    import warnings

    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.nn.vgg import Vgg19
    from mrfa_tpu_torch.train.loop import train
    from mrfa_tpu_torch.utils.convert import flax_path

    vgg, _ = vendored
    root = str(tmp_path / "data")
    write_png_videos(root, n_train=2, n_test=1, frames=3)
    cfg = loop_config(root)
    cfg["train_params"].update(num_epochs=1, bg_start=1)
    dataset = FramesDataset(is_train=True, seed=7, **cfg["dataset_params"])
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*RANDOMLY INITIALIZED VGG19")
        trainer = train(cfg, None, str(tmp_path / "log"), dataset, seed=0,
                        max_steps_per_epoch=1, device="cpu")
    assert trainer.steps == 1
    shutil.rmtree(tmp_path / "log" / "ckpt")  # ~0.2 GB
    state = trainer.model.vgg.state_dict()
    assert sorted(state) == sorted(Vgg19().state_dict())
    for key, t in state.items():
        _, path = flax_path(key, t.dim())
        leaf = vgg[path[0]][path[1]]
        want = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf
        np.testing.assert_array_equal(t.numpy(), want, err_msg=key)
    cfg["reconstruction_params"] = {"num_videos": 1, "format": ".png", "frame_batch": 3}
    test = FramesDataset(is_train=False, **cfg["dataset_params"])
    results = evals.reconstruction(cfg, trainer.model, str(tmp_path / "eval"), test,
                                   save_visualizations=False, device="cpu")
    assert results["lpips_weights"] == "vendored" and np.isfinite(results["lpips"])
