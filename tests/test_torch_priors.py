"""The FOMM and TPSM priors of the port against the JAX package's, on the CPU.

The TPS fit and warps (f32 and f64), `gaussian2kp`, `KPDetector` (jacobian
and visibility heads on), `TPSKPDetector`, `_dropout_softmax` with the same
keep mask, `TPSDenseMotionNetwork` with and without the background affine
(each module in eval mode and in train mode, with its updated BatchNorm
running statistics; in train mode with the channel dropout on, the same mask
injected into both packages), one eval-mode `MRFA` forward per prior at
64 px, and a port-only CPU `Trainer.step` per prior. No JAX train step and
no JAX train-mode `MRFA` forward is compiled: each JAX module runs alone,
compiled once for each mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu_torch.utils.convert import flax_path, load_jax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    image, jax_init, mtia_cfg, nchw, one_torch_thread, perturbed, smooth_image, to_nhwc,
    train_cfg, with_prior,
)

SIZE = 64
# one module at f32: summation-order differences of a few ulps, grown by
# depth; outputs O(1)
ATOL = 1e-5
# the ResNet-18 of the TPSM detector in train mode: batch statistics over
# the 8 positions of its last stage at B=2 grow the ulps (the same trunk is
# held at 1e-4 in test_torch_bg.py)
RESNET_TRAIN_ATOL = 1e-4
# the whole eval-mode forward at f32: outputs in [0, 1]
FRAME_ATOL = 1e-4
MODES = ["train", "eval"]
DROPOUT_P = 0.3


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _check_running_stats(module, batch_stats):
    keys = [k for k in module.state_dict() if k.endswith(("running_mean", "running_var"))]
    assert keys
    for key in keys:
        _, path = flax_path(key, 1)
        np.testing.assert_allclose(module.state_dict()[key].numpy(), _leaf(batch_stats, path),
                                   atol=ATOL, err_msg=key)


_JITTED = {}


def _jax_run(jmod, v, train, *args, key=None, **static):
    """`apply` in train mode (batch statistics, running ones updated) or in
    eval mode; compiled once per key (the inputs are arguments)."""
    key = key or (type(jmod), train)
    if key not in _JITTED:
        kw = {"train": True, "mutable": ["batch_stats"]} if train else {"train": False}
        rngs = {"dropout": jax.random.PRNGKey(0)}
        _JITTED[key] = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw, **static, rngs=rngs))
    out = _JITTED[key](v, *args)
    return (out[0], out[1]["batch_stats"]) if train else (out, v["batch_stats"])


def _kp_pairs(b, g, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    kp_1 = rng.uniform(-0.9, 0.9, (b, g, 5, 2))
    kp_2 = np.clip(kp_1 + 0.1 * rng.randn(b, g, 5, 2), -1, 1)
    return kp_1.astype(dtype), kp_2.astype(dtype)


# -------------------------------------------------------------------- TPS --


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tps_fit_and_warps_match_jax(dtype):
    from mrfa_tpu.ops import tps as jtps
    from mrfa_tpu_torch.ops.tps import tps_fit, tps_transform_grid, tps_warp_coordinates

    kp_1, kp_2 = _kp_pairs(2, 10, seed=1, dtype=dtype)
    coords = np.random.RandomState(2).uniform(-1, 1, (1, 40, 2)).astype(dtype)
    # the solve at f32: the system's conditioning grows the ulps of its inputs
    atol = 1e-5 if dtype == "float32" else 1e-12
    with jax.enable_x64(dtype == "float64"):
        jp = jtps.tps_fit(jnp.asarray(kp_1), jnp.asarray(kp_2))
        want_c = np.asarray(jtps.tps_warp_coordinates(jp, jnp.asarray(coords)))
        want_g = np.asarray(jtps.tps_transform_grid(jp, 12, 16))
        want_p = [np.asarray(t) for t in jp]
    params = tps_fit(torch.from_numpy(kp_1), torch.from_numpy(kp_2))
    for got, want, name in zip(params, want_p, ("theta", "control_points", "control_params")):
        assert got.dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(got.numpy(), want, atol=atol, err_msg=name)
    np.testing.assert_allclose(tps_warp_coordinates(params, torch.from_numpy(coords)).numpy(),
                               want_c, atol=atol)
    # the JAX grid is f32 at both dtypes (its make_coordinate_grid default)
    grid_atol = atol if dtype == "float32" else 1e-6
    got_g = tps_transform_grid(params, 12, 16)
    assert got_g.shape == (2, 10, 12, 16, 2)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=grid_atol)
    # the fit interpolates its control points (up to the 0.01 I smoothing)
    on_cps = tps_warp_coordinates(params, params.control_points.reshape(2, 50, 2))
    assert float((on_cps.reshape(2, 10, 10, 5, 2).diagonal(dim1=1, dim2=2).permute(0, 3, 1, 2)
                  - torch.from_numpy(kp_2)).abs().max()) < 0.05


def test_tps_fit_gradient_is_finite_at_the_diagonal():
    """U(s) = s log(s + 1e-9) meets s = 0 on the kernel's diagonal."""
    from mrfa_tpu_torch.ops.tps import tps_fit, tps_transform_grid

    kp_1, kp_2 = (torch.from_numpy(a).requires_grad_(True) for a in _kp_pairs(2, 3, seed=3))
    tps_transform_grid(tps_fit(kp_1, kp_2), 8, 8).square().sum().backward()
    assert torch.isfinite(kp_1.grad).all() and torch.isfinite(kp_2.grad).all()


# ------------------------------------------------------------- detectors --


def test_gaussian2kp_matches_jax():
    from mrfa_tpu.models.kp_detector import gaussian2kp as jg
    from mrfa_tpu_torch.models.kp_detector import gaussian2kp

    logits = np.random.RandomState(4).randn(2, 13, 11, 10).astype(np.float32)
    heat = np.exp(logits) / np.exp(logits).sum(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(gaussian2kp(nchw(heat)).numpy(), np.asarray(jg(jnp.asarray(heat))),
                               atol=1e-6)


KP_KW = dict(block_expansion=8, num_kp=10, num_channels=3, max_features=64, num_blocks=3,
             temperature=0.1, scale_factor=0.25, estimate_jacobian=True, estimate_occlusion=True)
# the visibility head's four 2x pools and its stride-4 convolution need a
# 64x64 feature map: 256 px frames at the 0.25 scale
KP_SIZE = 256


def _kp_variables(seed):
    from mrfa_tpu.models.kp_detector import KPDetector as JKP

    x = jnp.zeros((1, KP_SIZE, KP_SIZE, 3))
    v = perturbed(jax_init(JKP(**KP_KW), x, False), seed=seed)
    jac = v["params"]["jacobian"]  # zero at init: the jacobian would not see the input
    jac["kernel"] = (0.01 * np.random.RandomState(seed).randn(*jac["kernel"].shape)).astype(
        np.float32)
    return v


@pytest.mark.parametrize("mode", MODES)
def test_kp_detector_matches_jax(mode):
    from mrfa_tpu.models.kp_detector import KPDetector as JKP
    from mrfa_tpu_torch.models.kp_detector import KPDetector

    x = smooth_image(2, KP_SIZE, seed=5)
    v = _kp_variables(seed=5)
    want, stats = _jax_run(JKP(**KP_KW), v, mode == "train", jnp.asarray(x))
    port = KPDetector(**KP_KW)
    load_jax_variables(port, v)
    port.train(mode == "train")
    with torch.no_grad():
        got = port(nchw(x))
    assert sorted(got) == sorted(want) == ["jacobian", "kp", "kp_occlusion"]
    assert got["kp"].shape == (2, 10, 2) and got["jacobian"].shape == (2, 10, 2, 2)
    np.testing.assert_allclose(got["kp"].numpy(), np.asarray(want["kp"]), atol=ATOL)
    np.testing.assert_allclose(got["jacobian"].numpy(), np.asarray(want["jacobian"]), atol=ATOL)
    np.testing.assert_allclose(to_nhwc(got["kp_occlusion"]), np.asarray(want["kp_occlusion"]),
                               atol=ATOL)
    _check_running_stats(port, stats)


def test_kp_detector_jacobian_head_starts_at_the_identity():
    from mrfa_tpu_torch.models.kp_detector import KPDetector

    port = KPDetector(**KP_KW).eval()
    with torch.no_grad():
        jac = port(nchw(smooth_image(1, KP_SIZE, seed=6)))["jacobian"]
    np.testing.assert_allclose(jac.numpy(), np.broadcast_to(np.eye(2), (1, 10, 2, 2)), atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_tps_kp_detector_matches_jax(mode):
    from mrfa_tpu.models.kp_detector import TPSKPDetector as JTPS
    from mrfa_tpu_torch.models.kp_detector import TPSKPDetector

    x = smooth_image(2, SIZE, seed=7)
    v = perturbed(jax_init(JTPS(num_tps=10), jnp.zeros((1, SIZE, SIZE, 3)), False), seed=7)
    want, stats = _jax_run(JTPS(num_tps=10), v, mode == "train", jnp.asarray(x))
    port = TPSKPDetector(num_tps=10)
    load_jax_variables(port, v)
    port.train(mode == "train")
    with torch.no_grad():
        got = port(nchw(x))
    assert got["kp"].shape == (2, 50, 2) and float(got["kp"].abs().max()) <= 1.0
    np.testing.assert_allclose(got["kp"].numpy(), np.asarray(want["kp"]),
                               atol=RESNET_TRAIN_ATOL if mode == "train" else ATOL)
    _check_running_stats(port, stats)


# ----------------------------------------------------------- dense motion --


def _keep_mask(key, b, c, p):
    """The keep mask that mrfa_tpu's `_dropout_softmax` draws from `key`."""
    keep = np.array(jax.random.uniform(key, (b, c)) < (1.0 - p))
    keep[:, 0] = True
    return torch.from_numpy(keep)


def test_dropout_softmax_matches_jax_with_the_same_mask():
    from mrfa_tpu.models.dense_motion import _dropout_softmax as jdrop
    from mrfa_tpu_torch.models.dense_motion import _dropout_softmax

    logits = 3 * np.random.RandomState(8).randn(4, 6, 7, 11).astype(np.float32)
    key = jax.random.PRNGKey(8)
    keep = _keep_mask(key, 4, 11, DROPOUT_P)
    assert not bool(keep.all()) and bool(keep[:, 0].all())  # some channels dropped
    want = np.asarray(jdrop(jnp.asarray(logits), DROPOUT_P, key))
    got = _dropout_softmax(nchw(logits), keep)
    np.testing.assert_allclose(to_nhwc(got), want, atol=1e-6)
    dropped = ~keep[:, None, None, :].expand(4, 6, 7, 11).numpy()
    assert (want[dropped] == 0).all()


def test_dropout_keep_is_drawn_from_the_generator():
    from mrfa_tpu_torch.models.dense_motion import dropout_keep

    draw = lambda: dropout_keep(64, 11, DROPOUT_P, torch.Generator().manual_seed(3), "cpu")  # noqa
    a, b = draw(), draw()
    assert torch.equal(a, b) and bool(a[:, 0].all())
    share = float(a[:, 1:].float().mean())
    assert 0.6 < share < 0.8  # kept with probability 0.7


TPS_DM_KW = dict(block_expansion=8, max_features=64, num_blocks=3, scale_factor=0.25,
                 num_tps=10, num_channels=3)


def _dm_inputs(seed):
    rng = np.random.RandomState(seed)
    kp_d = np.tanh(rng.randn(2, 50, 2)).astype(np.float32) * 0.8
    kp_s = np.clip(kp_d + 0.05 * rng.randn(2, 50, 2), -1, 1).astype(np.float32)
    bg = (np.eye(3)[None] + np.pad(0.05 * rng.randn(2, 2, 3), ((0, 0), (0, 1), (0, 0)))
          ).astype(np.float32)
    return smooth_image(2, SIZE, seed=seed), kp_d, kp_s, bg


@pytest.mark.parametrize("bg", [False, True], ids=["no_bg", "bg"])
@pytest.mark.parametrize("mode", MODES)
def test_tps_dense_motion_matches_jax(mode, bg, monkeypatch):
    """In train mode the channel dropout is on, the same keep mask injected
    into both packages."""
    import mrfa_tpu.models.dense_motion as jdm
    import mrfa_tpu_torch.models.dense_motion as dm

    train = mode == "train"
    source, kp_d, kp_s, bg_param = _dm_inputs(seed=9)
    jmod = jdm.TPSDenseMotionNetwork(**TPS_DM_KW)
    jkp = lambda kp: {"kp": jnp.asarray(kp)}  # noqa: E731
    v = perturbed(jax_init(jmod, jnp.asarray(source), jkp(kp_d), jkp(kp_s)), seed=9)
    key = jax.random.PRNGKey(9)
    keep = _keep_mask(key, 2, 11, DROPOUT_P)
    real = jdm._dropout_softmax
    monkeypatch.setattr(jdm, "_dropout_softmax", lambda logits, p, rng: real(logits, p, key))
    monkeypatch.setattr(dm, "dropout_keep", lambda b, c, p, generator, device: keep)
    args = [jnp.asarray(source), jkp(kp_d), jkp(kp_s)] + [jnp.asarray(bg_param)] * bg
    want, stats = _jax_run(jmod, v, train, *args, key=("tps_dm", train, bg),
                           dropout_flag=train, dropout_p=DROPOUT_P)
    port = dm.TPSDenseMotionNetwork(**TPS_DM_KW)
    load_jax_variables(port, v)
    port.train(train)
    tkp = lambda kp: {"kp": torch.from_numpy(kp)}  # noqa: E731
    with torch.no_grad():
        got = port(nchw(source), tkp(kp_d), tkp(kp_s),
                   torch.from_numpy(bg_param) if bg else None,
                   dropout_flag=train, dropout_p=DROPOUT_P)
    if train:
        dropped = ~keep[:, :, None, None].expand_as(got["mask"])
        assert bool(dropped.any()) and (got["mask"][dropped] == 0).all()
    np.testing.assert_allclose(got["deformation"].numpy(), np.asarray(want["deformation"]),
                               atol=ATOL)
    for name in ("contribution_maps", "mask", "occlusion"):
        np.testing.assert_allclose(to_nhwc(got[name]), np.asarray(want[name]), atol=ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(got["deformed_source"].permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(want["deformed_source"]), atol=ATOL)
    _check_running_stats(port, stats)


def test_tps_dense_motion_keeps_multi_mask_unported():
    from mrfa_tpu_torch.models.dense_motion import TPSDenseMotionNetwork

    with pytest.raises(NotImplementedError, match="multi_mask"):
        TPSDenseMotionNetwork(**TPS_DM_KW, multi_mask=True)


# ----------------------------------------------------------------- MRFA --


@pytest.mark.parametrize("prior", ["fomm", "tpsm"])
def test_mrfa_eval_forward_matches_jax(prior):
    from mrfa_tpu.models.mrfa import MRFA as JMRFA
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = with_prior(mtia_cfg(SIZE, blocks=3, depth=1), prior)
    jmodel = JMRFA(cfg)
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    v = perturbed(jax.jit(lambda k: jmodel.init(k, dummy, dummy))(jax.random.PRNGKey(0)),
                  seed=10)
    if prior == "fomm":  # the identity-initialized jacobian head, moved off it
        jac = v["params"]["encoder"]["jacobian"]
        jac["kernel"] = (0.01 * np.random.RandomState(10).randn(*jac["kernel"].shape)).astype(
            np.float32)
    source, driving = smooth_image(2, SIZE, seed=11), smooth_image(2, SIZE, seed=12)
    gen, warp_vis, _, kp_s, kp_d = jax.jit(lambda v, s, d: jmodel.apply(v, s, d))(
        v, jnp.asarray(source), jnp.asarray(driving))
    model = MRFA(cfg, device="cpu")
    load_jax_variables(model, v)
    with torch.no_grad():
        got = model(nchw(source), nchw(driving), compute_loss=False)
    n_kp = 50 if prior == "tpsm" else 10
    assert got[3].shape == got[4].shape == (2, n_kp, 2)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(kp_s), atol=ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(kp_d), atol=ATOL)
    np.testing.assert_allclose(to_nhwc(got[0]), np.asarray(gen), atol=FRAME_ATOL)
    np.testing.assert_allclose(to_nhwc(got[1]), np.asarray(warp_vis), atol=FRAME_ATOL)
    if prior == "tpsm":  # the decoder sees the 5-keypoint group means
        np.testing.assert_allclose(model.kp_for_decoder({"kp": got[3]}).numpy(),
                                   np.asarray(kp_s).reshape(2, 10, 5, 2).mean(2), atol=ATOL)


@pytest.mark.parametrize("prior", ["fomm", "tpsm"])
def test_trainer_step_is_finite(prior):
    """A port-only CPU training step per prior with the training losses;
    under TPSM the dropout path is taken (its generator moves) and the
    jacobian term is absent (TPSM emits no jacobian)."""
    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = with_prior(train_cfg(SIZE, blocks=3, depth=1), prior)
    torch.manual_seed(13)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        trainer = Trainer(cfg, device="cpu")
    before = trainer.dropout_generator.get_state()
    batch = {"source": smooth_image(2, SIZE, seed=14), "driving": smooth_image(2, SIZE, seed=15)}
    out = trainer.step(batch, dropout_flag=prior == "tpsm", dropout_p=0.1)
    terms = {"loss", "perceptual", "equivariance"} | (
        {"equivariance_jacobian"} if prior == "fomm" else set())
    assert set(out) == terms | {"gen"}
    assert all(np.isfinite(out[k]) for k in terms)
    assert out["gen"].shape == (2, SIZE, SIZE, 3)
    moved = not torch.equal(before, trainer.dropout_generator.get_state())
    assert moved == (prior == "tpsm")
    assert ("dropout_generator" in trainer.state_dict()) == (prior == "tpsm")
