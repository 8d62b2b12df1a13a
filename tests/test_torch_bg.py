"""The background motion predictor of the port against the JAX package's,
on the CPU: ResNet-18 and `BGMotionPredictor` in train and eval BatchNorm
modes (outputs and running statistics), `DenseMotionNetwork` fed by the
predictor's affine in train mode, the background consistency term of
`MRFA.forward` with its two predictor calls in the JAX order, and the
two-optimizer schedule against optax `multi_transform` over mixed
background and plain steps. No JAX train step is compiled: each JAX module
runs alone."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu_torch.utils.convert import flax_path, load_jax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    image, jax_init, mtia_cfg, nchw, one_torch_thread, perturbed, smooth_image,
)

SIZE = 64
# f32 through a randomly initialized ResNet-18 in train mode: summation-order
# differences of a few ulps, grown by depth; outputs O(1)
ATOL = 1e-4
MODES = ["train", "eval"]


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
                                   atol=1e-5, err_msg=key)


_JITTED = {}


def _jax_run(jmod, v, train, *args):
    """`apply` in train mode (batch statistics, running ones updated) or
    eval; one compile per module class and mode (the inputs are arguments)."""
    key = (type(jmod), train)
    if key not in _JITTED:
        kw = {"train": True, "mutable": ["batch_stats"]} if train else {"train": False}
        _JITTED[key] = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))
    out = _JITTED[key](v, *args)
    return (out[0], out[1]["batch_stats"]) if train else (out, v["batch_stats"])


@functools.lru_cache(maxsize=None)
def _init(name):
    """JAX variables of the ResNet-18 (6 channels in, 6 out) or the
    predictor, initialized once for the module."""
    from mrfa_tpu.models.bg_motion import BGMotionPredictor as JBG
    from mrfa_tpu.nn.resnet import ResNet18 as JResNet

    x3, x6 = jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, SIZE, SIZE, 6))
    if name == "resnet":
        return jax_init(JResNet(num_outputs=6, in_channels=6), x6, False)
    return jax_init(JBG(), x3, x3, True)


def _bg_variables(seed):
    """JAX BGMotionPredictor variables moved off their init, with a random
    fc kernel (its init is zero: the output would not depend on the input)."""
    v = perturbed(_init("bg"), seed=seed)
    fc = v["params"]["bg_encoder"]["fc"]
    rng = np.random.RandomState(seed)
    fc["kernel"] = (0.02 * rng.randn(*fc["kernel"].shape)).astype(np.float32)
    return v


@pytest.mark.parametrize("mode", MODES)
def test_resnet18_matches_flax(mode):
    from mrfa_tpu.nn.resnet import ResNet18 as JResNet
    from mrfa_tpu_torch.nn.resnet import ResNet18

    x = image(2, SIZE, 6, seed=1)
    jmod = JResNet(num_outputs=6, in_channels=6)
    v = perturbed(_init("resnet"), seed=1)
    want, stats = _jax_run(jmod, v, mode == "train", jnp.asarray(x))
    port = ResNet18(6, in_channels=6)
    load_jax_variables(port, v)
    port.train(mode == "train")
    with torch.no_grad():
        got = port(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    _check_running_stats(port, stats)


def test_max_pool_pads_like_reduce_window():
    from mrfa_tpu.nn.resnet import max_pool_3x3_s2 as jpool
    from mrfa_tpu_torch.nn.resnet import max_pool_3x3_s2

    for size in (7, 8):  # odd and even sides; negative values meet the -inf pad
        x = image(2, size, 4, seed=size) - 0.5
        np.testing.assert_array_equal(max_pool_3x3_s2(nchw(x)).permute(0, 2, 3, 1).numpy(),
                                      np.asarray(jpool(jnp.asarray(x))))


@pytest.mark.parametrize("mode", MODES)
def test_bg_motion_predictor_matches_flax(mode):
    from mrfa_tpu.models.bg_motion import BGMotionPredictor as JBG
    from mrfa_tpu_torch.models.bg_motion import BGMotionPredictor

    s, d = smooth_image(2, SIZE, seed=2), smooth_image(2, SIZE, seed=3)
    v = _bg_variables(seed=2)
    want, stats = _jax_run(JBG(), v, mode == "train", jnp.asarray(s), jnp.asarray(d))
    port = BGMotionPredictor()
    load_jax_variables(port, v)
    port.train(mode == "train")
    with torch.no_grad():
        got = port(nchw(s), nchw(d))
    assert got.shape == (2, 3, 3)
    np.testing.assert_array_equal(got[:, 2].numpy(), np.tile([0.0, 0.0, 1.0], (2, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-4)
    _check_running_stats(port, stats)


def test_bg_motion_predictor_starts_at_the_identity():
    from mrfa_tpu_torch.models.bg_motion import BGMotionPredictor

    torch.manual_seed(0)
    port = BGMotionPredictor().train()
    s, d = (torch.from_numpy(image(3, SIZE, seed=i)).permute(0, 3, 1, 2) for i in (4, 5))
    with torch.no_grad():
        np.testing.assert_array_equal(port(s, d).numpy(), np.tile(np.eye(3), (3, 1, 1)))


def test_dense_motion_with_predicted_bg_param_train_mode():
    """The predictor's affine into `DenseMotionNetwork`, both in train mode."""
    from mrfa_tpu.models.bg_motion import BGMotionPredictor as JBG
    from mrfa_tpu.models.dense_motion import DenseMotionNetwork as JDM
    from mrfa_tpu_torch.models.bg_motion import BGMotionPredictor
    from mrfa_tpu_torch.models.dense_motion import DenseMotionNetwork

    s, d = smooth_image(2, SIZE, seed=6), smooth_image(2, SIZE, seed=7)
    rng = np.random.RandomState(8)
    kd, ks = (np.tanh(rng.randn(2, 10, 2)).astype(np.float32) * 0.8 for _ in range(2))
    jd, js = ((np.eye(2) + 0.1 * rng.randn(2, 10, 2, 2)).astype(np.float32) for _ in range(2))
    vb = _bg_variables(seed=6)
    bg_param, _ = _jax_run(JBG(), vb, True, jnp.asarray(s), jnp.asarray(d))
    cfg = dict(block_expansion=16, num_blocks=3, max_features=64, num_kp=10)
    jdm = JDM(**cfg)
    jkd = {"kp": jnp.asarray(kd), "jacobian": jnp.asarray(jd)}
    jks = {"kp": jnp.asarray(ks), "jacobian": jnp.asarray(js)}
    vd = perturbed(jax_init(jdm, jnp.asarray(s), jkd, jks), seed=8)
    want, stats = jax.jit(lambda v: jdm.apply(v, jnp.asarray(s), jkd, jks, bg_param=bg_param,
                                              train=True, mutable=["batch_stats"]))(vd)
    bg, dm = BGMotionPredictor(), DenseMotionNetwork(**cfg)
    load_jax_variables(bg, vb)
    load_jax_variables(dm, vd)
    tkd = {"kp": torch.from_numpy(kd), "jacobian": torch.from_numpy(jd)}
    tks = {"kp": torch.from_numpy(ks), "jacobian": torch.from_numpy(js)}
    with torch.no_grad():
        got = dm.train()(nchw(s), tkd, tks, bg.train()(nchw(s), nchw(d)))
    np.testing.assert_allclose(got["deformation"].numpy(), np.asarray(want["deformation"]),
                               atol=ATOL)
    np.testing.assert_allclose(got["mask"].permute(0, 2, 3, 1).numpy(), np.asarray(want["mask"]),
                               atol=ATOL)
    _check_running_stats(dm, stats["batch_stats"])


def test_mrfa_bg_term_and_call_order():
    """`MRFA.forward(use_bg=True)` in train mode: the bg term against 10 *
    mean |I - bg(s, d) @ bg(d, s)| from the JAX predictor called in that
    order, and the predictor's running statistics after both calls."""
    from mrfa_tpu.models.bg_motion import BGMotionPredictor as JBG
    from mrfa_tpu_torch.models.mrfa import MRFA

    s, d = smooth_image(2, SIZE, seed=9), smooth_image(2, SIZE, seed=10)
    v = _bg_variables(seed=9)
    fwd, stats = _jax_run(JBG(), v, True, jnp.asarray(s), jnp.asarray(d))
    rev, stats = _jax_run(JBG(), {"params": v["params"], "batch_stats": stats}, True,
                          jnp.asarray(d), jnp.asarray(s))
    want = 10.0 * np.mean(np.abs(np.eye(3) - np.matmul(np.asarray(fwd), np.asarray(rev))))

    cfg = mtia_cfg(SIZE, blocks=3, depth=1)
    cfg["train_params"]["bg_start"] = 0
    torch.manual_seed(0)
    model = MRFA(cfg, device="cpu")
    load_jax_variables(model.bg_predictor, v)
    model.train()
    with torch.no_grad():
        _, _, losses, _, _ = model(nchw(s), nchw(d), compute_loss=True, use_bg=True)
        _, _, plain, _, _ = model(nchw(s), nchw(d), compute_loss=True, use_bg=False)
    assert "bg" not in plain
    np.testing.assert_allclose(float(losses["bg"]), want, rtol=1e-4)
    _check_running_stats(model.bg_predictor, stats)


def test_two_optimizers_match_optax_multi_transform():
    """`Trainer.apply_gradients` on a small four-subtree model against the
    JAX package's two `make_optimizer` transforms and its clipping, over
    mixed steps: the bg group (and its schedule) moves only in bg steps."""
    import optax

    from mrfa_tpu.train.optim import BG_SUBTREES as JBG_SUB
    from mrfa_tpu.train.optim import MAIN_SUBTREES as JMAIN
    from mrfa_tpu.train.optim import clip_inf_norm_subtrees as jclip
    from mrfa_tpu.train.optim import make_optimizer as jmake
    from mrfa_tpu.train.optim import multistep_lr
    from mrfa_tpu_torch.train.optim import BG_SUBTREES, make_optimizer
    from mrfa_tpu_torch.train.trainer import Trainer

    names = ("encoder", "decoder", "dense_motion", "bg_predictor", "vgg")

    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, n in enumerate(names):
                setattr(self, n, torch.nn.Linear(3 + i, 2 + i))

    class TreeTrainer(Trainer):
        def __init__(self, model, lr, milestones, steps_per_epoch, clip):
            self.model, self.clip = model, clip
            self.optimizer, self.scheduler = make_optimizer(model, lr, milestones, steps_per_epoch)
            self.optimizer_bg, self.scheduler_bg = make_optimizer(
                model, lr, milestones, steps_per_epoch, BG_SUBTREES)

    lr, milestones, spe, clip = 1e-2, [1, 2], 2, 0.5
    torch.manual_seed(0)
    model = Tree()
    trainer = TreeTrainer(model, lr, milestones, spe, clip)
    params = {n: {"kernel": getattr(model, n).weight.detach().numpy().T.copy(),
                  "bias": getattr(model, n).bias.detach().numpy().copy()} for n in names}
    tx_main = jmake(params, lr, milestones, spe, JMAIN)
    tx_bg = jmake(params, lr, milestones, spe, JBG_SUB)
    om, ob = tx_main.init(params), tx_bg.init(params)
    sched = multistep_lr(lr, milestones, spe)
    rng = np.random.RandomState(1)
    n_main = n_bg = 0
    for use_bg in (False, True, True, False, True, True, False, True):
        grads = {n: {k: (rng.randn(*p.shape) * (1 + 3 * (n == "encoder"))).astype(np.float32)
                     for k, p in params[n].items()} for n in names}
        if not use_bg:  # the predictor is not run: zero (JAX) or no (port) gradient
            grads["bg_predictor"] = jax.tree.map(np.zeros_like, grads["bg_predictor"])
        for n in names:
            lin = getattr(model, n)
            lin.weight.grad = torch.from_numpy(grads[n]["kernel"].T.copy())
            lin.bias.grad = torch.from_numpy(grads[n]["bias"].copy())
            if (n == "bg_predictor" and not use_bg) or n == "vgg":
                lin.weight.grad = lin.bias.grad = None
        trainer.apply_gradients(use_bg)
        g = jclip(grads, clip)
        upd, om = tx_main.update(g, om, params)
        params = optax.apply_updates(params, upd)
        if use_bg:
            upd, ob = tx_bg.update(g, ob, params)
            params = optax.apply_updates(params, upd)
        n_main, n_bg = n_main + 1, n_bg + use_bg
        assert trainer.scheduler.get_last_lr()[0] == pytest.approx(float(sched(n_main)))
        assert trainer.scheduler_bg.get_last_lr()[0] == pytest.approx(float(sched(n_bg)))
        for n in names:
            lin = getattr(model, n)
            np.testing.assert_allclose(lin.weight.detach().numpy().T, params[n]["kernel"],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
            np.testing.assert_allclose(lin.bias.detach().numpy(), params[n]["bias"],
                                       rtol=1e-5, atol=1e-6, err_msg=n)
    assert (n_main, n_bg) == (8, 5)


def test_trainer_step_with_bg_moves_the_predictor():
    from mrfa_tpu_torch.train.trainer import Trainer
    from tests.torch_parity import train_cfg

    cfg = train_cfg(SIZE, blocks=3, depth=1)
    torch.manual_seed(0)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        plain = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="bg_predictor"):
        plain.step({"source": smooth_image(2, SIZE, 1), "driving": smooth_image(2, SIZE, 2)},
                   use_bg=True)
    cfg["train_params"]["bg_start"] = 0
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        trainer = Trainer(cfg, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.bg_predictor.state_dict().items()}
    batch = {"source": smooth_image(2, SIZE, 1), "driving": smooth_image(2, SIZE, 2)}
    out = trainer.step(batch)  # a plain step leaves the predictor alone
    assert "bg" not in out
    for k, v in trainer.model.bg_predictor.state_dict().items():
        assert torch.equal(v, before[k]), k
    out = trainer.step(batch, use_bg=True)
    assert np.isfinite(out["bg"]) and out["bg"] == pytest.approx(0.0, abs=1e-6)  # identity init
    assert trainer.scheduler_bg.last_epoch == 1 and trainer.scheduler.last_epoch == 2
    moved = trainer.model.bg_predictor.state_dict()
    assert not torch.equal(moved["bg_encoder.fc.weight"], before["bg_encoder.fc.weight"])
