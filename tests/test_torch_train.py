"""One whole training step of the port against the JAX package's, on the CPU.

The MTIA model at 64 px with 3-block hourglasses and a 1-layer TokenPose
(every width the flagship's) and the training losses on (`train_cfg`), B=2,
JAX-initialized weights moved off their initial values and carried into the
port by `load_jax_variables`, the same equivariance transform injected on
both sides. The JAX side is one `make_train_step` step (value_and_grad of
`model.apply(train=True, compute_loss=True, mutable=["batch_stats"])` under
jit, clipping, Adam); its gradients before clipping are read out of the
jitted step with `jax.debug.callback`. The port side is `Trainer.step`.

The JAX step runs in f64. Its f32 evaluation is not a reference at the
tolerances below: in train mode the randomly initialized network amplifies
rounding (a 1e-6 change of the input frames moves deep gradients by tens of
percent), and the JAX package's f32 keypoints already sit 1.5e-5 from their
f64 value, where the port's f32 keypoints sit 8.8e-7 from it
(tests/torch_train_precision.py measures both). So the port's step runs
twice: in f64, held to every comparison, and as it ships, in f32, held to
the loss terms, the generated frames, the running statistics and the
parameters after the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mrfa_tpu.models.mrfa as jmrfa_mod
import mrfa_tpu.train.trainer as jtrainer_mod
import mrfa_tpu_torch.train.trainer as trainer_mod
from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.ops.grid import make_coordinate_grid as jgrid
from mrfa_tpu.ops.tps import RandomTransformParams as JParams
from mrfa_tpu.train.optim import BG_SUBTREES, MAIN_SUBTREES, make_optimizer
from mrfa_tpu.train.trainer import create_train_state, make_train_step
from mrfa_tpu_torch.ops.grid import make_coordinate_grid
from mrfa_tpu_torch.ops.splat import splat
from mrfa_tpu_torch.ops.tps import RandomTransformParams
from mrfa_tpu_torch.train.trainer import Trainer
from mrfa_tpu_torch.utils.convert import _to_torch_layout, flax_path
from tests.torch_parity import perturbed, smooth_image, train_cfg, transform_arrays

SIZE = 64
B = 2
STEPS_PER_EPOCH = 10
LR = train_cfg()["train_params"]["lr"]
RUNS = ["f64", "f32"]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _jax_step(cfg, variables, source, driving, theta, cpar):
    """One make_train_step step in f64: (state, metrics, gen, pre-clip grads)."""
    jmodel = JMRFA(cfg)
    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        fixed = JParams(f64(theta), jgrid(5, 5, dtype=jnp.float64).reshape(1, 25, 2), f64(cpar))
        mp.setattr(jmrfa_mod, "random_transform_params", lambda *a, **k: fixed)
        grads = {}
        clip = jtrainer_mod.clip_inf_norm_subtrees

        def spy(g, max_norm):
            jax.debug.callback(lambda t: grads.update(jax.tree.map(np.asarray, t)), g)
            return clip(g, max_norm)

        mp.setattr(jtrainer_mod, "clip_inf_norm_subtrees", spy)
        v64 = jax.tree.map(f64, variables)
        tp = cfg["train_params"]
        tx_main = make_optimizer(v64["params"], tp["lr"], tp["epoch_milestones"],
                                 STEPS_PER_EPOCH, MAIN_SUBTREES)
        tx_bg = make_optimizer(v64["params"], tp["lr"], tp["epoch_milestones"],
                               STEPS_PER_EPOCH, BG_SUBTREES)
        step = make_train_step(jmodel, tx_main, tx_bg, use_bg=False, clip=tp["clip"],
                               donate=False)
        state, metrics, extras = step(
            create_train_state(v64, tx_main, tx_bg),
            {"source": f64(source), "driving": f64(driving)},
            jax.random.PRNGKey(7), jnp.float32(0.0),
        )
        to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        return {"params": to_np(state.params), "batch_stats": to_np(state.batch_stats),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "gen": np.asarray(extras["gen"]), "grads": grads}


def _port_step(cfg, variables, source, driving, theta, cpar, dtype):
    """One Trainer.step in `dtype`: (trainer, output, pre-clip grads, params before)."""
    with pytest.MonkeyPatch.context() as mp:
        fixed = RandomTransformParams(torch.from_numpy(theta).to(dtype),
                                      make_coordinate_grid(5, 5, dtype=dtype).reshape(1, 25, 2),
                                      torch.from_numpy(cpar).to(dtype))
        mp.setattr(trainer_mod, "random_transform_params", lambda *a, **k: fixed)
        grads = {}
        clip = trainer_mod.clip_inf_norm_subtrees

        def spy(model, max_norm):
            grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                          if p.grad is not None})
            return clip(model, max_norm)

        mp.setattr(trainer_mod, "clip_inf_norm_subtrees", spy)
        trainer = Trainer(cfg, device="cpu", steps_per_epoch=STEPS_PER_EPOCH, weights=variables)
        if dtype == torch.float64:
            trainer.model.double()  # the same Parameters: the optimizer keeps them
            mp.setattr(trainer, "_frames", lambda x: torch.from_numpy(x).double()
                       .permute(0, 3, 1, 2).contiguous())
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        launches = splat.launches
        out = trainer.step({"source": source, "driving": driving})
        assert splat.launches == launches  # CPU: the splat's plain version
    return {"trainer": trainer, "out": out, "grads": grads, "before": before}


@pytest.fixture(scope="module")
def case():
    cfg = train_cfg(SIZE, blocks=3, depth=1)
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "equivariance", "dropout"))}
    jmodel = JMRFA(cfg)
    variables = perturbed(jax.jit(
        lambda r: jmodel.init(r, dummy, dummy, train=True, compute_loss=True)
    )(rngs), seed=0)
    variables = jax.tree.map(np.asarray, variables)
    frames = (smooth_image(B, SIZE, seed=1), smooth_image(B, SIZE, seed=2))
    theta, cpar = transform_arrays(B, seed=3)
    return {
        "jax": _jax_step(cfg, variables, *frames, theta, cpar),
        "f64": _port_step(cfg, variables, *frames, theta, cpar, torch.float64),
        "f32": _port_step(cfg, variables, *frames, theta, cpar, torch.float32),
    }


@pytest.mark.parametrize("run", RUNS)
def test_loss_terms_match(case, run):
    want, got = case["jax"]["metrics"], case[run]["out"]
    assert set(got) - {"gen"} == {"loss", "perceptual", "equivariance", "equivariance_jacobian"}
    for k in ("loss", "perceptual", "equivariance", "equivariance_jacobian"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("run", RUNS)
def test_generated_image_matches(case, run):
    got = case[run]["out"]["gen"].numpy()
    want = case["jax"]["gen"]
    assert got.shape == want.shape == (B, SIZE, SIZE, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_every_gradient_matches(case):
    """Each parameter's gradient before clipping (f64 run), within 1e-3 of
    that tensor's largest |g|. A conv bias that feeds a train-mode BatchNorm
    has a gradient of exactly zero, so both sides carry only rounding there:
    its scale is floored at 1e-9 of the model's largest |g|."""
    grads, jgrads = case["f64"]["grads"], case["jax"]["grads"]
    model = case["f64"]["trainer"].model
    trained = [n for n, p in model.named_parameters() if not n.startswith("vgg.")]
    assert set(grads) == set(trained) and len(trained) > 300
    floor = 1e-9 * max(float(g.abs().max()) for g in grads.values())
    for name in trained:
        g = grads[name]
        _, path = flax_path(name, g.dim())
        want = _to_torch_layout(_leaf(jgrads, path), name, g.dim())
        scale = max(float(np.abs(want).max()), floor)
        err = float(np.abs(g.numpy() - want).max())
        assert err <= 1e-3 * scale, f"{name}: max err {err:.3e}, max |g| {scale:.3e}"


@pytest.mark.parametrize("run", RUNS)
def test_batchnorm_running_statistics_match(case, run):
    jstats = case["jax"]["batch_stats"]
    state = case[run]["trainer"].model.state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for key in keys:
        coll, path = flax_path(key, 1)
        assert coll == "batch_stats"
        np.testing.assert_allclose(state[key].double().numpy(), _leaf(jstats, path), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("run", RUNS)
def test_parameters_after_the_step_match(case, run):
    """Adam's first step moves a parameter by lr * g / (|g| + eps), about
    lr * sign(g). Where both gradients have the same sign and |g| >= 1e-5 (a
    thousand eps: the step no longer depends on the size of g), the
    parameters agree within 1e-6; elsewhere within 2 * lr (+ 1e-6 for f32
    rounding), and gradients of the other sign are fewer than 1e-3 of all.
    The frozen VGG19 does not move; every tensor with a nonzero gradient
    does."""
    jparams, jgrads = case["jax"]["params"], case["jax"]["grads"]
    run_case = case[run]
    flipped = total = 0
    for name, p in run_case["trainer"].model.named_parameters():
        before = run_case["before"][name]
        if name.startswith("vgg."):
            assert torch.equal(p, before), name
            continue
        _, path = flax_path(name, p.dim())
        want = _to_torch_layout(_leaf(jparams, path), name, p.dim())
        jg = _to_torch_layout(_leaf(jgrads, path), name, p.dim())
        g = run_case["grads"][name].double().numpy()
        same = np.sign(g) == np.sign(jg)
        settled = same & (np.abs(jg) >= 1e-5) & (np.abs(g) >= 1e-5)
        diff = np.abs(p.detach().double().numpy() - want)
        assert float(diff[settled].max(initial=0.0)) <= 1e-6, name
        assert float(diff.max()) <= 2 * LR + 1e-6, name
        if np.abs(jg).max() > 0:
            assert float((p.detach() - before).abs().max()) > 0, f"{name} did not move"
        flipped += int((~same).sum())
        total += same.size
    assert flipped < 1e-3 * total, f"{flipped} of {total} gradient signs differ"
