"""Training under the bf16 policy, on the CPU.

Module by module, each under the policy against the JAX module under
`set_compute_dtype(bf16)` (the JAX policy is process-wide: each use sets it
and restores None), the output dtypes equal and the distances of the bf16
outputs from the f32 ones bounded by a ratio of the JAX package's:
  - VGG19 (the perceptual loss's), its 5 features and the gradient of an L1
    feature loss with respect to its input (`jax.grad` of the same module);
  - train-mode BatchNorm on a bf16 input, with its updated statistics;
  - the background predictor's ResNet-18 in train mode, with its statistics;
  - the perceptual-pyramid term (`MRFA.perceptual_loss`) and the two
    equivariance terms (`MRFA.equivariance_losses`) against the JAX
    package's formulas on the JAX modules.
Then one bf16 `Trainer.step` at 64 px against the port's own f32 and f64
steps from the same weights, batch and transform (no JAX train step is
compiled): the loss terms' distance from f64, and each gradient tensor's
distance from f64 relative to its largest |g|, over the f32 step's. The
master weights, their gradients and Adam's moments stay f32; `loop.train`
under `compute_dtype: bf16` resumes bit for bit; another dtype raises.

The bounds come from readings of tests/torch_bf16_train_precision.py
(seeds 0-3, PERF.md).
"""
import contextlib
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu import precision as jprecision
from mrfa_tpu_torch.precision import apply_compute_dtype
from mrfa_tpu_torch.utils.convert import flax_path, load_jax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    jax_init, loop_config, nchw, one_torch_thread, perturbed, smooth_image, train_cfg,
    transform_arrays, write_png_videos,
)

SIZE = 64
BF16 = torch.bfloat16
# The port's bf16-to-f32 distance over the JAX package's, per module output
# (the larger of the max-abs and mean-abs ratios), readings over seeds 0-3:
# VGG19 features 0.83-0.99, its input gradient 0.92-1.13, the ResNet-18's
# output 0.93-1.59
MODULE_RATIO = 2.0
# the ResNet-18's parameter gradients, the same ratio per tensor: median
# over the 62 tensors 1.06-1.14, max 1.54-1.61
GRAD_RATIO_MEDIAN = 1.5
GRAD_RATIO_MAX = 2.5
PERCEPTUAL_ULPS = 2  # the bf16 perceptual term within 2 bf16 ulps of JAX's (read: 0)
# One step, bf16 against f64, readings over seeds 0-3 (f32 against f64
# beside). The random-init 64 px step is ill conditioned: the f32 step's own
# tensors sit up to 3.7% of their largest |g| from f64 in scale, and bf16
# rounding (bf16 keypoints, bf16 features under L1 signs) saturates that:
# loss terms rel loss 0.012-0.022, perceptual 1.6e-4-9.2e-3, equivariance
# 0.077-0.187, jacobian 0.008-0.015 (f32 <= 3.9e-6); each gradient tensor's
# largest |g| 0.63-1.03 from f64's at most (f32 0.006-0.037), its cosine with
# f64's median 0.70-0.76, min 0.11-0.29 (f32 >= 0.9994). So the gates are
# the readings' with room; the ratio to the f32 step's distance (~1e4) would
# say nothing more.
TERM_REL = {"loss": 0.05, "perceptual": 0.03, "equivariance": 0.4,
            "equivariance_jacobian": 0.05}
GRAD_SCALE_MAX = 1.5
GRAD_COS_MEDIAN = 0.5
GRAD_COS_MIN = 0.05


@contextlib.contextmanager
def jax_policy(dtype):
    jprecision.set_compute_dtype(dtype)
    try:
        yield
    finally:
        jprecision.set_compute_dtype(None)


def _dist(a, b):
    """(max abs, mean abs) between two arrays or tensors, in f64."""
    a = a.detach().double().numpy() if torch.is_tensor(a) else np.asarray(a, np.float64)
    b = b.detach().double().numpy() if torch.is_tensor(b) else np.asarray(b, np.float64)
    d = np.abs(a - b)
    return float(d.max()), float(d.mean())


def _ratio(port, jax_):
    """The port's (max, mean) distance over the JAX package's, each floored
    at 1e-12 (a distance of 0 on both sides reads 1)."""
    return tuple(max(p, 1e-12) / max(j, 1e-12) for p, j in zip(port, jax_))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _reading(pb, jb, pf, jf) -> dict:
    """One output's reading from the port's and the JAX package's bf16 and
    f32 values (numpy, same layout): the dtypes of the bf16 outputs, the
    (max, mean) distance of bf16 from f32 on each side, the f32 outputs'
    max distance and the largest |f32 output|."""
    return {"dtypes": (pb.dtype, jb.dtype), "port": _dist(pb, pf), "jax": _dist(jb, jf),
            "f32": _dist(pf, jf)[0], "scale": float(np.abs(np.asarray(pf, np.float64)).max())}


# --------------------------------------------------------------------------
# module by module

def vgg_readings(seed: int) -> dict:
    """VGG19 features of a smooth image and the input gradient of the L1
    distance to another image's features, f32 and bf16 in both packages:
    {output: `_reading`}."""
    from mrfa_tpu.nn.vgg import Vgg19 as JVgg19
    from mrfa_tpu_torch.nn.vgg import Vgg19

    x, y = smooth_image(2, SIZE, seed=seed), smooth_image(2, SIZE, seed=seed + 10)
    from mrfa_tpu.utils.torch_convert import convert_state_dict

    torch.manual_seed(seed)
    variables = convert_state_dict(Vgg19().state_dict())
    jmod = JVgg19()

    def jax_loss(v, a, b):
        fa, fb = jmod.apply(v, a), jmod.apply(v, b)
        return sum(jnp.mean(jnp.abs(p - jax.lax.stop_gradient(q))) for p, q in zip(fa, fb))

    out = {}
    for policy in (None, jnp.bfloat16):
        with jax_policy(policy):  # the layers read the policy while tracing
            feats = jax.jit(jmod.apply)(variables, jnp.asarray(x))
            grad = jax.jit(jax.grad(jax_loss, argnums=1))(variables, jnp.asarray(x),
                                                          jnp.asarray(y))
        out[policy] = {"features": feats, "grad": grad}
    ported = {}
    for dtype in (None, BF16):
        model = Vgg19()
        load_jax_variables(model, variables)
        if dtype is not None:
            apply_compute_dtype(model, dtype)
        xt = nchw(x).requires_grad_(True)
        feats = model(xt)
        with torch.no_grad():
            yfeats = model(nchw(y))
        sum(torch.mean(torch.abs(p - q)) for p, q in zip(feats, yfeats)).backward()
        ported[dtype] = {"features": feats, "grad": xt.grad}
    readings = {}
    for i in range(5):
        pb, pf = ported[BF16]["features"][i], ported[None]["features"][i]
        readings[f"vgg feature {i}"] = _reading(
            _nhwc(pb), out[jnp.bfloat16]["features"][i], _nhwc(pf), out[None]["features"][i])
        readings[f"vgg feature {i}"]["dtypes"] = (pb.dtype, out[jnp.bfloat16]["features"][i].dtype)
    pb, pf = ported[BF16]["grad"], ported[None]["grad"]
    readings["vgg input grad"] = _reading(_nhwc(pb), out[jnp.bfloat16]["grad"], _nhwc(pf),
                                          out[None]["grad"])
    readings["vgg input grad"]["dtypes"] = (pb.dtype, out[jnp.bfloat16]["grad"].dtype)
    return readings


def batchnorm_readings(seed: int) -> dict:
    """Train-mode BatchNorm on a bf16 input: (port output, jax output, port
    statistics, jax statistics)."""
    from mrfa_tpu.nn.norm import BatchNorm as JBatchNorm
    from mrfa_tpu_torch.nn.norm import BatchNorm

    rng = np.random.RandomState(seed)
    x = (rng.randn(4, 8, 8, 16) * 2 + 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jmod = JBatchNorm(16)
    v = perturbed(jmod.init(jax.random.PRNGKey(0), xb, False), seed=seed)
    jout, upd = jax.jit(lambda v, a: jmod.apply(v, a, True, mutable=["batch_stats"]))(v, xb)
    port = BatchNorm(16)
    load_jax_variables(port, v)
    port.train()
    with torch.no_grad():
        out = port(nchw(np.asarray(xb.astype(jnp.float32))).to(BF16))
    return {"out": (out, jout), "stats": (port.state_dict(), upd["batch_stats"])}


def resnet_readings(seed: int) -> dict:
    """The background predictor (its ResNet-18 in train mode) on smooth
    frames: {"affine": `_reading` of its output, "stats": the running
    statistics of both bf16 runs, "param_grads": a `_reading` of each
    parameter's gradient of a fixed random projection of the output}."""
    from mrfa_tpu.models.bg_motion import BGMotionPredictor as JBG
    from mrfa_tpu_torch.models.bg_motion import BGMotionPredictor

    src, drv = smooth_image(2, SIZE, seed=seed), smooth_image(2, SIZE, seed=seed + 20)
    x3 = jnp.zeros((1, SIZE, SIZE, 3))
    v = perturbed(jax_init(JBG(), x3, x3, True), seed=seed)
    fc = v["params"]["bg_encoder"]["fc"]
    fc["kernel"] = (0.02 * np.random.RandomState(seed).randn(*fc["kernel"].shape)).astype(
        np.float32)
    probe = np.random.RandomState(seed + 1).randn(2, 3, 3).astype(np.float32)
    outs, stats, grads = {}, {}, {}
    for policy in (None, jnp.bfloat16):
        with jax_policy(policy):
            jmod = JBG()

            def loss(params, a, b):
                out, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, a, b,
                                      True, mutable=["batch_stats"])
                return jnp.sum(out * probe), (out, upd["batch_stats"])

            g, (out, st) = jax.jit(jax.grad(loss, has_aux=True))(
                v["params"], jnp.asarray(src), jnp.asarray(drv))
        outs["jax", policy], stats["jax", policy], grads["jax", policy] = out, st, g
    for dtype in (None, BF16):
        port = BGMotionPredictor()
        load_jax_variables(port, v)
        if dtype is not None:
            apply_compute_dtype(port, dtype)
        port.train()
        out = port(nchw(src), nchw(drv))
        (out * torch.from_numpy(probe)).sum().backward()
        outs["port", dtype], stats["port", dtype] = out.detach(), port.state_dict()
        grads["port", dtype] = {k: p.grad for k, p in port.named_parameters()}
    pb, pf = outs["port", BF16], outs["port", None]
    jb, jf = outs["jax", jnp.bfloat16], outs["jax", None]
    affine = _reading(pb.numpy(), jb, pf.numpy(), jf)
    affine["dtypes"] = (pb.dtype, jb.dtype)
    param_grads = {}
    for key, gb in grads["port", BF16].items():
        coll, path = flax_path(key, gb.dim())
        leaf = {p: grads["jax", p] for p in (None, jnp.bfloat16)}
        for k in path:
            leaf = {p: t[k] for p, t in leaf.items()}
        to_jax = (lambda t: t.permute(2, 3, 1, 0)) if gb.dim() == 4 else (
            (lambda t: t.t()) if gb.dim() == 2 else (lambda t: t))
        param_grads[key] = _reading(to_jax(gb).numpy(), leaf[jnp.bfloat16],
                                    to_jax(grads["port", None][key]).numpy(), leaf[None])
        param_grads[key]["dtypes"] = (gb.dtype, leaf[jnp.bfloat16].dtype)
    return {"affine": affine, "stats": (stats["port", BF16], stats["jax", jnp.bfloat16]),
            "param_grads": param_grads}


def _small_model(dtype):
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(0)
    return MRFA(train_cfg(SIZE, blocks=3, depth=1), device="cpu", compute_dtype=dtype).train()


def loss_term_readings(seed: int) -> dict:
    """The perceptual term on (driving, generated) and the equivariance terms
    on bf16 keypoints (as the MTIA encoder makes them under the policy) and
    f32 jacobians: {term: (port value, jax value, port f32 value)}."""
    from mrfa_tpu.nn.vgg import Vgg19 as JVgg19
    from mrfa_tpu.ops.grid import make_coordinate_grid as jgrid
    from mrfa_tpu.ops.resize import AntiAliasParams
    from mrfa_tpu.ops.resize import antialias_downsample as jdown
    from mrfa_tpu.ops.tps import RandomTransformParams as JParams
    from mrfa_tpu.ops.tps import random_transform_jacobian as jjac
    from mrfa_tpu.ops.tps import random_transform_warp as jwarp
    from mrfa_tpu.utils.torch_convert import convert_state_dict
    from mrfa_tpu_torch.ops.grid import make_coordinate_grid
    from mrfa_tpu_torch.ops.tps import RandomTransformParams

    models = {dtype: _small_model(dtype) for dtype in (None, BF16)}
    vgg_vars = {"params": convert_state_dict(models[None].state_dict())["params"]["vgg"]}
    driving, gen = smooth_image(2, SIZE, seed=seed), smooth_image(2, SIZE, seed=seed + 30)
    cfg = train_cfg(SIZE)
    scales, weights = cfg["train_params"]["scales"], cfg["train_params"]["loss_weights"]

    def jax_perceptual(v, d, g):  # mrfa_tpu/models/mrfa.py:183-195, on the JAX modules
        vgg, total = JVgg19(), 0.0
        for s in scales:
            aa = AntiAliasParams.create(s)
            xf, yf = vgg.apply(v, jdown(g, aa)), vgg.apply(v, jdown(d, aa))
            for i, w in enumerate(weights["perceptual"]):
                total = total + w * jnp.mean(jnp.abs(xf[i] - jax.lax.stop_gradient(yf[i])))
        return total

    with jax_policy(jnp.bfloat16):
        jperc = jax.jit(jax_perceptual)(vgg_vars, jnp.asarray(driving), jnp.asarray(gen))
    with torch.no_grad():
        perc = {dtype: m.perceptual_loss(nchw(driving), nchw(gen)) for dtype, m in models.items()}

    rng = np.random.RandomState(seed)
    kp_d = (0.8 * rng.rand(2, 10, 2) - 0.4).astype(np.float32)
    kp_t = (kp_d + 0.05 * rng.randn(2, 10, 2)).astype(np.float32)
    jac_d = (np.eye(2) + 0.1 * rng.randn(2, 10, 2, 2)).astype(np.float32)
    jac_t = (np.eye(2) + 0.1 * rng.randn(2, 10, 2, 2)).astype(np.float32)
    theta, cpar = transform_arrays(2, seed=seed)
    kp_d, kp_t = (np.asarray(jnp.asarray(k, jnp.bfloat16)) for k in (kp_d, kp_t))

    def jax_equivariance(kd, kt, jd, jt):  # mrfa_tpu/models/mrfa.py:198-215
        p = JParams(jnp.asarray(theta), jgrid(5, 5).reshape(1, 25, 2), jnp.asarray(cpar))
        eq = weights["equivariance"] * jnp.mean(jnp.abs(kd - jwarp(p, kt)))
        value = jnp.matmul(jnp.linalg.inv(jd), jnp.matmul(jjac(p, kt), jt))
        return eq, weights["equivariance_jacobian"] * jnp.mean(jnp.abs(jnp.eye(2) - value))

    jeq = jax.jit(jax_equivariance)(kp_d, kp_t, jac_d, jac_t)
    params = RandomTransformParams(torch.from_numpy(theta),
                                   make_coordinate_grid(5, 5).reshape(1, 25, 2),
                                   torch.from_numpy(cpar))
    eq = models[BF16].equivariance_losses(
        {"kp": torch.from_numpy(kp_d.astype(np.float32)).to(BF16),
         "jacobian": torch.from_numpy(jac_d)},
        {"kp": torch.from_numpy(kp_t.astype(np.float32)).to(BF16),
         "jacobian": torch.from_numpy(jac_t)}, params)
    return {"perceptual": (perc[BF16], jperc, perc[None]),
            "equivariance": (eq["equivariance"], jeq[0], None),
            "equivariance_jacobian": (eq["equivariance_jacobian"], jeq[1], None)}


def test_vgg19_features_and_input_gradient_under_the_policy():
    for name, r in vgg_readings(seed=0).items():
        want = (BF16, jnp.bfloat16) if "feature" in name else (torch.float32, jnp.float32)
        assert r["dtypes"] == want, name
        # f32 port against f32 JAX: features 1.5e-7 of their largest value;
        # the input gradient, a sum of +-1/N L1 signs that mostly cancel,
        # 3.8e-3 of its largest value
        assert r["f32"] <= (1e-5 if "feature" in name else 1e-2) * r["scale"], (name, r)
        assert max(_ratio(r["port"], r["jax"])) <= MODULE_RATIO, (name, r)


def test_train_batchnorm_on_bf16_input():
    r = batchnorm_readings(seed=0)
    out, jout = r["out"]
    assert out.dtype == BF16 and jout.dtype == jnp.bfloat16
    # both normalize in f32 and round once to bf16: at most one bf16 ulp apart
    ulp = np.abs(np.asarray(jout.astype(jnp.float32))) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(_nhwc(out) - np.asarray(jout.astype(jnp.float32))) <= ulp)
    state, jstats = r["stats"]
    for key in ("running_mean", "running_var"):
        assert state[key].dtype == torch.float32
        _, path = flax_path(key, 1)
        np.testing.assert_allclose(state[key].numpy(), np.asarray(jstats[path[-1]]),
                                   rtol=1e-6, atol=1e-6)


def test_bg_predictor_resnet18_in_train_mode_under_the_policy():
    r = resnet_readings(seed=0)
    affine = r["affine"]
    assert affine["dtypes"] == (torch.float32, jnp.float32)  # the fc head is an f32 head
    assert affine["f32"] <= 1e-4
    assert max(_ratio(affine["port"], affine["jax"])) <= MODULE_RATIO, affine
    grads = r["param_grads"]
    assert len(grads) == 62
    for key, g in grads.items():
        assert g["dtypes"] == (torch.float32, jnp.float32), key  # f32 masters' gradients
    # f32 port against f32 JAX, each tensor's max |dg| over its max |g|:
    # median 4.1e-5-4.3e-5; the largest 1.1e-4 at seed 0 (0.14 at seed 3, in
    # layer1, where the B=2 train-mode step is ill conditioned)
    assert np.median([g["f32"] / g["scale"] for g in grads.values()]) <= 2e-4
    ratios = [max(_ratio(g["port"], g["jax"])) for g in grads.values()]
    assert np.median(ratios) <= GRAD_RATIO_MEDIAN and max(ratios) <= GRAD_RATIO_MAX, ratios
    assert max(g["f32"] / g["scale"] for g in grads.values()) <= 1e-3
    state, jstats = r["stats"]
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert keys
    for key in keys:
        assert state[key].dtype == torch.float32, key
        _, path = flax_path(key, 1)
        leaf = jstats
        for k in path:
            leaf = leaf[k]
        # the running statistics of the bf16 activations: the same rounding
        # on both sides up to the bf16 ulps of the activations they average
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=2e-2, atol=2e-3,
                                   err_msg=key)


def test_loss_terms_under_the_policy():
    r = loss_term_readings(seed=0)
    port, jax_, f32 = r["perceptual"]
    assert port.dtype == BF16 and jax_.dtype == jnp.bfloat16
    ulp = 2.0 ** -7 * abs(float(jax_))
    assert abs(float(port) - float(jax_)) <= PERCEPTUAL_ULPS * ulp, (float(port), float(jax_))
    assert abs(float(port) - float(f32)) <= 0.02 * abs(float(f32))
    for term in ("equivariance", "equivariance_jacobian"):
        port, jax_, _ = r[term]
        assert port.dtype == torch.float32 and jax_.dtype == jnp.float32, term
        np.testing.assert_allclose(float(port), float(jax_), rtol=1e-5, err_msg=term)


# --------------------------------------------------------------------------
# one step against the port's f32 and f64 steps

def step_readings(seed: int) -> dict:
    """One Trainer.step in f64, f32 and bf16 from the same weights, batch and
    equivariance transform: the loss terms and pre-clip gradients of each,
    and the bf16 trainer after its step."""
    import mrfa_tpu_torch.train.trainer as trainer_mod
    from mrfa_tpu_torch.ops.grid import make_coordinate_grid
    from mrfa_tpu_torch.ops.tps import RandomTransformParams
    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = train_cfg(SIZE, blocks=3, depth=1)
    torch.manual_seed(seed)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        base = Trainer(cfg, device="cpu")
    weights = base.model.state_dict()
    batch = {"source": smooth_image(2, SIZE, seed=seed + 1),
             "driving": smooth_image(2, SIZE, seed=seed + 2)}
    theta, cpar = transform_arrays(2, seed=seed)
    clip, draw = trainer_mod.clip_inf_norm_subtrees, trainer_mod.random_transform_params
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", None), ("bf16", BF16)):
        grads = {}

        def spy(model, max_norm, grads=grads):
            grads.update({n: p.grad.detach().double().clone()
                          for n, p in model.named_parameters() if p.grad is not None})
            return clip(model, max_norm)

        geom = torch.float64 if dtype == torch.float64 else torch.float32
        fixed = RandomTransformParams(torch.from_numpy(theta).to(geom),
                                      make_coordinate_grid(5, 5).reshape(1, 25, 2).to(geom),
                                      torch.from_numpy(cpar).to(geom))
        trainer = Trainer(cfg, device="cpu", weights={k: v.clone() for k, v in weights.items()},
                          compute_dtype=dtype if dtype == BF16 else None)
        if dtype == torch.float64:
            trainer.model.double()
            trainer._frames = lambda x: torch.as_tensor(x).double().permute(0, 3, 1, 2)
        try:
            trainer_mod.clip_inf_norm_subtrees = spy
            trainer_mod.random_transform_params = lambda *a, **k: fixed
            terms = trainer.step(batch)
        finally:
            trainer_mod.clip_inf_norm_subtrees = clip
            trainer_mod.random_transform_params = draw
        out[name] = {"terms": {k: v for k, v in terms.items() if k != "gen"}, "grads": grads,
                     "trainer": trainer}
    return out


def step_distances(readings: dict) -> dict:
    """From `step_readings`, for the f32 and the bf16 step against f64: each
    loss term's relative distance, and for each gradient tensor (those whose
    max |g_f64| >= 1e-5) the distance of its largest |g| from f64's,
    relative (`scale`), and its cosine similarity with f64's (`cos`)."""
    f64 = readings["f64"]
    out = {}
    for name in ("f32", "bf16"):
        r = readings[name]
        out[name, "terms"] = {k: abs(v - f64["terms"][k]) / abs(f64["terms"][k])
                              for k, v in r["terms"].items()}
        scale, cos = {}, {}
        for k, w in f64["grads"].items():
            if float(w.abs().max()) < 1e-5:
                continue
            g = r["grads"][k]
            scale[k] = abs(float(g.abs().max()) / float(w.abs().max()) - 1.0)
            cos[k] = float((g * w).sum() / (g.norm() * w.norm()))
        out[name, "scale"], out[name, "cos"] = scale, cos
    return out


@pytest.fixture(scope="module")
def steps():
    readings = step_readings(seed=0)
    return readings, step_distances(readings)


def test_bf16_step_against_the_f32_and_f64_steps(steps):
    readings, d = steps
    assert sorted(readings["bf16"]["terms"]) == sorted(readings["f32"]["terms"])
    for term, rel in d["bf16", "terms"].items():
        assert np.isfinite(readings["bf16"]["terms"][term])
        assert rel <= TERM_REL[term], (term, rel)
    scale, cos = d["bf16", "scale"], d["bf16", "cos"]
    assert sorted(scale) == sorted(d["f32", "scale"]) and len(scale) > 600
    assert set(readings["bf16"]["grads"]) == set(readings["f32"]["grads"])
    assert max(scale.values()) <= GRAD_SCALE_MAX, max(scale, key=scale.get)
    assert np.median(list(cos.values())) >= GRAD_COS_MEDIAN
    assert min(cos.values()) >= GRAD_COS_MIN, min(cos, key=cos.get)


def test_bf16_masters_grads_and_adam_stay_f32(steps):
    readings, _ = steps
    trainer = readings["bf16"]["trainer"]
    assert trainer.model.compute_dtype == BF16
    params = dict(trainer.model.named_parameters())
    assert all(p.dtype == torch.float32 for p in params.values())
    assert all(p.grad.dtype == torch.float32 for p in params.values() if p.grad is not None)
    state = trainer.optimizer.state
    assert state and all(v.dtype == torch.float32 for s in state.values()
                         for v in s.values() if torch.is_tensor(v) and v.dim() > 0)
    moved = readings["f32"]["trainer"].model.state_dict()
    changed = [k for k, p in params.items() if p.requires_grad
               and not torch.equal(p.detach(), moved[k].detach())]
    assert changed  # the bf16 step moved the masters, and not as the f32 step did
    from mrfa_tpu_torch.precision import cast_params_for_inference

    assert trainer.model.training
    with pytest.raises(ValueError, match="training mode"):
        cast_params_for_inference(trainer.model)
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def test_loop_bf16_resume_is_bit_equal_to_a_straight_run(tmp_path):
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.train.loop import train

    root = str(tmp_path / "data")
    write_png_videos(root)
    cfg = loop_config(root)
    cfg["train_params"].update(compute_dtype="bf16", bg_start=1000)

    def run(log, checkpoint=None):
        data = FramesDataset(is_train=True, seed=7, **cfg["dataset_params"])
        with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
            return train(cfg, checkpoint, str(tmp_path / log), data, seed=0,
                         max_steps_per_epoch=1, device="cpu")

    straight = run("a")
    assert straight.model.compute_dtype == BF16
    # a checkpoint is ~0.9 GB here: move the one resumed from, drop the rest
    os.makedirs(tmp_path / "r" / "ckpt")
    shutil.move(str(tmp_path / "a" / "ckpt" / "0"), str(tmp_path / "r" / "ckpt" / "0"))
    shutil.rmtree(tmp_path / "a" / "ckpt")
    resumed = run("r", str(tmp_path / "r" / "ckpt"))
    shutil.rmtree(tmp_path / "r" / "ckpt")
    want, got = straight.state_dict(), resumed.state_dict()
    assert want["step"] == got["step"] == 2
    for key, value in want["model"].items():
        assert value.dtype == got["model"][key].dtype and torch.equal(got["model"][key], value)
        assert not value.is_floating_point() or value.dtype in (torch.float32, torch.float64)
    for s_want, s_got in zip(want["optimizer"]["state"].values(),
                             got["optimizer"]["state"].values()):
        for k in s_want:
            assert torch.equal(s_want[k], s_got[k])
    lines = (tmp_path / "a" / "log.txt").read_text().splitlines()
    assert (tmp_path / "r" / "log.txt").read_text().splitlines() == lines[1:]


@pytest.mark.parametrize("value", ["fp16", "float16", "int8", "bfloat"])
def test_other_compute_dtypes_raise(value):
    from mrfa_tpu_torch.train.loop import train, train_compute_dtype

    assert train_compute_dtype({}) is None
    assert train_compute_dtype({"compute_dtype": "f32"}) is None
    assert train_compute_dtype({"compute_dtype": "bfloat16"}) == BF16
    cfg = loop_config("unused")
    cfg["train_params"]["compute_dtype"] = value
    with pytest.raises(ValueError, match="compute_dtype"):
        train(cfg, None, "unused", [], device="cpu")
