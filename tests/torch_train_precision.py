"""How far the f32 training step sits from its f64 value, for the JAX package
and for the port, on the setup of tests/test_torch_train.py.

Run from the repository root (CPU, ~10 minutes, most of it XLA compiling the
JAX step twice):

    JAX_PLATFORMS=cpu python -m tests.torch_train_precision

It prints one line per measurement:
  - the train-mode keypoints of the MTIA encoder: JAX f32 and the port's f32
    against their own f64 values, and the port's f64 against JAX's f64;
  - one whole step, the port's f32 `Trainer.step` against the JAX f32
    `make_train_step` and against the JAX f64 one: generated frames,
    BatchNorm running statistics, and how many gradient tensors differ by
    more than 1e-3 of their largest |g|;
  - how far the port's own f32 gradients move when the input frames move by
    1e-6 (the largest move over the tensors, relative to each tensor's max).
"""
from __future__ import annotations

import tests.conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mrfa_tpu.models.mrfa as jmrfa_mod
import mrfa_tpu.train.trainer as jtrainer_mod
import mrfa_tpu_torch.train.trainer as trainer_mod
from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.models.mrfa import mtia_encoder_from_cfg as jencoder
from mrfa_tpu.ops.grid import make_coordinate_grid as jgrid
from mrfa_tpu.ops.tps import RandomTransformParams as JParams
from mrfa_tpu.train.optim import BG_SUBTREES, MAIN_SUBTREES, make_optimizer
from mrfa_tpu.train.trainer import create_train_state, make_train_step
from mrfa_tpu_torch.models.mrfa import mtia_encoder_from_cfg
from mrfa_tpu_torch.ops.grid import make_coordinate_grid
from mrfa_tpu_torch.ops.tps import RandomTransformParams
from mrfa_tpu_torch.train.trainer import Trainer
from mrfa_tpu_torch.utils.convert import _to_torch_layout, flax_path, load_jax_variables
from tests.torch_parity import nchw, perturbed, smooth_image, train_cfg, transform_arrays

SIZE, B = 64, 2


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def jax_step(cfg, variables, frames, theta, cpar, dtype):
    """One make_train_step step in `dtype`: (gen, batch_stats, pre-clip grads)."""
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    with jax.enable_x64(dtype == jnp.float64):
        fixed = JParams(cast(theta), jgrid(5, 5, dtype=dtype).reshape(1, 25, 2), cast(cpar))
        jmrfa_mod.random_transform_params = lambda *a, **k: fixed
        grads, clip = {}, jtrainer_mod.clip_inf_norm_subtrees

        def spy(g, max_norm):
            jax.debug.callback(lambda t: grads.update(jax.tree.map(np.asarray, t)), g)
            return clip(g, max_norm)

        jtrainer_mod.clip_inf_norm_subtrees = spy
        v = jax.tree.map(cast, variables)
        tp = cfg["train_params"]
        tx = [make_optimizer(v["params"], tp["lr"], tp["epoch_milestones"], 10, s)
              for s in (MAIN_SUBTREES, BG_SUBTREES)]
        step = make_train_step(JMRFA(cfg), *tx, use_bg=False, clip=tp["clip"], donate=False)
        state, metrics, extras = step(create_train_state(v, *tx),
                                      {"source": cast(frames[0]), "driving": cast(frames[1])},
                                      jax.random.PRNGKey(7), jnp.float32(0.0))
        jtrainer_mod.clip_inf_norm_subtrees = clip
        return (np.asarray(extras["gen"]), jax.tree.map(np.asarray, state.batch_stats), grads)


def port_step(cfg, variables, frames, theta, cpar, noise=0.0):
    """One f32 Trainer.step: (gen, state_dict, pre-clip grads)."""
    fixed = RandomTransformParams(torch.from_numpy(theta), make_coordinate_grid(5, 5)
                                  .reshape(1, 25, 2), torch.from_numpy(cpar))
    trainer_mod.random_transform_params = lambda *a, **k: fixed
    grads, clip = {}, trainer_mod.clip_inf_norm_subtrees

    def spy(model, max_norm):
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return clip(model, max_norm)

    trainer_mod.clip_inf_norm_subtrees = spy
    rng = np.random.RandomState(5)
    batch = {k: (f + noise * rng.randn(*f.shape)).astype(np.float32)
             for k, f in zip(("source", "driving"), frames)}
    trainer = Trainer(cfg, device="cpu", weights=variables)
    out = trainer.step(batch)
    trainer_mod.clip_inf_norm_subtrees = clip
    return out["gen"].numpy(), trainer.model.state_dict(), grads


def compare(name, port, ref):
    gen, state, grads = port
    jgen, jstats, jgrads = ref
    stats = max(float(np.abs(state[k].numpy() - _leaf(jstats, flax_path(k, 1)[1])).max())
                for k in state if k.endswith(("running_mean", "running_var")))
    beyond = 0
    for n, g in grads.items():
        want = _to_torch_layout(_leaf(jgrads, flax_path(n, g.dim())[1]), n, g.dim())
        beyond += float(np.abs(g.numpy() - want).max()) > 1e-3 * float(np.abs(want).max())
    print(f"step, port f32 vs {name}: frames max abs {np.abs(gen - jgen).max():.3e}, "
          f"running statistics max abs {stats:.3e}, {beyond} of {len(grads)} gradient "
          f"tensors beyond 1e-3 of their max |g|")


def main():
    cfg = train_cfg(SIZE, blocks=3, depth=1)
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    rngs = {k: jax.random.PRNGKey(i) for i, k in enumerate(("params", "equivariance", "dropout"))}
    variables = jax.tree.map(np.asarray, perturbed(jax.jit(
        lambda r: JMRFA(cfg).init(r, dummy, dummy, train=True, compute_loss=True))(rngs)))
    frames = (smooth_image(B, SIZE, seed=1), smooth_image(B, SIZE, seed=2))
    theta, cpar = transform_arrays(B, seed=3)

    enc_vars = {c: variables[c]["encoder"] for c in ("params", "batch_stats")}
    kp = {}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            enc = jencoder(cfg["mtia_kp_detector"])
            v = jax.tree.map(lambda a: jnp.asarray(a, dtype), enc_vars)
            kp["jax", dtype] = np.asarray(jax.jit(lambda v, x: enc.apply(
                v, x, True, mutable=["batch_stats"])[0]["kp"])(v, jnp.asarray(frames[0], dtype)))
    for tdt, name in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        enc = mtia_encoder_from_cfg(cfg["mtia_kp_detector"])
        load_jax_variables(enc, enc_vars)
        enc.to(tdt).train()
        with torch.no_grad():
            kp["port", name] = enc(nchw(frames[0]).to(tdt))["kp"].double().numpy()
    f32, f64 = jnp.float32, jnp.float64
    print(f"train-mode keypoints: JAX f32 vs JAX f64 "
          f"{np.abs(kp['jax', f32] - kp['jax', f64]).max():.3e}; port f32 vs port f64 "
          f"{np.abs(kp['port', f32] - kp['port', f64]).max():.3e}; port f64 vs JAX f64 "
          f"{np.abs(kp['port', f64] - kp['jax', f64]).max():.3e}")

    port = port_step(cfg, variables, frames, theta, cpar)
    compare("JAX f32", port, jax_step(cfg, variables, frames, theta, cpar, jnp.float32))
    compare("JAX f64", port, jax_step(cfg, variables, frames, theta, cpar, jnp.float64))
    _, _, moved = port_step(cfg, variables, frames, theta, cpar, noise=1e-6)
    top = max(float(g.abs().max()) for g in port[2].values())
    rel = max(float((moved[n] - g).abs().max() / g.abs().max()) for n, g in port[2].items()
              if float(g.abs().max()) > 1e-6 * top)
    print(f"port f32 gradients under a 1e-6 change of the input frames: largest move "
          f"{rel:.3e} of a tensor's max |g| (tensors whose max |g| is under 1e-6 of the "
          f"model's, gradients that are zero in exact arithmetic, left out)")


if __name__ == "__main__":
    main()
