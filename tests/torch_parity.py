"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed, run through the JAX
module and its port counterpart on the CPU, and compared. The port runs
NCHW; the helpers transpose at the boundary.
"""
from __future__ import annotations

import jax
import numpy as np
import torch


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def image(b: int, size: int, c: int = 3, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(b, size, size, c).astype(np.float32)


def smooth_image(b: int, size: int, seed: int = 0) -> np.ndarray:
    """(B, size, size, 3) low-frequency frames in [0, 1]: an 8x8 random image
    per sample, bilinearly upsampled (align_corners=True). Real frames are
    smooth; white noise would make every warp as sensitive to its flow as
    the pixel steps are large."""
    coarse = np.random.RandomState(seed).rand(b, 8, 8, 3)
    src = np.linspace(0.0, 7.0, size)
    lo = np.minimum(np.floor(src).astype(int), 6)
    frac = src - lo
    m = np.zeros((size, 8))
    m[np.arange(size), lo] = 1.0 - frac
    m[np.arange(size), lo + 1] = frac
    return np.einsum("yi,bijc,xj->byxc", m, coarse, m).astype(np.float32)


def jax_init(module, *args, **kwargs):
    """`module.init` under jit (eager flax runs op by op, several times slower)."""
    return jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(0))


def jax_apply(module, variables, *args, **kwargs):
    """`module.apply` under jit; the inputs are closed over as constants."""
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def perturbed(variables, seed: int = 0):
    """JAX variables whose constant-initialized leaves are moved off their
    initial values, so norm scales, biases and running statistics are not
    trivial: 1-D parameters get +0.05*N(0,1), running means N(0, 0.1^2),
    running variances U(0.5, 1.5). Kernels keep their random initialization
    (a larger one would blow activations up over the model's depth)."""
    rng = np.random.RandomState(seed)

    def move(path, leaf):
        leaf = np.asarray(leaf)
        name = getattr(path[-1], "key", str(path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(leaf.dtype)
        if name == "mean":
            return (0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        if leaf.ndim == 1:
            return (leaf + 0.05 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    out = jax.tree_util.tree_map_with_path(move, dict(variables))
    return {k: out[k] for k in ("params", "batch_stats") if k in out}


def mtia_cfg(size: int = 64, blocks: int = 3, depth: int = 1) -> dict:
    """The flagship MTIA model cut to `size` px, `blocks`-block hourglasses
    and a `depth`-layer TokenPose (64/3 is the fast tier of the JAX package's
    dry run); every width is the flagship's."""
    return {
        "train_params": {
            "prior_model": "mtia", "num_epochs": 100, "bg_start": 1000,
            "scales": [1], "loss_weights": {
                "perceptual": [0, 0, 0, 0, 0], "equivariance": 0,
                "equivariance_jacobian": 0,
            },
        },
        "dense_motion": {
            "block_expansion": 64, "max_features": 1024, "num_blocks": blocks,
            "scale_factor": 0.25, "num_kp": 10, "num_channels": 3,
            "estimate_occlusion_map": True,
        },
        "mtia_kp_detector": {
            "MODEL": {
                "ESTIMATE_JACOBIAN": True, "TRANSFORMER_DEPTH": depth,
                "TRANSFORMER_HEADS": 8, "DIM": 192, "NUM_JOINTS": 10,
                "PATCH_SIZE": [4, 4], "IMAGE_SIZE": [size, size],
                "BASE_CHANNEL": 32, "TRANSFORMER_MLP_RATIO": 3,
            }
        },
        "raft_flow": {
            "prior_only": False, "num_kp": 10, "dim": 256, "size": size,
            "generator": {
                "num_channels": 3, "block_expansion": 64, "max_features": 512,
                "num_up_blocks": 5,
            },
            "driving_encoder": {
                "in_features": 10, "block_expansion": 32, "max_features": 512,
                "num_blocks": blocks,
            },
            "source_encoder": {
                "in_features": 13, "block_expansion": 32, "max_features": 512,
                "num_blocks": blocks,
            },
        },
    }


def train_cfg(size: int = 64, blocks: int = 3, depth: int = 1) -> dict:
    """`mtia_cfg` with the training losses switched on: perceptual pyramid
    over scales [1, 0.25] with weights [10]*5, equivariance 10 and jacobian
    equivariance 10 under the reference's transform parameters; the
    background predictor stays off (bg_start >= num_epochs)."""
    cfg = mtia_cfg(size, blocks, depth)
    cfg["train_params"].update({
        "scales": [1, 0.25],
        "loss_weights": {
            "perceptual": [10, 10, 10, 10, 10], "equivariance": 10,
            "equivariance_jacobian": 10,
        },
        "transform_params": {"sigma_affine": 0.05, "sigma_tps": 0.005, "points_tps": 5},
        "lr": 2.0e-4, "epoch_milestones": [60, 90], "clip_grad": True, "clip": 10,
    })
    return cfg


def transform_arrays(b: int, seed: int = 0):
    """numpy (theta (B, 2, 3), control_params (B, 1, 25)) of one equivariance
    transform, drawn as the reference does (sigma_affine 0.05, sigma_tps
    0.005, 5x5 control points)."""
    rng = np.random.RandomState(seed)
    theta = (np.eye(2, 3)[None] + 0.05 * rng.randn(b, 2, 3)).astype(np.float32)
    cpar = (0.005 * rng.randn(b, 1, 25)).astype(np.float32)
    return theta, cpar
