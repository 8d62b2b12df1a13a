"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed, run through the JAX
module and its port counterpart on the CPU, and compared. The port runs
NCHW; the helpers transpose at the boundary. JAX is imported by the helpers
that use it, so that `chip_smoke.py` (no JAX on the card) can use the rest.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one thread for the module that imports this fixture: the
    tier-1 run puts six test processes on eight cores, where more threads a
    process only contend with the other processes (and the JAX compiles)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_init(module, *args, **kwargs):
    """`module.init` under jit (eager flax runs op by op, several times slower)."""
    import jax

    return jax.jit(lambda key: module.init(key, *args, **kwargs))(jax.random.PRNGKey(0))


def jax_apply(module, variables, *args, **kwargs):
    """`module.apply` under jit; the inputs are closed over as constants."""
    import jax

    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def perturbed(variables, seed: int = 0):
    """JAX variables whose constant-initialized leaves are moved off their
    initial values, so norm scales, biases and running statistics are not
    trivial: 1-D parameters get +0.05*N(0,1), running means N(0, 0.1^2),
    running variances U(0.5, 1.5). Kernels keep their random initialization
    (a larger one would blow activations up over the model's depth)."""
    import jax

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


def with_prior(cfg: dict, prior: str, blocks: int = 3) -> dict:
    """`cfg` (from `mtia_cfg` or `train_cfg`) switched to `prior`, with the
    FOMM and TPSM sections of config/vox1.yaml cut to `blocks`-block
    hourglasses (every width the flagship's); under TPSM the jacobian
    equivariance is off (vox1.yaml: 0 for tpsm) and the channel-dropout
    schedule is vox1.yaml's."""
    cfg["train_params"]["prior_model"] = prior
    cfg["fomm_kp_detector"] = {
        "block_expansion": 32, "num_kp": 10, "num_channels": 3, "max_features": 1024,
        "num_blocks": blocks, "temperature": 0.1, "scale_factor": 0.25,
        "estimate_jacobian": True, "estimate_occlusion": False,
    }
    cfg["tpsm_kp_detector"] = {"num_tps": 10}
    cfg["tpsm_dense_motion"] = {
        "block_expansion": 64, "max_features": 1024, "num_blocks": blocks,
        "scale_factor": 0.25, "num_tps": 10, "num_channels": 3,
    }
    if prior == "tpsm":
        cfg["train_params"]["loss_weights"]["equivariance_jacobian"] = 0
        cfg["train_params"].update(dropout_epoch=35, dropout_maxp=0.3, dropout_startp=0.1,
                                   dropout_inc_epoch=10)
    return cfg


def transform_arrays(b: int, seed: int = 0):
    """numpy (theta (B, 2, 3), control_params (B, 1, 25)) of one equivariance
    transform, drawn as the reference does (sigma_affine 0.05, sigma_tps
    0.005, 5x5 control points)."""
    rng = np.random.RandomState(seed)
    theta = (np.eye(2, 3)[None] + 0.05 * rng.randn(b, 2, 3)).astype(np.float32)
    cpar = (0.005 * rng.randn(b, 1, 25)).astype(np.float32)
    return theta, cpar


def loop_config(root: str, size: int = 64) -> dict:
    """config/celebvhq.yaml cut to 64 px, 3-block hourglasses and a 1-layer
    TokenPose; background predictor from epoch 0; 2 epochs of B=2, a
    checkpoint each."""
    cfg = train_cfg(size, blocks=3, depth=1)
    cfg["train_params"].update(num_epochs=2, bg_start=0, batch_size=2, num_repeats=1,
                               checkpoint_freq=1, num_workers=1)
    cfg["dataset_params"] = {
        "root_dir": root, "frame_shape": [size, size, 3], "id_sampling": False,
        "augmentation_params": {"flip_param": {"horizontal_flip": True, "time_flip": True},
                                "jitter_param": {"brightness": 0.1, "contrast": 0.1,
                                                 "saturation": 0.1, "hue": 0.1}},
    }
    cfg["visualizer_params"] = {"draw_border": True, "colormap": "gist_rainbow"}
    return cfg


def write_png_videos(root, n_train=4, n_test=2, frames=5, size=64, seed=0):
    """train/ and test/ splits of smooth frame-directory videos, as PNG."""
    from mrfa_tpu_torch.utils.video import save_image

    for split, n in (("train", n_train), ("test", n_test)):
        for v in range(n):
            d = os.path.join(root, split, f"id{v:02d}#{v}")
            os.makedirs(d)
            clip = smooth_image(frames, size, seed=seed + 100 * v + (split == "test"))
            for t, f in enumerate(clip):
                save_image(os.path.join(d, f"{t:03d}.png"), (255 * f).astype(np.uint8))


VGG_LAYERS = {  # torchvision's vgg cfgs "E" (vgg19) and "D" (vgg16): channels, "M" a pool
    19: [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
         512, 512, 512, 512],
    16: [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512],
}


def torchvision_backbone_files(root, seed: int = 0) -> dict:
    """Random torchvision-shaped vgg19 and vgg16 `features` state dicts
    (every conv at its real channel counts) and lpips `lin` weights, saved
    under `root`: {"vgg19" | "vgg16" | "lpips_lin": path}."""
    gen = torch.Generator().manual_seed(seed)
    paths = {}
    for depth in (19, 16):
        sd, cin, idx = {}, 3, 0
        for v in VGG_LAYERS[depth]:
            if v == "M":
                idx += 1
                continue
            sd[f"features.{idx}.weight"] = 0.01 * torch.randn(v, cin, 3, 3, generator=gen)
            sd[f"features.{idx}.bias"] = 0.01 * torch.randn(v, generator=gen)
            cin, idx = v, idx + 2
        paths[f"vgg{depth}"] = os.path.join(root, f"vgg{depth}.pth")
        torch.save(sd, paths[f"vgg{depth}"])
    paths["lpips_lin"] = os.path.join(root, "lpips_lin.pth")
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen)
                for i, c in enumerate((64, 128, 256, 512, 512))}, paths["lpips_lin"])
    return paths


def reference_pth(state, path, drop=(), extra=None):
    """Write a reference-style checkpoint of a port state dict to `path`:
    keys under `module.`, VGG19 convolutions under their slice, the
    anti-alias buffers and the VGG19 mean/std beside the weights, and
    optimizer entries. `drop` leaves keys out, `extra` adds entries."""
    from mrfa_tpu_torch.nn.vgg import _SLICE_CONVS

    slice_of = {idx: k + 1 for k, convs in enumerate(_SLICE_CONVS) for idx, _ in convs}
    sd = {}
    for key, v in state.items():
        if key in drop:
            continue
        if key.startswith("vgg.features_"):
            idx, rest = key[len("vgg.features_"):].split(".", 1)
            key = f"vgg.slice{slice_of[int(idx)]}.{idx}.{rest}"
        sd["module." + key] = v.detach().cpu().clone()
    sd["module.pyramid.downs.0_25.weight"] = torch.ones(3, 1, 13, 13)
    sd["module.down.weight"] = torch.ones(3, 1, 13, 13)
    sd["module.vgg.mean"] = torch.zeros(1, 3, 1, 1)
    sd["module.vgg.std"] = torch.ones(1, 3, 1, 1)
    sd.update(extra or {})
    torch.save({"model": sd, "optimizer": {"state": {}}, "epoch": 3}, path)


def cli_config(size: int = 64) -> dict:
    """A whole run config (the sections both packages' CLIs read) around
    `train_cfg(size)`: a dataset under ./data, the eval and visualizer
    sections of config/vox1.yaml."""
    cfg = train_cfg(size, blocks=3, depth=1)
    cfg["dataset_params"] = {"root_dir": "data", "frame_shape": [size, size, 3],
                             "id_sampling": False}
    cfg["reconstruction_params"] = {"num_videos": None, "format": ".mp4"}
    cfg["animate_params"] = {"num_pairs": 1, "format": ".mp4", "normalization_params": {
        "adapt_movement_scale": False, "use_relative_movement": True,
        "use_relative_jacobian": True}}
    cfg["visualizer_params"] = {"draw_border": True, "colormap": "gist_rainbow"}
    return cfg


def write_cli_inputs(root, cfg=None, seed: int = 0):
    """A config yaml of `cfg` (default `cli_config()`, 64 px) and a
    reference-format `.pth` of a port model built on the CPU from `seed`,
    both under `root`: (config path, .pth path, the model's state dict)."""
    from mrfa_tpu_torch.config import model_config
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = cli_config() if cfg is None else cfg
    config_path = os.path.join(root, "model.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(cfg, f)
    torch.manual_seed(seed)
    state = MRFA(model_config(cfg), device="cpu").state_dict()
    pth_path = os.path.join(root, "model.pth")
    reference_pth(state, pth_path)
    return config_path, pth_path, state


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(args, work, ranks: int, cwd=REPO):
    """`ranks` processes of `python args` with torchrun's environment (one
    torch thread each), their output in work/rank<r>.log."""
    port = _free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
        log = open(os.path.join(work, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, *args], cwd=cwd, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, work, timeout: float):
    """Wait up to `timeout` s for each of `spawn_ranks`' processes; every
    rank's output, failing if one failed."""
    codes = []
    try:
        for proc, log in procs:
            codes.append(proc.wait(timeout=timeout))
            log.close()
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    logs = [open(os.path.join(work, f"rank{r}.log")).read() for r in range(len(procs))]
    assert codes == [0] * len(procs), "\n".join(f"rank {r}: {log[-3000:]}" for r, log in
                                                 enumerate(logs))
    return logs
