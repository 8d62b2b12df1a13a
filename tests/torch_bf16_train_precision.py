"""How far training under the bf16 policy sits from f32, module by module in
the port and in the JAX package, and for one whole step of the port against
its own f32 and f64 steps, on the setup of tests/test_torch_bf16_train.py
(64 px, 3-block hourglasses, 1-layer TokenPose, every width the flagship's).

Run from the repository root (CPU, about a minute a seed):

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_train_precision [--seeds 0 1 2 3]

It prints one JSON line per seed: for each module output, the port's bf16
distance from its f32 output over the JAX package's (the ratio of the max
and of the mean abs distances, the larger of the two); the perceptual term's
distance from JAX's in bf16 ulps; and for the whole step, each loss term's
relative distance from f64 (bf16 and f32), and over the gradient tensors the
distance of each one's largest |g| from f64's and its cosine with f64's
(median, max / min).
"""
from __future__ import annotations

import tests.conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)

import argparse
import json
import warnings

import numpy as np

from tests.test_torch_bf16_train import (
    _ratio,
    loss_term_readings,
    resnet_readings,
    step_distances,
    step_readings,
    vgg_readings,
)


def seed_readings(seed: int) -> dict:
    row = {"seed": seed}
    for name, r in vgg_readings(seed).items():
        row[name] = max(_ratio(r["port"], r["jax"]))
    resnet = resnet_readings(seed)
    row["resnet affine"] = max(_ratio(resnet["affine"]["port"], resnet["affine"]["jax"]))
    ratios = [max(_ratio(g["port"], g["jax"])) for g in resnet["param_grads"].values()]
    row["resnet param grads"] = {"median": float(np.median(ratios)), "max": max(ratios)}
    row["resnet param grads f32 vs jax / scale"] = max(
        g["f32"] / g["scale"] for g in resnet["param_grads"].values())
    terms = loss_term_readings(seed)
    port, jax_, f32 = (float(v) for v in terms["perceptual"])
    row["perceptual bf16 ulps from jax"] = abs(port - jax_) / (2.0 ** -7 * abs(jax_))
    row["perceptual bf16 vs f32 rel"] = abs(port - f32) / abs(f32)
    row["equivariance rel from jax"] = {
        k: abs(float(terms[k][0]) - float(terms[k][1])) / abs(float(terms[k][1]))
        for k in ("equivariance", "equivariance_jacobian")}
    d = step_distances(step_readings(seed))
    for name in ("f32", "bf16"):
        scale, cos = list(d[name, "scale"].values()), list(d[name, "cos"].values())
        row[f"step {name}"] = {
            "terms rel from f64": d[name, "terms"],
            "grad scale from f64": {"median": float(np.median(scale)), "max": max(scale)},
            "grad cos with f64": {"median": float(np.median(cos)), "min": min(cos)},
            "tensors": len(scale)}
    return row


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = parser.parse_args()
    warnings.simplefilter("ignore")  # the random VGG19's warning
    for seed in args.seeds:
        print(json.dumps(seed_readings(seed)), flush=True)


if __name__ == "__main__":
    main()
