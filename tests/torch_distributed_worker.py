"""One rank of the 2-rank runs of tests/test_torch_distributed.py, over gloo
on the CPU, started with torchrun's environment variables:

  RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
      python -m tests.torch_distributed_worker steps|loop <work dir>

`steps`: `BatchNorm` on this rank's half of a global batch (f32, f64, bf16),
then one f64 `Trainer.step` a case on this rank's rows of a global batch of
GLOBAL_B: the MTIA step, its two controls (no gradient average; each rank's
own BatchNorm statistics), a bg step and a TPSM step with channel dropout.
Each case's updated model is held against the one-process reference that the
test writes to <work>/ref_<case>.pt meanwhile, and against rank 0's; the
numbers go to <work>/steps_<rank>.pt.
`loop`: `loop.train` for 2 epochs of 2 steps over in-memory clips, then a
second run resumed from the first one's epoch-0 checkpoint; each rank writes
its dataset random state after each run to <work>/loop_<rank>.pt.

The helpers that make the inputs and the one-process steps are shared with
the test.
"""
from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import time
import warnings

import numpy as np
import torch

SIZE = 64
GLOBAL_B = 4
DROPOUT_P = 0.3
BN_SHAPE = (GLOBAL_B, 8, 6, 6)
BN_DTYPES = ("f32", "f64", "bf16")
REF_CASES = ("mtia", "bg", "tpsm")
# the sharded cases, each with the reference it is held against
STEP_CASES = {"mtia": "mtia", "no_grad_average": "mtia", "own_bn_stats": "mtia",
              "bg": "bg", "tpsm": "tpsm"}
REF_WAIT_S = 900


def bn_inputs(dtype: str):
    """The global BatchNorm input (N, C, H, W), cotangent, weight, bias and
    running statistics, from a numpy seed; the input in `dtype`, the rest in
    f64 for "f64" and f32 otherwise."""
    rng = np.random.RandomState(5)
    x = 1.5 * rng.randn(*BN_SHAPE) + 0.5
    g = rng.randn(*BN_SHAPE)
    c = BN_SHAPE[1]
    params = (1 + 0.1 * rng.randn(c), 0.1 * rng.randn(c), 0.1 * rng.randn(c),
              rng.uniform(0.5, 1.5, c))
    pdt = torch.float64 if dtype == "f64" else torch.float32
    xdt = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}[dtype]
    return (torch.from_numpy(x).to(xdt), torch.from_numpy(g).to(pdt),
            *(torch.from_numpy(p).to(pdt) for p in params))


def bn_run(bn, x, g):
    """Train-mode `bn` on `x`, backward of sum(y * g): (y, dx, dweight,
    dbias), `bn`'s running statistics updated."""
    x = x.clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y.to(g.dtype) * g).sum().backward()
    return y.detach(), x.grad, bn.weight.grad, bn.bias.grad


def make_bn(dtype: str, cls):
    """A `cls` BatchNorm over BN_SHAPE's channels with `bn_inputs`' weight,
    bias and running statistics."""
    _, _, weight, bias, mean, var = bn_inputs(dtype)
    bn = cls(BN_SHAPE[1]).to(weight.dtype)
    with torch.no_grad():
        bn.weight.copy_(weight)
        bn.bias.copy_(bias)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)
    return bn


def case_cfg(name: str) -> dict:
    """The 64 px / 3-block model of a reference case: MTIA, MTIA with the
    background predictor, or TPSM."""
    from tests.torch_parity import train_cfg, with_prior

    cfg = train_cfg(SIZE, blocks=3, depth=1)
    if name == "bg":
        cfg["train_params"]["bg_start"] = 0
    if name == "tpsm":
        cfg = with_prior(cfg, "tpsm")
    return cfg


def global_batch() -> dict:
    from tests.torch_parity import smooth_image

    return {"source": smooth_image(GLOBAL_B, SIZE, seed=1),
            "driving": smooth_image(GLOBAL_B, SIZE, seed=2)}


def f64_trainer(cfg: dict, mesh=None):
    """A Trainer built from seed 0 on the CPU (its equivariance and dropout
    generators seeded as always), its model in f64 and its frames too."""
    from mrfa_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOMLY INITIALIZED VGG19")
        trainer = Trainer(cfg, device="cpu", mesh=mesh)
    trainer.model.double()  # the same Parameters: the optimizer keeps them
    trainer._frames = lambda x: torch.as_tensor(x).double().permute(0, 3, 1, 2).contiguous()
    return trainer


@contextlib.contextmanager
def f64_draws():
    """The Trainer's equivariance transforms, drawn as always (for the
    global batch), then cast to f64."""
    import mrfa_tpu_torch.train.trainer as trainer_mod
    from mrfa_tpu_torch.ops.tps import RandomTransformParams

    draw = trainer_mod.random_transform_params

    def f64(*args, **kwargs):
        return RandomTransformParams(*(None if t is None else t.double()
                                       for t in draw(*args, **kwargs)))

    trainer_mod.random_transform_params = f64
    try:
        yield
    finally:
        trainer_mod.random_transform_params = draw


def run_step(trainer, name: str, batch: dict) -> dict:
    """One step of reference case `name` -> its loss terms as floats."""
    dropout = name == "tpsm"
    with f64_draws():
        out = trainer.step(batch, use_bg=name == "bg", dropout_flag=dropout,
                           dropout_p=DROPOUT_P if dropout else 0.0)
    return {k: v for k, v in out.items() if k != "gen"}


def reference(name: str) -> dict:
    """The one-process f64 step of case `name` on the global batch: its
    loss terms and the model's state after the update."""
    trainer = f64_trainer(case_cfg(name))
    terms = run_step(trainer, name, global_batch())
    return {"terms": terms, "state": trainer.model.state_dict()}


def _wait_for(path: str) -> dict:
    deadline = time.time() + REF_WAIT_S
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no {path} after {REF_WAIT_S} s")
        time.sleep(0.2)
    return torch.load(path, weights_only=True, mmap=True)


def _steps(work: str, mesh) -> dict:
    import torch.distributed as dist

    import mrfa_tpu_torch.train.trainer as trainer_mod
    from mrfa_tpu_torch.nn.norm import BatchNorm, sync_batch_norm
    from mrfa_tpu_torch.parallel.mesh import DATA_AXIS, data_shard, shard_batch, shard_rows

    from mrfa_tpu_torch.parallel.mesh import make_mesh

    group = mesh.get_group(DATA_AXIS)
    index, count = data_shard(mesh)
    out = {"bn": {}, "steps": {}, "mesh_refusals": []}
    for kwargs in ({"n_model": 3}, {"n_data": 3}):
        try:
            make_mesh(device_type="cpu", **kwargs)
        except ValueError as err:
            out["mesh_refusals"].append(str(err))
    for dtype in BN_DTYPES:
        x, g = bn_inputs(dtype)[:2]
        bn = sync_batch_norm(make_bn(dtype, BatchNorm), group)
        y, dx, dw, db = bn_run(bn, shard_rows(x, index, count), shard_rows(g, index, count))
        for grad in (dw, db):  # the global batch's parameter gradients
            dist.all_reduce(grad, group=group)
        out["bn"][dtype] = {"y": y, "dx": dx, "dweight": dw, "dbias": db,
                            "running_mean": bn.running_mean, "running_var": bn.running_var,
                            "num_batches_tracked": bn.num_batches_tracked}

    batch = shard_batch(global_batch(), mesh)
    for name, ref_name in STEP_CASES.items():
        trainer = f64_trainer(case_cfg(ref_name), mesh)
        if name == "own_bn_stats":
            sync_batch_norm(trainer.model, None)
        average = trainer_mod.average_gradients
        if name == "no_grad_average":
            trainer_mod.average_gradients = lambda params, group: None
        try:
            terms = run_step(trainer, ref_name, batch)
        finally:
            trainer_mod.average_gradients = average
        state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
        del trainer
        gc.collect()
        # the largest distance of this rank's weights and buffers from rank 0's
        spread = 0.0
        for v in state.values():
            first = v.clone()
            dist.broadcast(first, src=dist.get_global_rank(group, 0), group=group)
            spread = max(spread, float((v - first).abs().max()) if v.numel() else 0.0)
        ref = _wait_for(os.path.join(work, f"ref_{ref_name}.pt"))
        errors = {k: float((v.double() - ref["state"][k].double()).abs().max())
                  for k, v in state.items()}
        out["steps"][name] = {"terms": terms, "ref_terms": ref["terms"], "errors": errors,
                              "rank_spread": spread}
        del ref, state
        gc.collect()
    return out


class ClipDataset:
    """`FramesDataset`'s training-item contract over in-memory clips of 3 to
    10 frames: two frames of the clip, picked by the dataset's `rng`
    (sorted), which draws as many numbers as the clip's length asks for."""

    def __init__(self, n: int = 8, seed: int = 7):
        from tests.torch_parity import smooth_image

        frames = smooth_image(10, SIZE, seed=11)
        self.clips = [frames[:3 + i] for i in range(n)]
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, idx: int) -> dict:
        i, j = np.sort(self.rng.choice(len(self.clips[idx]), replace=True, size=2))
        return {"source": self.clips[idx][i], "driving": self.clips[idx][j],
                "name": f"clip{idx}"}


def loop_cfg() -> dict:
    """tests.torch_parity's loop config (celebvhq cut to 64 px: the bg
    predictor from epoch 0, a checkpoint every epoch) for a global batch of
    GLOBAL_B: 2 epochs of 2 steps over 8 clips on 2 ranks."""
    from tests.torch_parity import loop_config

    cfg = loop_config("unused")
    cfg["train_params"]["batch_size"] = GLOBAL_B
    return cfg


def _loop(work: str, mesh) -> dict:
    import torch.distributed as dist

    from mrfa_tpu_torch.train.loop import _rng_state, train

    cfg, rank = loop_cfg(), dist.get_rank()
    states = {}
    for run, checkpoint in (("a", None), ("r", os.path.join(work, "r", "ckpt"))):
        if checkpoint is not None and rank == 0:
            shutil.copytree(os.path.join(work, "a", "ckpt", "0"), os.path.join(checkpoint, "0"),
                            copy_function=os.link)  # a checkpoint is ~0.9 GB
        dist.barrier()
        data = ClipDataset()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*VGG19")
            train(cfg, checkpoint, os.path.join(work, run), data, seed=0, device="cpu",
                  mesh=mesh)
        states[run] = _rng_state(data.rng)
        dist.barrier()  # rank 0's checkpoint is written
    return states


def main(task: str, work: str) -> None:
    import torch.distributed as dist

    from mrfa_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    init_distributed("cpu")
    try:
        mesh = make_mesh(device_type="cpu")
        out = {"steps": _steps, "loop": _loop}[task](work, mesh)
        torch.save(out, os.path.join(work, f"{task}_{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
