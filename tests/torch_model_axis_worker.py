"""One rank of the 2x2 run of tests/test_torch_model_axis.py, over gloo on
the CPU, started with torchrun's environment variables:

  RANK=r WORLD_SIZE=4 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \\
      python -m tests.torch_model_axis_worker <work dir>

On a ("data", "model") = 2x2 mesh: the mesh's coordinates, groups and
refusals; the f32 eval forward of `eval_model()` on this rank's rows of the
global batch with the correlation queries split over the model group, and
the same with the row gather's blocks in the wrong order (a control); one
f64 `Trainer.step` on the rows, and the same with the group copy's backward
sum left out, everywhere and for the lookup coordinates alone (two
controls), each held against the one-process step that the
test writes to <work>/ref_step.pt meanwhile, and against rank 0's; the query
counts the lookup and its backward were called with. The numbers go to
<work>/rank<r>.pt.

The helpers that make the models, the inputs and the one-process step are
shared with the test.
"""
from __future__ import annotations

import contextlib
import gc
import os
import sys
import warnings

import numpy as np
import torch

from chip_smoke import _recorded_query_counts
from tests.torch_distributed_worker import SIZE, _wait_for, f64_trainer, global_batch, run_step

N_DATA = N_MODEL = 2
RANKS = N_DATA * N_MODEL
DEPTH = 2  # TokenPose cut to 2 layers, as tests/test_model_axis.py


def eval_cfg() -> dict:
    from tests.torch_parity import mtia_cfg

    return mtia_cfg(SIZE, blocks=3, depth=DEPTH)


def step_cfg() -> dict:
    from tests.torch_parity import train_cfg

    return train_cfg(SIZE, blocks=3, depth=DEPTH)


def eval_model():
    """The eval-mode port model of `eval_cfg()` from seed 3, its 1-D
    parameters and BatchNorm statistics moved off their initial values (as
    tests.torch_parity.perturbed moves the JAX variables)."""
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(3)
    model = MRFA(eval_cfg(), device="cpu")
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(0.1 * rng.randn(*t.shape)))
            elif t.dim() == 1 and t.is_floating_point():
                t.add_(torch.from_numpy(0.05 * rng.randn(*t.shape)).to(t.dtype))
    return model.eval()


def eval_forward(model, batch: dict) -> torch.Tensor:
    """The generated frames (B, 3, H, W) of an eval-mode forward."""
    from tests.torch_parity import nchw

    with torch.no_grad():
        return model(nchw(batch["source"]), nchw(batch["driving"]), compute_loss=False)[0]


def reference_step() -> dict:
    """The one-process f64 step on the global batch: its loss terms, the
    model's state after the update and the gradients it applied."""
    trainer = f64_trainer(step_cfg())
    terms = run_step(trainer, "mtia", global_batch())
    return {"terms": terms, "state": trainer.model.state_dict(),
            "grads": {n: p.grad for n, p in trainer.model.named_parameters()
                      if p.grad is not None}}


@contextlib.contextmanager
def patched(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _mesh(out: dict):
    import torch.distributed as dist

    from mrfa_tpu_torch.parallel.mesh import (
        DATA_AXIS, MODEL_AXIS, data_shard, make_mesh, model_shard,
    )

    out["refusals"] = []
    for kwargs in ({"n_model": 3}, {"n_data": 3, "n_model": 2}):
        try:
            make_mesh(device_type="cpu", **kwargs)
        except ValueError as err:
            out["refusals"].append(str(err))
    mesh = make_mesh(N_DATA, N_MODEL, device_type="cpu")
    out["mesh"] = {"data": data_shard(mesh), "model": model_shard(mesh),
                   "data_group": dist.get_process_group_ranks(mesh.get_group(DATA_AXIS)),
                   "model_group": dist.get_process_group_ranks(mesh.get_group(MODEL_AXIS))}
    return mesh


def _eval(out: dict, mesh, rows: dict) -> None:
    import mrfa_tpu_torch.models.raft as raft_mod
    from mrfa_tpu_torch.models.raft import shard_queries

    gather = raft_mod.gather_rows

    def reversed_blocks(x, group):  # every block gathered, in the wrong order
        per = x.shape[1]
        got = gather(x, group)
        return torch.cat([got[:, i * per:(i + 1) * per] for i in reversed(range(N_MODEL))], 1)

    model = shard_queries(eval_model(), mesh)
    seen: dict = {}
    with _recorded_query_counts(seen):
        out["forward"] = eval_forward(model, rows)
    out["eval_query_counts"] = seen
    with patched(raft_mod, "gather_rows", reversed_blocks):
        out["forward_wrong_order"] = eval_forward(model, rows)
    try:  # queries that do not split over the model group
        model.decoder._own_queries(torch.zeros(1, 3, 2))
    except ValueError as err:
        out["refusals"].append(str(err))


def _steps(out: dict, mesh, rows: dict, work: str) -> None:
    import torch.distributed as dist

    import mrfa_tpu_torch.models.raft as raft_mod

    copy = raft_mod.group_copy
    steps = {"step": copy, "no_copy_sum": lambda x, group: x,
             # the lookup coordinates' (B, nq, 2) copy alone left out
             "no_coords_sum": lambda x, group: x if x.shape[-1] == 2 else copy(x, group)}
    out["steps"] = {}
    for name, group_copy in steps.items():
        seen: dict = {}
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*RANDOMLY INITIALIZED VGG19")
            trainer = f64_trainer(step_cfg(), mesh)
        with patched(raft_mod, "group_copy", group_copy), _recorded_query_counts(seen):
            terms = run_step(trainer, "mtia", rows)
        state = {k: v.detach() for k, v in trainer.model.state_dict().items()}
        grads = {n: p.grad for n, p in trainer.model.named_parameters() if p.grad is not None}
        del trainer
        gc.collect()
        # the largest distance of this rank's weights and buffers from rank 0's
        spread = 0.0
        for v in state.values():
            first = v.clone()
            dist.broadcast(first, src=0)
            spread = max(spread, float((v - first).abs().max()) if v.numel() else 0.0)
        ref = _wait_for(os.path.join(work, "ref_step.pt"))
        errors = {k: float((v.double() - ref["state"][k].double()).abs().max())
                  for k, v in state.items()}
        # each gradient's distance from the reference's, and its largest |g|
        grad_errors = {n: (float((g - ref["grads"][n]).abs().max()),
                           float(ref["grads"][n].abs().max())) for n, g in grads.items()}
        out["steps"][name] = {"terms": terms, "ref_terms": ref["terms"], "errors": errors,
                              "grad_errors": grad_errors, "rank_spread": spread,
                              "grad_names": sorted(grads) == sorted(ref["grads"]),
                              "query_counts": seen}
        del ref, state, grads
        gc.collect()


def main(work: str) -> None:
    import torch.distributed as dist

    from mrfa_tpu_torch.parallel.mesh import init_distributed, shard_batch

    torch.set_num_threads(1)
    init_distributed("cpu")
    try:
        out: dict = {}
        mesh = _mesh(out)
        rows = shard_batch(global_batch(), mesh)
        _eval(out, mesh, rows)
        _steps(out, mesh, rows, work)
        torch.save(out, os.path.join(work, f"rank{dist.get_rank()}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
