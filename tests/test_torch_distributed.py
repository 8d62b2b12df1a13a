"""The port's multi-device layer on the CPU: 2 processes over gloo, as
tests/test_multihost.py holds the JAX package's.

- `BatchNorm` over 2 ranks, half of the global batch each, against
  `nn.BatchNorm2d` and the JAX `BatchNorm` on the global batch in training
  mode: output, input and parameter gradients, running statistics (f32, f64,
  and a bf16 input).
- `BatchLoader`'s shards against the JAX `BatchLoader._indices`.
- One f64 `Trainer.step` on 2 ranks x 2 rows against the one-process step on
  the global 4 rows (MTIA, a bg step, a TPSM step with channel dropout):
  every loss term, every parameter and buffer after the update, the same
  weights on both ranks; and two controls that break the synchronization
  (no gradient average; each rank's own BatchNorm statistics), which must
  miss the one-process step by a wide margin.
- `loop.train` on 2 ranks: rank 0 writes the log and the checkpoints, a
  checkpoint holds both ranks' dataset random states, and a run resumed from
  epoch 0 ends bit-equal to the straight run.
- `python -m mrfa_tpu_torch.cli.run --distributed --device cpu` in 2
  processes with torchrun's environment variables.
- `AnimationServer(devices=["cpu", "cpu"])` against the one-device server.

The ranks run tests/torch_distributed_worker.py; the one-process f64
references are computed here while they run.
"""
import glob
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from mrfa_tpu.data.dataset import BatchLoader as JBatchLoader
from mrfa_tpu.nn.norm import BatchNorm as JBatchNorm
from mrfa_tpu_torch.data.dataset import BatchLoader
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.serving import AnimationServer
from tests import torch_distributed_worker as worker
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    loop_config, mtia_cfg, one_torch_thread, smooth_image, spawn_ranks, wait_ranks,
    write_png_videos,
)

RANKS = 2
RUN_TIMEOUT_S = 900
# the 2-rank f64 step against the one-process f64 step on the global batch:
# the two sum the same products in other orders (the batch statistics over
# two halves, the gradient as the mean of two halves' means), ~1e-14 apart
# in the loss terms and the gradients. Adam's first step moves a weight by
# lr * g / (|g| + 1e-8), which multiplies a gradient's difference by up to
# lr / 4e-8 = 5e3 where |g| is near 1e-8, so the weights agree to ~1e-10;
# a broken synchronization moves them by about the learning rate (2e-4)
TERM_TOL = 1e-12
STEP_TOL = 1e-9
CONTROL_MARGIN = 1e-6
BN_TOL = {"f32": 1e-5, "f64": 1e-12}
# f32 frames in [0, 1] from a batch of 2 streams against a batch of 4: the
# rounding of the batch-size-dependent convolution kernels, carried through
# six refinement iterations (1.5e-6 seen)
SERVER_TOL = 1e-5


def _bn_references(dtype: str) -> dict:
    """`nn.BatchNorm2d` and the JAX BatchNorm in training mode on the global
    batch: output, input and parameter gradients, running statistics."""
    x, g, weight, bias, mean, var = worker.bn_inputs(dtype)
    bn = worker.make_bn(dtype, nn.BatchNorm2d)
    y, dx, dw, db = worker.bn_run(bn, x, g)
    torch_ref = {"y": y, "dx": dx, "dweight": dw, "dbias": db,
                 "running_mean": bn.running_mean, "running_var": bn.running_var}

    jdt = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}[dtype]
    pdt = jnp.float64 if dtype == "f64" else jnp.float32
    with jax.enable_x64(dtype == "f64"):
        module = JBatchNorm(features=x.shape[1])
        params = {"scale": jnp.asarray(weight.numpy(), pdt), "bias": jnp.asarray(bias.numpy(), pdt)}
        stats = {"mean": jnp.asarray(mean.numpy(), pdt), "var": jnp.asarray(var.numpy(), pdt)}
        xj = jnp.asarray(x.to(weight.dtype).numpy().transpose(0, 2, 3, 1), jdt)
        gj = jnp.asarray(g.numpy().transpose(0, 2, 3, 1), pdt)

        def loss(p, xx):
            y, upd = module.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                  mutable=["batch_stats"])
            return (y.astype(pdt) * gj).sum(), (y, upd["batch_stats"])

        (_, (jy, jstats)), (jdp, jdx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, xj)
        nchw = lambda a: np.asarray(a, np.float64).transpose(0, 3, 1, 2)  # noqa: E731
        jax_ref = {"y": nchw(jy), "dx": nchw(jdx), "dweight": np.asarray(jdp["scale"]),
                   "dbias": np.asarray(jdp["bias"]), "running_mean": np.asarray(jstats["mean"]),
                   "running_var": np.asarray(jstats["var"])}
    return {"torch": torch_ref, "jax": jax_ref}


@pytest.fixture(scope="module")
def loop_ranks(tmp_path_factory):
    """The ranks' `loop` run, started before the `steps` run so that the two
    overlap: (its directory, its processes). Its ~2.7 GB of checkpoints go
    afterwards."""
    work = str(tmp_path_factory.mktemp("loop"))
    procs = spawn_ranks(["-m", "tests.torch_distributed_worker", "loop", work], work, RANKS)
    try:
        yield work, procs
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def steps(tmp_path_factory, loop_ranks):
    """The ranks' `steps` run, with the BatchNorm and one-process step
    references computed here meanwhile: (rank outputs, BatchNorm refs)."""
    work = str(tmp_path_factory.mktemp("steps"))
    procs = spawn_ranks(["-m", "tests.torch_distributed_worker", "steps", work], work,
                        RANKS)
    try:
        bn_refs = {dtype: _bn_references(dtype) for dtype in worker.BN_DTYPES}
        for name in worker.REF_CASES:
            path = os.path.join(work, f"ref_{name}.pt")
            torch.save(worker.reference(name), path + ".tmp")
            os.replace(path + ".tmp", path)
    finally:
        wait_ranks(procs, work, RUN_TIMEOUT_S)
    outs = [torch.load(os.path.join(work, f"steps_{r}.pt"), weights_only=True)
            for r in range(RANKS)]
    for name in worker.REF_CASES:
        os.remove(os.path.join(work, f"ref_{name}.pt"))
    return outs, bn_refs


def _as_np(t):
    return t.detach().double().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)


@pytest.mark.parametrize("dtype", worker.BN_DTYPES)
def test_batch_norm_over_two_ranks_is_the_global_batch_norm(steps, dtype):
    outs, bn_refs = steps
    got = {k: (torch.cat([o["bn"][dtype][k] for o in outs]) if k in ("y", "dx")
               else outs[0]["bn"][dtype][k]) for k in bn_refs[dtype]["torch"]}
    for k in ("running_mean", "running_var", "dweight", "dbias"):
        np.testing.assert_array_equal(_as_np(outs[1]["bn"][dtype][k]), _as_np(got[k]), err_msg=k)
    assert int(outs[0]["bn"][dtype]["num_batches_tracked"]) == 1
    for ref_name, ref in bn_refs[dtype].items():
        for k, want in ref.items():
            g, w = _as_np(got[k]), _as_np(want)
            if dtype == "bf16" and k in ("y", "dx"):
                # bf16 tensors of f32 expressions summed in other orders
                # (dx subtracts batch means of terms as large as the
                # largest |dx|): within one bf16 ulp of the largest value
                tol = 2.0 ** -7 * np.abs(w).max()
                assert np.abs(g - w).max() <= tol, (ref_name, k, np.abs(g - w).max())
            else:
                tol = BN_TOL["f32" if dtype == "bf16" else dtype]
                np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{ref_name} {k}")


@pytest.mark.parametrize("case", ["mtia", "bg", "tpsm"])
def test_two_rank_step_is_the_one_process_step(steps, case):
    outs, _ = steps
    for rank, out in enumerate(outs):
        got = out["steps"][case]
        assert set(got["terms"]) == set(got["ref_terms"]), case
        if case == "bg":
            assert "bg" in got["terms"]
        for k, v in got["terms"].items():
            assert abs(v - got["ref_terms"][k]) <= TERM_TOL * max(1.0, abs(v)), (rank, k)
        worst = max(got["errors"], key=got["errors"].get)
        assert got["errors"][worst] <= STEP_TOL, (rank, worst, got["errors"][worst])
        assert got["rank_spread"] == 0.0, rank
    # the compared state holds the BatchNorm buffers beside the parameters
    assert any(k.endswith("running_var") for k in outs[0]["steps"][case]["errors"])


@pytest.mark.parametrize("control", ["no_grad_average", "own_bn_stats"])
def test_broken_synchronization_misses_the_one_process_step(steps, control):
    outs, _ = steps
    errors = outs[0]["steps"][control]["errors"]
    params = [v for k, v in errors.items() if "running" not in k]
    assert max(params) > CONTROL_MARGIN, max(params)
    if control == "own_bn_stats":  # the forward differs: loss terms and running statistics
        got = outs[0]["steps"][control]
        assert max(abs(v - got["ref_terms"][k]) for k, v in got["terms"].items()) > CONTROL_MARGIN
        assert max(v for k, v in errors.items() if "running" in k) > CONTROL_MARGIN
    else:  # each rank steps on its own gradient: the ranks part
        assert outs[1]["steps"][control]["rank_spread"] > CONTROL_MARGIN


def test_mesh_is_the_world_over_data(steps):
    outs, _ = steps
    for out in outs:
        assert out["mesh_refusals"] == [
            "2 ranks do not split over n_model=3",
            "a 3x1 mesh needs a world of 3, not 2"]


def test_mesh_and_init_need_a_world(monkeypatch):
    from mrfa_tpu_torch.parallel.mesh import TORCHRUN_ENV, init_distributed, make_mesh

    with pytest.raises(RuntimeError, match="initialized process group"):
        make_mesh(device_type="cpu")
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        init_distributed("cpu")


def test_one_rank_mesh_takes_the_plain_step(tmp_path, monkeypatch):
    """A world of one rank: the mesh Trainer syncs, shards, replicates and
    averages nothing, and its step is bit-equal to the plain Trainer's."""
    import torch.distributed as dist

    import mrfa_tpu_torch.train.trainer as trainer_mod
    from mrfa_tpu_torch.nn.norm import BatchNorm
    from mrfa_tpu_torch.parallel.mesh import make_mesh

    cfg = worker.case_cfg("mtia")
    batch = {"source": smooth_image(2, 64, seed=1), "driving": smooth_image(2, 64, seed=2)}

    def stepped(mesh):
        torch.manual_seed(0)
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*RANDOMLY INITIALIZED VGG19")
            trainer = trainer_mod.Trainer(cfg, device="cpu", mesh=mesh)
        return trainer, trainer.step(batch)

    plain, want = stepped(None)
    for name in ("replicated", "average_gradients", "average_scalars", "sync_batch_norm",
                 "shard_queries"):
        def refuse(*args, name=name, **kwargs):
            raise AssertionError(f"{name} in a one-rank world")
        monkeypatch.setattr(trainer_mod, name, refuse)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        meshed, got = stepped(make_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    assert meshed.batch_shard == (0, 1) and meshed.group is None
    assert all(m.process_group is None for m in meshed.model.modules()
               if isinstance(m, BatchNorm))
    _equal_trees(got, want)
    _equal_trees(meshed.model.state_dict(), plain.model.state_dict())


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_batch_loader_shards_are_jax_shards(num_shards):
    items = _Items(23)
    for epoch in (0, 4):
        shards = []
        for index in range(num_shards):
            kw = dict(batch_size=2, shuffle=True, seed=5, shard_index=index,
                      num_shards=num_shards)
            got = BatchLoader(items, **kw)._indices(epoch)
            np.testing.assert_array_equal(got, JBatchLoader(items, **kw)._indices(epoch))
            shards.append(got)
        assert sorted(np.concatenate(shards).tolist()) == list(range(23))


@pytest.fixture(scope="module")
def loop_run(loop_ranks):
    """The ranks' `loop` run, finished: (its directory, each rank's output,
    each rank's dataset states)."""
    work, procs = loop_ranks
    logs = wait_ranks(procs, work, RUN_TIMEOUT_S)
    states = [torch.load(os.path.join(work, f"loop_{r}.pt"), weights_only=True)
              for r in range(RANKS)]
    return work, logs, states


def _equal_trees(a, b, path=""):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _checkpoint(work, run, epoch):
    return torch.load(os.path.join(work, run, "ckpt", str(epoch), "state.pt"),
                      map_location="cpu", weights_only=True, mmap=True)


def test_loop_rank_zero_writes_the_log_and_checkpoints(loop_run):
    work, logs, _ = loop_run
    assert sorted(os.listdir(os.path.join(work, "a", "ckpt"))) == ["0", "1"]
    lines = open(os.path.join(work, "a", "log.txt")).read().splitlines()
    assert [line.split(")")[0] for line in lines] == ["00000000", "00000001"]
    assert sorted(os.listdir(os.path.join(work, "a", "train-vis"))) == [
        "00000000-rec.png", "00000001-rec.png"]
    # the epoch line counts the global batch: 2 steps x 4 samples
    assert [line.split(" in ")[0] for line in logs[0].splitlines()
            if line.startswith("epoch ")] == ["epoch 0: 2 steps", "epoch 1: 2 steps",
                                              "epoch 1: 2 steps"]
    assert "epoch " not in logs[1]


def test_loop_checkpoint_holds_each_rank_data_state(loop_run):
    work, _, states = loop_run
    saved = _checkpoint(work, "a", 1)["data_rng"]
    assert isinstance(saved, list) and len(saved) == RANKS
    for rank in range(RANKS):
        _equal_trees(saved[rank], states[rank]["a"])
    # each rank drew its own items, from clips of other lengths
    assert (saved[0]["pos"] != saved[1]["pos"]
            or not torch.equal(saved[0]["keys"], saved[1]["keys"]))


def test_loop_resume_on_two_ranks_is_bit_equal(loop_run):
    work, _, states = loop_run
    straight, resumed = _checkpoint(work, "a", 1), _checkpoint(work, "r", 1)
    assert straight["trainer"]["step"] == resumed["trainer"]["step"] == 4
    _equal_trees(resumed["trainer"], straight["trainer"])
    _equal_trees(resumed["data_rng"], straight["data_rng"])
    for rank in range(RANKS):
        _equal_trees(states[rank]["r"], states[rank]["a"])
    lines = open(os.path.join(work, "a", "log.txt")).read().splitlines()
    assert open(os.path.join(work, "r", "log.txt")).read().splitlines() == lines[1:]


def test_cli_distributed_trains_on_two_processes(tmp_path):
    root = str(tmp_path / "data")
    write_png_videos(root, n_train=4, n_test=1, frames=4)
    cfg = loop_config(root)
    cfg["train_params"].update(num_epochs=1, batch_size=2)
    config = str(tmp_path / "tiny.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    try:
        procs = spawn_ranks(["-m", "mrfa_tpu_torch.cli.run", "--distributed", "--device", "cpu",
                             "--mode", "train", "--max_steps_per_epoch", "1", "--config", config,
                             "--log_dir", str(tmp_path / "log")], str(tmp_path), RANKS)
        logs = wait_ranks(procs, str(tmp_path), RUN_TIMEOUT_S)
        (log_dir,) = glob.glob(str(tmp_path / "log" / "tiny *"))
        assert os.path.exists(os.path.join(log_dir, "tiny.yaml"))
        assert len(open(os.path.join(log_dir, "log.txt")).read().splitlines()) == 1
        assert "Training... (device: cpu, 2 ranks)" in logs[0]
        assert "epoch 0: 1 steps" in logs[0] and "epoch " not in logs[1]
        assert "Training" not in logs[1]
        saved = torch.load(os.path.join(log_dir, "ckpt", "0", "state.pt"), map_location="cpu",
                           weights_only=True, mmap=True)
        assert len(saved["data_rng"]) == RANKS and saved["trainer"]["step"] == 1
    finally:
        shutil.rmtree(tmp_path / "log", ignore_errors=True)


@pytest.fixture(scope="module")
def server_case():
    cfg = mtia_cfg(64, blocks=3, depth=1)
    torch.manual_seed(0)
    weights = MRFA(cfg, device="cpu").state_dict()
    sources, first = smooth_image(4, 64, seed=1), smooth_image(4, 64, seed=2)
    chunk = np.stack([smooth_image(4, 64, seed=3), smooth_image(4, 64, seed=4)])  # K=2, S=4
    return cfg, weights, sources, first, chunk


def test_split_server_is_the_one_device_server(server_case):
    """The 4 streams split over 2 devices: bit-equal to one-device servers
    on each half, and within SERVER_TOL of one server on all 4 (its
    convolutions take a batch of 4, not 2, and the CPU's kernels for the two
    batch sizes round differently)."""
    cfg, weights, sources, first, chunk = server_case
    split = AnimationServer(MRFA(cfg, device="cpu"), weights, devices=["cpu", "cpu"])
    assert len(split.replicas) == 2 and split.replicas[1].model is not split.model
    state = split.open_streams(sources, first, adapt_movement_scale=True)
    assert len(state) == 2 and state[0].source.shape[0] == 2
    got = {"serve": split.serve(state, chunk[1]), "serve_chunk": split.serve_chunk(state, chunk)}
    assert got["serve"].shape == (4, 64, 64, 3) and got["serve_chunk"].shape == (2, 4, 64, 64, 3)
    one = AnimationServer(MRFA(cfg, device="cpu"), weights, device="cpu")
    halves = {"serve": [], "serve_chunk": [], "scale": []}
    for rows in (slice(0, 2), slice(2, 4)):
        st = one.open_streams(sources[rows], first[rows], adapt_movement_scale=True)
        halves["scale"].append(st.scale)
        halves["serve"].append(one.serve(st, chunk[1][rows]))
        halves["serve_chunk"].append(one.serve_chunk(st, chunk[:, rows]))
    torch.testing.assert_close(torch.cat([s.scale for s in state]), torch.cat(halves["scale"]),
                               rtol=0, atol=0)
    for name, dim in (("serve", 0), ("serve_chunk", 1)):
        torch.testing.assert_close(got[name], torch.cat(halves[name], dim=dim), rtol=0, atol=0)
    whole = one.open_streams(sources, first, adapt_movement_scale=True)
    torch.testing.assert_close(torch.cat([s.scale for s in state]), whole.scale,
                               rtol=0, atol=1e-6)
    for name, want in (("serve", one.serve(whole, chunk[1])),
                       ("serve_chunk", one.serve_chunk(whole, chunk))):
        torch.testing.assert_close(got[name], want, rtol=0, atol=SERVER_TOL)


def test_split_server_refuses_streams_that_do_not_divide(server_case):
    cfg, weights, sources, first, _ = server_case
    split = AnimationServer(MRFA(cfg, device="cpu"), weights, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 streams do not split over 2 devices"):
        split.open_streams(sources[:3], first[:3])
    with pytest.raises(ValueError, match="not both"):
        AnimationServer(MRFA(cfg, device="cpu"), weights, device="cpu", devices=["cpu"])
