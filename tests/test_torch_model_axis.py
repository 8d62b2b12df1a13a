"""The port's 'model' mesh axis on the CPU: 4 processes over gloo on a
("data", "model") = 2x2 mesh, as tests/test_model_axis.py holds the JAX
package's (the 64 px / 3-block MTIA model, TokenPose cut to 2 layers,
B=4).

- `make_mesh(2, 2)`: each rank's data and model coordinates and groups in
  the JAX mesh's order, and the shapes that do not tile the world refused.
- The eval forward with each sample's correlation queries split over the
  model group (`shard_queries`), each data rank on its 2 rows, against the
  JAX package's eval forward and the port's one-process forward on the 4.
- One f64 `Trainer.step` on the mesh against the one-process f64 step on
  the global batch: the loss terms, the applied gradients, every parameter
  and buffer after the update, all four ranks' weights bit-equal.
- The lookup and its backward on each rank at half of each sample's queries.
- Three controls that must miss: the row gather's blocks in the wrong order
  (the forward), the group copy's backward sum left out (the gradients of
  everything upstream of the correlation volume), and left out for the
  lookup coordinates alone (the flow's cotangent through them).

The ranks run tests/torch_model_axis_worker.py; the references are computed
here while they run (the JAX forward is one eval-mode `apply` compile).
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import QUERIES
from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mrfa_tpu.utils.torch_convert import convert_state_dict
from tests import torch_model_axis_worker as worker
from tests.torch_distributed_worker import GLOBAL_B, global_batch
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    one_torch_thread, spawn_ranks, wait_ranks,
)

RUN_TIMEOUT_S = 600
# f32 frames in [0, 1]: the port against the JAX package (tests/test_torch_frame.py),
# and the sharded forward against the one-process forward (batches of 2 rows and
# of 4 round differently in the CPU's convolutions; 1.5e-6 seen in
# tests/test_torch_distributed.py's split server)
JAX_ATOL = 1e-4
ONE_PROCESS_ATOL = 1e-5
# the f64 step as tests/test_torch_distributed.py holds the data axis's: loss
# terms, and the weights after Adam's first update (which multiplies a
# gradient's difference by up to lr / 4e-8 where |g| is near 1e-8); each
# applied gradient within GRAD_TOL of its tensor's largest |g| (6e-14 seen),
# plus GRAD_ATOL for the gradients that are 0 in exact arithmetic (the conv
# biases BatchNorm follows: from 1e-20 to 3.2e-15, and as far apart)
TERM_TOL = 1e-12
STEP_TOL = 1e-9
GRAD_TOL = 1e-10
GRAD_ATOL = 1e-13
# the controls miss by more than these: the frames (in [0, 1]) of the wrong
# gather order, by a hundred times ONE_PROCESS_ATOL (2.3e-3 seen); for the
# missing sum, every gradient upstream of the volume, over its largest |g|
# (half of each is missing: 0.4997-0.4999 seen); for the coordinates' sum
# alone, the worst gradient over its largest |g| (3e-4 seen)
WRONG_ORDER_MARGIN = 1e-3
NO_SUM_MARGIN = 1e-2
NO_COORDS_SUM_MARGIN = 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' outputs and the references computed meanwhile: (rank
    outputs, {"jax": JAX frames, "port": one-process frames})."""
    work = str(tmp_path_factory.mktemp("model_axis"))
    procs = spawn_ranks(["-m", "tests.torch_model_axis_worker", work], work, worker.RANKS)
    try:
        path = os.path.join(work, "ref_step.pt")
        torch.save(worker.reference_step(), path + ".tmp")
        os.replace(path + ".tmp", path)
        batch = global_batch()
        model = worker.eval_model()
        refs = {"port": worker.eval_forward(model, batch).numpy()}
        variables = convert_state_dict(model.state_dict())
        del model
        jmodel = JMRFA(worker.eval_cfg())
        gen = jax.jit(lambda v, s, d: jmodel.apply(v, s, d, train=False)[0])(
            variables, jnp.asarray(batch["source"]), jnp.asarray(batch["driving"]))
        refs["jax"] = np.asarray(gen).transpose(0, 3, 1, 2)
        wait_ranks(procs, work, RUN_TIMEOUT_S)
        outs = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
                for r in range(worker.RANKS)]
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(work, ignore_errors=True)
    return outs, refs


def _rows(out):
    """The global batch's rows of a rank's data coordinate."""
    index, count = out["mesh"]["data"]
    per = GLOBAL_B // count
    return slice(index * per, (index + 1) * per)


def test_mesh_coordinates_are_the_jax_mesh_order(ranks):
    outs, _ = ranks
    jmesh = jax_make_mesh(worker.N_DATA, worker.N_MODEL, devices=jax.devices()[:worker.RANKS])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)  # [data, model] -> device id
    assert ids.shape == (worker.N_DATA, worker.N_MODEL)
    for rank, out in enumerate(outs):
        (d,), (m,) = np.nonzero(ids == rank)
        assert out["mesh"]["data"] == (d, worker.N_DATA)
        assert out["mesh"]["model"] == (m, worker.N_MODEL)
        assert out["mesh"]["data_group"] == sorted(int(i) for i in ids[:, m])
        assert out["mesh"]["model_group"] == sorted(int(i) for i in ids[d, :])


def test_shapes_that_do_not_tile_are_refused(ranks):
    outs, _ = ranks
    for out in outs:
        assert out["refusals"] == ["4 ranks do not split over n_model=3",
                                   "a 3x2 mesh needs a world of 6, not 4",
                                   "3 queries do not split over 2 model ranks"]


@pytest.mark.parametrize("ref", ["jax", "port"])
def test_sharded_eval_forward_is_the_one_device_forward(ranks, ref):
    outs, refs = ranks
    tol = JAX_ATOL if ref == "jax" else ONE_PROCESS_ATOL
    for rank, out in enumerate(outs):
        got, want = out["forward"].numpy(), refs[ref][_rows(out)]
        assert got.shape == want.shape == (GLOBAL_B // worker.N_DATA, 3, 64, 64)
        err = float(np.abs(got - want).max())
        assert err <= tol, (rank, ref, err)
    for out in outs:  # the model ranks of a data coordinate hold the same frames
        twin = outs[out["mesh"]["model_group"][0]]
        np.testing.assert_array_equal(out["forward"].numpy(), twin["forward"].numpy())


def test_lookups_run_on_half_of_the_queries(ranks):
    outs, _ = ranks
    rows = GLOBAL_B // worker.N_DATA
    want = [rows * nq // worker.N_MODEL for nq in QUERIES[64]]
    for out in outs:
        assert out["eval_query_counts"] == {"corr_lookup": want}
        assert out["steps"]["step"]["query_counts"] == {"corr_lookup": want,
                                                        "corr_lookup_bwd": want[::-1]}


def test_sharded_step_is_the_one_process_step(ranks):
    outs, _ = ranks
    for rank, out in enumerate(outs):
        got = out["steps"]["step"]
        assert got["grad_names"], rank
        assert set(got["terms"]) == set(got["ref_terms"])
        for k, v in got["terms"].items():
            assert abs(v - got["ref_terms"][k]) <= TERM_TOL * max(1.0, abs(v)), (rank, k)
        for n, (err, scale) in got["grad_errors"].items():
            assert err <= GRAD_TOL * scale + GRAD_ATOL, (rank, n, err, scale)
        worst = max(got["errors"], key=got["errors"].get)
        assert got["errors"][worst] <= STEP_TOL, (rank, worst, got["errors"][worst])
    # the compared state holds the BatchNorm buffers beside the parameters
    assert any(k.endswith("running_var") for k in outs[0]["steps"]["step"]["errors"])


def test_ranks_end_bit_equal(ranks):
    outs, _ = ranks
    assert [out["steps"]["step"]["rank_spread"] for out in outs] == [0.0] * worker.RANKS


@pytest.mark.parametrize("control", ["wrong_gather_order", "no_copy_sum", "no_coords_sum"])
def test_broken_query_sharding_misses(ranks, control):
    outs, refs = ranks
    for rank, out in enumerate(outs):
        if control == "wrong_gather_order":
            err = float(np.abs(out["forward_wrong_order"].numpy() - refs["port"][_rows(out)]).max())
            assert err > WRONG_ORDER_MARGIN, (rank, err)
            continue
        got = out["steps"][control]
        # the forward is untouched
        for k, v in got["terms"].items():
            assert abs(v - got["ref_terms"][k]) <= TERM_TOL * max(1.0, abs(v)), (rank, k)
        if control == "no_coords_sum":  # the flow's cotangent stays partial
            worst = max(err / scale for err, scale in got["grad_errors"].values()
                        if scale > GRAD_ATOL)
            assert worst > NO_COORDS_SUM_MARGIN, (rank, worst)
            continue
        # the features' cotangents stay partial, so every gradient upstream
        # of the correlation volume misses
        upstream = {n: err / scale for n, (err, scale) in got["grad_errors"].items()
                    if scale > GRAD_ATOL and n.startswith(
                        ("decoder.kp.", "decoder.kp_head", "decoder.kp_img",
                         "decoder.pos_embedding"))}
        assert len(upstream) > 10 and min(upstream.values()) > NO_SUM_MARGIN, (
            rank, len(upstream), min(upstream.values()))
