"""The TPSM prior on the port's serving path, on the CPU: the TPS fit
against float64 LAPACK (values, and gradients by `gradcheck`), the TPSM
`serve_chunk` against the benchmark's plain reference from the same
weights, and the frame step's stages and `tps.fits` counter under each
prior. No JAX."""
import numpy as np
import pytest
import torch

from mrfa_tpu_torch.ops.tps import tps_fit
from mrfa_tpu_torch.utils import profiling
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    mtia_cfg, one_torch_thread, smooth_image, with_prior,
)

EPS32 = float(torch.finfo(torch.float32).eps)


def _keypoints(b, g, seed, collinear=0.0, dtype=torch.float64):
    """(B, G, 5, 2) control points spread over [-0.7, 0.7]^2 and their
    targets a small motion away. `collinear` > 0 puts each group's five on a
    line through the group's first point, off it by `collinear` at most:
    the fit's affine block is then near singular."""
    gen = torch.Generator().manual_seed(seed)
    kp_1 = torch.rand(b, g, 5, 2, generator=gen, dtype=dtype) * 1.4 - 0.7
    if collinear:
        angle = torch.rand(b, g, 1, generator=gen, dtype=dtype) * 3.14159
        along = torch.rand(b, g, 5, generator=gen, dtype=dtype) * 1.2 - 0.6
        off = (torch.rand(b, g, 5, generator=gen, dtype=dtype) * 2 - 1) * collinear
        direction = torch.stack([torch.cos(angle), torch.sin(angle)], -1)
        normal = torch.stack([-torch.sin(angle), torch.cos(angle)], -1)
        kp_1 = (kp_1[:, :, :1] * 0.3 + along[..., None] * direction
                + off[..., None] * normal)
    kp_2 = kp_1 + 0.05 * torch.randn(b, g, 5, 2, generator=gen, dtype=dtype)
    return kp_1, kp_2


def _system(kp_1, kp_2):
    """The fit's regularized (N+3)^2 matrix and right-hand side, built by
    hand here from the TPS definition."""
    n = kp_1.shape[2]
    s = (kp_1[:, :, :, None] - kp_1[:, :, None]).square().sum(-1)
    k = s * torch.log(s + 1e-9)
    p = torch.cat([kp_1, torch.ones_like(kp_1[..., :1])], -1)
    zeros = torch.zeros(*kp_1.shape[:2], 3, 3, dtype=kp_1.dtype)
    l_mat = torch.cat([torch.cat([k, p], -1), torch.cat([p.transpose(2, 3), zeros], -1)], 2)
    l_mat = l_mat + 0.01 * torch.eye(n + 3, dtype=kp_1.dtype)
    y = torch.cat([kp_2, torch.zeros(*kp_1.shape[:2], 3, 2, dtype=kp_1.dtype)], 2)
    return l_mat, y


CASES = [(0, 0.0), (1, 0.0), (2, 1e-2), (3, 1e-3), (4, 3e-2)]


def _solution(params):
    """A fit's (B, G, N+3, 2) solution: control parameters over the affine
    part's transpose."""
    return torch.cat([params.control_params, params.theta.transpose(2, 3)], 2)


@pytest.mark.parametrize("seed,collinear", CASES)
def test_tps_fit_matches_float64_lapack(seed, collinear):
    """Each group's fit against the float64 LAPACK solution of the system
    built by hand. In float64 the two agree to round-off times the
    condition number. In float32 the error is held by the forward-error
    bound of a stable elimination, cond(L) x eps x max|x|, times 2 (over
    1000 such systems the largest reading of the ratio was 0.51); the
    nearly collinear groups reach cond(L) 5.7e4 (seed 2)."""
    kp_1, kp_2 = _keypoints(4, 10, seed, collinear)
    l_mat, y = _system(kp_1, kp_2)
    want = torch.linalg.solve(l_mat, y)
    cond = torch.linalg.cond(l_mat)
    scale = want.abs().amax((-2, -1))
    err64 = (_solution(tps_fit(kp_1, kp_2)) - want).abs().amax((-2, -1))
    assert bool((err64 <= 64 * torch.finfo(torch.float64).eps * cond * scale).all())
    got32 = _solution(tps_fit(kp_1.float(), kp_2.float()))
    assert got32.dtype == torch.float32
    err32 = (got32.double() - want).abs().amax((-2, -1))
    assert bool((err32 <= 2 * EPS32 * cond * scale).all()), (err32 / (EPS32 * cond * scale)).max()


def test_tps_fit_is_the_system_solved():
    """tps_fit's control points are its inputs, and its parameters the
    float64 solution of the system built by hand."""
    kp_1, kp_2 = _keypoints(2, 10, seed=5)
    want = torch.linalg.solve(*_system(kp_1, kp_2))
    got = tps_fit(kp_1, kp_2)
    assert torch.equal(got.control_points, kp_1)
    np.testing.assert_allclose(_solution(got).numpy(), want.numpy(), atol=1e-10)


@pytest.mark.parametrize("collinear", [0.0, 1e-2])
def test_tps_fit_gradcheck(collinear):
    """The gradient of the fit through its batched LU solve (`solve_ex`:
    LU with partial pivoting, the pivots' choice fixed near the point)
    against finite differences, in float64."""
    kp_1, kp_2 = (t.requires_grad_(True) for t in _keypoints(1, 2, seed=6, collinear=collinear))

    def fit(a, b):
        return tuple(tps_fit(a, b))[::2]  # theta, control_params

    assert torch.autograd.gradcheck(fit, (kp_1, kp_2), eps=1e-6, atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ serving --


class _Marks:
    """Stands in for a `StageEvents` being timed: the stage marks in order."""

    def __init__(self):
        self.names = []

    def mark(self, name):
        self.names.append(name)


STAGES = ["frame.keypoints", "frame.dense_motion", "frame.levels", "frame.refine",
          "frame.decode"]


@pytest.mark.parametrize("prior", ["mtia", "fomm", "tpsm"])
def test_frame_step_stages_and_fits(prior):
    """A TPSM frame step marks the stage `frame.tps` between the keypoints
    and the dense motion (the marks a graph's capture turns into its event
    nodes) and solves B x K systems (`tps.fits`); an MTIA or FOMM step
    marks the five stages it always had and solves none."""
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(0)
    model = MRFA(with_prior(mtia_cfg(64), prior), device="cpu")
    animator = Animator(model, model.state_dict(), device="cpu")
    frames = smooth_image(3, 64, seed=2)
    state = animator.begin(frames[:2], frames[1:])
    marks = _Marks()
    before = profiling.snapshot()["counters"].get("tps.fits", 0)
    profiling.REGISTRY.stage_events = marks
    try:
        animator.animate_frame(state, frames[1:])
    finally:
        profiling.REGISTRY.stage_events = None
    fits = profiling.snapshot()["counters"].get("tps.fits", 0) - before
    if prior == "tpsm":
        assert marks.names == STAGES[:1] + ["frame.tps"] + STAGES[1:]
        assert fits == 2 * 10
    else:
        assert marks.names == STAGES and fits == 0


def test_tpsm_serve_chunk_matches_the_reference():
    """The port's TPSM `serve_chunk` (S=2, K=2, 64 px, f32, CPU) against the
    benchmark's plain reference (`portbench/reference`, its `Clip`) from the
    same weights and inputs. On the CPU both run the same operations in the
    same order, the fit's LAPACK solve too, so the frames agree to float32
    round-off (1e-6; read 0.0 at seeds 1, 2, 3 and 2^34 + 9)."""
    import json

    from portbench import inputs
    from portbench.reference import serve as ref_serve
    from portbench.reference.models.mrfa import MRFA as RefMRFA
    from portbench.tests.small import ROOT, SIZE, model_cfg
    from portbench.weights import make_weights

    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.serving import AnimationServer

    seed = 1
    init = json.loads((ROOT / "configs" / "vox1-tpsm.json").read_text())["init"]
    motion = json.loads((ROOT / "traffic" / "serve-s8-bf16-graph.json").read_text())["motion"]
    cfg = model_cfg("vox1-tpsm")
    weights = make_weights(cfg, seed, "cpu", init)
    clips = inputs.driving_clips(2, 3, SIZE, motion, seed, "cpu")
    sources = inputs.sources(1, 2, SIZE, motion, seed, "cpu")[0]
    server = AnimationServer(MRFA(cfg, device="cpu"), weights, device="cpu")
    got = server.serve_chunk(server.open_streams(sources, clips[0]), clips[1:3])

    def nchw(x):
        return x.float().permute(0, 3, 1, 2).contiguous()

    ref = RefMRFA(cfg, "cpu")
    ref.load_state_dict(weights)
    clip = ref_serve.Clip(ref.eval(), nchw(sources), nchw(clips[0]))
    want = torch.stack([clip.frame(nchw(clips[t])).permute(0, 2, 3, 1) for t in (1, 2)])
    assert got.shape == want.shape == (2, 2, SIZE, SIZE, 3)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got[:, 0] - got[:, 1]).abs().mean()) > 1e-2  # the streams differ
