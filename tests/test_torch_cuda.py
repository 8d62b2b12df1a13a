"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a, nvcc) and skips without one.
On the GPU machine, from the repository root:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`--noconftest` leaves out the shared conftest, which sets up JAX; these
tests import no JAX.) `chip_smoke.py` runs the same checks at the main
path's shapes and drives the frame step through the kernels.
"""
import numpy as np
import pytest
import torch

from mrfa_tpu_torch.ops.corr_lookup import CHANNELS, CorrLookup, corr_lookup_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lookup_inputs(bq, size, dtype, device, seed):
    """y-major maps and coords with integer centres and windows partly and
    wholly outside the map."""
    rng = np.random.RandomState(seed)
    c0 = rng.randn(bq, size, size).astype(np.float32)
    c1 = rng.randn(bq, size // 2, size // 2).astype(np.float32)
    coords = rng.uniform(-12, size + 12, (bq, 2)).astype(np.float32)
    coords[: bq // 8] = np.round(coords[: bq // 8])
    coords[-1] = [-40.0, size + 40.0]
    to = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
    return to(c0), to(c1), torch.from_numpy(coords).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bq,size", [(64, 64), (1000, 64), (333, 32), (4099, 64)])
def test_corr_lookup_kernel_matches_plain(cuda, dtype, bq, size):
    lookup = CorrLookup()
    c0, c1, coords = _lookup_inputs(bq, size, dtype, cuda, seed=bq + size)
    got = lookup(c0, c1, coords)
    want = corr_lookup_plain(c0, c1, coords)
    torch.cuda.synchronize()
    assert lookup.launches == 1
    assert got.shape == (bq, CHANNELS) and got.dtype == dtype and got.is_cuda
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        # same terms, order and roundings as the plain version
        assert torch.equal(got, want)
    else:
        # one bf16 ulp of each output (8 significant bits)
        a = want.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
        assert bool((diff <= torch.exp2(torch.floor(torch.log2(a)) - 7)).all())


def test_corr_lookup_kernel_with_no_queries_launches_nothing(cuda):
    lookup = CorrLookup()
    c0, c1, coords = _lookup_inputs(8, 16, torch.float32, cuda, seed=0)
    out = lookup(c0[:0], c1[:0], coords[:0])
    assert out.shape == (0, CHANNELS) and lookup.launches == 0


def _splat_args(b, n, c, h, w, dtype, device, seed, flow="wild"):
    """g and the corners and pair weights of n samples a batch onto h x w:
    `wild` uniform over the image and 2 px beyond it (on, across and beyond
    every edge), `smooth` and `noisy` a flow of a few pixels around a grid,
    `collapse` every sample within a pixel of one point."""
    from mrfa_tpu_torch.ops.sampler import _tap_weights

    g = torch.Generator(device=device).manual_seed(seed)
    grad = torch.randn(b, n, c, generator=g, device=device).to(dtype)
    grid = torch.arange(n, device=device).float()
    gx, gy = grid % w, (grid // w) % h
    if flow == "wild":
        ix = torch.rand(b, n, generator=g, device=device) * (w + 4) - 2
        iy = torch.rand(b, n, generator=g, device=device) * (h + 4) - 2
    elif flow == "smooth":
        phase = torch.rand(b, 1, generator=g, device=device) * 6.3
        ix = gx + 3.0 * torch.sin(gy / 7.0 + phase)
        iy = gy + 3.0 * torch.cos(gx / 5.0 + phase)
    elif flow == "noisy":
        ix = gx + 2.0 * torch.randn(b, n, generator=g, device=device)
        iy = gy + 2.0 * torch.randn(b, n, generator=g, device=device)
    else:  # collapse
        ix = w / 3 + torch.rand(b, n, generator=g, device=device) * 2 - 1
        iy = h / 3 + torch.rand(b, n, generator=g, device=device) * 2 - 1
    x0, y0, wx, wy, vx0, vx1, vy0, vy1 = _tap_weights(ix, iy, h, w, True)
    return (grad, y0, ((1 - wy) * vy0).contiguous(), (wy * vy1).contiguous(), x0,
            ((1 - wx) * vx0).contiguous(), (wx * vx1).contiguous(), h, w)


# N = h * w for the flows around a grid; N not square, C = 3 and 512, and an
# image that is no multiple of the 16-pixel tile among them
SPLAT_CASES = [(2, 4096, 64, 64, 64, "wild"), (3, 500, 3, 17, 23, "wild"),
               (1, 64, 512, 8, 8, "wild"), (2, 4096, 64, 64, 64, "smooth"),
               (2, 391, 3, 17, 23, "smooth"), (2, 1024, 512, 32, 32, "noisy"),
               (2, 2000, 64, 40, 50, "noisy"), (2, 4096, 64, 64, 64, "collapse"),
               (1, 300, 512, 24, 40, "collapse")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,n,c,h,w,flow", SPLAT_CASES)
def test_splat_kernel_matches_plain(cuda, dtype, b, n, c, h, w, flow):
    from mrfa_tpu_torch.ops.splat import DIRECT_PIXELS, Splat, splat_plain

    spl = Splat()
    args = _splat_args(b, n, c, h, w, dtype, cuda, seed=n, flow=flow)
    got = spl(*args)
    want = splat_plain(*args)
    torch.cuda.synchronize()
    binned = h * w > DIRECT_PIXELS
    assert spl.launches == 1 and spl.bin_launches == 2 * binned
    assert got.shape == (b, h, w, c) and got.dtype == torch.float32
    # f32 sums in another order than index_add_: the JAX package's hardware gate
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("b,n,c,h,w,flow", SPLAT_CASES)
def test_splat_bins_match_plain(cuda, b, n, c, h, w, flow):
    """The binning kernels' bins, as sets per tile, are splat_bins_plain's."""
    from mrfa_tpu_torch.ops.splat import Splat, splat_bins_plain

    args = _splat_args(b, n, 1, h, w, torch.float32, cuda, seed=n, flow=flow)
    counts, members = Splat().bins(args[1], args[4], h, w)
    want_counts, want_members = splat_bins_plain(args[1], args[4], h, w)
    assert torch.equal(counts, want_counts)
    bins = torch.repeat_interleave(torch.arange(counts.numel(), device=cuda), counts)
    assert torch.equal((bins * b * n + members).sort().values % (b * n), want_members)


@pytest.mark.parametrize("flow", ["smooth", "collapse"])
def test_splat_kernel_twice_agrees(cuda, flow):
    """Two launches on the same inputs agree within the gate that holds each
    to the plain version, not bit for bit: the samples of a bin take their
    slots through atomic counters, so the order in which a warp adds them
    into a pixel, and with it the roundings of its f32 sums, may change from
    launch to launch. The bins agree as sets (test_splat_bins_match_plain)."""
    from mrfa_tpu_torch.ops.splat import Splat

    spl = Splat()
    args = _splat_args(2, 4096, 64, 64, 64, torch.float32, cuda, seed=7, flow=flow)
    first, second = spl(*args), spl(*args)
    torch.cuda.synchronize()
    assert float((first - second).abs().max()) <= 1e-4 * float(first.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bq,size", [(64, 64), (1000, 64), (333, 32), (40, 6)])
def test_corr_lookup_bwd_kernel_matches_plain(cuda, dtype, bq, size):
    from mrfa_tpu_torch.ops.corr_lookup import CorrLookupBwd, corr_lookup_bwd_plain

    bwd = CorrLookupBwd()
    c0, c1, coords = _lookup_inputs(bq, size, dtype, cuda, seed=bq + size)
    g = torch.randn(bq, CHANNELS, device=cuda).to(dtype)
    got = bwd(c0, c1, coords, g)
    want = corr_lookup_bwd_plain(c0, c1, coords, g)
    torch.cuda.synchronize()
    assert bwd.launches == 1
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == b.shape and a.dtype == dtype
        diff = (a.float() - b.float()).abs()
        if dtype == torch.float32:  # same terms, order and roundings
            assert float(diff.max()) <= 1e-6 * float(b.abs().max())
        else:  # one bf16 ulp
            m = b.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
            assert bool((diff <= torch.exp2(torch.floor(torch.log2(m)) - 7)).all())
    # d_coords: sums of 98 terms in another order
    assert float((got[2] - want[2]).abs().max()) <= 1e-5 * max(1.0, float(want[2].abs().max()))
    assert not got[0][-1].any() and not got[2][-1].any()  # the far-out centre


def test_corr_lookup_function_backward_on_the_card(cuda):
    from mrfa_tpu_torch.ops.corr_lookup import CorrLookupFn, corr_lookup_plain

    c0, c1, coords = _lookup_inputs(500, 64, torch.float32, cuda, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (c0, c1, coords)]
    g = torch.randn(500, CHANNELS, device=cuda)
    got = torch.autograd.grad(CorrLookupFn.apply(*leaves), leaves, g)
    want = torch.autograd.grad(corr_lookup_plain(*leaves), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bq,size", [(64, 64), (1000, 64), (333, 32), (40, 6)])
def test_corr_lookup_pooled_bwd_kernel_matches_plain(cuda, dtype, bq, size):
    from mrfa_tpu_torch.ops.corr_lookup import (
        CorrLookupPooledBwd,
        corr_lookup_pooled_bwd_plain,
    )

    bwd = CorrLookupPooledBwd()
    corr, _, coords = _lookup_inputs(bq, size, dtype, cuda, seed=bq + size)
    g = torch.randn(bq, CHANNELS, device=cuda)
    got = bwd(corr, coords, g)
    want = corr_lookup_pooled_bwd_plain(corr, coords, g)
    torch.cuda.synchronize()
    assert bwd.launches == 1
    assert got[0].shape == corr.shape and got[0].dtype == dtype
    # d_corr depends on g and the fractions alone: bit-exact in f32, one
    # rounding of the same f32 sum in bf16
    assert torch.equal(got[0], want[0])
    # d_coords: sums of 98 terms in another order
    assert float((got[1] - want[1]).abs().max()) <= 2e-5 * max(1.0, float(want[1].abs().max()))
    assert not got[0][-1].any() and not got[1][-1].any()  # the far-out centre


# (48, 48, 16): rows of 192 and 96 bytes, so both levels end in a partial stage
@pytest.mark.parametrize("bq,size,qb", [(4096, 64, 16), (64, 16, 8), (96, 64, 32),
                                        (16384, 64, 16), (48, 48, 16)])
def test_stream_probe_kernel_is_bit_exact(cuda, bq, size, qb):
    from mrfa_tpu_torch.ops.stream_probe import StreamProbe, stream_probe_plain

    probe = StreamProbe()
    corr = torch.randn(bq, size, size, device=cuda)
    c0 = corr.reshape(bq * size, size)
    c1 = torch.nn.functional.avg_pool2d(corr, 2).reshape(bq * size // 2, size // 2)
    for second in (c1, None):
        got = probe(c0, second, bq, qb)
        torch.cuda.synchronize()
        assert torch.equal(got, stream_probe_plain(c0, second, bq, qb))
    assert probe.launches == 2


def test_stream_probe_kernel_refuses_an_unaligned_view(cuda):
    from mrfa_tpu_torch.ops.stream_probe import StreamProbe

    probe = StreamProbe()
    flat = torch.randn(32 * 64 * 64 + 4, device=cuda)
    # storage offset 1: contiguous views 4 bytes past 16-byte alignment
    c0_off = flat[1:1 + 32 * 64 * 64].view(32 * 64, 64)
    c1_off = flat[1:1 + 32 * 32 * 32].view(32 * 32, 32)
    c0, c1 = torch.randn(32 * 64, 64, device=cuda), torch.randn(32 * 32, 32, device=cuda)
    assert c0_off.is_contiguous() and c0_off.data_ptr() % 16
    for first, second in ((c0_off, c1), (c0_off, None), (c0, c1_off)):
        with pytest.raises(ValueError, match="aligned"):
            probe(first, second, 32, 16)
    assert probe.launches == 0


def test_corr_lookup_pooled_function_on_the_card(cuda):
    from mrfa_tpu_torch.ops.corr_lookup import CorrLookupPooledFn, corr_lookup_plain

    corr, _, coords = _lookup_inputs(500, 64, torch.float32, cuda, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (corr, coords)]
    g = torch.randn(500, CHANNELS, device=cuda)
    got = torch.autograd.grad(CorrLookupPooledFn.apply(*leaves), leaves, g)
    pooled = torch.nn.functional.avg_pool2d(leaves[0], 2)
    want = torch.autograd.grad(corr_lookup_plain(leaves[0], pooled, leaves[1]), leaves, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def _ulp(x, bits: int):
    """The spacing of floats with `bits` significant bits at |x|, elementwise."""
    a = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - (bits - 1))


def _warp_coords(b, n, res, device, seed, motions=1):
    """(B, N) pixel coordinates: smooth flows around the grid of `motions`
    copies of a res x res image, with integer coordinates, points up to 3 px
    beyond every edge (partly outside) and four far outside mixed in."""
    from mrfa_tpu_torch.tools.kernel_times import sample_coords

    gen = torch.Generator(device=device).manual_seed(seed)
    ix, iy = (t.reshape(b, -1)[:, :n].clone()
              for t in sample_coords(res, "smooth", gen, device, batch=b * motions))
    k = max(n // 8, 1)
    ix[:, :k], iy[:, :k] = torch.round(ix[:, :k]), torch.round(iy[:, :k])
    for t in (ix, iy):
        t[:, k:2 * k] = torch.rand(b, t[:, k:2 * k].shape[1], generator=gen,
                                   device=device) * (res + 6) - 3
    far = torch.tensor([[-40.0, 5.0], [res + 30.0, 20.0], [10.0, -50.0], [-9.0, -9.0]],
                       device=device)
    m = min(4, n - 2 * k)
    if m > 0:
        ix[:, 2 * k:2 * k + m], iy[:, 2 * k:2 * k + m] = far[:m, 0], far[:m, 1]
    return ix, iy


def _assert_warp_close(got, want, scale, dtype):
    """f32: within 2 f32 ulps of the blend's scale (the sum of its terms'
    magnitudes); bf16: within 1 bf16 ulp of the value, and those 2 f32 ulps."""
    diff = (got.float() - want.float()).abs()
    tol = 2 * _ulp(scale, 24)
    if dtype == torch.bfloat16:
        tol = tol + _ulp(want, 8)
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    assert bool((diff <= tol).all()), float((diff - tol).max())


# the served warps' (B, C, side, motions): the pyramid levels at 8-256 px,
# the image warp, and dense motion's source warp at 11 motions
WARP_SHAPES = [(b, c, res, m) for b in (1, 8)
               for c, res, m in ((512, 8, 1), (512, 16, 1), (512, 32, 1), (256, 64, 1),
                                 (128, 128, 1), (64, 256, 1), (3, 256, 1), (3, 64, 11))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,res,motions", WARP_SHAPES)
def test_warp_bilinear_kernel_matches_plain(cuda, dtype, b, c, res, motions):
    from mrfa_tpu_torch.ops.sampler import WarpBilinear, _unnormalize, warp_pixels_plain

    warp = WarpBilinear()
    img = torch.randn(b, c, res, res, device=cuda).to(dtype)
    n = motions * res * res
    ix, iy = _warp_coords(b, n, res, cuda, seed=b + c + res, motions=motions)
    grid = torch.stack([ix, iy], -1)  # read in place through its strides
    scale = warp_pixels_plain(img.abs(), ix, iy).float()
    _assert_warp_close(warp(img, grid[..., 0], grid[..., 1]), warp_pixels_plain(img, ix, iy),
                       scale, dtype)
    # a normalized grid, mapped to pixels inside the launch
    for ac in (False, True):
        norm = (2.0 * grid + 1.0) / res - 1.0 if not ac else grid * (2.0 / (res - 1)) - 1.0
        px, py = _unnormalize(norm[..., 0], res, ac), _unnormalize(norm[..., 1], res, ac)
        _assert_warp_close(warp(img, norm[..., 0], norm[..., 1], True, ac),
                           warp_pixels_plain(img, px, py),
                           warp_pixels_plain(img.abs(), px, py).float(), dtype)
    # border and reflection: coordinates folded into the image first
    cx, cy = ix.clamp(0, res - 1), iy.clamp(0, res - 1)
    _assert_warp_close(warp(img, cx, cy, False), warp_pixels_plain(img, cx, cy, False),
                       warp_pixels_plain(img.abs(), cx, cy, False).float(), dtype)
    torch.cuda.synchronize()
    assert warp.launches == 4


def test_warp_bilinear_kernel_takes_strided_images(cuda):
    """A channels-last image and a non-contiguous output layout of its
    caller's making: the kernel reads through strides."""
    from mrfa_tpu_torch.ops.sampler import WarpBilinear, warp_pixels_plain

    warp = WarpBilinear()
    img = torch.randn(2, 64, 32, 32, device=cuda).to(memory_format=torch.channels_last)
    ix, iy = _warp_coords(2, 32 * 32, 32, cuda, seed=3)
    got = warp(img, ix, iy)
    torch.cuda.synchronize()
    _assert_warp_close(got, warp_pixels_plain(img.contiguous(), ix, iy),
                       warp_pixels_plain(img.abs().contiguous(), ix, iy), torch.float32)


def test_warp_bilinear_kernel_raises_on_what_it_cannot_take(cuda):
    from mrfa_tpu_torch.ops.sampler import WarpBilinear

    warp = WarpBilinear()
    img = torch.randn(2, 3, 8, 8, device=cuda)
    ix = torch.rand(2, 5, device=cuda)
    for bad, args in ((TypeError, (img.double(), ix, ix)),
                      (TypeError, (img.half(), ix, ix)),
                      (TypeError, (img, ix.double(), ix.double())),
                      (ValueError, (img, ix.cpu(), ix.cpu()))):
        with pytest.raises(bad):
            warp(*args)
    out = warp(img[:0], ix[:0], ix[:0])
    assert out.shape == (0, 3, 5) and warp.launches == 0


def _small_cfg(size=64, blocks=3, depth=1, prior="mtia"):
    """config/vox1.yaml's model under `prior` cut to 64 px, 3-block
    hourglasses and a 1-layer TokenPose (every width kept)."""
    from mrfa_tpu_torch.config import model_config

    cfg = model_config(_small_run_cfg("vox1", size, blocks, depth))
    cfg["train_params"]["prior_model"] = prior
    return cfg


def _small_run_cfg(name, size=64, blocks=3, depth=1):
    """The whole config/<name>.yaml (for `loop.train`), its model cut as
    `_small_cfg` says and its perceptual pyramid to scales [1, 0.25]."""
    from pathlib import Path

    from mrfa_tpu_torch.config import load_config

    cfg = load_config(str(Path(__file__).resolve().parents[1] / "config" / f"{name}.yaml"))
    cfg["train_params"]["scales"] = [1, 0.25]
    for key in ("dense_motion", "fomm_kp_detector", "tpsm_dense_motion"):
        cfg[key]["num_blocks"] = blocks
    model = cfg["mtia_kp_detector"]["MODEL"]
    model["TRANSFORMER_DEPTH"], model["IMAGE_SIZE"] = depth, [size, size]
    raft = cfg["raft_flow"]
    raft["size"] = size
    for enc in ("driving_encoder", "source_encoder"):
        raft[enc]["num_blocks"] = blocks
    return cfg


def _spread_tps_keypoints(model):
    """Each of the random TPSM detector's 50 keypoints at its own place in
    [-0.7, 0.7]^2 (its head's bias), as the benchmark's weights put them: at
    torch's initialization all sit near the origin and the fits are ill
    conditioned."""
    fc = model.encoder.fg_encoder.fc
    u = 1.4 * torch.rand(fc.bias.shape, generator=torch.Generator().manual_seed(7)) - 0.7
    with torch.no_grad():
        fc.bias.copy_(torch.log((1 + u) / (1 - u)))


STAGES = {"mtia": ["frame.keypoints", "frame.dense_motion", "frame.levels", "frame.refine",
                   "frame.decode"]}
STAGES["fomm"] = STAGES["mtia"]
STAGES["tpsm"] = STAGES["mtia"][:1] + ["frame.tps"] + STAGES["mtia"][1:]


@pytest.mark.parametrize("prior", ["mtia", "tpsm", "fomm"])
def test_animate_chunk_graph_equals_frame_by_frame(cuda, prior):
    from mrfa_tpu_torch.animate import Animator, FrameGraph
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils import profiling

    torch.manual_seed(0)
    model = MRFA(_small_cfg(prior=prior))
    if prior == "tpsm":
        _spread_tps_keypoints(model)
    animator = Animator(model, model.state_dict())
    rng = np.random.RandomState(0)
    source = rng.rand(64, 64, 3).astype(np.float32)
    frames = rng.rand(5, 64, 64, 3).astype(np.float32)
    state = animator.begin(source, frames[0])
    want = torch.stack([animator.animate_frame(state, f)[0] for f in frames])
    before = profiling.snapshot()["counters"]
    got = animator.animate_chunk(state, frames)  # captures the graph
    again = animator.animate_chunk(state, frames[::-1].copy())  # replays it
    torch.cuda.synchronize()
    assert got.shape == (5, 1, 64, 64, 3)
    assert torch.equal(got, want) and torch.equal(again, want.flip(0))
    # 6 lookups and 19 warps a frame step, and under TPSM 10 fits of one
    # stream: the eager warm-up steps and 10 replays
    after = profiling.snapshot()["counters"]
    steps = FrameGraph.WARMUP_STEPS + 10
    fits = 10 if prior == "tpsm" else 0
    assert after["launch.corr_lookup"] - before["launch.corr_lookup"] == 6 * steps
    assert after["launch.warp_bilinear"] - before["launch.warp_bilinear"] == 19 * steps
    assert after.get("tps.fits", 0) - before.get("tps.fits", 0) == fits * steps
    assert {k: n for k, n in animator._graph.launches.items() if n} == {
        "corr_lookup": 6, "warp_bilinear": 19}
    assert list(animator._graph.stages.times_ms()) == STAGES[prior]


@pytest.mark.parametrize("streams", [1, 8])
def test_tps_fit_captured_alone_replays_equal_to_eager(cuda, streams):
    """`tps_fit` of the 10 groups of 1 and of 8 streams, captured alone: each
    replay on new keypoints gives the eager fit bit for bit, no synchronizing
    runtime call runs in an eager fit or a replay, and the capture counts
    the systems it solves (`tps.fits`, which `FrameGraph` adds at each
    replay)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mrfa_tpu_torch.ops.tps import tps_fit
    from mrfa_tpu_torch.utils import profiling

    g = torch.Generator(device=cuda).manual_seed(3)

    def keypoints():
        kp_1 = torch.rand(streams, 10, 5, 2, generator=g, device=cuda) * 1.4 - 0.7
        return kp_1, kp_1 + 0.05 * torch.randn(streams, 10, 5, 2, generator=g, device=cuda)

    static = [t.clone() for t in keypoints()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tps_fit(*static)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with profiling.CapturedCounts() as counts, torch.cuda.graph(graph, stream=side):
        out = tps_fit(*static)
    assert counts.delta["tps.fits"] == 10 * streams
    for _ in range(3):
        kp = keypoints()
        for dst, src in zip(static, kp):
            dst.copy_(src)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("probe.fits"):
                graph.replay()
                want = tps_fit(*kp)
            torch.cuda.synchronize()
        for got, w in zip(out, want):
            assert torch.equal(got, w)
        assert bool(torch.isfinite(out.control_params).all())
        events = list(prof.profiler.kineto_results.events())
        (probe,) = [e for e in events
                    if e.name() == "probe.fits" and "CPU" in str(e.device_type())]
        t0, t1 = probe.start_ns(), probe.start_ns() + probe.duration_ns()
        inside = {e.name() for e in events if t0 <= e.start_ns() <= t1}
        assert "cudaGraphLaunch" in inside
        assert not inside & {"cudaStreamSynchronize", "cudaDeviceSynchronize",
                             "cudaEventSynchronize", "cudaMemcpy"}, sorted(inside)


def test_a_new_clip_frees_the_last_graph_before_its_capture(cuda, monkeypatch):
    """The last clip's graph, and with it its memory pool, is gone before the
    next clip's graph captures: a capture cannot free cached blocks, so what
    the old pool holds would be missing to it (cuDNN then swaps a
    convolution's plan for one of a smaller workspace, and the graph departs
    from the eager step)."""
    import weakref

    from mrfa_tpu_torch import animate
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(0)
    model = MRFA(_small_cfg())
    animator = animate.Animator(model, model.state_dict())
    rng = np.random.RandomState(0)
    frames = rng.rand(3, 2, 64, 64, 3).astype(np.float32)
    animator.animate_chunk(animator.begin(frames[0, 0], frames[0, 0]), frames[:, :1])
    last = weakref.ref(animator._graph)
    seen = {}

    class Watched(animate.FrameGraph):
        def __init__(self, *args):
            seen["last_alive"] = last() is not None
            super().__init__(*args)

    monkeypatch.setattr(animate, "FrameGraph", Watched)
    state = animator.begin(frames[0], frames[0])
    got = animator.animate_chunk(state, frames)
    torch.cuda.synchronize()
    assert seen == {"last_alive": False}
    want = torch.stack([animator.animate_frame(state, f)[0] for f in frames])
    assert torch.equal(got, want)


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:0"), ("cuda:0", "cuda:1")],
                         ids=["one_card", "two_cards"])
def test_split_server_graph_on_each_device(cuda, devices):
    """`serve_chunk` over replicas: each replica's graph is captured on its
    own device, replays the frame step's 6 lookups, and gives frame by
    frame what the one-device server's eager `serve` gives for its streams."""
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.serving import AnimationServer

    if torch.cuda.device_count() < len(set(devices)):
        pytest.skip(f"needs {len(set(devices))} cards")
    torch.manual_seed(0)
    weights = MRFA(_small_cfg(), device="cpu").state_dict()
    split = AnimationServer(MRFA(_small_cfg(), device="cpu"), weights, devices=list(devices))
    one = AnimationServer(MRFA(_small_cfg(), device="cpu"), weights)
    rng = np.random.RandomState(0)
    sources = rng.rand(4, 64, 64, 3).astype(np.float32)
    frames = rng.rand(3, 4, 64, 64, 3).astype(np.float32)  # K=3, S=4
    state = split.open_streams(sources, frames[0])
    got = split.serve_chunk(state, frames)
    again = split.serve_chunk(state, frames[::-1].copy())  # replays the graphs
    for r in split.replicas:
        assert r._graph.output.device == r.device
        assert {k: n for k, n in r._graph.launches.items() if n} == {
            "corr_lookup": 6, "warp_bilinear": 19}
    want = []
    for rows in (slice(0, 2), slice(2, 4)):
        st = one.open_streams(sources[rows], frames[0][rows])
        want.append(torch.stack([one.serve(st, f[rows]) for f in frames]))
    want = torch.cat(want, dim=1)
    torch.cuda.synchronize()
    assert got.shape == (3, 4, 64, 64, 3) and got.device == torch.device("cuda:0")
    assert torch.equal(got, want) and torch.equal(again, want.flip(0))
    assert not torch.equal(got[0], got[1])


class _Clips:
    """`FramesDataset`'s training items over in-memory random clips."""

    def __init__(self, n, size, seed=0):
        self.clips = np.random.RandomState(seed).rand(n, 2, size, size, 3).astype(np.float32)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        a, b = np.sort(self.rng.choice(2, size=2))
        return {"name": f"clip{i}", "source": self.clips[i, a], "driving": self.clips[i, b]}


@pytest.mark.parametrize("name", ["celebvhq", "vox1"])
def test_loop_epoch_of_two_steps_on_the_card(cuda, tmp_path, name):
    """One epoch of 2 steps of `loop.train` at 64 px (celebvhq: background
    predictor on): the kernels launch 6 lookups, 6 lookup backwards, 17
    splats and 20 warps (the frame step's 19 and the equivariance transform)
    a step, the loss terms are finite (bg among them with celebvhq),
    and the checkpoint restores into a new Trainer bit for bit."""
    from mrfa_tpu_torch.config import model_config
    from mrfa_tpu_torch.ops import launches
    from mrfa_tpu_torch.train.loop import train
    from mrfa_tpu_torch.train.trainer import Trainer
    from mrfa_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = _small_run_cfg(name)
    cfg["train_params"].update(num_epochs=1, batch_size=2, num_repeats=1, num_workers=1)
    before = launches.counts()
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        trainer = train(cfg, None, str(tmp_path), _Clips(4, 64), max_steps_per_epoch=2)
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in launches.counts().items()}
    assert counts == {"corr_lookup": 12, "corr_lookup_bwd": 12, "splat": 34,
                      "corr_lookup_pooled_bwd": 0, "stream_probe": 0, "warp_bilinear": 40}
    (line,) = (tmp_path / "log.txt").read_text().splitlines()
    terms = dict(t.split(" - ") for t in line.split(") ", 1)[1].split("; "))
    assert ("bg" in terms) == (name == "celebvhq")
    assert all(np.isfinite(float(v)) for v in terms.values())
    saved, step = restore_checkpoint(str(tmp_path / "ckpt"))
    assert step == 0 and saved["trainer"]["step"] == 2 == trainer.steps
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        fresh = Trainer(model_config(cfg), steps_per_epoch=2)
    fresh.load_state_dict(saved["trainer"])
    for key, want in trainer.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[key], want), key
    got, want = (t.optimizer.state_dict()["state"] for t in (fresh, trainer))
    assert got.keys() == want.keys()
    for i in want:
        for k in want[i]:
            assert torch.equal(got[i][k].cpu(), want[i][k].cpu()), (i, k)
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())


def _animator_and_frames(cuda, k=3):
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    torch.manual_seed(0)
    model = MRFA(_small_cfg())
    animator = Animator(model, model.state_dict())
    rng = np.random.RandomState(0)
    source = rng.rand(64, 64, 3).astype(np.float32)
    frames = torch.from_numpy(rng.rand(k, 64, 64, 3).astype(np.float32)).to(cuda)
    return animator, animator.begin(source, frames[0].cpu().numpy()), frames


def test_captured_stage_events_time_the_replay(cuda):
    """The stage events captured into the frame step's graph: five positive
    stage times whose sum is within 3% of CUDA events around the same
    replay."""
    from mrfa_tpu_torch.utils import profiling

    animator, state, frames = _animator_and_frames(cuda)
    animator.animate_chunk(state, frames)  # captures the graph
    graph = animator._graph
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ratios = []
    for k in range(5):
        start.record()
        with torch.inference_mode():  # the graph's input is an inference tensor
            graph.replay(frames[k % 3][None])
        end.record()
        end.synchronize()
        stages = graph.stages.times_ms()
        assert list(stages) == ["frame.keypoints", "frame.dense_motion", "frame.levels",
                                "frame.refine", "frame.decode"]
        assert all(t > 0 for t in stages.values()), stages
        ratios.append(sum(stages.values()) / start.elapsed_time(end))
    assert 0.97 <= float(np.median(ratios)) <= 1.0 + 1e-6, ratios
    calls = profiling.snapshot()["calls"]
    assert calls[-1]["stages_ms"] is not None and calls[-1]["captured"]


def test_graph_counters_equal_the_calls(cuda):
    from mrfa_tpu_torch.utils import profiling

    animator, state, frames = _animator_and_frames(cuda)
    before = profiling.snapshot()
    for _ in range(2):
        animator.animate_chunk(state, frames)  # one capture, 6 replays
    state2 = animator.begin(frames[1].cpu().numpy(), frames[2].cpu().numpy())
    animator.animate_chunk(state2, frames[:2])  # a second capture, 2 replays
    torch.cuda.synchronize()
    after = profiling.snapshot()

    def grew(name):
        return after["counters"][name] - before["counters"].get(name, 0)

    assert grew("graph.captures") == 2 and grew("graph.replays") == 8
    assert grew("launch.corr_lookup") == 6 * (2 * animator._graph.WARMUP_STEPS + 8)
    assert grew("launch.warp_bilinear") == 19 * (2 * animator._graph.WARMUP_STEPS + 8)
    calls = after["calls"][len(before["calls"]):]
    assert [c["captured"] for c in calls] == [True, False, True]
    assert calls[0]["gap_ms"] is None and calls[1]["gap_ms"] >= 0
    assert all(c["device_ms"] > 0 for c in calls)
    # a graph's first call is sampled (its stage times lost unless it was
    # done before the second replayed the graph), its second is not
    assert calls[1]["stages_ms"] is None and calls[2]["stages_ms"]


def test_reading_the_registry_never_synchronizes(cuda):
    """No synchronizing runtime call inside a profiler trace of
    `animate_chunk` calls and `snapshot()`: the registry reads events only
    once they report done."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from mrfa_tpu_torch.utils import profiling

    animator, state, frames = _animator_and_frames(cuda)
    animator.animate_chunk(state, frames)  # captures the graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("probe.calls"):
            for _ in range(3):
                animator.animate_chunk(state, frames)
            profiling.snapshot()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    (probe,) = [e for e in events if e.name() == "probe.calls" and "CPU" in str(e.device_type())]
    t0, t1 = probe.start_ns(), probe.start_ns() + probe.duration_ns()
    inside = {e.name() for e in events if t0 <= e.start_ns() <= t1}
    assert "cudaGraphLaunch" in inside
    assert not inside & {"cudaStreamSynchronize", "cudaDeviceSynchronize",
                         "cudaEventSynchronize"}, sorted(inside)
