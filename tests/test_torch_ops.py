"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same numpy inputs go through each JAX function and its port counterpart;
the port runs NCHW inside, so images are transposed at the boundary. f32
throughout; tolerances are stated per test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mrfa_tpu.ops import corr as jcorr
from mrfa_tpu.ops import grid as jgrid
from mrfa_tpu.ops import resize as jresize
from mrfa_tpu.ops import sampler as jsampler
from mrfa_tpu_torch.ops import corr as tcorr
from mrfa_tpu_torch.ops import grid as tgrid
from mrfa_tpu_torch.ops import resize as tresize
from mrfa_tpu_torch.ops import sampler as tsampler
from mrfa_tpu_torch.ops.corr_lookup import corr_lookup, corr_lookup_plain

# single ops on O(1) values: a few f32 ulps of summation-order difference
ATOL = 1e-5


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(16, 24), (5, 7), (3, 12)])
def test_resize_bilinear(align_corners, size):
    x = np.random.RandomState(0).randn(2, 8, 12, 3).astype(np.float32)
    want = jresize.resize_bilinear(jnp.asarray(x), size, align_corners=align_corners)
    got = tresize.resize_bilinear(nchw(x), size, align_corners=align_corners)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("op", ["avg_pool", "upsample_nearest", "downsample_nearest"])
def test_pool_and_nearest(op):
    x = np.random.RandomState(9).randn(2, 8, 12, 3).astype(np.float32)
    want = getattr(jresize, op)(jnp.asarray(x), 2)
    got = getattr(tresize, op)(nchw(x), 2)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("scale", [0.25, 0.5])
def test_antialias_downsample(scale):
    """Depthwise gaussian conv + subsample equals the JAX band matrices,
    zero padding at the borders included."""
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    want = jresize.antialias_downsample(
        jnp.asarray(x), jresize.AntiAliasParams.create(scale)
    )
    got = tresize.antialias_downsample(nchw(x), scale)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(padding_mode, align_corners):
    rng = np.random.RandomState(2)
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 6, 5, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1, -1], [1, 1], [0, 0]]  # exact corners and centre
    want = jsampler.grid_sample(
        jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners,
        padding_mode=padding_mode,
    )
    got = tsampler.grid_sample(
        nchw(img), torch.from_numpy(grid), align_corners=align_corners,
        padding_mode=padding_mode,
    )
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)


def test_sample_pixel_with_mask():
    rng = np.random.RandomState(3)
    img = rng.randn(2, 16, 16, 5).astype(np.float32)
    coords = rng.uniform(-3, 19, (2, 7, 9, 2)).astype(np.float32)
    coords[1, 0, :4] = [[0, 0], [15, 15], [3, 7], [-1, 16]]  # integer taps
    want, want_m = jsampler.sample_pixel(jnp.asarray(img), jnp.asarray(coords), mask=True)
    got, got_m = tsampler.sample_pixel(nchw(img), torch.from_numpy(coords), mask=True)
    # the port normalizes pixel coordinates for grid_sample and back: a
    # coordinate round trip of a few f32 ulps at |x| <= 19
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(to_nhwc(got_m), np.asarray(want_m))


def test_kp2gaussian_and_grids():
    kp = np.tanh(np.random.RandomState(4).randn(2, 10, 2)).astype(np.float32)
    want = jgrid.kp2gaussian(jnp.asarray(kp), (16, 12), 0.01)
    got = tgrid.kp2gaussian(torch.from_numpy(kp), (16, 12), 0.01)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-6)
    np.testing.assert_array_equal(
        tgrid.make_coordinate_grid(5, 7).numpy(), np.asarray(jgrid.make_coordinate_grid(5, 7))
    )
    np.testing.assert_array_equal(
        tgrid.coords_grid(5, 7).numpy(), np.asarray(jgrid.coords_grid(5, 7))
    )
    x = np.random.RandomState(5).randn(3, 4, 2).astype(np.float32)
    h = tgrid.to_homogeneous(torch.from_numpy(x))
    np.testing.assert_array_equal(h.numpy(), np.asarray(jgrid.to_homogeneous(jnp.asarray(x))))
    np.testing.assert_array_equal(tgrid.from_homogeneous(h).numpy(), x)


def _lookup_case(bq, size, seed, dtype=np.float32):
    """y-major level maps (level 1 = 2x2 mean of level 0) and coords that
    include exact integer centres and partly and fully out-of-bounds windows."""
    rng = np.random.RandomState(seed)
    c0 = rng.randn(bq, size, size).astype(np.float32)
    c1 = c0.reshape(bq, size // 2, 2, size // 2, 2).mean(axis=(2, 4))
    coords = rng.uniform(-12, size + 12, (bq, 2)).astype(np.float32)
    coords[:4] = np.round(coords[:4])
    coords[4] = [-40.0, 3.5]  # whole window outside
    coords[5] = [size + 30.0, size + 30.0]
    return c0, c1, coords


@pytest.mark.parametrize("bq,size", [(24, 64), (40, 16)])
def test_plain_lookup_matches_gather_oracle(bq, size):
    c0, c1, coords = _lookup_case(bq, size, seed=6)
    want = jcorr.corr_block_lookup_levels_gather(
        jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(coords)
    )
    t0, t1, tc = map(torch.from_numpy, (c0, c1, coords))
    got = corr_lookup_plain(t0, t1, tc)
    assert got.shape == (bq, 98) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the port's own gather oracles agree too
    np.testing.assert_allclose(
        tcorr.corr_block_lookup_levels_gather(t0, t1, tc).numpy(), np.asarray(want), atol=ATOL
    )
    pooled = jcorr.corr_block_lookup(jnp.asarray(c0)[..., None], jnp.asarray(coords))
    np.testing.assert_allclose(
        tcorr.corr_block_lookup(t0, tc).numpy(), np.asarray(pooled), atol=ATOL
    )


def test_plain_lookup_matches_padded_pallas_kernel_interpret():
    """The TPU kernel this slice replaces, run in interpret mode on x-padded
    x-major maps built as tests/test_pallas.py builds them."""
    from mrfa_tpu.ops.pallas_kernels import PAD, _corr_lookup_pallas_padded_impl

    bq, size = 24, 64  # not a multiple of the kernel's query block
    c0, c1, coords = _lookup_case(bq, size, seed=7)
    zp = ((0, 0), (PAD, PAD), (0, 0))
    c0p = jnp.pad(jnp.transpose(jnp.asarray(c0), (0, 2, 1)), zp)
    c1p = jnp.pad(jnp.transpose(jnp.asarray(c1), (0, 2, 1)), zp)
    want = _corr_lookup_pallas_padded_impl(c0p, c1p, jnp.asarray(coords), interpret=True)
    got = corr_lookup_plain(*map(torch.from_numpy, (c0, c1, coords)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_plain_lookup_bf16_maps():
    """bf16 maps: f32 blend, result rounded once to bf16 — exactly the f32
    lookup on the same (bf16-valued) maps, rounded to bf16."""
    c0, c1, coords = _lookup_case(32, 64, seed=8)
    t0 = torch.from_numpy(c0).to(torch.bfloat16)
    t1 = torch.from_numpy(c1).to(torch.bfloat16)
    tc = torch.from_numpy(coords)
    got = corr_lookup(t0, t1, tc)
    assert got.dtype == torch.bfloat16
    ref = corr_lookup_plain(t0.float(), t1.float(), tc).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), ref.float().numpy())


def _warp_case(seed=10, b=2, c=5, h=9, w=11, n=30):
    """An image and pixel coordinates inside, partly outside and wholly
    outside it, some of them integers."""
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    ix = torch.from_numpy(rng.uniform(-3, w + 3, (b, n)).astype(np.float32))
    iy = torch.from_numpy(rng.uniform(-3, h + 3, (b, n)).astype(np.float32))
    ix[:, :4], iy[:, :4] = torch.round(ix[:, :4]), torch.round(iy[:, :4])
    ix[:, 4], iy[:, 5] = -40.0, h + 30.0
    return img, ix, iy


def test_warp_bilinear_on_cpu_takes_the_plain_version():
    """CPU tensors take `warp_pixels_plain` and count no launch, through the
    wrapper and through the samplers."""
    img, ix, iy = _warp_case()
    before = tsampler.warp_bilinear.launches
    for zero_oob in (True, False):
        want = tsampler.warp_pixels_plain(img, ix, iy, zero_oob)
        assert torch.equal(tsampler.warp_bilinear(img, ix, iy, zero_oob), want)
        assert torch.equal(tsampler.warp_pixels(img, ix, iy, zero_oob), want)
    grid = torch.stack([ix, iy], -1)[:, :, None]
    tsampler.sample_pixel(img, grid)
    tsampler.grid_sample(img, grid / 6.0, padding_mode="reflection")
    assert tsampler.warp_bilinear.launches == before


BAD_WARP_ARGS = {
    "img_rank": (ValueError, lambda img, ix, iy: (img[0], ix, iy)),
    "coords_rank": (ValueError, lambda img, ix, iy: (img, ix[..., None], iy[..., None])),
    "coords_shapes": (ValueError, lambda img, ix, iy: (img, ix, iy[:, :-1])),
    "batch": (ValueError, lambda img, ix, iy: (img[:1], ix, iy)),
    "img_f16": (TypeError, lambda img, ix, iy: (img.half(), ix, iy)),
    "img_int": (TypeError, lambda img, ix, iy: (img.int(), ix, iy)),
    "coords_bf16": (TypeError, lambda img, ix, iy: (img, ix.bfloat16(), iy.bfloat16())),
    "coords_int": (TypeError, lambda img, ix, iy: (img, ix.long(), iy.long())),
    "coords_mixed": (TypeError, lambda img, ix, iy: (img, ix, iy.double())),
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", sorted(BAD_WARP_ARGS))
def test_warp_bilinear_checks_its_arguments_first(case, device):
    """Each check raises before the device branch: on the CPU, and on a
    device the wrapper does not run on (which would raise ValueError)."""
    error, make = BAD_WARP_ARGS[case]
    args = [t.to(device) for t in make(*_warp_case())]
    before = tsampler.warp_bilinear.launches
    with pytest.raises(error):
        tsampler.warp_bilinear(*args)
    assert tsampler.warp_bilinear.launches == before


def test_warp_bilinear_refuses_other_devices_and_f64_off_the_cpu():
    img, ix, iy = (t.to("meta") for t in _warp_case())
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tsampler.warp_bilinear(img, ix, iy)
    with pytest.raises(TypeError):
        tsampler.warp_bilinear(img.double(), ix, iy)
    with pytest.raises(TypeError):
        tsampler.warp_bilinear(img, ix.double(), iy.double())


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [1, 2, 7, 64, 255, 256])
def test_unnorm_terms_are_unnormalize(size, align_corners):
    """The kernel's ((g + 1) * a - b) * c is `_unnormalize` bit for bit."""
    g = torch.from_numpy(np.random.RandomState(size).uniform(-1.6, 1.6, 4096).astype(np.float32))
    g[:5] = torch.tensor([-1.0, 1.0, 0.0, -0.0, 1e-8])
    a, b, c = tsampler._unnorm_terms(size, align_corners)
    assert torch.equal(((g + 1.0) * a - b) * c, tsampler._unnormalize(g, size, align_corners))


@pytest.mark.parametrize("align_corners", [True, False])
def test_zero_padded_grid_sample_maps_the_grid_inside_the_warp(align_corners):
    """With zero padding the warp takes the normalized grid and maps it to
    pixels itself: the forward and both gradients are those of the grid
    mapped first and warped at pixel coordinates, bit for bit."""
    img, ix, iy = _warp_case(c=4, n=24)
    h, w = img.shape[-2:]
    grid = torch.stack([ix / (w / 2.0) - 1.0, iy / (h / 2.0) - 1.0], -1).reshape(2, 4, 6, 2)

    def run(folded):
        leaves = [img.clone().requires_grad_(True), grid.clone().requires_grad_(True)]
        if folded:
            out = tsampler.grid_sample(*leaves, align_corners=align_corners)
        else:
            g = leaves[1].reshape(2, -1, 2)
            out = tsampler.warp_pixels(
                leaves[0], tsampler._unnormalize(g[..., 0], w, align_corners),
                tsampler._unnormalize(g[..., 1], h, align_corners)).reshape(2, 4, 4, 6)
        cot = torch.from_numpy(np.random.RandomState(1).randn(*out.shape).astype(np.float32))
        return (out, *torch.autograd.grad(out, leaves, cot))

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)
