"""Parity of the port's training ops with the JAX package's, on the CPU.

The splat (warp backward), the lookup backward, the differentiable warp, the
equivariance transform, VGG19 and the optimizer, each held against its JAX
counterpart on the same numpy inputs. Where the JAX function reaches a Pallas
kernel, it runs in interpret mode, as the JAX package's own tests run it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrfa_tpu.ops import corr as jcorr
from mrfa_tpu.ops import sampler as jsampler
from mrfa_tpu.ops import tps as jtps
from mrfa_tpu.ops.pallas_kernels import _corr_lookup_pallas_pret_bwd_impl
from mrfa_tpu.ops.pallas_splat import splat_pallas
from mrfa_tpu_torch.ops import sampler as tsampler
from mrfa_tpu_torch.ops import tps as ttps
from mrfa_tpu_torch.ops.corr_lookup import (
    CorrLookupFn,
    corr_lookup,
    corr_lookup_bwd,
    corr_lookup_bwd_plain,
    corr_lookup_plain,
)
from mrfa_tpu_torch.ops.grid import make_coordinate_grid
from mrfa_tpu_torch.ops.splat import splat, splat_plain
from tests.torch_parity import jax_apply, jax_init, nchw, to_nhwc, transform_arrays

# single ops on O(1) values: a few f32 ulps of summation-order difference
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ----------------------------------------------------------------- splat --


def _splat_case(rng, b, h, w, c, n, margin=2):
    """Corners over [-1 - margin, size + margin] (taps on, across and beyond
    every edge) and random pair weights. The JAX splat clips corners to
    [-1, size]; its Pallas kernel takes them already in that range."""
    g = rng.randn(b, n, c).astype(np.float32)
    y0 = rng.randint(-1 - margin, h + margin + 1, (b, n)).astype(np.int32)
    x0 = rng.randint(-1 - margin, w + margin + 1, (b, n)).astype(np.int32)
    ws = [rng.rand(b, n).astype(np.float32) for _ in range(4)]
    return g, y0, ws[0], ws[1], x0, ws[2], ws[3]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b,h,w,c,n", [(2, 32, 32, 64, 1024), (1, 16, 16, 128, 300),
                                       (2, 8, 12, 3, 200)])
def test_splat_plain_matches_jax_f32(b, h, w, c, n):
    args = _splat_case(np.random.RandomState(n), b, h, w, c, n)
    got = splat_plain(*map(_t, args), h, w).numpy()
    want = np.asarray(jsampler._splat(*map(jnp.asarray, args), h, w))
    assert got.shape == (b, h, w, c)
    assert _rel(got, want) <= 1e-5
    if c % 64 == 0:  # the Pallas kernel takes lane-aligned channel tiles only
        args = _splat_case(np.random.RandomState(n + 1), b, h, w, c, n, margin=0)
        got = splat_plain(*map(_t, args), h, w).numpy()
        kernel = np.asarray(splat_pallas(*map(jnp.asarray, args), h, w, interpret=True))
        assert _rel(got, kernel) <= 1e-5


def test_splat_plain_matches_jax_bf16():
    """bf16 g: pair weights cast to bf16, u = wx * g rounded to bf16, f32
    accumulation. Held against the XLA splat, whose bf16 products are exact;
    the Pallas kernel's interpret mode rounds them (tests/test_pallas.py)."""
    args = list(_splat_case(np.random.RandomState(5), 2, 32, 32, 64, 1500))
    gb = jnp.asarray(args[0], jnp.bfloat16)
    want = np.asarray(jsampler._splat(gb, *map(jnp.asarray, args[1:]), 32, 32), np.float32)
    tg = torch.from_numpy(np.asarray(gb.astype(jnp.float32))).to(torch.bfloat16)
    got = splat_plain(tg, *map(_t, args[1:]), 32, 32)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-4


def test_splat_out_of_range_rows_drop():
    """Corners at -1 and at the size: only the in-image taps land; rows and
    columns beyond the image take nothing (as tests/test_pallas.py checks)."""
    b, h, w, c, n = 1, 16, 16, 64, 4
    g = np.ones((b, n, c), np.float32)
    y0 = np.array([[-1, -1, h, 3]], np.int32)
    x0 = np.array([[w, -1, 2, -5]], np.int32)
    one = np.ones((b, n), np.float32)
    got = splat(*map(_t, (g, y0, one, one, x0, one, one)), h, w).numpy()
    want = np.asarray(jsampler._splat(*map(jnp.asarray, (g, y0, one, one, x0, one, one)), h, w))
    np.testing.assert_array_equal(got, want)
    # sample 1 lands on (0, 0) only; sample 3's x0 = -5 clips to -1, so its
    # x + 1 tap lands on column 0 of rows 3 and 4; the rest drop
    assert got.sum() == 3 * c and got[0, 0, 0, 0] == 1 and got[0, 3, 0, 0] == 1


# ------------------------------------------------------- lookup backward --


def _lookup_case(bq, size, seed, dtype=np.float32):
    """y-major maps, coords with integer, edge and far-out centres, and g."""
    rng = np.random.RandomState(seed)
    c0 = rng.randn(bq, size, size).astype(np.float32)
    c1 = rng.randn(bq, size // 2, size // 2).astype(np.float32)
    coords = rng.uniform(-10, size + 10, (bq, 2)).astype(np.float32)
    n = bq // 6
    coords[:n] = np.round(coords[:n])  # integer centres
    coords[n:2 * n, 0] = rng.choice([0.0, size - 1.0, -3.5, size + 2.25], n)  # edges
    coords[-3:] = [[-40.0, 5.0], [size + 30.0, size + 30.0], [3.0, -60.0]]  # far out
    g = rng.randn(bq, 98).astype(np.float32)
    if dtype is not np.float32:
        c0 = np.asarray(jnp.asarray(c0, jnp.bfloat16).astype(jnp.float32))
        c1 = np.asarray(jnp.asarray(c1, jnp.bfloat16).astype(jnp.float32))
    return c0, c1, coords, g


def _bf16_ulp(x):
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("bq,size", [(40, 16), (24, 64)])
def test_lookup_backward_plain_matches_jax_f32(bq, size):
    c0, c1, coords, g = _lookup_case(bq, size, seed=bq)
    d0, d1, dc = (t.numpy() for t in corr_lookup_bwd_plain(*map(_t, (c0, c1, coords, g))))
    # the JAX lookup backward kernels (x-major maps: the transposes)
    k0, k1, kc = _corr_lookup_pallas_pret_bwd_impl(
        jnp.asarray(c0.transpose(0, 2, 1)), jnp.asarray(c1.transpose(0, 2, 1)),
        jnp.asarray(coords), jnp.asarray(g), interpret=True,
    )
    np.testing.assert_allclose(d0, np.asarray(k0).transpose(0, 2, 1), atol=ATOL)
    np.testing.assert_allclose(d1, np.asarray(k1).transpose(0, 2, 1), atol=ATOL)
    np.testing.assert_allclose(dc, np.asarray(kc), atol=ATOL)
    # autodiff of the gather oracle
    _, vjp = jax.vjp(jcorr.corr_block_lookup_levels, *map(jnp.asarray, (c0, c1, coords)))
    w0, w1, wc = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d0, np.asarray(w0), atol=ATOL)
    np.testing.assert_allclose(d1, np.asarray(w1), atol=ATOL)
    np.testing.assert_allclose(dc, np.asarray(wc), atol=ATOL)
    # far-out centres: zero map gradients and a zero coordinate gradient
    assert not d0[-3:].any() and not d1[-3:].any() and not dc[-3:].any()


def test_lookup_backward_plain_matches_jax_bf16():
    """bf16 maps: f32 patch arithmetic, each d_map value cast once, within
    one bf16 ulp of the JAX kernels' on the same bf16 values."""
    c0, c1, coords, g = _lookup_case(32, 16, seed=7, dtype="bf16")
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731  (exact: values are bf16)
    d0, d1, dc = corr_lookup_bwd_plain(tb(c0), tb(c1), _t(coords), _t(g))
    assert d0.dtype == d1.dtype == torch.bfloat16 and dc.dtype == torch.float32
    jb = lambda a: jnp.asarray(a.transpose(0, 2, 1), jnp.bfloat16)  # noqa: E731
    k0, k1, kc = _corr_lookup_pallas_pret_bwd_impl(
        jb(c0), jb(c1), jnp.asarray(coords), jnp.asarray(g), interpret=True
    )
    for got, want in ((d0, k0), (d1, k1)):
        want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1)
        assert bool((np.abs(got.float().numpy() - want) <= _bf16_ulp(want)).all())
    np.testing.assert_allclose(dc.numpy(), np.asarray(kc), atol=ATOL)


def test_lookup_backward_plain_matches_torch_autograd():
    c0, c1, coords, g = map(_t, _lookup_case(30, 16, seed=3))
    leaves = [t.clone().requires_grad_(True) for t in (c0, c1, coords)]
    want = torch.autograd.grad(corr_lookup_plain(*leaves), leaves, g)
    for got, w in zip(corr_lookup_bwd_plain(c0, c1, coords, g), want):
        torch.testing.assert_close(got, w, rtol=0, atol=ATOL)


def test_lookup_function_on_cpu_matches_jax_vjp():
    """`CorrLookupFn` through torch.autograd.grad: the forward and both
    backward wrappers take their plain versions and count no launch."""
    c0, c1, coords, g = _lookup_case(36, 16, seed=11)
    launches = (corr_lookup.launches, corr_lookup_bwd.launches)
    leaves = [_t(a).requires_grad_(True) for a in (c0, c1, coords)]
    out = CorrLookupFn.apply(*leaves)
    got = torch.autograd.grad(out, leaves, _t(g))
    assert (corr_lookup.launches, corr_lookup_bwd.launches) == launches
    want_out, vjp = jax.vjp(jcorr.corr_block_lookup_levels, *map(jnp.asarray, (c0, c1, coords)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=ATOL)
    for a, b in zip(got, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


# ------------------------------------------------------------------ warp --


def _warp_vjp_pair(jfn, tfn, img, coords, seed):
    """Forward and (d_img, d_coords) of a JAX warp and its port counterpart."""
    out, vjp = jax.vjp(jfn, jnp.asarray(img), jnp.asarray(coords))
    g = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jd_img, jd_coords = vjp(jnp.asarray(g))
    timg = nchw(img).requires_grad_(True)
    tcoords = torch.from_numpy(coords).requires_grad_(True)
    tout = tfn(timg, tcoords)
    tg = torch.from_numpy(np.moveaxis(g, -1, 1).copy())
    d_img, d_coords = torch.autograd.grad(tout, (timg, tcoords), tg)
    np.testing.assert_allclose(np.moveaxis(tout.detach().numpy(), 1, -1), np.asarray(out),
                               atol=ATOL)
    np.testing.assert_allclose(to_nhwc(d_img), np.asarray(jd_img), atol=ATOL)
    np.testing.assert_allclose(d_coords.numpy(), np.asarray(jd_coords), atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_forward_and_gradients(padding_mode, align_corners):
    rng = np.random.RandomState(2)
    img = rng.randn(2, 9, 11, 4).astype(np.float32)
    grid = rng.uniform(-1.4, 1.4, (2, 6, 5, 2)).astype(np.float32)
    grid[0, 0, :3] = [[-1, -1], [1, 1], [0, 0]]  # exact corners and centre
    kw = {"align_corners": align_corners, "padding_mode": padding_mode}
    _warp_vjp_pair(lambda i, gr: jsampler.grid_sample(i, gr, **kw),
                   lambda i, gr: tsampler.grid_sample(i, gr, **kw), img, grid, seed=3)


def test_sample_pixel_forward_and_gradients():
    rng = np.random.RandomState(4)
    img = rng.randn(2, 12, 10, 5).astype(np.float32)
    coords = rng.uniform(-2.0, 13.0, (2, 7, 6, 2)).astype(np.float32)
    coords[0, 0, :3] = [[0.0, 0.0], [9.0, 11.0], [4.0, 5.5]]  # integer and edge points
    _warp_vjp_pair(jsampler.sample_pixel, tsampler.sample_pixel, img, coords, seed=5)


def test_warp_of_an_input_image_launches_no_splat(monkeypatch):
    """d_img is computed only when the image needs a gradient: a warp of an
    input frame gives its coordinates their gradient without the splat."""
    calls = []
    monkeypatch.setattr(tsampler, "splat", lambda *a: calls.append(1) or splat_plain(*a))
    img = torch.rand(1, 3, 8, 8)
    coords = (torch.rand(1, 5, 5, 2) * 7).requires_grad_(True)
    tsampler.sample_pixel(img, coords).sum().backward()
    assert coords.grad is not None and not calls
    feat = torch.rand(1, 3, 8, 8, requires_grad=True)
    tsampler.sample_pixel(feat, coords.detach()).sum().backward()
    assert feat.grad is not None and len(calls) == 1


# ------------------------------------------------------ random transform --


@pytest.fixture
def transform():
    theta, cpar = transform_arrays(2, seed=8)
    jp = jtps.RandomTransformParams(jnp.asarray(theta), jnp.asarray(np.asarray(
        make_coordinate_grid(5, 5).reshape(1, 25, 2))), jnp.asarray(cpar))
    tp = ttps.RandomTransformParams(torch.from_numpy(theta),
                                    make_coordinate_grid(5, 5).reshape(1, 25, 2),
                                    torch.from_numpy(cpar))
    kp = np.tanh(np.random.RandomState(9).randn(2, 10, 2)).astype(np.float32)
    return jp, tp, kp


def test_random_transform_warp_and_frame(transform):
    jp, tp, kp = transform
    np.testing.assert_allclose(ttps.random_transform_warp(tp, torch.from_numpy(kp)).numpy(),
                               np.asarray(jtps.random_transform_warp(jp, jnp.asarray(kp))),
                               atol=ATOL)
    frame = np.random.RandomState(10).rand(2, 32, 32, 3).astype(np.float32)
    want = jtps.random_transform_frame(jp, jnp.asarray(frame))
    got = ttps.random_transform_frame(tp, nchw(frame))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=ATOL)


def test_random_transform_jacobian_and_its_gradient(transform):
    """The forward-mode jacobian, and its gradient with respect to the
    keypoints (the jacobian equivariance loss trains through it)."""
    jp, tp, kp = transform
    w = np.random.RandomState(12).randn(2, 10, 2, 2).astype(np.float32)
    want = jtps.random_transform_jacobian(jp, jnp.asarray(kp))
    want_grad = jax.grad(
        lambda k: jnp.sum(jtps.random_transform_jacobian(jp, k) * w))(jnp.asarray(kp))
    tkp = torch.from_numpy(kp).requires_grad_(True)
    got = ttps.random_transform_jacobian(tp, tkp)
    (got_grad,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), tkp)
    assert got.shape == (2, 10, 2, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), atol=ATOL)


# ------------------------------------------------------------------ VGG19 --


def test_vgg19_slices():
    from mrfa_tpu.nn.vgg import Vgg19 as JVgg
    from mrfa_tpu_torch.nn.vgg import Vgg19
    from mrfa_tpu_torch.utils.convert import load_jax_variables

    x = np.random.RandomState(13).rand(2, 32, 32, 3).astype(np.float32)
    jv = JVgg()
    variables = jax_init(jv, jnp.asarray(x))
    want = jax_apply(jv, variables, jnp.asarray(x))
    vgg = Vgg19()
    load_jax_variables(vgg, variables)
    assert not any(p.requires_grad for p in vgg.parameters())  # frozen
    got = vgg(nchw(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(to_nhwc(g) - w).max()) <= 1e-4 * scale


# -------------------------------------------------------------- optimizer --


class _Model(torch.nn.Module):
    """The MRFA subtrees the optimizer sees, at toy size, and a frozen `vgg`."""

    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(3, 4)
        self.decoder = torch.nn.Linear(4, 2)
        self.dense_motion = torch.nn.Linear(2, 3)
        self.vgg = torch.nn.Linear(2, 2).requires_grad_(False)


def test_optimizer_matches_optax_across_a_milestone():
    """Adam (0.5, 0.999), the MultiStep drop at epoch 1 x 2 steps/epoch (the
    third update runs at lr / 10), inf-norm clipping at 10 on the encoder
    and the dense motion network only, over three steps of the same
    gradients (large enough to clip)."""
    from mrfa_tpu.train.optim import MAIN_SUBTREES
    from mrfa_tpu.train.optim import clip_inf_norm_subtrees as jclip
    from mrfa_tpu.train.optim import make_optimizer as jmake
    from mrfa_tpu_torch.train.optim import clip_inf_norm_subtrees, make_optimizer
    from mrfa_tpu_torch.utils.convert import _to_torch_layout, flax_path

    model = _Model()
    rng = np.random.RandomState(14)
    params = {}
    for key, t in model.state_dict().items():
        _, path = flax_path(key, t.dim())
        leaf = rng.randn(*(t.shape[::-1] if t.dim() == 2 else t.shape)).astype(np.float32)
        params.setdefault(path[0], {})[path[1]] = leaf
        t.copy_(torch.from_numpy(_to_torch_layout(leaf, key, t.dim()).copy()))
    jparams = jax.tree.map(jnp.asarray, params)
    lr, spe = 1e-2, 2
    tx = jmake(jparams, lr, [1], spe, MAIN_SUBTREES)
    state = tx.init(jparams)
    opt, sched = make_optimizer(model, lr, [1], spe)
    for step in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(30 * rng.randn(*a.shape), jnp.float32),
                             jparams)
        updates, state = tx.update(jclip(grads, 10.0), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            _, path = flax_path(name, p.dim())
            p.grad = torch.from_numpy(_to_torch_layout(
                np.asarray(grads[path[0]][path[1]]), name, p.dim()).copy())
        clip_inf_norm_subtrees(model, 10.0)
        opt.step()
        sched.step()
        for key, t in model.state_dict().items():
            _, path = flax_path(key, t.dim())
            want = _to_torch_layout(np.asarray(jparams[path[0]][path[1]]), key, t.dim())
            np.testing.assert_allclose(t.numpy(), want, atol=1e-6, err_msg=f"{key} step {step}")
    assert sched.get_last_lr() == [pytest.approx(lr * 0.1)]
