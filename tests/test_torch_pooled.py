"""The port's pooled correlation lookup, its two backward routes and the
streaming probe against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode and autodiff of its
gather oracle; the port runs the plain versions its wrappers take for CPU
tensors. Tolerances are the JAX package's own (tests/test_pallas.py) where
they exist.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from mrfa_tpu.ops import pallas_kernels as pk
from mrfa_tpu.ops.corr import corr_block_lookup as jax_lookup
from mrfa_tpu.ops.resize import avg_pool as jax_avg_pool
from mrfa_tpu_torch.ops.corr_lookup import (
    CorrLookupPooledBwd,
    CorrLookupPooledFn,
    corr_lookup_pooled,
    corr_lookup_pooled_bwd_b3,
    corr_lookup_pooled_bwd_plain,
)
from mrfa_tpu_torch.ops.stream_probe import (
    BLOCKS_PER_SM,
    SLOT_BYTES,
    StreamProbe,
    launch_plan,
    stream_probe_plain,
)


def _inputs(bq, seed, lo=-12.0, hi=76.0, integer=0):
    rng = np.random.RandomState(seed)
    corr = rng.randn(bq, 64, 64).astype(np.float32)
    coords = np.stack([rng.uniform(lo, hi, bq), rng.uniform(lo, hi, bq)], -1).astype(np.float32)
    coords[:integer] = np.round(coords[:integer])  # fx = fy = 0
    g = rng.randn(bq, 98).astype(np.float32)
    return corr, coords, g


def test_pooled_forward_matches_the_jax_kernel_and_gather_oracle():
    corr, coords, _ = _inputs(24, seed=0, integer=4)
    got = corr_lookup_pooled(torch.from_numpy(corr), torch.from_numpy(coords)).numpy()
    kernel = np.asarray(pk._corr_lookup_pallas_impl(corr[..., None], coords, interpret=True))
    oracle = np.asarray(jax_lookup(jnp.asarray(corr[..., None]), jnp.asarray(coords)))
    np.testing.assert_allclose(got, kernel, atol=2e-5)
    np.testing.assert_allclose(got, oracle, atol=2e-5)


def test_pooled_forward_and_backward_of_far_out_centres_are_exact_zeros():
    corr = torch.ones(8, 64, 64)
    coords = torch.tensor([[-50.0, 5.0]] * 4 + [[5.0, 500.0]] * 4)
    assert not corr_lookup_pooled(corr, coords).any()
    d_corr, d_coords = corr_lookup_pooled_bwd_plain(corr, coords, torch.randn(8, 98))
    assert not d_corr.any() and not d_coords.any()


@pytest.fixture(scope="module")
def bwd_case():
    """B5's inputs at BQ=16 and the JAX kernel's and autodiff's answers."""
    corr, coords, g = _inputs(16, seed=1, lo=-8.0, hi=72.0)
    kernel = pk._corr_lookup_pallas_bwd_impl(corr[..., None], coords, g, interpret=True)
    _, vjp = jax.vjp(jax_lookup, jnp.asarray(corr[..., None]), jnp.asarray(coords))
    oracle = vjp(jnp.asarray(g))
    answers = {name: (np.asarray(dc)[..., 0], np.asarray(dxy))
               for name, (dc, dxy) in (("kernel", kernel), ("vjp", oracle))}
    return (corr, coords, g), answers


@pytest.mark.parametrize("reference", ["kernel", "vjp"])
def test_pooled_backward_plain_matches_jax(bwd_case, reference):
    (corr, coords, g), answers = bwd_case
    d_corr, d_coords = corr_lookup_pooled_bwd_plain(*(torch.from_numpy(a) for a in (corr, coords, g)))
    want_dc, want_dxy = answers[reference]
    # the JAX package's bounds (tests/test_pallas.py); measured here: d_corr
    # within 1e-6, d_coords within 3e-5 (sums of 98 terms in another order)
    np.testing.assert_allclose(d_corr.numpy(), want_dc, atol=2e-5)
    np.testing.assert_allclose(d_coords.numpy(), want_dxy, atol=3e-4)
    assert float(np.abs(d_corr.numpy() - want_dc).max()) <= 1e-6
    assert float(np.abs(d_coords.numpy() - want_dxy).max()) <= 3e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b3_route_and_autograd_match_the_pooled_backward(dtype):
    corr, coords, g = (torch.from_numpy(a) for a in _inputs(40, seed=2, integer=4))
    corr, g = corr.to(dtype), g.to(dtype)  # autograd hands g over in corr's dtype
    want_dc, want_dxy = corr_lookup_pooled_bwd_plain(corr, coords, g)
    got_dc, got_dxy = corr_lookup_pooled_bwd_b3(corr, coords, g)
    wrapper = CorrLookupPooledBwd()
    wrap_dc, wrap_dxy = wrapper(corr, coords, g)
    assert wrapper.launches == 0 and wrapper.library._lib is None  # plain path, no build
    torch.testing.assert_close(wrap_dc, want_dc, rtol=0, atol=0)
    torch.testing.assert_close(wrap_dxy, want_dxy, rtol=0, atol=0)
    leaves = [corr.clone().requires_grad_(True), coords.clone().requires_grad_(True)]
    auto_dc, auto_dxy = torch.autograd.grad(CorrLookupPooledFn.apply(*leaves), leaves, g)
    assert got_dc.dtype == auto_dc.dtype == dtype
    if dtype == torch.float32:
        # the same d_corr terms in the same order; d_coords sum in another order
        torch.testing.assert_close(got_dc, want_dc, rtol=0, atol=0)
        torch.testing.assert_close(got_dxy, want_dxy, rtol=0, atol=1e-5)
    else:
        # the B3 route rounds the pooled map and d_c1 to bf16 on the way
        torch.testing.assert_close(got_dc.float(), want_dc.float(), rtol=0, atol=2e-2)
        torch.testing.assert_close(got_dxy, want_dxy, rtol=0, atol=0.2)
    torch.testing.assert_close(auto_dc, want_dc, rtol=0, atol=0)
    torch.testing.assert_close(auto_dxy, want_dxy, rtol=0, atol=0)


def _jax_null_streams(c0, c1, bq):
    """The two pallas_calls of tools/probe_stream.py, rebuilt in interpret mode."""
    qb, patch = pk.QB, pk.PATCH
    n = qb * patch
    h, w = c0.shape[0] // bq, c0.shape[1]
    spec0 = pl.BlockSpec((qb * h, w), lambda i: (i, 0))
    spec1 = pl.BlockSpec((qb * (h // 2), w // 2), lambda i: (i, 0))
    out_spec = pl.BlockSpec((2, n, patch), lambda i: (0, i, 0))
    shape = jax.ShapeDtypeStruct((2, bq * patch, patch), jnp.float32)

    def null_kernel(c0_ref, c1_ref, out_ref):
        out_ref[0] = c0_ref[0:n, 0:patch]
        out_ref[1] = c1_ref[0:n, 0:patch]

    def null0_kernel(c0_ref, out_ref):
        out_ref[0] = c0_ref[0:n, 0:patch]
        out_ref[1] = c0_ref[0:n, 0:patch]

    both = pl.pallas_call(null_kernel, grid=(bq // qb,), in_specs=[spec0, spec1],
                          out_specs=out_spec, out_shape=shape, interpret=True)(c0, c1)
    l0 = pl.pallas_call(null0_kernel, grid=(bq // qb,), in_specs=[spec0],
                        out_specs=out_spec, out_shape=shape, interpret=True)(c0)
    return np.asarray(both), np.asarray(l0)


def test_stream_probe_plain_is_bit_exact_with_the_jax_null_kernels():
    bq = 32
    corr = np.random.RandomState(3).randn(bq, 64, 64, 1).astype(np.float32)
    c0 = corr[..., 0].reshape(bq * 64, 64)
    c1 = np.array(jax_avg_pool(jnp.asarray(corr), 2))[..., 0].reshape(bq * 32, 32)
    want_both, want_l0 = _jax_null_streams(c0, c1, bq)
    probe = StreamProbe()
    got_both = probe(torch.from_numpy(c0), torch.from_numpy(c1), bq, pk.QB)
    got_l0 = probe(torch.from_numpy(c0), None, bq, pk.QB)
    assert probe.launches == 0 and probe.library._lib is None
    np.testing.assert_array_equal(got_both.numpy(), want_both)
    np.testing.assert_array_equal(got_l0.numpy(), want_l0)
    np.testing.assert_array_equal(stream_probe_plain(torch.from_numpy(c0), None, bq).numpy(),
                                  want_l0)


@pytest.mark.parametrize("case", ["ragged_bq", "short_rows", "dtype", "width"])
def test_stream_probe_rejects_bad_inputs(case):
    bq = 24 if case == "ragged_bq" else 32  # 24 is no multiple of qb = 16
    c0, c1 = torch.zeros(bq * 64, 64), torch.zeros(bq * 32, 32)
    if case == "short_rows":
        c1 = torch.zeros(bq * 4, 32)
    elif case == "dtype":
        c0 = c0.double()
    elif case == "width":
        c0 = torch.zeros(bq * 64, 6)
    with pytest.raises((ValueError, TypeError)):
        StreamProbe()(c0, c1, bq, 16)


def test_probes_run_on_the_cpu_and_print_finite_numbers(capsys):
    import json

    from mrfa_tpu_torch.tools import probe_lookup, probe_stream

    assert probe_lookup.main(["both", "32", "--device", "cpu", "--calls", "2"]) == 0
    assert probe_stream.main(["--device", "cpu", "--bq", "32", "--calls", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    records = [json.loads(ln) for ln in lines]
    assert [r["probe"] for r in records] == ["lookup", "stream"]
    lookup_fns = [r["fn"] for r in records[0]["rows"]]
    assert lookup_fns == ["fwd pooled", "bwd pooled", "bwd b3+fold"]
    assert len(records[1]["rows"]) == 5
    for rec in records:
        for row in rec["rows"]:
            values = [v for k, v in row.items() if k != "fn"]
            assert all(np.isfinite(v) for v in values), row
    errs = records[0]["rows"]
    assert errs[0]["max_err"] <= 2e-5
    assert max(errs[1]["err_dcorr"], errs[2]["err_dcorr"]) <= 1e-5
    assert max(errs[1]["err_dcoords"], errs[2]["err_dcoords"]) <= 1e-4


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(levels=st.lists(st.tuples(st.integers(1, 5000), st.integers(2, 1024).map(lambda v: 4 * v)),
                       min_size=1, max_size=2),
       sms=st.integers(1, 200))
def test_stream_probe_plan_tiles_every_level_once(levels, sms):
    plan = launch_plan(levels, sms)
    # a persistent grid, each block with a stage at least
    assert 1 <= plan.blocks == min(plan.stages, BLOCKS_PER_SM * sms)
    ends = [0] * len(levels)
    for k in range(plan.stages):
        level, row0, rows, nbytes = plan.stage(k)
        lv = plan.levels[level]
        assert row0 == ends[level]  # in order, no gap and no overlap
        assert 1 <= rows <= lv.stage_rows and nbytes == rows * lv.row_bytes
        assert nbytes % 16 == 0 and nbytes <= SLOT_BYTES
        ends[level] = row0 + rows
    last = -1
    for (rows, w), lv, end in zip(levels, plan.levels, ends):
        assert end == rows and lv.row_bytes == 4 * w  # every byte of the level
        last += lv.stages  # the level's last stage, partial or whole, is copied
        assert plan.stage(last)[2] == lv.last_rows and 1 <= lv.last_rows <= lv.stage_rows


@pytest.mark.parametrize("bq,size,want", [
    (4096, 64, [(64, 4096, 64), (128, 1024, 128)]),
    (16384, 64, [(64, 16384, 64), (128, 4096, 128)]),
    (4096, 48, [(85, 2314, 3), (170, 579, 44)]),  # both levels end in a partial stage
])
def test_stream_probe_plan_at_the_probe_shapes(bq, size, want):
    plan = launch_plan([(bq * size, size), (bq * size // 2, size // 2)], sms=132)
    assert [(lv.stage_rows, lv.stages, lv.last_rows) for lv in plan.levels] == want
    assert plan.blocks == 264  # two persistent blocks on each of an H100's 132 SMs


@pytest.mark.parametrize("rows", [2 ** 31, 2 ** 33])
@pytest.mark.parametrize("level", [0, 1])
def test_stream_probe_plan_refuses_levels_of_2_31_rows(level, rows):
    shapes = [(4096 * 64, 64), (4096 * 32, 32)]
    shapes[level] = (rows, shapes[level][1])
    with pytest.raises(ValueError):
        launch_plan(shapes, sms=132)
    launch_plan([(2 ** 31 - 1, 8)], sms=132)  # the largest level it takes


def test_stream_probe_takes_unaligned_views_and_new_widths_on_the_cpu():
    """On CPU tensors the 16-byte alignment the bulk copies need does not
    apply, and a width that divides no 16 KiB slot in whole stages is taken
    as the card takes it."""
    bq, qb = 32, 16
    rng = np.random.RandomState(5)
    flat = torch.from_numpy(rng.randn(bq * 24 * 40 + 1).astype(np.float32))
    c0 = flat[1:].view(bq * 24, 40)  # storage offset 1: 4 bytes past alignment
    c1 = torch.from_numpy(rng.randn(bq * 12, 20).astype(np.float32))
    assert c0.data_ptr() % 16 and c0.is_contiguous()
    for second in (c1, None):
        got = StreamProbe()(c0, second, bq, qb)
        want = stream_probe_plain(c0.clone(), second, bq, qb)
        assert torch.equal(got, want) and got.shape == (2, bq * 8, 8)


def test_stream_probe_plain_is_bit_exact_with_the_jax_null_kernels_on_partial_stages():
    """48x48 maps: rows of 192 and 96 bytes, so both levels end in a partial
    stage of the kernel's ring."""
    bq = 32
    corr = np.random.RandomState(4).randn(bq, 48, 48, 1).astype(np.float32)
    c0 = corr[..., 0].reshape(bq * 48, 48)
    c1 = np.array(jax_avg_pool(jnp.asarray(corr), 2))[..., 0].reshape(bq * 24, 24)
    assert all(lv.last_rows < lv.stage_rows for lv in launch_plan([c0.shape, c1.shape], 1).levels)
    want_both, want_l0 = _jax_null_streams(c0, c1, bq)
    probe = StreamProbe()
    np.testing.assert_array_equal(
        probe(torch.from_numpy(c0), torch.from_numpy(c1), bq, pk.QB).numpy(), want_both)
    np.testing.assert_array_equal(probe(torch.from_numpy(c0), None, bq, pk.QB).numpy(), want_l0)


@pytest.mark.parametrize("evict_first", [True, False])
def test_stream_sweep_patches_the_ring_and_the_l2_policy(evict_first):
    from mrfa_tpu_torch.ops.cuda_build import CSRC_DIR
    from mrfa_tpu_torch.tools.stream_sweep import variant_source

    source = (CSRC_DIR / "stream_probe.cu").read_text()
    out = variant_source(source, 32768, 3, 1, evict_first)
    for line in ("constexpr int kSlotBytes = 32768;", "constexpr int kRing = 3;",
                 "constexpr int kBlocksPerSm = 1;"):
        assert line in out
    # the shipped kernel's ring matches its wrapper's plan
    assert f"constexpr int kSlotBytes = {SLOT_BYTES};" in source
    assert f"constexpr int kBlocksPerSm = {BLOCKS_PER_SM};" in source
    assert ("cache_hint" in out and "createpolicy" in out) == evict_first
    assert out.count("cp.async.bulk.shared::cluster") == 1
