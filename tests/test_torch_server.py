"""The port's multi-stream server against mrfa_tpu.serving.AnimationServer,
on the CPU.

The MTIA model at 64 px with 3-block hourglasses and a 1-layer TokenPose
(every width the flagship's), JAX-initialized weights moved off their initial
values; S=3 streams with different smooth sources, with and without the
per-stream movement scale: `serve` and `serve_chunk` (K=2) against JAX's,
the per-stream scales against JAX's, and each stream against a port
`Animator` that runs it alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.serving import AnimationServer as JServer
from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.serving import AnimationServer, stream_scales
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    mtia_cfg, one_torch_thread, perturbed, smooth_image,
)

SIZE = 64
STREAMS = 3
# the whole frame at f32 (keypoints, dense motion, six refinement
# iterations, decode): outputs in [0, 1], as tests/test_torch_frame.py
ATOL = 1e-4


@pytest.fixture(scope="module")
def servers():
    cfg = mtia_cfg(SIZE, blocks=3, depth=1)
    jmodel = JMRFA(cfg)
    dummy = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    variables = perturbed(
        jax.jit(lambda k: jmodel.init(k, dummy, dummy))(jax.random.PRNGKey(0)), seed=0
    )
    server = AnimationServer(MRFA(cfg, device="cpu"), variables, device="cpu")
    animator = Animator(MRFA(cfg, device="cpu"), variables, device="cpu")
    sources = smooth_image(STREAMS, SIZE, seed=1)
    # (T, S, H, W, 3): frame 0 opens the streams, frames 1-2 drive them
    clips = smooth_image(3 * STREAMS, SIZE, seed=2).reshape(3, STREAMS, SIZE, SIZE, 3)
    return JServer(jmodel, variables), server, animator, sources, clips


@pytest.mark.parametrize("adapt", [False, True], ids=["scale_1", "adapt_scale"])
def test_server_matches_jax(servers, adapt):
    jserver, server, _, sources, clips = servers
    jstate = jserver.open_streams(sources, clips[0], adapt_movement_scale=adapt)
    state = server.open_streams(sources, clips[0], adapt_movement_scale=adapt)
    scale = state.scale.numpy()
    np.testing.assert_allclose(scale, np.asarray(jstate.scale), rtol=1e-5)
    if adapt:  # each stream its own scale
        assert len(set(scale.tolist())) == STREAMS
    want = np.asarray(jserver.serve(jstate, clips[1]))
    got = server.serve(state, clips[1])
    assert tuple(got.shape) == (STREAMS, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    want_chunk = np.asarray(jserver.serve_chunk(jstate, clips[1:]))
    got_chunk = server.serve_chunk(state, clips[1:])
    assert tuple(got_chunk.shape) == (2, STREAMS, SIZE, SIZE, 3)
    np.testing.assert_allclose(got_chunk.numpy(), want_chunk, atol=ATOL)
    np.testing.assert_array_equal(got_chunk[0].numpy(), got.numpy())  # K=1 is serve


def test_stream_scales_are_per_stream(servers):
    """A stream's scale is its own keypoints' hull ratio: permuting the
    streams permutes the scales (sample 0's ratio alone would not)."""
    _, server, _, sources, clips = servers
    state = server.open_streams(sources, clips[0])
    scales = stream_scales(state.kp_source, state.kp_driving_initial)
    perm = [2, 0, 1]
    flipped = server.open_streams(sources[perm], clips[0][perm])
    np.testing.assert_allclose(stream_scales(flipped.kp_source, flipped.kp_driving_initial),
                               scales[perm], rtol=1e-5)


@pytest.mark.parametrize("adapt", [False, True], ids=["scale_1", "adapt_scale"])
def test_each_stream_matches_an_animator_alone(servers, adapt):
    _, server, animator, sources, clips = servers
    state = server.open_streams(sources, clips[0], adapt_movement_scale=adapt)
    got = server.serve_chunk(state, clips[1:])
    for s in range(STREAMS):
        clip = animator.begin(sources[s], clips[0, s], adapt_movement_scale=adapt)
        for k in range(2):
            want = animator.animate_frame(clip, clips[1 + k, s])[0][0]
            np.testing.assert_allclose(got[k, s].numpy(), want.numpy(), atol=ATOL,
                                       err_msg=f"stream {s} frame {k}")
    assert server._graph is None  # graphs are captured on CUDA only
