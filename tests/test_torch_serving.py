"""The rest of the port's serving surface against the JAX package, on the CPU:
the bf16 policy, the weight pre-cast, `prior_only`, `animate_chunk` and
`make_animation_from_best_frame`.

The MTIA model at 64 px with 3-block hourglasses and a 1-layer TokenPose
(every width the flagship's). Weights: the port's random initialization,
carried into the JAX package by its own torch converter and moved off their
initial values (`perturbed`), then loaded back into the port, so both sides
hold the same values. The JAX policy is a process-wide setting: each use sets
it and restores None.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfa_tpu import precision as jprecision
from mrfa_tpu.animate import Animator as JAnimator
from mrfa_tpu.models.mrfa import MRFA as JMRFA
from mrfa_tpu.utils.torch_convert import convert_state_dict
from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.precision import cast_params_for_inference
from mrfa_tpu_torch.utils.convert import flax_path
from tests.torch_parity import image, mtia_cfg, perturbed, smooth_image

SIZE = 64
ATOL = 1e-4  # f32 frames, as tests/test_torch_frame.py
BF16_MEAN = 0.02  # bf16 policy against f32, mean abs (tests/test_precision.py)
# The port's bf16-to-f32 distance over the JAX package's, (mean, max) abs, on
# one frame. Readings at this size over 5 frames x 2 weight seeds
# (tests/torch_bf16_precision.py, PERF.md): white noise mean 1.04-2.92, max
# 0.88-1.40; smooth mean 0.98-1.65, max 0.31-0.72. On noise the JAX
# package's own distance moves 2.2x with how its step is cut into jitted
# programs, so the noise bound is the looser one.
FRAME_RATIO = {"noise": (3.0, 1.5), "smooth": (1.75, 1.0)}
# the same per module from f32 inputs; readings 0.22-1.05 (mean), 0.31-1.32 (max)
MODULE_RATIO = 1.5


@contextlib.contextmanager
def jax_policy(dtype):
    jprecision.set_compute_dtype(dtype)
    try:
        yield
    finally:
        jprecision.set_compute_dtype(None)


def _variables(cfg, seed):
    torch.manual_seed(seed)
    return perturbed(convert_state_dict(MRFA(cfg, device="cpu").state_dict()), seed=seed)


@pytest.fixture(scope="module")
def clip():
    return image(1, SIZE, seed=1)[0], image(5, SIZE, seed=2)


@pytest.fixture(scope="module")
def smooth_clip():
    return smooth_image(1, SIZE, seed=1)[0], smooth_image(5, SIZE, seed=2)


@pytest.fixture(scope="module")
def f32_pair():
    cfg = mtia_cfg(SIZE, blocks=3, depth=1)
    variables = _variables(cfg, seed=0)
    janimator = JAnimator(JMRFA(cfg), variables)
    animator = Animator(MRFA(cfg, device="cpu"), variables, device="cpu")
    return cfg, variables, janimator, animator


OUTPUTS = ("generated", "warped source")


def _frame(animator, source, driving, t: int = 1):
    """The generated frame and the warped source of driving[t], f32 numpy."""
    out = animator.animate_frame(animator.begin(source, driving[0]), driving[t])
    return [np.asarray(o[0], dtype=np.float32) for o in out[:2]]


def _dist(a, b):
    """(max abs, mean abs) between two float arrays."""
    d = np.abs(np.asarray(a, dtype=np.float32) - np.asarray(b, dtype=np.float32))
    return float(d.max()), float(d.mean())


def bf16_frame_distances(cfg, variables, clips, frames=(1,), f32_animators=None):
    """{(clip, t, output): (port, jax, f32)}: the (max, mean) abs distance of
    the bf16 frame from the f32 frame of the same input through `Animator`,
    in the port and in the JAX package, and the max abs distance of the two
    f32 frames, for the driving frames `frames` of each (source, driving)
    clip."""
    janimator, animator = f32_animators or (
        JAnimator(JMRFA(cfg), variables), Animator(MRFA(cfg, device="cpu"), variables,
                                                   device="cpu"))
    with jax_policy(jnp.bfloat16):
        jbf16 = JAnimator(JMRFA(cfg), variables)
        jb = {(kind, t): _frame(jbf16, *c, t) for kind, c in clips.items() for t in frames}
    pbf16 = Animator(MRFA(cfg, device="cpu", compute_dtype=torch.bfloat16), variables,
                     device="cpu")
    out = {}
    for kind, (source, driving) in clips.items():
        for t in frames:
            jf, pf, pb = (_frame(a, source, driving, t) for a in (janimator, animator, pbf16))
            for i, name in enumerate(OUTPUTS):
                out[kind, t, name] = (_dist(pb[i], pf[i]), _dist(jb[kind, t][i], jf[i]),
                                      _dist(pf[i], jf[i])[0])
    return out


def bf16_module_distances(cfg, variables, source, frame):
    """{output: (port, jax, f32)} for each module under the policy, fed the
    f32 outputs of the modules before it: the keypoints of `frame`, dense
    motion from the f32 keypoints of `source` and `frame`, RaftFlow's
    generated frame and warped source from the f32 keypoints and motion.
    port and jax: the (max, mean) abs distance of the bf16 output from the
    f32 output; f32: the max abs distance of the two f32 outputs."""
    import jax

    from mrfa_tpu.ops.resize import AntiAliasParams
    from mrfa_tpu.ops.resize import antialias_downsample as jdownsample
    from mrfa_tpu_torch.ops.resize import antialias_downsample

    jmodel = JMRFA(cfg)

    def jax_inputs(m, s, d):
        kps, kpd = m.encode_kp(s), m.encode_kp(d)
        return kps, kpd, m.run_dense_motion(s, kpd, kps, None, False, 0.0, False)

    def jax_stages(m, s, d, kps, kpd, dm):
        motion = m.run_dense_motion(s, kpd, kps, None, False, 0.0, False)
        down = jdownsample(s, AntiAliasParams.create(0.25))
        out, warp, _ = m.decoder(m.kp_for_decoder(kps), m.kp_for_decoder(kpd), dm, img=down,
                                 img_full=s, train=False, source_cache=None)
        return {"kp": m.encode_kp(d)["kp"], "deformation": motion["deformation"],
                "occlusion": motion["occlusion"][..., 0], "generated": out,
                "warped source": warp}

    s, d = jnp.asarray(source[None]), jnp.asarray(frame[None])
    inputs = jax.jit(lambda v: jmodel.apply(v, s, d, method=jax_inputs))(variables)
    jf = jax.jit(lambda v: jmodel.apply(v, s, d, *inputs, method=jax_stages))(variables)
    with jax_policy(jnp.bfloat16):
        cast = jprecision.cast_params_for_inference(variables)
        jb = jax.jit(lambda v: jmodel.apply(v, s, d, *inputs, method=jax_stages))(cast)

    def port_stages(a, kps, kpd, dm):
        m = a.model
        with torch.inference_mode():
            s, d = a._image(source), a._image(frame)
            motion = m.run_dense_motion(s, kpd, kps)
            out, warp, _ = m.decoder(m.kp_for_decoder(kps), m.kp_for_decoder(kpd), dm,
                                     antialias_downsample(s, 0.25), s)
            return {"kp": m.encode_kp(d)["kp"], "deformation": motion["deformation"],
                    "occlusion": motion["occlusion"][:, 0], "generated": out,
                    "warped source": warp}

    animator = Animator(MRFA(cfg, device="cpu"), variables, device="cpu")
    with torch.inference_mode():
        m = animator.model
        s, d = animator._image(source), animator._image(frame)
        kps, kpd = m.encode_kp(s), m.encode_kp(d)
        dm = m.run_dense_motion(s, kpd, kps)
    pf = port_stages(animator, kps, kpd, dm)
    pb = port_stages(Animator(MRFA(cfg, device="cpu", compute_dtype=torch.bfloat16), variables,
                              device="cpu"), kps, kpd, dm)
    out = {}
    for k in jf:
        p = [t.float() for t in (pf[k], pb[k])]
        p = [(t.permute(0, 2, 3, 1) if t.dim() == 4 and k != "deformation" else t).numpy()
             for t in p]  # NHWC, as the JAX outputs
        out[k] = (_dist(p[1], p[0]), _dist(jb[k], jf[k]), _dist(p[0], jf[k])[0])
    return out


def test_bf16_policy_frames_against_f32_and_jax(f32_pair, clip, smooth_clip):
    """The bf16 frame against the f32 frame of the same inputs, in the port
    and in the JAX package, on white-noise and on smooth frames: each within
    the JAX test's bound, and the port's distance within FRAME_RATIO times
    the JAX package's."""
    cfg, variables, janimator, animator = f32_pair
    distances = bf16_frame_distances(cfg, variables, {"noise": clip, "smooth": smooth_clip},
                                     f32_animators=(janimator, animator))
    for (kind, _, name), (port, jax_, f32) in distances.items():
        mean_ratio, max_ratio = FRAME_RATIO[kind]
        assert f32 <= ATOL, (kind, name, f32)
        if name == "generated":
            assert port[1] < BF16_MEAN and jax_[1] < BF16_MEAN, (kind, port, jax_)
        assert port[1] <= mean_ratio * jax_[1], (kind, name, port, jax_)
        assert port[0] <= max_ratio * jax_[0], (kind, name, port, jax_)


def test_bf16_policy_modules_against_jax(f32_pair, clip):
    """Each module under the policy, fed the f32 outputs of the modules before
    it (keypoints, dense motion, RaftFlow): each bf16 output's distance from
    its f32 output (max and mean abs) is within MODULE_RATIO times the JAX
    package's."""
    cfg, variables, _, _ = f32_pair
    source, driving = clip
    for k, (port, jax_, f32) in bf16_module_distances(cfg, variables, source,
                                                      driving[1]).items():
        assert f32 <= ATOL, (k, f32)
        assert port[0] <= MODULE_RATIO * jax_[0], (k, port, jax_)
        assert port[1] <= MODULE_RATIO * jax_[1], (k, port, jax_)


def test_bf16_policy_dtypes_match_jax(f32_pair, clip):
    """Under the policy, the output dtype of every module the frame step runs
    (each convolution, dense and norm layer, each block, the keypoint
    encoder's and dense motion's outputs by key, the decoder's outputs)
    equals the JAX package's: the policy casts at the same sites."""
    import collections

    import jax

    from mrfa_tpu.ops.resize import AntiAliasParams
    from mrfa_tpu.ops.resize import antialias_downsample as jdownsample
    from mrfa_tpu_torch.ops.resize import antialias_downsample
    from mrfa_tpu_torch.utils.convert import _fold_indices

    cfg, variables, _, _ = f32_pair
    source, driving = clip

    def jax_step(m, s, d):
        kps, kpd = m.encode_kp(s), m.encode_kp(d)
        dm = m.run_dense_motion(s, kpd, kps, None, False, 0.0, False)
        return m.decoder(m.kp_for_decoder(kps), m.kp_for_decoder(kpd), dm,
                         img=jdownsample(s, AntiAliasParams.create(0.25)), img_full=s,
                         train=False, source_cache=None)

    jmodel = JMRFA(cfg)
    s, d = jnp.asarray(source[None]), jnp.asarray(driving[1:2])
    with jax_policy(jnp.bfloat16):
        cast = jprecision.cast_params_for_inference(variables)
        _, state = jax.jit(lambda v: jmodel.apply(
            v, s, d, method=jax_step, capture_intermediates=True, mutable=["intermediates"],
        ))(cast)
    want = collections.defaultdict(set)
    for path, leaf in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
        keys = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)]
        call = keys.index("__call__")  # the module's path, then its output's keys
        want[tuple(keys[:call] + keys[call + 1:])].add(str(leaf.dtype))

    animator = Animator(MRFA(cfg, device="cpu", compute_dtype=torch.bfloat16), variables,
                        device="cpu")
    got = collections.defaultdict(set)

    def record(name):
        path = tuple(_fold_indices(name.split(".")))

        def hook(module, args, out):
            items = out.items() if isinstance(out, dict) else (
                ((), t) for t in (out if isinstance(out, (tuple, list)) else [out]))
            for key, t in items:
                if torch.is_tensor(t):
                    got[path + ((key,) if key != () else ())].add(
                        str(t.dtype).replace("torch.", ""))
        return hook

    m = animator.model
    for name, module in m.named_modules():
        if name:
            module.register_forward_hook(record(name))
    with torch.inference_mode():
        s, d = animator._image(source), animator._image(driving[1])
        kps, kpd = m.encode_kp(s), m.encode_kp(d)
        m.decoder(m.kp_for_decoder(kps), m.kp_for_decoder(kpd), m.run_dense_motion(s, kpd, kps),
                  antialias_downsample(s, 0.25), s)
    common = set(want) & set(got)
    assert len(common) > 500 and len(set(want) - common) <= 1, sorted(set(want) - common)
    assert {("encoder", "kp"), ("dense_motion", "deformation"), ("decoder",)} <= common
    assert [(k, want[k], got[k]) for k in sorted(common) if want[k] != got[k]] == []


def test_cast_params_for_inference_casts_the_leaves_jax_casts(f32_pair):
    cfg, variables, _, _ = f32_pair
    jcast = jprecision.cast_params_for_inference(variables, jnp.bfloat16)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    want = {p for p, v in leaves(jcast["params"]) if v.dtype == jnp.bfloat16}
    model = MRFA(cfg, device="cpu")
    cast = cast_params_for_inference(model, torch.bfloat16)
    state = model.state_dict()
    got = {flax_path(k, state[k].dim())[1] for k in cast}
    assert got == want and len(got) > 100
    assert model.encoder.transformer.mlp_head_jacobian[1].weight.dtype == torch.float32
    assert model.decoder.pos_embedding.dtype == torch.float32
    assert model.decoder.kp_head.bias.dtype == torch.float32
    # under the policy the f32 head computes in f32, every other layer in bf16
    policy = MRFA(cfg, device="cpu", compute_dtype=torch.bfloat16)
    assert policy.encoder.transformer.mlp_head_jacobian[1].compute_dtype is None
    assert policy.encoder.transformer.mlp_head[1].compute_dtype == torch.bfloat16
    assert policy.decoder.kp_head.compute_dtype == torch.bfloat16


def test_prior_only_frame_matches_jax(clip):
    cfg = mtia_cfg(SIZE, blocks=3, depth=1)
    cfg["raft_flow"]["prior_only"] = True
    variables = _variables(cfg, seed=3)
    source, driving = clip
    janimator = JAnimator(JMRFA(cfg), variables)
    want = janimator.animate_frame(janimator.begin(source, driving[0]), driving[1])
    animator = Animator(MRFA(cfg, device="cpu"), variables, device="cpu")
    got = animator.animate_frame(animator.begin(source, driving[0]), driving[1])
    assert not hasattr(animator.model.decoder, "kp_head")
    for name, g, w in zip(("generated", "warped source", "occlusion strip"), got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)


def test_animate_chunk_equals_frame_by_frame(f32_pair, clip):
    _, _, _, animator = f32_pair
    source, driving = clip
    state = animator.begin(source, driving[0])
    chunk = animator.animate_chunk(state, driving[1:4])
    assert tuple(chunk.shape) == (3, 1, SIZE, SIZE, 3)
    for k in range(3):
        assert torch.equal(chunk[k], animator.animate_frame(state, driving[1 + k])[0])
    chunked = animator.make_animation(source, driving, chunk=2)
    single = animator.make_animation(source, driving)
    assert len(chunked) == len(single) == 5
    for a, b in zip(chunked, single):
        np.testing.assert_array_equal(a, b)


def test_make_animation_from_best_frame_matches_jax(f32_pair, clip):
    _, _, janimator, animator = f32_pair
    source, driving = clip
    frames = np.concatenate([driving[:1], source[None], driving[1:2]])  # T = 3, best is 1
    want = janimator.make_animation_from_best_frame(source, frames)
    got = animator.make_animation_from_best_frame(source, frames)
    assert animator.find_best_frame(source, frames) == 1
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL)
