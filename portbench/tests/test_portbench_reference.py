"""The frozen reference against the port, on the CPU at 64 px, from the same
weights and inputs. On the CPU the port runs its kernels' plain versions,
which the reference copies, and the same operations in the same order, so
the serving frame and the training step agree to float32 round-off: the
tolerances are a few ulps of the values compared (1e-6 relative)."""
import pytest
import torch

from portbench import inputs
from portbench.entries.train_step import generators
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.reference.models.mrfa import MRFA as RefMRFA
from portbench.tests.small import SIZE, model_cfg
from portbench.weights import make_weights

MOTION = {"texture_side": 8, "translate": 0.1, "rotate": 0.15, "zoom": 0.08,
          "period_frames": [48, 160]}
SEED = 2 ** 33 + 17
INIT = {"pos_embedding": {"uniform": 0.0346}, "keypoint_token": {"uniform": 0.0346},
        "mlp_head_jacobian.1.weight": "zeros", "mlp_head_jacobian.1.bias": [1.0, 0.0, 0.0, 1.0],
        "fg_encoder.fc.bias": {"logit_spread": 0.7}}


def nchw(x):
    return x.float().permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("config", ["vox1-mtia", "vox1-tpsm"])
def test_serving_frame_equals_port(config):
    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = model_cfg(config)
    weights = make_weights(cfg, SEED, "cpu", INIT)
    clips = inputs.driving_clips(2, 3, SIZE, MOTION, SEED, "cpu")
    sources = inputs.sources(1, 2, SIZE, MOTION, SEED, "cpu")[0]
    animator = Animator(MRFA(cfg, device="cpu"), weights, device="cpu")
    state = animator.begin(sources, clips[0])
    got = animator.animate_frame(state, clips[2])[0]
    ref = RefMRFA(cfg, "cpu")
    ref.load_state_dict(weights)
    clip = ref_serve.Clip(ref.eval(), nchw(sources), nchw(clips[0]))
    want = clip.frame(nchw(clips[2])).permute(0, 2, 3, 1)
    assert float((got - want).abs().max()) <= 1e-6
    assert float((got[0] - got[1]).abs().mean()) > 1e-3  # the streams differ


@pytest.mark.parametrize("config,dropout_p", [("vox1-mtia", None), ("vox1-tpsm", 0.1)])
def test_training_step_equals_port(config, dropout_p):
    from mrfa_tpu_torch.train.trainer import Trainer

    cfg = model_cfg(config)
    weights = make_weights(cfg, SEED, "cpu", INIT)
    src, drv = inputs.training_pairs(2, 2, SIZE, MOTION, SEED, "cpu")
    gen, dgen = generators(SEED)
    port = Trainer(cfg, device="cpu", weights=weights, generator=gen, dropout_generator=dgen)
    gen, dgen = generators(SEED)
    ref = ref_train.Trainer(cfg, weights, "cpu", gen, dgen, dropout_p)
    for step in range(2):
        terms, _ = port.train_step({"source": src[step], "driving": drv[step]},
                                   dropout_flag=dropout_p is not None,
                                   dropout_p=dropout_p or 0.0)
        want = ref.step(nchw(src[step]), nchw(drv[step]))
        assert set(terms) == set(want)
        for k in want:
            assert abs(float(terms[k]) - float(want[k])) <= 1e-6 * abs(float(want[k])), k
    got = dict(port.model.named_parameters())
    for name, p in ref.model.named_parameters():
        assert float((got[name] - p).abs().max()) <= 1e-6 * max(float(p.abs().max()), 1e-6), name
    moved = [n for n, p in ref.model.named_parameters()
             if n.split(".")[0] in ref_train.MAIN_SUBTREES and not torch.equal(p, weights[n])]
    assert len(moved) > 100
