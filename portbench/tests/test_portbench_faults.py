"""The check against what it must catch, on the CPU at 64 px, with each
cell's limits as the workload files state them: a sound run is correct;
the control (the reference one precision below the configuration's, put in
the program's place) fails at least one number; and a run with its timed
path broken underneath, once for each fault the cell can have, comes out
not correct. The harness runs as the command drives it, past its look for
a card. (One card: no exchange between chips to leave out.)"""
import pytest

from portbench import calibrate, harness
from portbench.tests.small import BENCH, LEFT_OUT, LIVE, add_cell, cell_args

SEED = 2 ** 34 + 9
SERVING = ["vox1-mtia.serve-s8-bf16-graph", "vox1-mtia.serve-s1-bf16-graph", LIVE["name"]]
TRAINING = ["vox1-mtia.train-b10-f32", "vox1-tpsm.train-b10-f32"]


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """BENCHMARK.json's cells and the cells left out of it beside them."""
    return add_cell(tmp_path, monkeypatch, LEFT_OUT)


def run(bench, cell, after_check=None, seconds=0.2):
    result, _ = harness.run(cell, SEED, seconds, False, after_check=after_check,
                            **cell_args(cell, bench))
    return result


@pytest.mark.parametrize("cell", SERVING + TRAINING)
def test_a_sound_run_is_correct(bench, cell):
    result = run(bench, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell", SERVING + TRAINING)
def test_the_control_fails(bench, cell):
    hook = calibrate.serving_control if cell in SERVING else calibrate.training_control
    result = run(bench, cell, hook)
    limits = harness.load_json(harness.ROOT / "workloads" / f"{cell}.json")["limits"]
    control = result["calibration"]["control"]
    assert any(control[k] > limits[k] for k in control if limits.get(k) is not None), control


def _alter(out):
    out = out.clone()
    out[..., 0, :, :, :] = 1.0 - out[..., 0, :, :, :]  # stream 0's frames, produced wrong
    return out


def _half(out):
    out = out.clone()
    s = out.shape[-4]
    out[..., s // 2:, :, :, :] = out[..., :s // 2, :, :, :].mean(-4, keepdim=True)
    return out


@pytest.mark.parametrize("fault", ["altered", "half_the_streams", "stale"])
def test_a_broken_server_is_caught(bench, fault, monkeypatch):
    from mrfa_tpu_torch.serving import AnimationServer

    plain = AnimationServer.serve_chunk
    first = {}

    def broken(self, state, frames):
        out = plain(self, state, frames)
        if fault == "stale":  # every call answers with the first call's frames
            return first.setdefault("out", out.clone())
        return _alter(out) if fault == "altered" else _half(out)

    monkeypatch.setattr(AnimationServer, "serve_chunk", broken)
    # a window long enough to re-open the streams on new sources at least once
    assert not run(bench, "vox1-mtia.serve-s8-bf16-graph", seconds=3.0)["correct"]


@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_broken_frame_step_is_caught(bench, fault, monkeypatch):
    from mrfa_tpu_torch.animate import Animator

    plain = Animator.animate_frame
    first = {}

    def broken(self, state, frame):
        out = plain(self, state, frame)
        if fault == "stale":
            return (first.setdefault("out", out[0].clone()),) + out[1:]
        return (_alter(out[0][None])[0],) + out[1:]

    monkeypatch.setattr(Animator, "animate_frame", broken)
    assert not run(bench, LIVE["name"])["correct"]


@pytest.mark.parametrize("cell", TRAINING)
@pytest.mark.parametrize("fault", ["unchanged", "half_the_batch", "altered"])
def test_a_broken_training_step_is_caught(bench, cell, fault, monkeypatch):
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.train import trainer

    if fault == "unchanged":  # the step returns its state unchanged
        monkeypatch.setattr(trainer.Trainer, "apply_gradients", lambda self, use_bg: None)
    elif fault == "half_the_batch":  # the mean over the first half of the rows
        plain = trainer.frames_to_device
        monkeypatch.setattr(trainer, "frames_to_device",
                            lambda x, device: plain(x[:len(x) // 2], device))
    else:  # the perceptual loss, produced wrong
        plain = MRFA.perceptual_loss
        monkeypatch.setattr(MRFA, "perceptual_loss", lambda self, d, g: 1.05 * plain(self, d, g))
    assert not run(bench, cell)["correct"]


def test_every_cell_is_covered():
    assert sorted(c["name"] for c in BENCH["workloads"]) == sorted(SERVING[:2])
    assert sorted(c["name"] for c in LEFT_OUT) == sorted(SERVING[2:] + TRAINING)
