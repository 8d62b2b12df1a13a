"""The port's checkpoints on the CPU: the save/restore round trip, true
resume of `loop.train` (epoch 0, save, restore, epoch 1) bit-equal to a
straight 2-epoch run, and the import of a reference `.pth` against the JAX
package's `load_torch_weights_into` followed by `load_jax_variables`."""
import os
import shutil

import numpy as np
import pytest
import torch

from mrfa_tpu_torch.utils.checkpoint import (
    latest_step,
    load_torch_weights_into,
    restore_checkpoint,
    save_checkpoint,
)
from mrfa_tpu_torch.utils.convert import flax_path, load_jax_variables
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    loop_config, one_torch_thread, reference_pth, train_cfg, with_prior, write_png_videos,
)

SIZE = 64


def _equal_trees(a, b, path=""):
    """Bit-equal nested state: tensors, numbers, strings, lists, dicts."""
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}/{i}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def test_save_restore_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(3)
    torch.randn(5, generator=gen)
    tree = {"model": {"w": torch.randn(3, 4), "n": torch.tensor(7)},
            "generator": gen.get_state(), "epoch": 4, "lrs": [1e-4, 2e-5]}
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "ckpt"))
    save_checkpoint(str(tmp_path / "ckpt"), {"epoch": 0}, step=3)
    save_checkpoint(str(tmp_path / "ckpt"), tree, step=7)
    assert latest_step(str(tmp_path / "ckpt")) == 7
    got, step = restore_checkpoint(str(tmp_path / "ckpt"))
    assert step == 7
    _equal_trees(got, tree)
    save_checkpoint(str(tmp_path / "ckpt"), tree, step=3)  # replaces step 3
    _equal_trees(restore_checkpoint(str(tmp_path / "ckpt"), step=3)[0], tree)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3", "7"]


def test_resume_is_bit_equal_to_a_straight_run(tmp_path):
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.train.loop import train

    root = str(tmp_path / "data")
    write_png_videos(root)
    cfg = loop_config(root)

    def dataset():
        return FramesDataset(is_train=True, seed=7, **cfg["dataset_params"])

    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        data_a = dataset()
        straight = train(cfg, None, str(tmp_path / "a"), data_a, seed=0, device="cpu")
    assert sorted(os.listdir(tmp_path / "a" / "ckpt")) == ["0", "1"]
    # a checkpoint is ~0.9 GB here: move the one resumed from, drop the rest
    os.makedirs(tmp_path / "r" / "ckpt")
    shutil.move(str(tmp_path / "a" / "ckpt" / "0"), str(tmp_path / "r" / "ckpt" / "0"))
    shutil.rmtree(tmp_path / "a" / "ckpt")
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        data_r = dataset()
        resumed = train(cfg, str(tmp_path / "r" / "ckpt"), str(tmp_path / "r"), data_r, seed=0,
                        device="cpu")
    want, got = straight.state_dict(), resumed.state_dict()
    assert want["step"] == got["step"] == 4
    assert set(want) == {"model", "optimizer", "scheduler", "optimizer_bg", "scheduler_bg",
                         "generator", "step"}
    # parameters, BatchNorm statistics, both optimizers' moments and steps,
    # both schedules' learning rates, the equivariance generator
    _equal_trees(got, want)
    assert straight.scheduler_bg.get_last_lr() == resumed.scheduler_bg.get_last_lr()
    np.testing.assert_array_equal(data_a.rng.get_state()[1], data_r.rng.get_state()[1])
    # the resumed run logged epoch 1 as the straight run did
    lines = (tmp_path / "a" / "log.txt").read_text().splitlines()
    assert len(lines) == 2 and "; bg - " in lines[1]
    assert (tmp_path / "r" / "log.txt").read_text().splitlines() == lines[1:]
    _equal_trees(restore_checkpoint(str(tmp_path / "r" / "ckpt"))[0]["trainer"], want)


def test_tpsm_resume_with_dropout_is_bit_equal_to_a_straight_run(tmp_path):
    """The same as above under the TPSM prior with its channel dropout on
    (epochs 0-1 < dropout_epoch): the dropout generator travels in the
    checkpoint."""
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.train.loop import epoch_phase, train

    root = str(tmp_path / "data")
    write_png_videos(root)
    cfg = with_prior(loop_config(root), "tpsm")
    assert [epoch_phase(cfg["train_params"], e)[1:] for e in (0, 1)] == [(True, 0.1),
                                                                         (True, 0.13)]

    def run(log, checkpoint=None):
        data = FramesDataset(is_train=True, seed=7, **cfg["dataset_params"])
        with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
            return train(cfg, checkpoint, str(tmp_path / log), data, seed=0, device="cpu")

    straight = run("a")
    # a checkpoint is ~0.9 GB here: move the one resumed from, drop the rest
    os.makedirs(tmp_path / "r" / "ckpt")
    shutil.move(str(tmp_path / "a" / "ckpt" / "0"), str(tmp_path / "r" / "ckpt" / "0"))
    shutil.rmtree(tmp_path / "a" / "ckpt")
    resumed = run("r", str(tmp_path / "r" / "ckpt"))
    shutil.rmtree(tmp_path / "r" / "ckpt")
    want, got = straight.state_dict(), resumed.state_dict()
    assert want["step"] == got["step"] == 4
    assert "dropout_generator" in want
    # the masks were drawn: the generator left its seed
    assert not torch.equal(want["dropout_generator"],
                           torch.Generator().manual_seed(1235).get_state())
    _equal_trees(got, want)


@pytest.mark.parametrize("prior", ["fomm", "tpsm"])
def test_pth_import_takes_a_prior_state_dict(tmp_path, prior):
    """A reference `.pth` of a FOMM or TPSM model (the port model's own keys)
    fills every key, and equals the JAX package's import of it."""
    from mrfa_tpu.utils.checkpoint import load_torch_weights_into as jload
    from mrfa_tpu.utils.torch_convert import convert_state_dict
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = with_prior(train_cfg(SIZE, blocks=3, depth=1), prior)
    cfg["train_params"]["bg_start"] = 0
    torch.manual_seed(0)
    source = MRFA(cfg, device="cpu").state_dict()
    pth = str(tmp_path / "ref.pth")
    reference_pth(source, pth)
    torch.manual_seed(1)
    port = MRFA(cfg, device="cpu")
    init = {k: v.clone() for k, v in port.state_dict().items()}
    assert load_torch_weights_into(port, pth, verbose=False) == ([], [])
    merged, jmissing, junexpected = jload(convert_state_dict(init), pth, verbose=False)
    assert jmissing == [] and junexpected == []
    via_jax = MRFA(cfg, device="cpu")
    load_jax_variables(via_jax, merged)
    _equal_trees(port.state_dict(), via_jax.state_dict())
    os.remove(pth)
    state = port.state_dict()
    for key, v in source.items():
        assert torch.equal(state[key], v), key


@pytest.mark.parametrize("drop_pos", [False, True], ids=["all", "drop_decoder_pos_embedding"])
def test_pth_import_matches_jax(tmp_path, drop_pos):
    from mrfa_tpu.utils.checkpoint import load_torch_weights_into as jload
    from mrfa_tpu.utils.torch_convert import convert_state_dict
    from mrfa_tpu_torch.models.mrfa import MRFA

    cfg = train_cfg(SIZE, blocks=3, depth=1)
    cfg["train_params"]["bg_start"] = 0
    torch.manual_seed(0)
    source = MRFA(cfg, device="cpu").state_dict()
    missing_key = "dense_motion.mask.bias"
    wrong_shape = "encoder.transformer.keypoint_token"
    pth = str(tmp_path / "ref.pth")
    reference_pth(source, pth, drop=(missing_key, wrong_shape), extra={
        "module.decoder.extra_leaf": torch.zeros(2),
        f"module.{wrong_shape}": torch.zeros(3, 3),
    })

    torch.manual_seed(1)
    port = MRFA(cfg, device="cpu")
    init = {k: v.clone() for k, v in port.state_dict().items()}
    missing, unexpected = load_torch_weights_into(port, pth, drop_decoder_pos_embedding=drop_pos,
                                                  verbose=False)
    merged, jmissing, junexpected = jload(convert_state_dict(init), pth,
                                          drop_decoder_pos_embedding=drop_pos, verbose=False)
    via_jax = MRFA(cfg, device="cpu")
    load_jax_variables(via_jax, merged)
    _equal_trees(port.state_dict(), via_jax.state_dict())

    def flax_name(key):
        name, note = (key.split(" ", 1) + [""])[:2]
        coll, path = flax_path(name, init[name].dim())
        return "/".join((coll,) + path) + (" " + note if note else "")

    want_missing = {missing_key, wrong_shape} | ({"decoder.pos_embedding"} if drop_pos else set())
    assert {m.split(" ")[0] for m in missing} == want_missing
    assert "shape mismatch" in next(m for m in missing if m.startswith(wrong_shape))
    assert {flax_name(m).split(" ")[0] for m in missing} == {m.split(" ")[0] for m in jmissing}
    assert unexpected == ["decoder.extra_leaf"]
    assert ["params/decoder/extra_leaf"] == junexpected
    state = port.state_dict()
    for key, v in source.items():
        if key in want_missing or key.endswith("num_batches_tracked"):
            assert torch.equal(state[key], init[key]), key
        else:
            assert torch.equal(state[key], v), key
