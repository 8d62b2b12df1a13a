"""The frozen arithmetic: the lookup's (B1) and the splat's (B4) bytes at the
cells' shapes recomputed from first principles, and against the port's own
`tools/kernel_times.py` they were copied from; and the FLOP counter over a
tiny model against a hand count."""
import json

import numpy as np
import pytest
import torch
from torch import nn

from portbench import arith
from portbench.tests.small import ROOT

CONFIG = json.loads((ROOT / "configs" / "vox1-mtia.json").read_text())
SERVE = json.loads((ROOT / "traffic" / "serve-s8-bf16-graph.json").read_text())
TRAIN = json.loads((ROOT / "traffic" / "train-b10-f32.json").read_text())


def window_taps(cx: float, cy: float, side: int):
    """The distinct map cells a 7x7 bilinear window centred at (cx, cy) reads."""
    x0, y0 = int(np.floor(cx)), int(np.floor(cy))
    return {(y0 + j + dy, x0 + i + dx) for i in range(-3, 4) for j in range(-3, 4)
            for dx in (0, 1) for dy in (0, 1)
            if 0 <= x0 + i + dx < side and 0 <= y0 + j + dy < side}


@pytest.mark.parametrize("bq_per_sample", [b for b, _ in CONFIG["lookups"]["per_step"]])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lookup_bytes_from_first_principles(bq_per_sample, dtype):
    side = CONFIG["lookups"]["map_side"]
    bq = bq_per_sample * SERVE["streams"]
    item = arith.ITEMSIZE[dtype]
    rng = np.random.default_rng(bq)
    # windows inside both levels: centres at least 4 cells from every edge of
    # level 1 (half as wide), so of level 0 too
    centres = rng.uniform(8, side - 10, size=(3, 2))
    per_query = [len(window_taps(cx, cy, side)) + len(window_taps(cx / 2, cy / 2, side // 2))
                 for cx, cy in centres]
    assert per_query == [128, 128, 128]
    want = bq * (128 * item + 2 * 4 + 98 * item)  # patches, f32 coords, 98 outputs
    assert arith.lookup_bytes(bq, side, item) == want


def test_lookup_arithmetic_matches_the_port():
    from mrfa_tpu_torch.tools import kernel_times as kt

    bq = 4096 * SERVE["streams"]
    coords = torch.full((bq, 2), 30.5)  # every window inside both levels
    for item in (2, 4):
        assert arith.lookup_bytes(bq, 64, item) == kt.lookup_bytes(bq, coords, item)
    assert arith.lookup_flops(bq) == kt.lookup_flops(bq)
    assert arith.HBM_BYTES_PER_S == kt.HBM_BYTES_PER_S
    assert arith.F32_FLOPS_PER_S == kt.F32_FLOPS_PER_S


@pytest.mark.parametrize("res,c,_n", CONFIG["splats"])
def test_splat_bytes_from_first_principles(res, c, _n):
    from mrfa_tpu_torch.tools import kernel_times as kt

    batch = TRAIN["batch"] if res <= 64 else 1  # the bytes are linear in the batch
    args, _, _ = kt.splat_inputs(res, c, torch.float32, "cpu", seed=1)
    args = tuple(a[:batch] if torch.is_tensor(a) else a for a in args)
    handed = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    written = batch * res * res * c * 4  # d_img, f32
    assert arith.splat_bytes(batch, res * res, c, res, res, 4) == handed + written
    assert arith.splat_flops(batch, res * res, c) == kt.splat_flops(batch, res * res, c)


def test_flop_count_of_a_tiny_model():
    model = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.Flatten(), nn.Linear(4 * 5 * 5, 6))
    x = torch.randn(2, 3, 5, 5)
    conv = 2 * 2 * 4 * 3 * 3 * 3 * 5 * 5  # 2 x batch x Cout x Cin x k x k x H x W
    linear = 2 * 2 * 100 * 6
    assert arith.count_flops(lambda: model(x)) == conv + linear
    # forward and backward: the backward of each product costs twice its forward
    # (the input's gradient and the weight's), the first layer's input needs none
    assert arith.count_flops(lambda: model(x.requires_grad_()).sum().backward()) == \
        3 * (conv + linear)


def test_bounds_take_the_larger_side():
    assert arith.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert arith.bound_s(0, 67e12) == pytest.approx(1.0)
    assert arith.PEAK_FLOPS_PER_S == {"float32": 67e12, "bfloat16": 989e12}
