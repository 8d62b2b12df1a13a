"""Training logger and visualizer.

Counterpart of mrfa_tpu/utils/logger.py (the reference's logger.py):
per-iteration loss accumulation, per-epoch mean lines to log.txt and stdout,
epoch visualization grids with keypoint dots, the checkpoint cadence. The
keypoint colors come from the port's own copy of matplotlib's `gist_rainbow`
colormap (its segment table and 256-entry lookup), so no plotting package is
needed.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, List, Optional

import numpy as np

from mrfa_tpu_torch.utils.video import save_image

# matplotlib's gist_rainbow: (position, RGB) segment points
_GIST_RAINBOW = (
    (0.000, (1.00, 0.00, 0.16)),
    (0.030, (1.00, 0.00, 0.00)),
    (0.215, (1.00, 1.00, 0.00)),
    (0.400, (0.00, 1.00, 0.00)),
    (0.586, (0.00, 1.00, 1.00)),
    (0.770, (0.00, 0.00, 1.00)),
    (0.954, (1.00, 0.00, 1.00)),
    (1.000, (1.00, 0.00, 0.75)),
)
_LUT_SIZE = 256  # matplotlib's image.lut


def _lookup_table(points, n: int = _LUT_SIZE) -> np.ndarray:
    """(n, 3) table of the piecewise-linear map through `points`, sampled
    at n equidistant positions (matplotlib's `_create_lookup_table`)."""
    x = np.array([p for p, _ in points]) * (n - 1)
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = []
    for ch in range(3):
        y = np.array([c[ch] for _, c in points])
        lut.append(np.concatenate([[y[0]], distance * (y[ind] - y[ind - 1]) + y[ind - 1],
                                   [y[-1]]]))
    return np.clip(np.stack(lut, axis=1), 0.0, 1.0)


class Colormap:
    """value in [0, 1] -> RGB, as matplotlib's colormap of that name (the
    port carries gist_rainbow, the configs' colormap)."""

    def __init__(self, name: str):
        if name != "gist_rainbow":
            raise ValueError(f"colormap {name!r} is not carried by the port (gist_rainbow only)")
        self.lut = _lookup_table(_GIST_RAINBOW)

    def __call__(self, value: float) -> np.ndarray:
        i = int(min(max(value * len(self.lut), 0), len(self.lut) - 1))
        return self.lut[i]


class Logger:
    def __init__(
        self,
        log_dir: str,
        log_file_name: str = "log.txt",
        visualizer_params: Optional[dict] = None,
        checkpoint_freq: int = 100,
        zfill_num: int = 8,
    ):
        self.loss_list: List[List[float]] = []
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.vis_dir = os.path.join(log_dir, "train-vis")
        os.makedirs(self.vis_dir, exist_ok=True)
        self.log_path = os.path.join(log_dir, log_file_name)
        self.zfill_num = zfill_num
        self.visualizer = Visualizer(**(visualizer_params or {}))
        self.checkpoint_freq = checkpoint_freq
        self.epoch = 0
        self.names: Optional[List[str]] = None

    def log_iter(self, losses: Dict[str, float]) -> None:
        losses = collections.OrderedDict((k, float(v)) for k, v in losses.items())
        self.names = list(losses.keys())
        self.loss_list.append(list(losses.values()))

    def log_epoch_scores(self) -> str:
        loss_mean = np.array(self.loss_list).mean(axis=0)
        loss_string = "; ".join(
            [f"{name} - {value:.5f}" for name, value in zip(self.names, loss_mean)]
        )
        line = f"{str(self.epoch).zfill(self.zfill_num)}) {loss_string}"
        with open(self.log_path, "a") as f:
            print(line, file=f)
        print(line)
        self.loss_list = []
        return line

    def visualize_rec(self, inp: dict, out: dict) -> None:
        image = self.visualizer.visualize(
            source=inp["source"], driving=inp["driving"],
            out=out.get("rec"), kp_s=out.get("kp_s"), kp_d=out.get("kp_d"),
        )
        save_image(os.path.join(self.vis_dir, f"{str(self.epoch).zfill(self.zfill_num)}-rec.png"),
                   image)

    def log_epoch(self, epoch: int, inp: Optional[dict] = None, out: Optional[dict] = None):
        self.epoch = epoch
        if self.loss_list:
            self.log_epoch_scores()
        if inp is not None and out is not None:
            self.visualize_rec(inp, out)


class Visualizer:
    """Side-by-side (source | driving | outputs) uint8 grids with kp dots."""

    def __init__(self, kp_size: int = 5, draw_border: bool = False, colormap: str = "gist_rainbow"):
        self.kp_size = kp_size
        self.draw_border = draw_border
        self.colormap = Colormap(colormap)

    def draw_image_with_kp(self, image: np.ndarray, kp_array: np.ndarray) -> np.ndarray:
        image = np.copy(image)
        spatial_size = np.array(image.shape[:2][::-1])[np.newaxis]
        kp_array = spatial_size * (kp_array + 1) / 2
        num_kp = kp_array.shape[0]
        h, w = image.shape[:2]
        yy, xx = np.mgrid[:h, :w]
        for kp_ind, kp in enumerate(kp_array):
            mask = (xx - kp[0]) ** 2 + (yy - kp[1]) ** 2 <= self.kp_size**2
            image[mask] = self.colormap(kp_ind / num_kp)
        return image

    def create_image_column_with_kp(self, images, kp) -> np.ndarray:
        return self.create_image_column(
            [self.draw_image_with_kp(v, k) for v, k in zip(images, kp)]
        )

    def create_image_column(self, images) -> np.ndarray:
        if self.draw_border:
            images = np.copy(images)
            images[:, :, [0, -1]] = (1, 1, 1)
        return np.concatenate(list(images), axis=0)

    def create_image_grid(self, *args) -> np.ndarray:
        out = []
        for arg in args:
            if isinstance(arg, tuple):
                out.append(self.create_image_column_with_kp(arg[0], arg[1]))
            else:
                out.append(self.create_image_column(arg))
        return np.concatenate(out, axis=1)

    def visualize(self, driving, source, out=None, kp_s=None, kp_d=None) -> np.ndarray:
        """All image args are NHWC float arrays in [0,1]."""
        images = []
        source = np.asarray(source)
        driving = np.asarray(driving)
        images.append((source, np.asarray(kp_s)) if kp_s is not None else source)
        images.append((driving, np.asarray(kp_d)) if kp_d is not None else driving)
        if out is not None:
            images.append(np.asarray(out))
        image = self.create_image_grid(*images)
        return (255 * np.clip(image, 0, 1)).astype(np.uint8)
