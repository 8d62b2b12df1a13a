"""Host-side video augmentation (numpy, no PIL round-trips).

Counterpart of mrfa_tpu/data/augmentation.py (the reference's
augmentation.py), with the same draws from the shared `RandomState` in the
same order:
  - RandomFlip: time reversal and/or horizontal mirror, each p=0.5 (the
    reference's early-return makes them mutually exclusive per sample —
    preserved),
  - ColorJitter: brightness/contrast/saturation/hue factors sampled
    uniformly, transforms applied in shuffled order, identical across the
    frames of one sample.

Operates on lists of (H, W, 3) float32 frames in [0, 1].
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

_GRAY = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def _blend(img1: np.ndarray, img2: np.ndarray, ratio: float) -> np.ndarray:
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, np.zeros_like(img), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = (img @ _GRAY).mean()
    return _blend(img, np.full_like(img, mean), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (img @ _GRAY)[..., None].repeat(3, axis=-1)
    return _blend(img, gray, factor)


def adjust_hue(img: np.ndarray, hue_shift: float) -> np.ndarray:
    """Shift hue by hue_shift in [-0.5, 0.5] turns (HSV round-trip)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)

    h = (h + hue_shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r2 = np.select(conds, [v, q, p, p, t, v])
    g2 = np.select(conds, [t, v, v, q, p, p])
    b2 = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], axis=-1).astype(img.dtype)


class RandomFlip:
    def __init__(self, rng, time_flip=False, horizontal_flip=False):
        self.rng = rng
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        # Preserves the reference's early-return: at most one flip fires.
        if self.rng.rand() < 0.5 and self.time_flip:
            return clip[::-1]
        if self.rng.rand() < 0.5 and self.horizontal_flip:
            return [np.ascontiguousarray(img[:, ::-1]) for img in clip]
        return clip


class ColorJitter:
    def __init__(self, rng, brightness=0, contrast=0, saturation=0, hue=0):
        self.rng = rng
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        ops = []
        if self.brightness > 0:
            f = self.rng.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
            ops.append(lambda im: adjust_brightness(im, f))
        if self.contrast > 0:
            f = self.rng.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
            ops.append(lambda im: adjust_contrast(im, f))
        if self.saturation > 0:
            f = self.rng.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
            ops.append(lambda im: adjust_saturation(im, f))
        if self.hue > 0:
            f = self.rng.uniform(-self.hue, self.hue)
            ops.append(lambda im: adjust_hue(im, f))
        self.rng.shuffle(ops)
        out = []
        for img in clip:
            for op in ops:
                img = op(img)
            out.append(np.clip(img, 0.0, 1.0).astype(np.float32))
        return out


class RandomRotation:
    """Rotate all frames of a clip by one uniformly sampled angle (degrees)."""

    def __init__(self, rng, degrees):
        self.rng = rng
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) else tuple(degrees)

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        from scipy.ndimage import rotate

        angle = self.rng.uniform(self.degrees[0], self.degrees[1])
        return [
            np.clip(
                rotate(img, angle, reshape=False, order=1, mode="constant"),
                0.0, 1.0,
            ).astype(np.float32)
            for img in clip
        ]


class RandomResize:
    """Rescale the whole clip by one uniformly sampled ratio."""

    def __init__(self, rng, ratio):
        self.rng = rng
        self.ratio = tuple(ratio) if not np.isscalar(ratio) else (1 - ratio, 1 + ratio)

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        from scipy.ndimage import zoom

        scale = self.rng.uniform(self.ratio[0], self.ratio[1])
        return [
            np.clip(zoom(img, (scale, scale, 1), order=1), 0.0, 1.0).astype(np.float32)
            for img in clip
        ]


class RandomCrop:
    """Crop one random (h, w) window shared by all frames of the clip."""

    def __init__(self, rng, size):
        self.rng = rng
        self.size = (size, size) if np.isscalar(size) else tuple(size)

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        h, w = clip[0].shape[:2]
        ch, cw = self.size
        ch, cw = min(ch, h), min(cw, w)
        y0 = self.rng.randint(0, h - ch + 1)
        x0 = self.rng.randint(0, w - cw + 1)
        return [img[y0 : y0 + ch, x0 : x0 + cw] for img in clip]


class AllAugmentationTransform:
    def __init__(
        self,
        rng=None,
        flip_param=None,
        rotation_param=None,
        resize_param=None,
        crop_param=None,
        jitter_param=None,
        **unused,
    ):
        self.rng = rng if rng is not None else np.random.RandomState()
        self.transforms = []
        if flip_param is not None:
            self.transforms.append(RandomFlip(self.rng, **flip_param))
        if rotation_param is not None:
            self.transforms.append(RandomRotation(self.rng, **rotation_param))
        if resize_param is not None:
            self.transforms.append(RandomResize(self.rng, **resize_param))
        if crop_param is not None:
            self.transforms.append(RandomCrop(self.rng, **crop_param))
        if jitter_param is not None:
            self.transforms.append(ColorJitter(self.rng, **jitter_param))

    def __call__(self, clip: List[np.ndarray]) -> List[np.ndarray]:
        for t in self.transforms:
            clip = t(clip)
        return clip
