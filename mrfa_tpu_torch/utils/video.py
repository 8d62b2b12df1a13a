"""Image and video writers.

Counterpart of mrfa_tpu/utils/video.py. Images are written as PNG by the
port's own writer (zlib + struct, no image package). Videos go, in this
order, through imageio (ffmpeg or pyav where present), OpenCV's
VideoWriter, or a directory of PNG frames, which always works.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes (8-bit RGB)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"PNG writer takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 a row
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def save_video(path: str, frames: List[np.ndarray], fps: int = 25) -> str:
    """Save uint8 RGB frames; returns the path actually written."""
    frames = [np.asarray(f) for f in frames]
    try:
        import imageio.v2 as imageio

        imageio.mimsave(path, frames, fps=fps)
        return path
    except Exception:  # no imageio, or no backend for this format: the next writer
        pass
    try:
        import cv2

        h, w = frames[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        ok = writer.isOpened()
        if ok:
            for f in frames:
                writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        if ok and os.path.getsize(path) > 0:
            return path
    except Exception:  # no OpenCV, or it cannot encode here: the frame directory
        pass
    out_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        save_image(os.path.join(out_dir, f"{i:06d}.png"), f)
    return out_dir
