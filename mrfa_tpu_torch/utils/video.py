"""Image and video writers, and a PNG reader.

Counterpart of mrfa_tpu/utils/video.py. Images are written as PNG by the
port's own writer (zlib + struct, no image package) and read back by its
inverse, `decode_png` (zlib + numpy), so PNG frame directories and strips
need no image package. Videos go, in this order, through imageio (ffmpeg or
pyav where present), OpenCV's VideoWriter, or a directory of PNG frames,
which always works.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


# color type -> channels: gray, RGB, gray + alpha, RGBA (3, palette, is not read)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class UnsupportedPNG(ValueError):
    """A PNG that `decode_png` does not read (palette, not 8-bit, interlaced)."""


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (h, 1 + w * bpp) filtered bytes."""
    out = np.zeros((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:  # None
            cur = line
        elif kind == 1:  # Sub: a running sum of each channel along the row
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: byte by byte, left to right
            filt, up, row = line.tolist(), prev.tolist(), [0] * (w * bpp)
            for i in range(w * bpp):
                a = row[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                row[i] = (filt[i] + pred) & 0xFF
            cur = np.array(row, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C = 1 (gray), 2 (gray + alpha), 3 (RGB)
    or 4 (RGBA): the 8-bit, non-interlaced files, with any of the five row
    filters. Raises `UnsupportedPNG` on a palette, another bit depth or an
    interlaced file, and ValueError on bytes that are no PNG."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("not a PNG file (no IHDR or IDAT chunk)")
    w, h, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise UnsupportedPNG(f"PNG color type {color} (palette) is not read")
    if depth != 8:
        raise UnsupportedPNG(f"PNG bit depth {depth} is not read (8-bit only)")
    if interlace:
        raise UnsupportedPNG("interlaced PNG is not read")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"PNG data holds {raw.size} bytes, not {h * (1 + w * c)}")
    return _unfilter(raw.reshape(h, 1 + w * c), h, w, c).reshape(h, w, c)


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
