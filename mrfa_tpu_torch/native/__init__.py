"""ctypes bindings of the host image codec (decode, resize, batch).

Counterpart of mrfa_tpu/native/__init__.py, over a copy of its C++ source
(imagecodec.cpp: libpng, libjpeg and pthreads). The library is built with
g++ at first use into `build/` at the repository root, under a name made
from the hash of its source and flags (an edited source is rebuilt), never
into the package. When it cannot be built or loaded, `available()` is False
and `build_error()` says why; the data path then decodes PNG with
`utils.video.decode_png` and anything else with imageio.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

from mrfa_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "imagecodec.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libmrfa_imagecodec-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile the codec into `target` (written beside it, then renamed, so
    concurrent builders never load half a file); raises with the compiler's
    output on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on the PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    target = library_path()
    try:
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
    except (RuntimeError, OSError, subprocess.SubprocessError) as err:
        _error = str(err)
        return None
    lib.mrfa_decode_resize.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.mrfa_decode_resize.restype = ctypes.c_int
    lib.mrfa_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mrfa_decode_batch.restype = ctypes.c_int
    lib.mrfa_image_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mrfa_image_size.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the codec is not available (the compiler's or the loader's
    message), or None when it is (or has not been tried)."""
    return _error


def image_size(path: str):
    """(h, w) from the file header without decoding, or None."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.mrfa_image_size(path.encode(), ctypes.byref(h), ctypes.byref(w))
    return (h.value, w.value) if rc == 0 else None


def decode_resize(path: str, dst_h: int, dst_w: int) -> Optional[np.ndarray]:
    """Decode one PNG/JPEG to (dst_h, dst_w, 3) float32 in [0, 1], or None."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((dst_h, dst_w, 3), dtype=np.float32)
    rc = lib.mrfa_decode_resize(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dst_h, dst_w,
    )
    return out if rc == 0 else None


def decode_batch(
    paths: List[str], dst_h: int, dst_w: int, n_threads: int = 4
) -> Optional[np.ndarray]:
    """Decode many frames into an (N, dst_h, dst_w, 3) float32 batch, or None
    when any of them fails."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, dst_h, dst_w, 3), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed = lib.mrfa_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dst_h, dst_w, n_threads,
    )
    return out if failed == 0 else None
