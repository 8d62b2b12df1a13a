"""The port's host image codec and PNG reader on the CPU.

- The codec (a copy of the JAX package's C++, built with g++ into build/)
  against `mrfa_tpu.native` on PNG and JPEG files that imageio wrote:
  `image_size`, `decode_resize` (native size, shrinking, enlarging) and
  `decode_batch` (4 threads), bit-equal; a source that does not compile
  leaves it unavailable, with the compiler's message.
- `utils.video.decode_png` against imageio on PNGs that PIL wrote (L, LA,
  RGB, RGBA), one file for each row filter written by hand, and the port's
  own writer's files, bit-equal; palette, 16-bit and interlaced files raise.
- `read_video` and `FramesDataset` items against the JAX package's on a
  frame directory (both through their codecs) and a PNG strip (the port's
  reader against imageio), bit-equal, with the decoder counts.

The JAX side runs on a private build of the JAX package's own codec source
(the `jax_codec` fixture), not on the library `mrfa_tpu.native` makes in
its package directory at first use: several test processes that start on a
tree without that library all run `make` into the same file at once, and
one that loads a half-written file keeps the failure for its lifetime.
"""
import io
import os
import shutil
import struct
import subprocess
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import mrfa_tpu.data.dataset as jdata
from mrfa_tpu import native as jnative
from mrfa_tpu_torch import native
from mrfa_tpu_torch.data import dataset as data
from mrfa_tpu_torch.utils.video import (
    PNG_SIGNATURE, UnsupportedPNG, _chunk, decode_png, encode_png, save_image,
)

SIZE = 24


@pytest.fixture(scope="module", autouse=True)
def jax_codec(tmp_path_factory):
    """`mrfa_tpu.native` (and so `mrfa_tpu.data.dataset`'s native route) on
    a library compiled for this module alone from the JAX package's
    imagecodec.cpp, with its Makefile's flags."""
    source = os.path.join(os.path.dirname(jnative.__file__), "imagecodec.cpp")
    lib = str(tmp_path_factory.mktemp("jax_codec") / "libmrfa_imagecodec.so")
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", lib, source,
                    "-lpng", "-ljpeg", "-lpthread"], check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", lib)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.available()
        yield lib


def _frames(n, seed=0, h=SIZE, w=SIZE + 8):
    """Smooth-ish uint8 frames (row filters have something to predict)."""
    rng = np.random.RandomState(seed)
    base = np.cumsum(rng.randint(0, 9, (n, h, w, 3)), axis=2)
    return (base + 40 * rng.rand(n, 1, 1, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """PNG and JPEG frames written by imageio."""
    root = tmp_path_factory.mktemp("codec")
    out = {"png": [], "jpg": []}
    for i, frame in enumerate(_frames(5)):
        for ext in out:
            path = str(root / f"f{i}.{ext}")
            imageio.imwrite(path, frame)
            out[ext].append(path)
    return out


def test_codec_builds_into_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.library_path().parent.name == "build"
    assert native.library_path().exists()


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_codec_matches_jax(files, ext):
    assert jnative.available()
    paths = files[ext]
    for p in paths:
        assert native.image_size(p) == jnative.image_size(p) == (SIZE, SIZE + 8)
        for shape in ((SIZE, SIZE + 8), (11, 13), (40, 50), (SIZE, 17)):
            got, want = native.decode_resize(p, *shape), jnative.decode_resize(p, *shape)
            assert got.dtype == want.dtype == np.float32 and got.shape == shape + (3,)
            np.testing.assert_array_equal(got, want)
    for shape in ((SIZE, SIZE + 8), (12, 16)):
        got = native.decode_batch(paths, *shape, n_threads=4)
        np.testing.assert_array_equal(got, jnative.decode_batch(paths, *shape, n_threads=4))
    assert native.decode_batch(paths + ["missing.png"], SIZE, SIZE + 8) is None
    assert native.image_size("missing.png") is None


def test_codec_unavailable_when_it_does_not_build(tmp_path, monkeypatch):
    bad = tmp_path / "imagecodec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    assert not native.available()
    assert "failed" in native.build_error() and "imagecodec.cpp" in native.build_error()
    assert native.decode_batch(["x.png"], 4, 4) is None
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_decode_png_matches_imageio_on_pil_files(mode, channels):
    frame = _frames(1, seed=channels)[0]
    pixels = np.concatenate([frame, frame[..., :1]], axis=-1)[..., :channels]
    buf = io.BytesIO()
    Image.fromarray(pixels[..., 0] if channels == 1 else pixels, mode).save(buf, format="PNG")
    got = decode_png(buf.getvalue())
    want = imageio.imread(io.BytesIO(buf.getvalue()))
    assert got.dtype == np.uint8 and got.shape == (SIZE, SIZE + 8, channels)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def _filtered_png(image: np.ndarray, kind: int) -> bytes:
    """An RGB PNG whose every row uses filter `kind` (PNG spec 9.2)."""
    h = image.shape[0]
    rows = image.reshape(h, -1).astype(np.int16)
    bpp = image.shape[2]
    raw = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int16), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        raw.append(np.concatenate([[kind], (cur - pred) % 256]).astype(np.uint8))
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", image.shape[1], h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(np.stack(raw).tobytes()))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_decode_png_each_row_filter(kind):
    image = _frames(1, seed=10 + kind)[0]
    data_ = _filtered_png(image, kind)
    np.testing.assert_array_equal(imageio.imread(io.BytesIO(data_)), image)
    np.testing.assert_array_equal(decode_png(data_), image)


def test_decode_png_reads_the_port_writer():
    for image in _frames(3, seed=20):
        data_ = encode_png(image)
        np.testing.assert_array_equal(decode_png(data_), image)
        np.testing.assert_array_equal(decode_png(data_), imageio.imread(io.BytesIO(data_)))


@pytest.mark.parametrize("kind", ["palette", "16-bit", "interlaced"])
def test_decode_png_refuses(kind):
    frame = _frames(1, seed=30)[0]
    buf = io.BytesIO()
    if kind == "palette":
        Image.fromarray(frame).convert("P").save(buf, format="PNG")
    elif kind == "16-bit":
        Image.fromarray(frame[..., 0].astype(np.uint16) * 257).save(buf, format="PNG")
    else:
        header = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
        buf.write(PNG_SIGNATURE + _chunk(b"IHDR", header)
                  + _chunk(b"IDAT", zlib.compress(bytes(100))) + _chunk(b"IEND", b""))
    with pytest.raises(UnsupportedPNG, match={"palette": "palette", "16-bit": "bit depth",
                                              "interlaced": "interlaced"}[kind]):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(40))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """train/ and test/ of PNG frame directories (the port's writer) and a
    PNG strip (imageio), 24 px frames."""
    base = tmp_path_factory.mktemp("frames")
    for split in ("train", "test"):
        for v, name in enumerate(("idA#1", "idB#1")):
            d = base / split / name
            d.mkdir(parents=True)
            for t, frame in enumerate(_frames(4, seed=40 + v)[..., :SIZE, :]):
                save_image(str(d / f"{t:03d}.png"), frame)
        strip = np.concatenate(list(_frames(3, seed=50)[..., :SIZE, :]), axis=1)
        imageio.imwrite(base / split / "strip.png", strip)
    return str(base)


def _expected_counts(native_frames=0, png=0, imageio_=0):
    return {"native": native_frames, "png": png, "imageio": imageio_}


def test_read_video_matches_jax(root):
    shape = (SIZE, SIZE, 3)
    data.DECODED.reset()
    for first in (False, True):
        got = data.read_video(f"{root}/test/idA#1", shape, first)
        np.testing.assert_array_equal(got, jdata.read_video(f"{root}/test/idA#1", shape, first))
    assert data.DECODED.counts() == _expected_counts(native_frames=5)
    got = data.read_video(f"{root}/test/strip.png", shape)
    assert got.shape == (3,) + shape
    np.testing.assert_array_equal(got, jdata.read_video(f"{root}/test/strip.png", shape))
    assert data.DECODED.counts() == _expected_counts(native_frames=5, png=1)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_frames_dataset_matches_jax(root, is_train):
    kw = dict(root_dir=root, frame_shape=(SIZE, SIZE, 3), is_train=is_train, seed=3)
    got_ds, want_ds = data.FramesDataset(**kw), jdata.FramesDataset(**kw)
    data.DECODED.reset()
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert sorted(got) == sorted(want)
        for k in got:
            if k != "name":
                np.testing.assert_array_equal(got[k], want[k])
    # train: 2 frames from each of 2 directories and the strip (read whole);
    # test: 4 frames from each directory and the strip
    want_counts = (_expected_counts(native_frames=4, png=1) if is_train
                   else _expected_counts(native_frames=8, png=1))
    assert data.DECODED.counts() == want_counts


def test_decoders_agree(root, monkeypatch):
    """Without the codec the same frames come from `decode_png`, bit-equal
    to imageio's route; the codec converts with a multiply by
    float32(1/255), one ulp from uint8 / 255 on 126 of the 256 values, as
    the JAX package's codec does against its imageio route."""
    path = f"{root}/test/idB#1"
    data.DECODED.reset()
    via_codec = data.read_video(path)
    monkeypatch.setattr(data.native, "available", lambda: False)
    via_png = data.read_video(path)
    monkeypatch.setattr(data, "decode_png", lambda _: (_ for _ in ()).throw(UnsupportedPNG()))
    via_imageio = data.read_video(path)
    assert data.DECODED.counts() == _expected_counts(native_frames=4, png=4, imageio_=4)
    np.testing.assert_array_equal(via_png, via_imageio)
    u8 = np.rint(via_png * 255).astype(np.uint8)
    np.testing.assert_array_equal(via_png, u8.astype(np.float32) / np.float32(255))
    np.testing.assert_array_equal(via_codec, u8.astype(np.float32) * (np.float32(1) / 255))
    ulp = np.spacing(np.float32(1) / 2)
    assert np.abs(via_codec - via_png).max() <= ulp
