"""Host-side data pipeline: frame datasets, repeaters, animation pairs.

Counterpart of mrfa_tpu/data/dataset.py (the reference's frames_dataset.py):
  - videos stored as frame directories, .png strips, or .mp4/.gif/.mov,
  - train sampling: pick a video (optionally grouping identities by name
    prefix), sample 2 random frames (sorted), augment, emit source+driving,
  - test: the whole video,
  - DatasetRepeater for virtual epoch lengthening; PairedDataset for
    animation pairs; BatchLoader for batches in a deterministic order.

Images are float32 in [0, 1], HWC, and batches NHWC numpy arrays; `Trainer`
copies them to the card. Frames are decoded as the JAX package decodes them:
a frame directory of PNG/JPEG files goes through the host codec
(`mrfa_tpu_torch.native`) at its first frame's size when the codec is built;
otherwise, and for a PNG strip, each PNG goes through the port's own reader
(`utils.video.decode_png`) and anything else through `imageio`, imported
when such a file is read. `DECODED` counts the frames each decoder served.
"""
from __future__ import annotations

import csv
import glob
import os
import queue as queue_mod
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from mrfa_tpu_torch import native
from mrfa_tpu_torch.utils.video import UnsupportedPNG, decode_png

FRAME_EXTENSIONS = (".png", ".jpg", ".jpeg")
DECODERS = ("native", "png", "imageio")


class DecoderCounts:
    """The frames each decoder served, counted from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(DECODERS, 0)

    def add(self, decoder: str, frames: int = 1) -> None:
        with self._lock:
            self._counts[decoder] += frames

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(DECODERS, 0)


DECODED = DecoderCounts()


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError as err:
        raise ImportError("reading images and videos needs the `imageio` package") from err
    return imageio


def img_as_float32(img: np.ndarray) -> np.ndarray:
    """uint8/uint16/float -> float32 in [0, 1]."""
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _ensure_rgb(img: np.ndarray) -> np.ndarray:
    """Gray, gray + alpha, RGB or RGBA -> RGB (alpha dropped)."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    return img


def read_image(path: str) -> np.ndarray:
    """One image file -> (H, W, 3) float32 in [0, 1]: a PNG through
    `decode_png` (imageio only for the PNGs it does not read: palette,
    16-bit, interlaced), any other file through imageio."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            data = f.read()
        try:
            img = decode_png(data)
            DECODED.add("png")
            return img_as_float32(_ensure_rgb(img))
        except UnsupportedPNG:
            pass
    img = _imageio().imread(path)
    DECODED.add("imageio")
    return img_as_float32(_ensure_rgb(img))


def _read_frames(paths: List[str]) -> list:
    """Frames of one video, each (H, W, 3) float32: all at once through the
    host codec at the first frame's size when every file is a PNG or JPEG
    and the codec is built (JAX dataset.py's route), else one by one."""
    if paths and all(p.lower().endswith(FRAME_EXTENSIONS) for p in paths) and native.available():
        size = native.image_size(paths[0])
        batch = None if size is None else native.decode_batch(paths, *size, n_threads=4)
        if batch is not None:
            DECODED.add("native", len(paths))
            return list(batch)
    return [read_image(p) for p in paths]


def read_video(name: str, frame_shape=(256, 256, 3), read_first_frame: bool = False) -> np.ndarray:
    """Read a video (frame dir / png strip / movie) -> (T, H, W, 3) f32."""
    if os.path.isdir(name):
        frames = sorted(os.listdir(name))
        count = 1 if read_first_frame else len(frames)
        return np.array(_read_frames([os.path.join(name, frames[i]) for i in range(count)]))
    lower = name.lower()
    if lower.endswith((".png", ".jpg")):
        # a strip is read as the JAX package reads it (not through the codec,
        # whose float conversion differs from imageio's in the last bit)
        image = read_image(name)
        video = np.moveaxis(image, 1, 0)
        video = video.reshape((-1,) + tuple(frame_shape))
        return np.moveaxis(video, 1, 2)
    if lower.endswith((".gif", ".mp4", ".mov")):
        reader = _imageio().get_reader(name)
        frames = []
        try:
            for im in reader:
                frames.append(im)
                if read_first_frame:
                    break
        except RuntimeError:
            pass
        reader.close()
        video = np.array(frames)
        if video.ndim == 3:
            video = np.stack([_ensure_rgb(f) for f in video])
        if video.shape[-1] == 4:
            video = video[..., :3]
        return img_as_float32(video)
    raise ValueError(f"Unknown file extension: {name}")


class FramesDataset:
    """Train/test dataset over a root with train/ and test/ subdirectories.

    Its `rng` draws the frames and the augmentation of every training item;
    a training run's checkpoint carries its state.
    """

    def __init__(
        self,
        root_dir: str,
        frame_shape=(256, 256, 3),
        id_sampling: bool = False,
        is_train: bool = True,
        pairs_list: Optional[str] = None,
        augmentation_params: Optional[Dict[str, Any]] = None,
        read_first_frame: bool = False,
        split_len: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        self.frame_shape = tuple(frame_shape)
        self.pairs_list = pairs_list
        self.id_sampling = id_sampling
        self.read_first_frame = read_first_frame
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)

        if not is_train:
            train_videos = []  # eval-only roots need no train/ split
        elif id_sampling:
            names = os.listdir(os.path.join(root_dir, "train"))
            if split_len is not None:
                train_videos = {os.path.basename(v)[:split_len] for v in names}
            else:
                train_videos = {os.path.basename(v).split("#")[0] for v in names}
            train_videos = sorted(train_videos)
        else:
            train_videos = sorted(os.listdir(os.path.join(root_dir, "train")))
        test_videos = sorted(os.listdir(os.path.join(root_dir, "test")))
        self.root_dir = os.path.join(root_dir, "train" if is_train else "test")
        self.videos = train_videos if is_train else test_videos

        self.transform = None
        if is_train and augmentation_params is not None:
            from mrfa_tpu_torch.data.augmentation import AllAugmentationTransform

            self.transform = AllAugmentationTransform(rng=self.rng, **augmentation_params)

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        name = self.videos[idx]
        if self.is_train and self.id_sampling:
            candidates = glob.glob(os.path.join(self.root_dir, name + "*.mp4"))
            if not candidates:  # frame-dir layouts
                candidates = sorted(glob.glob(os.path.join(self.root_dir, name + "*")))
            path = candidates[self.rng.randint(len(candidates))]
        else:
            path = os.path.join(self.root_dir, name)

        out: Dict[str, Any] = {"name": os.path.basename(path)}
        if self.is_train:
            if os.path.isdir(path):
                frames = sorted(os.listdir(path))
                frame_idx = np.sort(self.rng.choice(len(frames), replace=True, size=2))
                video = _read_frames([os.path.join(path, frames[i]) for i in frame_idx])
            else:
                arr = read_video(path, frame_shape=self.frame_shape)
                frame_idx = np.sort(self.rng.choice(len(arr), replace=True, size=2))
                video = [arr[i] for i in frame_idx]
            if self.transform is not None:
                video = self.transform(video)
            out["source"] = np.ascontiguousarray(video[0], dtype=np.float32)
            out["driving"] = np.ascontiguousarray(video[1], dtype=np.float32)
        else:
            video = read_video(path, frame_shape=self.frame_shape,
                               read_first_frame=self.read_first_frame)
            out["video"] = np.asarray(video, dtype=np.float32)  # (T, H, W, 3)
        return out


class DatasetRepeater:
    """Virtually lengthen an epoch by passing over the dataset N times."""

    def __init__(self, dataset, num_repeats: int = 100):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self):
        return self.num_repeats * len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % len(self.dataset)]


class PairedDataset:
    """(driving, source) pairs for animation, random or from a CSV list with
    `source` and `driving` columns."""

    def __init__(self, initial_dataset: FramesDataset, number_of_pairs: int, seed: int = 0):
        self.initial_dataset = initial_dataset
        pairs_list = initial_dataset.pairs_list
        rng = np.random.RandomState(seed)
        if pairs_list is None:
            max_idx = min(number_of_pairs, len(initial_dataset))
            xy = np.mgrid[:max_idx, :max_idx].reshape(2, -1).T
            number_of_pairs = min(xy.shape[0], number_of_pairs)
            take = rng.choice(xy.shape[0], number_of_pairs, replace=False)
            self.pairs = xy.take(take, axis=0)
        else:
            videos = initial_dataset.videos
            name_to_index = {name: i for i, name in enumerate(videos)}
            with open(pairs_list, newline="") as f:
                rows = [r for r in csv.DictReader(f)
                        if r["source"] in name_to_index and r["driving"] in name_to_index]
            self.pairs = [(name_to_index[r["driving"]], name_to_index[r["source"]])
                          for r in rows[:number_of_pairs]]

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        pair = self.pairs[idx]
        self.initial_dataset.read_first_frame = False
        first = self.initial_dataset[pair[0]]
        self.initial_dataset.read_first_frame = True
        second = self.initial_dataset[pair[1]]
        self.initial_dataset.read_first_frame = False
        out = {f"driving_{k}": v for k, v in first.items()}
        out.update({f"source_{k}": v for k, v in second.items()})
        return out


class BatchLoader:
    """Threaded prefetching batch loader (host side).

    `num_workers` threads assemble NHWC batches ahead of time into bounded
    per-worker queues; the consumer pops them round-robin, so the batch
    ORDER is the same for any worker count (the items' random draws are
    ordered only with one worker: the dataset's `rng` is shared). Each
    epoch shuffles with seed + epoch; a process of a data-parallel run then
    takes every `num_shards`-th index from `shard_index` on. An epoch left
    early (the generator closed) stops its workers.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_prefetch: int = 2,
        seed: int = 0,
        num_workers: int = 1,
        shard_index: int = 0,
        num_shards: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_prefetch = num_prefetch
        self.seed = seed
        self.num_workers = max(1, int(num_workers))
        self.shard_index = shard_index
        self.num_shards = num_shards

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx[self.shard_index::self.num_shards]

    def epoch(self, epoch: int, num_batches: Optional[int] = None):
        """Yield the epoch's batches {'source': (B,H,W,3), 'driving': ...,
        'name': [...]}, only its first `num_batches` when given (no item
        beyond them is read)."""
        idx = self._indices(epoch)
        nb = len(idx) // self.batch_size
        if not self.drop_last and len(idx) % self.batch_size:
            nb += 1
        if num_batches is not None:
            nb = min(nb, num_batches)
        nw = min(self.num_workers, max(nb, 1))
        queues = [queue_mod.Queue(maxsize=max(1, self.num_prefetch)) for _ in range(nw)]
        stop = threading.Event()

        def worker(wid):
            # worker w makes batches w, w+nw, ...: popping queue b % nw for
            # b = 0..nb-1 restores the global order
            for b in range(wid, nb, nw):
                chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
                try:
                    items = [self.dataset[int(i)] for i in chunk]
                    batch = {
                        "source": np.stack([it["source"] for it in items]),
                        "driving": np.stack([it["driving"] for it in items]),
                        "name": [it["name"] for it in items],
                    }
                except Exception as err:  # handed to the consumer, which raises it
                    batch = err
                while not stop.is_set():
                    try:
                        queues[wid].put(batch, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if stop.is_set() or isinstance(batch, Exception):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(nw)]
        for t in threads:
            t.start()
        try:
            for b in range(nb):
                batch = queues[b % nw].get()
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)

    def __len__(self):
        return len(self._indices(0)) // self.batch_size
