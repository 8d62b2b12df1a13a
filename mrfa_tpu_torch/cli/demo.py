"""Single-animation demo CLI.

Counterpart of mrfa_tpu/cli/demo.py:

  python -m mrfa_tpu_torch.cli.demo --config config/vox1.yaml \\
      --checkpoint vox.pth --source_image src.png --driving_video drv.mp4 \\
      --result_video result.mp4 [--relative] [--adapt_scale] \\
      [--img_shape 256,256] [--find_best_frame] [--fps 25] [--device cuda|cpu]

`--checkpoint` is a reference `.pth` or a port checkpoint directory (written
by training or by `cli/convert.py`). Images are read through the data path's
decoders (the port's PNG reader needs no image package) and the video is
written by `utils/video.py::save_video` (a directory of PNG frames where no
video writer is installed). The card is the default device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def _axis_weights(n_in: int, n_out: int, area: bool) -> torch.Tensor:
    """(n_out, n_in) f64 weights resizing one axis as OpenCV's INTER_AREA
    does. `area` (the image shrinks or keeps its size on both axes): each
    output pixel is the mean of the input interval it covers, partial pixels
    by their covered fraction. Otherwise each output pixel takes input pixel
    floor(x * n_in / n_out), blended with the next one only where an input
    pixel's edge falls inside it."""
    i = torch.arange(n_out, dtype=torch.float64)
    if area:
        s = n_in / n_out
        j = torch.arange(n_in, dtype=torch.float64)[None, :]
        lo = i[:, None] * s
        return (torch.minimum(j + 1, lo + s) - torch.maximum(j, lo)).clamp(min=0) / s
    sx = torch.floor(i * (n_in / n_out))
    fx = (i + 1) - (sx + 1) * (n_out / n_in)
    fx = torch.where(fx <= 0, torch.zeros_like(fx), fx - torch.floor(fx))
    last = sx >= n_in - 1
    fx = torch.where(last, torch.zeros_like(fx), fx)
    sx = sx.clamp(max=n_in - 1).long()
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    w[rows, sx] += 1 - fx
    w[rows, (sx + 1).clamp(max=n_in - 1)] += fx
    return w


def resize_frame(frame: np.ndarray, shape) -> np.ndarray:
    """An (H, W, C) frame in [0, 1] resized to `shape` (h, w), float32, as
    OpenCV's INTER_AREA resizes (the JAX demo's resize where cv2 is
    installed), in torch: each axis by `_axis_weights`, in f64. It equals a
    box average at integer shrinking factors and cv2.resize(INTER_AREA) at
    any factor, both within 2e-7 (f32 rounding; tests/test_torch_cli.py)."""
    h, w = shape
    if frame.shape[0] == h and frame.shape[1] == w:
        return frame.astype(np.float32)
    area = h <= frame.shape[0] and w <= frame.shape[1]
    x = torch.from_numpy(np.asarray(frame, dtype=np.float64))
    out = torch.einsum("yi,ijc,xj->yxc", _axis_weights(frame.shape[0], h, area), x,
                       _axis_weights(frame.shape[1], w, area))
    return out.to(torch.float32).numpy()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="reference .pth or port checkpoint directory")
    parser.add_argument("--source_image", required=True)
    parser.add_argument("--driving_video", required=True)
    parser.add_argument("--result_video", default="result.mp4")
    parser.add_argument("--relative", dest="relative", action="store_true")
    parser.add_argument("--adapt_scale", dest="adapt_scale", action="store_true")
    parser.add_argument("--img_shape", default="256,256",
                        type=lambda s: [int(x) for x in s.split(",")])
    parser.add_argument(
        "--find_best_frame", action="store_true",
        help="anchor relative animation at the driving frame whose pose "
             "best matches the source (model-keypoint distance)",
    )
    parser.add_argument("--fps", type=int, default=25)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.set_defaults(relative=True)
    args = parser.parse_args(argv)

    from mrfa_tpu_torch.animate import Animator
    from mrfa_tpu_torch.config import load_config, model_config
    from mrfa_tpu_torch.data.dataset import read_image, read_video
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import load_torch_weights_into, restore_checkpoint
    from mrfa_tpu_torch.utils.device import resolve_device
    from mrfa_tpu_torch.utils.video import save_video

    device = resolve_device(args.device)
    config = load_config(args.config)
    model = MRFA(model_config(config), device=device)
    if args.checkpoint is None:
        print("warning: running demo with random weights (no --checkpoint)")
    elif args.checkpoint.endswith(".pth"):
        load_torch_weights_into(model, args.checkpoint)
    else:
        state, _ = restore_checkpoint(args.checkpoint)
        model.load_state_dict(state["trainer"]["model"])

    shape = args.img_shape
    source_image = resize_frame(read_image(args.source_image), shape)
    driving_video = np.stack([resize_frame(f, shape) for f in read_video(args.driving_video)])

    animator = Animator(model, model.state_dict(), device=device, relative=args.relative)
    if args.find_best_frame:
        predictions = animator.make_animation_from_best_frame(
            source_image, driving_video, adapt_movement_scale=args.adapt_scale)
    else:
        predictions = animator.make_animation(
            source_image, driving_video, adapt_movement_scale=args.adapt_scale)
    written = save_video(args.result_video,
                         [(255 * np.clip(p, 0, 1)).astype(np.uint8) for p in predictions],
                         fps=args.fps)
    print(f"saved {len(predictions)} frames to {written}")
    return predictions, written


if __name__ == "__main__":
    main()
