"""Evaluation: the reconstruction metrics harness and the animate mode.

Counterpart of mrfa_tpu/evals.py (the reference's reconstruction.py and
animate.py):
  - reconstruction: source = frame 0, every frame reconstructed from it in
    chunks of `frame_batch`; L1 / LPIPS / PSNR means over all frames;
    per-video prediction strips and visualization videos; the wall clock of
    each phase,
  - animate: relative-motion transfer over PairedDataset pairs, one
    visualization video each.
Both run on CUDA unless the caller passes another device.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.data.dataset import PairedDataset
from mrfa_tpu_torch.metrics import LpipsVgg
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.utils.convert import load_jax_variables
from mrfa_tpu_torch.utils.device import frames_to_device, resolve_device
from mrfa_tpu_torch.utils.logger import Visualizer
from mrfa_tpu_torch.utils.video import save_image, save_video
from mrfa_tpu_torch.weights import lpips_variables


def _lpips_module(weights: Optional[Mapping[str, Any]], device: torch.device) -> LpipsVgg:
    """LPIPS with `weights` (a port state dict or the JAX package's
    variables), or, without them, the uniform-weight variant on a VGG16
    drawn from seed 0 (the global RNG state is left as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        module = LpipsVgg(use_linear_weights=weights is not None)
    if weights is None:
        warnings.warn(
            "no LPIPS weights: using the uniform-weight variant on a random VGG16 "
            "(comparable across runs of this port only)",
            stacklevel=3,
        )
    elif "params" in weights:
        load_jax_variables(module, weights)
    else:
        module.load_state_dict(weights)
    return module.to(device).eval()


def reconstruction(
    config: Dict[str, Any],
    model: MRFA,
    log_dir: str,
    dataset,
    *,
    lpips_weights: Optional[Mapping[str, Any]] = None,
    save_visualizations: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict[str, Any]:
    """Reconstruct every test video from its first frame with `model` (its
    weights as loaded) and return the mean L1, LPIPS and PSNR over all
    frames, the frame count and the per-phase wall clocks (seconds). LPIPS
    takes `lpips_weights`, else the vendored `weights.LPIPS_FILE`, else the
    uniform-weight variant (with a warning)."""
    dev = resolve_device(device)
    model = model.to(dev).eval()
    png_dir = os.path.join(log_dir, "reconstruction/png")
    log_dir = os.path.join(log_dir, "reconstruction")
    os.makedirs(png_dir, exist_ok=True)
    lpips_source = "given"
    if lpips_weights is None:  # the vendored LPIPS weights, where converted
        lpips_weights = lpips_variables()
        lpips_source = "uniform-fallback" if lpips_weights is None else "vendored"
    lpips = _lpips_module(lpips_weights, dev)

    # Frames go through in fixed-size chunks: the source broadcast over the
    # chunk, the last chunk padded by repeating the final frame (the pad's
    # metrics dropped), one host transfer per chunk.
    frame_batch = int(config["reconstruction_params"].get("frame_batch", 8))

    @torch.inference_mode()
    def eval_frames(source, driving):
        src = source.expand_as(driving).contiguous()
        gen, warp_vis, _, kp_s, kp_d = model(src, driving, compute_loss=False)
        m_l1 = torch.mean(torch.abs(gen - driving), dim=(1, 2, 3))
        mse = torch.mean((gen - driving) ** 2, dim=(1, 2, 3))
        m_psnr = 20.0 * torch.log10(1.0 / torch.sqrt(mse))
        m_lpips = lpips(driving, gen)
        out = (gen.permute(0, 2, 3, 1), warp_vis.permute(0, 2, 3, 1), kp_s, kp_d,
               m_l1, m_lpips, m_psnr)
        return [t.float().cpu().numpy() for t in out]

    visualizer = Visualizer(**(config.get("visualizer_params") or {}))
    num_videos = config["reconstruction_params"].get("num_videos")
    fmt = config["reconstruction_params"].get("format", ".mp4")

    phase = {"first_call": 0.0, "read": 0.0, "device": 0.0, "visualize": 0.0, "encode": 0.0}
    first_call_done = False
    loss_list, lpips_list, psnr_list = [], [], []
    for it in range(len(dataset)):
        if num_videos is not None and it > num_videos:
            break
        t0 = time.perf_counter()
        x = dataset[it]
        video = np.asarray(x["video"])  # (T, H, W, 3)
        phase["read"] += time.perf_counter() - t0
        source_np = video[:1]
        source = frames_to_device(source_np, dev)
        predictions, visualizations = [], []
        for c0 in range(0, video.shape[0], frame_batch):
            chunk = video[c0 : c0 + frame_batch]
            n_valid = chunk.shape[0]
            if n_valid < frame_batch:  # pad to the fixed chunk
                pad = np.repeat(chunk[-1:], frame_batch - n_valid, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            t0 = time.perf_counter()
            driving = frames_to_device(chunk, dev)
            gen, warp_vis, kp_s, kp_d, m_l1, m_lpips, m_psnr = eval_frames(source, driving)
            phase["device" if first_call_done else "first_call"] += time.perf_counter() - t0
            first_call_done = True
            loss_list.extend(m_l1[:n_valid].tolist())
            lpips_list.extend(m_lpips[:n_valid].tolist())
            psnr_list.extend(m_psnr[:n_valid].tolist())
            predictions.extend(gen[:n_valid])
            if save_visualizations:
                t0 = time.perf_counter()
                for t in range(n_valid):
                    visualizations.append(visualizer.visualize(
                        source=source_np, driving=chunk[t : t + 1],
                        out=np.concatenate([warp_vis[t : t + 1], gen[t : t + 1]], axis=2),
                        kp_s=kp_s[t : t + 1], kp_d=kp_d[t : t + 1],
                    ))
                phase["visualize"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        strip = np.concatenate(predictions, axis=1)
        save_image(os.path.join(png_dir, x["name"] + ".png"),
                   (255 * np.clip(strip, 0, 1)).astype(np.uint8))
        if save_visualizations:
            save_video(os.path.join(log_dir, x["name"] + fmt), visualizations)
        phase["encode"] += time.perf_counter() - t0

    results = {
        "phase_wall": {k: round(v, 2) for k, v in phase.items()},
        "l1": float(np.mean(loss_list)) if loss_list else float("nan"),
        "lpips": float(np.mean(lpips_list)) if lpips_list else float("nan"),
        "psnr": float(np.mean(psnr_list)) if psnr_list else float("nan"),
        "frames": len(loss_list),
        "lpips_weights": lpips_source,
    }
    print(f"Reconstruction loss (L1): {results['l1']}")
    print(f"lpips loss: {results['lpips']}")
    print(f"psnr: {results['psnr']}")
    return results


def animate(
    config: Dict[str, Any],
    model: MRFA,
    log_dir: str,
    dataset,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> List[str]:
    """Animate each source of `PairedDataset` pairs by its driving video with
    relative motion; returns the paths of the visualization videos written."""
    dev = resolve_device(device)
    log_dir = os.path.join(log_dir, "animation")
    os.makedirs(log_dir, exist_ok=True)
    params = config["animate_params"]
    norm = params.get("normalization_params", params)

    paired = PairedDataset(dataset, number_of_pairs=params["num_pairs"])
    animator = Animator(
        model, model.state_dict(), device=dev,
        relative=norm.get("use_relative_movement", True),
        use_relative_jacobian=norm.get("use_relative_jacobian", True),
    )
    visualizer = Visualizer(**(config.get("visualizer_params") or {}))

    written = []
    for it in range(len(paired)):
        x = paired[it]
        driving_video = x["driving_video"]  # (T, H, W, 3)
        source = x["source_video"][0]
        clip_state = animator.begin(
            source, driving_video[0],
            adapt_movement_scale=norm.get("adapt_movement_scale", False),
        )
        visualizations = []
        for t in range(driving_video.shape[0]):
            out = animator.animate_frame(clip_state, driving_video[t])[0].cpu().numpy()
            visualizations.append(visualizer.visualize(
                source=source[None], driving=driving_video[t : t + 1], out=out))
        name = f"{x['driving_name']}-{x['source_name']}.mp4"
        written.append(save_video(os.path.join(log_dir, name), visualizations))
    return written
