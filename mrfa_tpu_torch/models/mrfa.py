"""MRFA composite model: serving surface and training forward.

Counterpart of mrfa_tpu/models/mrfa.py::MRFA: the prior that
`train_params.prior_model` selects (mtia: the TokenPose encoder; fomm: the
hourglass `KPDetector`; tpsm: the ResNet `TPSKPDetector` with the TPS dense
motion) as the encoder (`encoder`) and the dense motion network
(`dense_motion`), the RaftFlow decoder (`decoder`),
the background motion predictor (`bg_predictor`, built when the config's
`bg_start` < `num_epochs`) and, when the perceptual loss is on, the frozen
VGG19 (`vgg`). `forward` is the training forward with its losses: the
multi-scale VGG19 perceptual pyramid, the keypoint and jacobian equivariance
losses under a random affine + TPS transform and, with `use_bg`, the
background consistency loss. Under TPSM the decoder sees each group of 5
keypoints as their mean, and the dense motion may take the channel dropout.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn

from mrfa_tpu_torch.models.bg_motion import BGMotionPredictor
from mrfa_tpu_torch.models.dense_motion import DenseMotionNetwork, TPSDenseMotionNetwork
from mrfa_tpu_torch.models.kp_detector import KPDetector, TPSKPDetector
from mrfa_tpu_torch.models.raft import RaftFlow
from mrfa_tpu_torch.models.tokenpose import TokenPoseB
from mrfa_tpu_torch.nn.vgg import Vgg19
from mrfa_tpu_torch.precision import apply_compute_dtype
from mrfa_tpu_torch.ops.resize import antialias_downsample
from mrfa_tpu_torch.ops.tps import (
    RandomTransformParams,
    random_transform_frame,
    random_transform_jacobian,
    random_transform_params,
    random_transform_warp,
)
from mrfa_tpu_torch.utils.device import resolve_device


def mtia_encoder_from_cfg(mtia_cfg: Dict[str, Any]) -> TokenPoseB:
    """Build the MTIA TokenPose encoder from the caps-style MODEL config."""
    m = mtia_cfg["MODEL"]
    return TokenPoseB(
        num_keypoints=m["NUM_JOINTS"],
        dim=m["DIM"],
        depth=m["TRANSFORMER_DEPTH"],
        heads=m["TRANSFORMER_HEADS"],
        mlp_ratio=m.get("TRANSFORMER_MLP_RATIO", 3),
        image_size=m["IMAGE_SIZE"][0],
        patch_size=m["PATCH_SIZE"][0],
        base_channel=m.get("BASE_CHANNEL", 32),
        estimate_jacobian=m.get("ESTIMATE_JACOBIAN", True),
    )


class MRFA(nn.Module):
    """Built on `device` (CUDA unless the caller names another), in eval mode;
    call `.train()` before the training forward.

    Weights come from torch's default initializers under the caller's RNG
    state; load trained ones with `load_state_dict` or
    `utils.convert.load_jax_variables`.
    """

    def __init__(self, cfg: Dict[str, Any], device: Optional[Union[str, torch.device]] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        """`compute_dtype`: None (f32 throughout, the default) or torch.bfloat16
        for the serving policy of `precision.py`; `Animator` then pre-casts
        the weights it covers."""
        super().__init__()
        dev = resolve_device(device)
        self.compute_dtype = compute_dtype
        tp = cfg["train_params"]
        self.prior_model = tp["prior_model"]
        self.scales = list(tp.get("scales", [1]))
        self.loss_weights = tp.get("loss_weights", {})
        self.transform_params = tp.get("transform_params", {})
        if self.prior_model == "fomm":
            self.encoder = KPDetector(**cfg["fomm_kp_detector"])
        elif self.prior_model == "tpsm":
            self.encoder = TPSKPDetector(**cfg["tpsm_kp_detector"])
        elif self.prior_model == "mtia":
            self.encoder = mtia_encoder_from_cfg(cfg["mtia_kp_detector"])
        else:
            raise ValueError(f"unknown prior_model {self.prior_model!r}")
        if self.prior_model == "tpsm":
            self.dense_motion = TPSDenseMotionNetwork(**cfg["tpsm_dense_motion"])
        else:
            self.dense_motion = DenseMotionNetwork(**cfg["dense_motion"],
                                                   compute_dtype=compute_dtype)
        if tp.get("bg_start", 0) < tp.get("num_epochs", 0):
            self.bg_predictor = BGMotionPredictor()
        # remat and the lookup-dispatch keys only steer the JAX package's TPU paths
        raft_cfg = {
            k: v for k, v in cfg["raft_flow"].items()
            if k not in ("remat", "fast_lookup", "lookup_impl")
        }
        self.decoder = RaftFlow(**raft_cfg, compute_dtype=compute_dtype)
        if sum(self.loss_weights.get("perceptual", [0])) != 0:
            self.vgg = Vgg19()
        if compute_dtype is not None:
            apply_compute_dtype(self, compute_dtype)
        self.to(dev)
        self.eval()

    def encode_kp(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.encoder(image)

    def run_dense_motion(self, source, kp_d, kp_s, bg_param=None, dropout_flag=False,
                         dropout_p=0.0, keep=None) -> Dict[str, torch.Tensor]:
        return self.dense_motion(source, kp_d, kp_s, bg_param, dropout_flag, dropout_p, keep)

    def kp_for_decoder(self, kp: Dict[str, torch.Tensor]) -> torch.Tensor:
        """TPSM keypoints are averaged 5 -> 1 per group before RaftFlow."""
        v = kp["kp"]
        if self.prior_model == "tpsm":
            return v.reshape(v.shape[0], -1, 5, 2).mean(dim=2)
        return v

    def encode_source_cache(self, source, kp_source, img_down):
        """Per-clip-constant decoder source work: generator feature pyramid and
        source correlation features. Pass it as `source_cache` to `decoder`."""
        return self.decoder.encode_source(self.kp_for_decoder(kp_source), img_down, source)

    def pyramid(self, x: torch.Tensor) -> Dict[float, torch.Tensor]:
        return {s: antialias_downsample(x, s) for s in self.scales}

    def perceptual_loss(self, driving: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
        """The weighted L1 distance of VGG19 features over the image pyramid;
        under the bf16 policy each term is a bf16 mean and the sum stays
        bf16 (as the JAX package's `0.0 + w * mean`)."""
        pyr_real = self.pyramid(driving)
        pyr_gen = self.pyramid(gen)
        total = 0.0
        for s in self.scales:
            x_feats = self.vgg(pyr_gen[s])
            with torch.no_grad():  # the real branch is a constant
                y_feats = self.vgg(pyr_real[s])
            for i, weight in enumerate(self.loss_weights["perceptual"]):
                total = total + weight * torch.mean(torch.abs(x_feats[i] - y_feats[i]))
        return total

    def equivariance_losses(self, kp_d: Dict[str, torch.Tensor],
                            transformed_kp: Dict[str, torch.Tensor],
                            transform: RandomTransformParams) -> Dict[str, torch.Tensor]:
        """The keypoint equivariance loss and, where the config weighs it and
        the encoder makes jacobians, the jacobian one, from the driving
        keypoints and those of the driving frame under `transform`. The
        transform's f32 promotes bf16 keypoints, so both are f32."""
        weights = self.loss_weights
        warped_back = random_transform_warp(transform, transformed_kp["kp"])
        out = {"equivariance": weights["equivariance"] * torch.mean(
            torch.abs(kp_d["kp"] - warped_back))}
        if weights.get("equivariance_jacobian", 0) != 0 and "jacobian" in kp_d:
            t_jac = random_transform_jacobian(transform, transformed_kp["kp"])
            jacobian_transformed = torch.matmul(t_jac, transformed_kp["jacobian"])
            # inv_ex: no host sync for the singularity check (as jnp.linalg.inv)
            inv_d = torch.linalg.inv_ex(kp_d["jacobian"]).inverse
            value = torch.matmul(inv_d, jacobian_transformed)
            eye = torch.eye(2, dtype=value.dtype, device=value.device)
            out["equivariance_jacobian"] = weights["equivariance_jacobian"] * torch.mean(
                torch.abs(eye - value))
        return out

    def forward(
        self,
        source: torch.Tensor,
        driving: torch.Tensor,
        compute_loss: bool = True,
        transform: Optional[RandomTransformParams] = None,
        use_bg: bool = False,
        dropout_flag: bool = False,
        dropout_p=0.0,
        dropout_keep: Optional[torch.Tensor] = None,
    ):
        """The training forward of (B, 3, H, W) frames in [0, 1].

        `transform` is the equivariance transform; when None it is drawn from
        torch's default generator. `use_bg` runs the background predictor
        (the model must have built it). `dropout_flag` takes the channel
        dropout in the dense motion, each channel dropped with probability
        `dropout_p`: `dropout_keep` is the (B, K+1) keep mask (drawn from
        torch's default generator when None). Returns (generated (B, 3, H, W), the
        warped-image + occlusion strip (B, 3, H, 8W), the loss terms, the
        source and driving keypoints).
        """
        # module calls in the JAX order (BatchNorm running statistics depend
        # on it): the encoder on source and driving, bg(source, driving), the
        # dense motion, the decoder, the encoder on the transformed driving
        # frame, then bg(driving, source)
        kp_s = self.encode_kp(source)
        kp_d = self.encode_kp(driving)
        img_down = antialias_downsample(source, 0.25)
        bg_param = self.bg_predictor(source, driving) if use_bg else None
        dense_motion = self.run_dense_motion(source, kp_d, kp_s, bg_param, dropout_flag,
                                             dropout_p, dropout_keep)
        gen, warp_img, occlusion = self.decoder(
            self.kp_for_decoder(kp_s), self.kp_for_decoder(kp_d), dense_motion,
            img_down, source,
        )
        warp_vis = torch.cat([warp_img, occlusion.expand(-1, 3, -1, -1)], dim=3)

        losses: Dict[str, torch.Tensor] = {}
        if not compute_loss:
            return gen, warp_vis, losses, kp_s["kp"], kp_d["kp"]

        weights = self.loss_weights
        if sum(weights.get("perceptual", [0])) != 0:
            losses["perceptual"] = self.perceptual_loss(driving, gen)

        if weights.get("equivariance", 0) != 0:
            if transform is None:
                transform = random_transform_params(
                    None, driving.shape[0], **self.transform_params, device=driving.device
                )
            transformed_kp = self.encode_kp(random_transform_frame(transform, driving))
            losses.update(self.equivariance_losses(kp_d, transformed_kp, transform))

        if use_bg:
            value = torch.matmul(bg_param, self.bg_predictor(driving, source))
            eye = torch.eye(3, dtype=value.dtype, device=value.device)
            losses["bg"] = 10.0 * torch.mean(torch.abs(eye - value))
        return gen, warp_vis, losses, kp_s["kp"], kp_d["kp"]
