"""RaftFlow, the multi-resolution motion refinement decoder, NCHW.

Counterpart of mrfa_tpu/models/raft.py::RaftFlow, in eval and train mode:
  - per-query 2-level correlation maps at the basic resolution (size/4),
    built as batched products of driving query features against source
    features (pooling either side of the volume is linear, so each level is
    one product against pooled features);
  - six refinement iterations over resolutions size/32 .. size, each with a
    7x7 two-level window lookup (`CorrLookupFn`: the `corr_lookup` kernel
    forward, the `corr_lookup_bwd` kernel backward), the motion
    encoder, a context warp and the refine convs, with telescoping
    upsampling of the deltas on top of the prior flow;
  - per-scale feature warps, a coarse branch warped by the prior flow alone,
    and the generator decode.

With `prior_only` it is the generator alone, decoding the source features
warped by the dense-motion prior (no refinement, no correlation).

Under the bf16 policy (`compute_dtype`, see precision.py) the final image
warp reads bf16 pixels; the correlation maps are bf16 because the features
they are built from are.

Flows are (B, 2, H, W) in pixels at their own resolution; they are turned
into (B, H, W, 2) sampling grids at each warp. The lookup's window x offset
runs along the first window axis (the reference's channel order).

Training runs the same code with autograd: the levels are built once per
driving resolution and the full-resolution ones are shared by the last
iterations, with no activation checkpointing (the JAX package's remat
regions and in-iteration level building exist for a 16 GB TPU chip; the
training step fits the 80 GB card without them). The final image warp stays
separate from the last context warp.

`shard_queries` splits each sample's correlation queries over a mesh's
'model' group (the JAX package's `maybe_constrain(c0, "data", "model",
None)`): each rank builds the levels of its contiguous block of the queries
against the whole source features, looks them up, and gathers the 98-channel
windows of every block back before the motion encoder; everything else runs
whole on each rank. The driving and source features and each iteration's
lookup coordinates pass through `group_copy`, whose backward sums the
blocks' partial cotangents.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mrfa_tpu_torch.models.generator import OcclusionAwareGenerator, pyramid_channels
from mrfa_tpu_torch.nn.blocks import Hourglass, conv2d
from mrfa_tpu_torch.ops.corr_lookup import CorrLookupFn
from mrfa_tpu_torch.ops.grid import coords_grid, kp2gaussian
from mrfa_tpu_torch.ops.resize import avg_pool, resize_bilinear
from mrfa_tpu_torch.ops.sampler import grid_sample, sample_pixel
from mrfa_tpu_torch.parallel.mesh import MODEL_AXIS, gather_rows, group_copy, model_shard


def _id_grid(res: int, like: torch.Tensor) -> torch.Tensor:
    """Pixel identity grid as a (1, 2, res, res) flow-shaped tensor."""
    return coords_grid(res, res, dtype=like.dtype, device=like.device).permute(2, 0, 1)[None]


def _to_grid(flow: torch.Tensor) -> torch.Tensor:
    """(B, 2, H, W) -> (B, H, W, 2)."""
    return flow.permute(0, 2, 3, 1)


class BasicMotionEncoder(nn.Module):
    def __init__(self, num_levels: int = 2, radius: int = 3):
        super().__init__()
        cor_planes = num_levels * (2 * radius + 1) ** 2
        self.convc1 = conv2d(cor_planes, 128, 1)
        self.convc2 = conv2d(128, 96, 3, padding=1)
        self.convf1 = conv2d(2, 128, 7, padding=3)
        self.convf2 = conv2d(128, 64, 3, padding=1)
        self.conv = conv2d(96 + 64, 126, 3, padding=1)

    def forward(self, delta_flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(delta_flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, delta_flow], dim=1)  # 128 channels


class RefineFlow(nn.Module):
    def __init__(self):
        super().__init__()
        self.convc1 = conv2d(192, 128, 3, padding=1)
        self.conv1 = conv2d(256, 128, 3, padding=1)
        self.conv2 = conv2d(128, 2, 3, padding=1)
        self.convo1 = conv2d(256, 128, 3, padding=1)
        self.convo2 = conv2d(128, 1, 3, padding=1)

    def forward(self, m_f: torch.Tensor, warp_f: torch.Tensor):
        inp = torch.cat([m_f, F.relu(self.convc1(warp_f))], dim=1)  # 256 channels
        flow = self.conv2(F.relu(self.conv1(inp)))
        occ = self.convo2(F.relu(self.convo1(inp)))
        return torch.cat([flow, occ], dim=1), inp


class RaftFlow(nn.Module):
    query_group = None  # set by `shard_queries`

    def __init__(
        self,
        prior_only: bool = False,
        num_kp: int = 10,
        dim: int = 256,
        size: int = 256,
        generator: Optional[Dict[str, Any]] = None,
        driving_encoder: Optional[Dict[str, Any]] = None,
        source_encoder: Optional[Dict[str, Any]] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.prior_only = prior_only
        self.compute_dtype = compute_dtype
        self.dim = dim
        self.size = size
        self.scale = dim**-0.5
        self.h = self.w = size // 4
        self.total_iter = int(math.log2(32)) + 1  # 6 fixed refinement steps
        self.basic_res_index = int(math.log2(self.h // (size // 32)))
        gen_cfg = dict(generator or {})
        self.generator = OcclusionAwareGenerator(**gen_cfg, coarse_branch=not prior_only)
        if prior_only:
            return
        self.kp = Hourglass(**(driving_encoder or {}))
        self.kp_img = Hourglass(**(source_encoder or {}))
        self.kp_head = conv2d(self.kp.out_filters, dim, 1)
        self.kp_img_head = conv2d(self.kp_img.out_filters, dim, 1)
        # learned positional embedding in torch layout (1, K, h, w)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_kp, self.h, self.w))
        nn.init.trunc_normal_(self.pos_embedding, std=0.02, a=-0.04, b=0.04)
        self.corr_enc = BasicMotionEncoder()
        self.refine = RefineFlow()
        chans = pyramid_channels(
            gen_cfg.get("block_expansion", 64), gen_cfg.get("max_features", 512),
            gen_cfg.get("num_up_blocks", 5),
        )
        self.to_context = nn.ModuleList(conv2d(c, 192, 1) for c in chans[: self.total_iter])

    def encode_source(self, kp_s: torch.Tensor, img: torch.Tensor, img_full: torch.Tensor):
        """Per-clip-constant source work, hoisted out of the frame loop: the
        generator feature pyramid and the source correlation features, plain
        (f_s) and 2x2-pooled (f_s_p), each (B, n, dim)."""
        feature = self.generator.encode(img_full)
        if self.prior_only:
            return {"feature": feature}
        h, w = img.shape[-2:]
        g_s = kp2gaussian(kp_s, (h, w), 0.1) + self.pos_embedding
        k_s = self.kp_img_head(self.kp_img(torch.cat([g_s, img], dim=1)))  # (B,dim,h,w)
        return {
            "feature": feature,
            "f_s": k_s.flatten(2).transpose(1, 2).contiguous(),
            "f_s_p": avg_pool(k_s, 2).flatten(2).transpose(1, 2).contiguous(),
        }

    def _own_queries(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous block of each sample's queries of the (B, nq,
        C) `x` under `shard_queries`; all of them otherwise."""
        group = self.query_group
        if group is None:
            return x
        index, count = dist.get_rank(group), dist.get_world_size(group)
        nq = x.shape[1]
        if nq % count:
            raise ValueError(f"{nq} queries do not split over {count} model ranks")
        per = nq // count
        return x[:, index * per:(index + 1) * per]

    def _build_levels(self, fd_sp: torch.Tensor, f_s: torch.Tensor, f_s_p: torch.Tensor):
        """(B*nq, h, w) and (B*nq, h/2, w/2) y-major maps of the (B, dim, hq, wq)
        queries (this rank's block of them under `shard_queries`) against the
        source features; the 1/sqrt(dim) volume scale is folded into the
        queries."""
        fd = self._own_queries(fd_sp.flatten(2).transpose(1, 2) * self.scale)  # (B, nq, dim)
        bq = fd.shape[0] * fd.shape[1]
        map0 = torch.matmul(fd, f_s.transpose(1, 2)).reshape(bq, self.h, self.w)
        map1 = torch.matmul(fd, f_s_p.transpose(1, 2)).reshape(bq, self.h // 2, self.w // 2)
        return map0, map1

    def _refine_iter(self, i, flow, occlusion, d_f_pre, d_occ_pre, map0, map1,
                     feature_i, init_flow, init_occlusion):
        """One refinement iteration at resolution (size//32) * 2^i."""
        b = flow.shape[0]
        res = (self.size // 32) * (2**i)
        id_grid = _id_grid(res, flow)
        bri = self.basic_res_index

        # query coordinates against the (driving-pooled) correlation levels
        scale = float(2 ** (bri - i)) if i < bri else 1.0
        if i > bri:
            flow_sample = resize_bilinear(flow, self.h, align_corners=True) * (0.5 ** (i - bri))
            id_sample = _id_grid(self.h, flow)
        else:
            flow_sample, id_sample = flow, id_grid
        hq = flow_sample.shape[-1]
        coords = _to_grid((flow_sample + id_sample) * scale).reshape(b, -1, 2)
        group = self.query_group
        if group is not None:  # the flow's cotangent through each rank's block of coords
            coords = self._own_queries(group_copy(coords, group))
        coords = coords.reshape(-1, 2).contiguous()
        corr = CorrLookupFn.apply(map0, map1, coords)  # (B*hq*hq, 98), this rank's queries
        if group is not None:
            corr = gather_rows(corr.reshape(b, -1, corr.shape[-1]), group)
        corr = corr.reshape(b, hq, hq, -1).permute(0, 3, 1, 2)
        if i > bri:
            corr = resize_bilinear(corr, res, align_corners=True)

        m_f = self.corr_enc(flow, corr)
        warped = sample_pixel(feature_i, _to_grid(flow + id_grid))
        warp_f = F.relu(self.to_context[i](warped))
        d_all, _ = self.refine(m_f, warp_f)
        d_flow, d_occ = d_all[:, 0:2], d_all[:, 2:3]
        flow_w = flow + d_flow
        occlusion = occlusion + d_occ
        occ_logits = occlusion

        # telescoping upsample of the deltas on top of the prior flow
        if i < self.total_iter - 1:
            nxt = res * 2
            scale_init = 2.0 ** (bri - i) / 2.0
            d_f = resize_bilinear(d_flow, nxt, align_corners=True) * 2.0
            flow = d_f + resize_bilinear(init_flow, nxt, align_corners=True) / scale_init
            if d_f_pre is None:
                d_f_pre = d_f
            else:
                up_pre = resize_bilinear(d_f_pre, nxt, align_corners=True) * 2.0
                flow = flow + up_pre
                d_f_pre = d_f + up_pre
            d_occ_up = resize_bilinear(d_occ, nxt, align_corners=True)
            occlusion = d_occ_up + resize_bilinear(init_occlusion, nxt, align_corners=True)
            if d_occ_pre is None:
                d_occ_pre = d_occ_up
            else:
                up_occ_pre = resize_bilinear(d_occ_pre, nxt, align_corners=True)
                occlusion = occlusion + up_occ_pre
                d_occ_pre = d_occ_up + up_occ_pre
        return flow, occlusion, d_f_pre, d_occ_pre, flow_w, occ_logits

    def _warp_decode(self, features, flow_ws, occs, deformation, warp_img):
        """Per-scale feature warps, the coarse prior-flow branch, and the decode.

        The decode reads the coarse branch at every scale but the finest, so
        that warp is not computed (the JAX package computes it and its
        compiler drops it)."""
        out_warp_f, out_warp_f_c = [], []
        prior = deformation.permute(0, 3, 1, 2)  # (B, 2, h, w) normalized
        for i, (feat, flow_w) in enumerate(zip(features, flow_ws)):
            res = feat.shape[-1]
            out_warp_f.append(sample_pixel(feat, _to_grid(flow_w + _id_grid(res, flow_w))))
            if i == len(features) - 1:
                continue
            flow_res = (
                deformation if i == self.basic_res_index
                else _to_grid(resize_bilinear(prior, res, align_corners=True))
            )
            out_warp_f_c.append(grid_sample(feat, flow_res, align_corners=False))
        return self.generator.decode(out_warp_f, warp_img, occs, out_warp_f_c)

    def _prior_only_forward(self, dense_motion, feature, img):
        """Decode the source features warped by the prior alone: each scale
        takes the prior grid and occlusion resized to it (align_corners=True),
        and the image is warped by the finest one."""
        deformation = dense_motion["deformation"]  # (B, h, w, 2) normalized
        prior = deformation.permute(0, 3, 1, 2)
        occlusion = dense_motion["occlusion"]  # logits (B, 1, h, w)
        out_warp_f, out_occlusion = [], []
        for feat in feature[: self.total_iter]:
            res = feat.shape[-1]
            if res != deformation.shape[1]:
                flow_res = _to_grid(resize_bilinear(prior, res, align_corners=True))
                occlusion_res = resize_bilinear(occlusion, res, align_corners=True)
            else:
                flow_res, occlusion_res = deformation, occlusion
            out_warp_f.append(grid_sample(feat, flow_res, align_corners=False))
            out_occlusion.append(torch.sigmoid(occlusion_res))
        warp_img = grid_sample(img, flow_res, align_corners=False)
        out = self.generator.decode(out_warp_f, warp_img, out_occlusion)
        vis = [resize_bilinear(o, self.size, align_corners=True) for o in out_occlusion]
        return out, warp_img, torch.cat(vis, dim=3)

    def forward(
        self,
        kp_s: torch.Tensor,
        kp_d: torch.Tensor,
        dense_motion: Dict[str, torch.Tensor],
        img: torch.Tensor,
        img_full: torch.Tensor,
        source_cache: Optional[Dict[str, Any]] = None,
    ):
        """Returns (generated (B,3,H,W), warped source (B,3,H,W), occlusion
        strip (B,1,H,7W))."""
        if source_cache is None:
            source_cache = self.encode_source(kp_s, img, img_full)
        feature = source_cache["feature"]
        img_cast = img_full if self.compute_dtype is None else img_full.to(self.compute_dtype)
        if self.prior_only:
            return self._prior_only_forward(dense_motion, feature, img_cast)
        f_s, f_s_p = source_cache["f_s"], source_cache["f_s_p"]
        h, w = img.shape[-2:]

        g_d = kp2gaussian(kp_d, (h, w), 0.1) + self.pos_embedding
        q_d = self.kp_head(self.kp(g_d))  # (B, dim, h, w) driving query features
        if self.query_group is not None:  # each rank's lookups use a part of each
            q_d, f_s, f_s_p = (group_copy(t, self.query_group) for t in (q_d, f_s, f_s_p))

        # correlation levels per driving resolution; the full-resolution
        # levels are built once and shared by the last iterations
        bri = self.basic_res_index
        full_levels = self._build_levels(q_d, f_s, f_s_p)
        levels: List[Any] = [
            self._build_levels(avg_pool(q_d, 2 ** (bri - i)), f_s, f_s_p)
            if i < bri else full_levels
            for i in range(self.total_iter)
        ]

        # prior motion initialization (normalized -> pixel flow)
        deformation = dense_motion["deformation"]  # (B, h, w, 2)
        init_flow = (h - 1) * (deformation.permute(0, 3, 1, 2) + 1.0) / 2.0 - _id_grid(
            h, deformation
        )
        init_occlusion = dense_motion["occlusion"]
        flow = resize_bilinear(init_flow, self.size // 32, align_corners=True) / 8.0
        occlusion = resize_bilinear(init_occlusion, self.size // 32, align_corners=True)

        out_flow_w, out_occ_logits = [], []
        d_f_pre = d_occ_pre = None
        for i in range(self.total_iter):
            map0, map1 = levels[i]
            flow, occlusion, d_f_pre, d_occ_pre, flow_w, occ_logits = self._refine_iter(
                i, flow, occlusion, d_f_pre, d_occ_pre, map0, map1, feature[i],
                init_flow, init_occlusion,
            )
            out_flow_w.append(flow_w)
            out_occ_logits.append(occ_logits)

        # as the reference: the final image warp uses the last iteration's
        # pre-refinement flow
        warp_img = sample_pixel(img_cast, _to_grid(flow + _id_grid(self.size, flow)))
        out_occlusion = [torch.sigmoid(o) for o in out_occ_logits]
        out = self._warp_decode(
            feature[: self.total_iter], out_flow_w, out_occlusion, deformation, warp_img
        )
        vis = [
            resize_bilinear(o, self.size, align_corners=True)
            for o in out_occlusion + [torch.sigmoid(init_occlusion)]
        ]
        return out, warp_img, torch.cat(vis, dim=3)


def shard_queries(model: nn.Module, mesh) -> nn.Module:
    """Every `RaftFlow` of `model` splits each sample's correlation queries
    over `mesh`'s model group, each rank taking its contiguous block (a
    group of one rank: all of them again). The ranks of the group must hold
    the same rows and weights."""
    group = mesh.get_group(MODEL_AXIS) if model_shard(mesh)[1] > 1 else None
    for m in model.modules():
        if isinstance(m, RaftFlow):
            m.query_group = group
    return model
