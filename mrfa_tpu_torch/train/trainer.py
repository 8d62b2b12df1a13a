"""The training step, for each of the three priors.

Counterpart of mrfa_tpu/train/trainer.py::make_train_step (reference
train.py): forward in train mode (BatchNorm on batch statistics, running
statistics updated), the loss terms summed, backward, per-subtree inf-norm
clipping, Adam and the MultiStep learning rate on the main subtrees and, in
the background predictor's phases (`use_bg`), on `bg_predictor` as well.
f32 by default; under `compute_dtype=torch.bfloat16` the forward and its
backward compute in bf16 where `precision.py`'s policy says so, while the
parameters (the master weights), their gradients, the clip and Adam's
moments stay f32, as in the JAX step, where optax sees f32 parameters and
the layers cast inside the traced step. The caller sets the TF32 policy
(the port runs with TF32 off).

With a mesh (`parallel.mesh`) each process steps on its own rows of the
global batch (its data coordinate) and, on a model dimension of more than
one rank, looks up its own block of each sample's correlation queries
(`models.raft.shard_queries`). The step equals one process's step on the
global batch: the equivariance transforms and the TPSM dropout masks are
drawn for the global batch from the same generators on every rank and
sliced by the data coordinate, BatchNorm takes the global batch's
statistics over the data group, the gradients are averaged before the clip
and the loss terms are averaged, so every rank keeps the same weights and
reports the global loss. The gradients and the loss terms are averaged
over the whole world, not the data group: the ranks of a model group hold
equal values in exact arithmetic, so the mean is the same, and the world's
one all_reduce leaves every rank's weights bit-equal even where the card's
replicated compute is not deterministic (the bf16 splat adds a bin's
samples in slot-claim order). BatchNorm's statistics stay over the data
group: its inputs are the same bits on every rank of a model group (the
gathered lookups are, and the forward is deterministic). A world of one
rank takes the plain step: there is nothing to sync, average or slice.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from mrfa_tpu_torch.models.dense_motion import dropout_keep
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.models.raft import shard_queries
from mrfa_tpu_torch.nn.norm import sync_batch_norm
from mrfa_tpu_torch.ops.tps import random_transform_params
from mrfa_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    average_gradients,
    average_scalars,
    data_shard,
    model_shard,
    replicated,
    shard_rows,
)
from mrfa_tpu_torch.train.optim import BG_SUBTREES, clip_inf_norm_subtrees, make_optimizer
from mrfa_tpu_torch.utils import profiling
from mrfa_tpu_torch.utils.convert import load_jax_variables
from mrfa_tpu_torch.utils.device import frames_to_device, resolve_device


class Trainer:
    """One MRFA model and its optimizers, on CUDA unless the caller passes
    another device.

    `weights` is a port `state_dict()` or the JAX package's variables
    {'params', 'batch_stats'}; without it the model keeps the initializers'
    values drawn under the caller's RNG state, VGG19 included, and warns:
    its perceptual loss is then not the reference's until the caller loads
    the ImageNet VGG19 (`weights.overlay_vgg19`, as `loop.train` does after
    building the Trainer). `generator` draws the equivariance transforms (a
    CPU generator seeded 0 when None) and `dropout_generator` the TPSM
    prior's channel-dropout masks (a CPU generator seeded 1 when None). A
    model with a background predictor (`bg_start` < `num_epochs`) gets its second
    Adam group, which steps only in `use_bg` steps, so its learning-rate
    milestones count those steps (as the JAX package's `opt_state_bg`).
    `compute_dtype` (None: f32, or torch.bfloat16) is the model's precision
    policy; the weights are never pre-cast (`cast_params_for_inference`
    refuses a model in training mode), so the optimizer keeps f32 masters
    and the checkpoint tree is the f32 one. `mesh` (a `parallel.mesh`
    DeviceMesh over the world) makes this process one rank: `train_step`
    takes this rank's rows of the global batch (its data coordinate's), the
    model's correlation queries are split over the model dimension when it
    holds more than one rank, and in a world of more than one rank the model
    is replicated from global rank 0.
    """

    def __init__(
        self,
        cfg: Dict[str, Any],
        device: Optional[Union[str, torch.device]] = None,
        steps_per_epoch: int = 1000,
        generator: Optional[torch.Generator] = None,
        weights: Optional[Mapping[str, Any]] = None,
        dropout_generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[torch.dtype] = None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        tp = cfg["train_params"]
        self.model = MRFA(cfg, device=self.device, compute_dtype=compute_dtype)
        if weights is not None and "params" in weights:
            load_jax_variables(self.model, weights)
        elif weights is not None:
            self.model.load_state_dict(weights)
        if hasattr(self.model, "vgg") and weights is None:
            warnings.warn(
                "the perceptual loss runs on a RANDOMLY INITIALIZED VGG19, not the "
                "reference's ImageNet VGG19 (weights.overlay_vgg19 loads the vendored one)",
                stacklevel=2,
            )
        self.model.train()
        milestones = tp.get("epoch_milestones", [])
        self.optimizer, self.scheduler = make_optimizer(
            self.model, tp["lr"], milestones, steps_per_epoch
        )
        self.optimizer_bg = self.scheduler_bg = None
        if hasattr(self.model, "bg_predictor"):
            self.optimizer_bg, self.scheduler_bg = make_optimizer(
                self.model, tp["lr"], milestones, steps_per_epoch, BG_SUBTREES
            )
        self.clip = tp.get("clip", 10.0) if tp.get("clip_grad", True) else None
        self.generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dropout_generator = (dropout_generator if dropout_generator is not None
                                  else torch.Generator().manual_seed(1))
        self.steps = 0
        self.batch_shard = data_shard(mesh)  # (this rank, the ranks) of the global batch
        world = dist.get_world_size() if mesh is not None else 1
        self.group = dist.group.WORLD if world > 1 else None  # the gradient and loss means
        if self.batch_shard[1] > 1:
            sync_batch_norm(self.model, mesh.get_group(DATA_AXIS))
        if model_shard(mesh)[1] > 1:
            shard_queries(self.model, mesh)
        if self.group is not None:
            replicated(self.model)

    def _frames(self, x) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1], numpy or tensor -> (B, 3, H, W) f32 on the device."""
        return frames_to_device(x, self.device)

    def train_step(
        self, batch: Mapping[str, Any], use_bg: bool = False, dropout_flag: bool = False,
        dropout_p: float = 0.0,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """One training step on {"source", "driving"} with no host sync, the
        channel dropout of probability `dropout_p` on when `dropout_flag` ->
        (the loss terms as 0-d tensors, "loss" their sum; the generated
        frames "gen", the warp strip "warp_vis" (both NHWC) and the keypoints
        "kp_s", "kp_d"), all on the device and detached."""
        if use_bg and self.optimizer_bg is None:
            raise ValueError("use_bg needs a model with a bg_predictor (bg_start < num_epochs)")
        with profiling.span("train.step"):
            source = self._frames(batch["source"])
            driving = self._frames(batch["driving"])
            tp = self.cfg["train_params"]
            index, count = self.batch_shard

            def rows(x):  # this rank's rows of a draw for the global batch
                return x if count == 1 or x is None else shard_rows(x, index, count)

            with profiling.span("train.forward"):
                transform = keep = None
                if tp["loss_weights"].get("equivariance", 0) != 0:
                    transform = random_transform_params(
                        self.generator, source.shape[0] * count, **tp["transform_params"],
                        device=self.device
                    )
                    transform = transform._replace(theta=rows(transform.theta),
                                                   control_params=rows(transform.control_params))
                if dropout_flag:
                    keep = rows(dropout_keep(source.shape[0] * count,
                                             self.model.dense_motion.motions, dropout_p,
                                             self.dropout_generator, self.device))
                gen, warp_vis, losses, kp_s, kp_d = self.model(
                    source, driving, compute_loss=True, transform=transform, use_bg=use_bg,
                    dropout_flag=dropout_flag, dropout_p=dropout_p, dropout_keep=keep,
                )
                total = sum(losses.values())
            with profiling.span("train.backward"):
                self.model.zero_grad(set_to_none=True)
                total.backward()
            terms = {"loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
            if self.group is not None:
                with profiling.span("train.allreduce"):
                    average_gradients(self.model.parameters(), self.group)
                    terms = average_scalars(terms, self.group)
            with profiling.span("train.update"):
                self.apply_gradients(use_bg)
            self.steps += 1
            extras = {"gen": gen.detach().permute(0, 2, 3, 1),
                      "warp_vis": warp_vis.detach().permute(0, 2, 3, 1),
                      "kp_s": kp_s.detach(), "kp_d": kp_d.detach()}
            return terms, extras

    def apply_gradients(self, use_bg: bool) -> None:
        """Clip, then one update of the main group and, when `use_bg`, of the
        background predictor's; each group's schedule steps with it."""
        if self.clip is not None:
            clip_inf_norm_subtrees(self.model, self.clip)
        self.optimizer.step()
        self.scheduler.step()
        if use_bg:
            self.optimizer_bg.step()
            self.scheduler_bg.step()

    def step(self, batch: Mapping[str, Any], use_bg: bool = False, dropout_flag: bool = False,
             dropout_p: float = 0.0) -> Dict[str, Any]:
        """One training step on {"source", "driving"} -> the loss terms as
        Python floats ("loss" is their sum) and the generated frames "gen"
        (B, H, W, 3)."""
        terms, extras = self.train_step(batch, use_bg, dropout_flag, dropout_p)
        return {**{k: float(v) for k, v in terms.items()}, "gen": extras["gen"]}

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resumed run needs to continue bit for bit: the model
        (running statistics included), both optimizers and schedules, the
        equivariance generator's state, under TPSM the dropout generator's
        and the step count."""
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "generator": self.generator.get_state(),
            "step": self.steps,
        }
        if self.model.prior_model == "tpsm":
            state["dropout_generator"] = self.dropout_generator.get_state()
        if self.optimizer_bg is not None:
            state["optimizer_bg"] = self.optimizer_bg.state_dict()
            state["scheduler_bg"] = self.scheduler_bg.state_dict()
        return state

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.optimizer_bg is not None:
            self.optimizer_bg.load_state_dict(state["optimizer_bg"])
            self.scheduler_bg.load_state_dict(state["scheduler_bg"])
        self.generator.set_state(state["generator"])
        if self.model.prior_model == "tpsm":
            self.dropout_generator.set_state(state["dropout_generator"])
        self.steps = int(state["step"])
