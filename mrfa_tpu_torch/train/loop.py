"""The training loop: epochs, phase schedule, checkpoints, true resume.

Counterpart of mrfa_tpu/train/loop.py (the reference's train.py), on one
device or, with a data mesh (`parallel.mesh`), on one device a process:
DatasetRepeater epochs, the MultiStep milestones (in `Trainer`'s
schedules), the background predictor's phase from `bg_start`, the loss terms
flushed to the host every FLUSH_EVERY steps (no host sync in between), the
per-epoch log line, samples/s and visualization, and checkpoints every
`checkpoint_freq` epochs and at the last one.

A checkpoint holds the whole `Trainer` state (model, both optimizers and
schedules, the equivariance generator and, under TPSM, the dropout
generator, the step count), the epoch and the
dataset's random state, so a run resumed from it continues as the straight
run would have, bit for bit on the CPU, with one data worker (more workers
draw from the dataset's shared random state in no fixed order).

Over a mesh of W ranks each rank loads every W-th item of the epoch's
shuffle from its own index on, `batch_size // W` items a step; the log, the
visualizations and the checkpoints are rank 0's, a checkpoint holds every
rank's dataset random state, and each rank resumes its own.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from mrfa_tpu_torch.config import model_config
from mrfa_tpu_torch.data.dataset import BatchLoader, DatasetRepeater
from mrfa_tpu_torch.parallel.mesh import DATA_AXIS, data_shard
from mrfa_tpu_torch.train.trainer import Trainer
from mrfa_tpu_torch.utils.checkpoint import (
    load_torch_weights_into,
    restore_checkpoint,
    save_checkpoint,
)
from mrfa_tpu_torch.utils.logger import Logger
from mrfa_tpu_torch.weights import overlay_vgg19

FLUSH_EVERY = 64  # steps whose loss terms stay on the device before one copy


def epoch_phase(tp: Dict[str, Any], epoch: int) -> Tuple[bool, bool, float]:
    """(use_bg, dropout_flag, dropout_p) of `epoch`, the JAX loop's formulas:
    the background predictor from `bg_start` on, and the TPSM prior's
    channel-dropout schedule."""
    num_epochs, bg_start = tp["num_epochs"], tp["bg_start"]
    use_bg = epoch >= bg_start and bg_start < num_epochs
    if tp["prior_model"] == "tpsm" and epoch < tp.get("dropout_epoch", 0):
        p = epoch / tp["dropout_inc_epoch"] * tp["dropout_maxp"] + tp["dropout_startp"]
        return use_bg, True, min(p, tp["dropout_maxp"])
    return use_bg, False, 0.0


def train_compute_dtype(tp: Dict[str, Any]) -> Optional[torch.dtype]:
    """The precision policy `train_params.compute_dtype` names (as the JAX
    loop reads it): None for f32 (absent, "f32", "float32"), torch.bfloat16
    for "bf16" / "bfloat16"; any other value raises."""
    name = tp.get("compute_dtype")
    if name in (None, "f32", "float32"):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"train_params.compute_dtype {name!r}: f32 or bf16")


def is_checkpoint_epoch(epoch: int, num_epochs: int, checkpoint_freq: int) -> bool:
    return (epoch + 1) % checkpoint_freq == 0 or epoch == num_epochs - 1


def _data_rng(dataset) -> Optional[np.random.RandomState]:
    """The random state of the dataset under any repeaters, if it has one."""
    while not hasattr(dataset, "rng") and hasattr(dataset, "dataset"):
        dataset = dataset.dataset
    rng = getattr(dataset, "rng", None)
    return rng if isinstance(rng, np.random.RandomState) else None


def _rng_state(rng: np.random.RandomState) -> Dict[str, Any]:
    kind, keys, pos, has_gauss, cached = rng.get_state()
    return {"keys": torch.from_numpy(keys.astype(np.int64)), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached_gaussian": float(cached)}


def _set_rng_state(rng: np.random.RandomState, state: Dict[str, Any]) -> None:
    rng.set_state(("MT19937", state["keys"].numpy().astype(np.uint32), state["pos"],
                   state["has_gauss"], state["cached_gaussian"]))


def _gather_rng_states(rng: Optional[np.random.RandomState], mesh):
    """This rank's dataset random state (None without one), or over a mesh
    of more than one rank the list of every rank's, on every rank."""
    state = None if rng is None else _rng_state(rng)
    _, world = data_shard(mesh)
    if world == 1:
        return state
    states = [None] * world
    dist.all_gather_object(states, state, group=mesh.get_group(DATA_AXIS))
    return states


def _restore_rng_state(rng: np.random.RandomState, saved, mesh) -> None:
    """Set `rng` to this rank's state in a checkpoint's `data_rng`."""
    rank, world = data_shard(mesh)
    if isinstance(saved, list) != (world > 1) or (world > 1 and len(saved) != world):
        ranks = len(saved) if isinstance(saved, list) else 1
        raise ValueError(f"the checkpoint holds the data state of {ranks} rank(s), this run "
                         f"has {world}: a true resume needs the same number")
    _set_rng_state(rng, saved[rank] if world > 1 else saved)


def _flush(logger: Logger, buf: List[Dict[str, torch.Tensor]]) -> None:
    """Copy the buffered steps' loss terms to the host at once and log them."""
    if not buf:
        return
    names = list(buf[0])
    values = torch.stack([torch.stack([m[k] for k in names]) for m in buf]).cpu()
    for row in values.tolist():
        logger.log_iter(dict(zip(names, row)))


def train(
    config: Dict[str, Any],
    checkpoint: Optional[str],
    log_dir: str,
    dataset,
    *,
    seed: int = 0,
    max_steps_per_epoch: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    mesh=None,
) -> Trainer:
    """Train `config`'s model on `dataset` (items {"source", "driving",
    "name"}, as `FramesDataset` gives them), on CUDA unless `device` names
    another. `checkpoint`: None (fresh weights from `seed`), a reference
    `.pth` (its weights, the decoder's positional embedding left out;
    optimizers and epochs start afresh) or a checkpoint directory this loop
    wrote (`<log_dir>/ckpt`: its latest step is resumed). `mesh`: this
    process's data mesh (`parallel.mesh.make_mesh`), `device` then this
    rank's device. Returns the Trainer."""
    tp = config["train_params"]
    num_epochs = tp["num_epochs"]
    compute_dtype = train_compute_dtype(tp)
    rank, world = data_shard(mesh)
    batch_size = tp["batch_size"] // world
    if tp["batch_size"] % world:
        warnings.warn(f"batch_size={tp['batch_size']} is not divisible by the {world} ranks: "
                      f"each rank takes {batch_size}, a global batch of {batch_size * world}",
                      stacklevel=2)
    if tp.get("num_repeats", 1) != 1:
        dataset = DatasetRepeater(dataset, tp["num_repeats"])
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=True, drop_last=True,
                         seed=seed, num_workers=tp.get("num_workers", 4),
                         shard_index=rank, num_shards=world)
    # the shortest shard's batches, so that every rank steps as often
    steps_per_epoch = len(dataset) // world // batch_size
    if max_steps_per_epoch is not None:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    cfg = model_config(config)
    # the JAX loop's default: no clipping unless the config asks for it
    cfg["train_params"]["clip_grad"] = tp.get("clip_grad", False)
    torch.manual_seed(seed)
    # the equivariance and dropout generators: the JAX loop's "equivariance"
    # and "dropout" rng streams. The vendored VGG19 is overlaid right after,
    # where the JAX loop does it (so the overlay, not the Trainer, warns when
    # the file is absent); a .pth or a checkpoint restored below overrides it.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*RANDOMLY INITIALIZED VGG19")
        trainer = Trainer(cfg, device=device, steps_per_epoch=steps_per_epoch,
                          generator=torch.Generator().manual_seed(seed + 1234),
                          dropout_generator=torch.Generator().manual_seed(seed + 1235),
                          compute_dtype=compute_dtype, mesh=mesh)
    overlay_vgg19(trainer.model)
    if checkpoint is not None and checkpoint.endswith(".pth"):
        load_torch_weights_into(trainer.model, checkpoint, drop_decoder_pos_embedding=True)

    data_rng = _data_rng(dataset)
    start_epoch = 0
    if checkpoint is not None and not checkpoint.endswith(".pth"):
        state, _ = restore_checkpoint(checkpoint)
        trainer.load_state_dict(state["trainer"])
        if data_rng is not None and "data_rng" in state:
            _restore_rng_state(data_rng, state["data_rng"], mesh)
        start_epoch = int(state["epoch"]) + 1

    checkpoint_freq = tp.get("checkpoint_freq", 100)
    logger = (Logger(log_dir, visualizer_params=config.get("visualizer_params") or {},
                     checkpoint_freq=checkpoint_freq) if rank == 0 else None)
    for epoch in range(start_epoch, num_epochs):
        use_bg, dropout_flag, dropout_p = epoch_phase(tp, epoch)
        t0 = time.time()
        buf, last, n_steps = [], None, 0
        with contextlib.closing(loader.epoch(epoch, steps_per_epoch)) as batches:
            for batch in batches:
                terms, extras = trainer.train_step(batch, use_bg, dropout_flag, dropout_p)
                last, n_steps = (batch, extras), n_steps + 1
                if logger is None:
                    continue
                buf.append({k: v for k, v in terms.items() if k != "loss"})
                if len(buf) >= FLUSH_EVERY:
                    _flush(logger, buf)
                    buf = []
        if is_checkpoint_epoch(epoch, num_epochs, checkpoint_freq):
            rng_states = _gather_rng_states(data_rng, mesh)
        if logger is None:
            continue
        _flush(logger, buf)
        dt = time.time() - t0
        print(f"epoch {epoch}: {n_steps} steps in {dt:.3f}s "
              f"({n_steps * batch_size * world / max(dt, 1e-9):.2f} samples/s)")
        if last is not None:
            batch, out = last
            # bf16 under the bf16 policy: the visualizer takes f32 numpy
            rec = torch.cat([out["warp_vis"][:1], out["gen"][:1]], dim=2)
            logger.log_epoch(
                epoch,
                inp={"source": batch["source"][:1], "driving": batch["driving"][:1]},
                out={"rec": rec.float().cpu().numpy(),
                     "kp_s": out["kp_s"][:1].float().cpu().numpy(),
                     "kp_d": out["kp_d"][:1].float().cpu().numpy()},
            )
        else:
            logger.log_epoch(epoch)

        if is_checkpoint_epoch(epoch, num_epochs, checkpoint_freq):
            tree = {"trainer": trainer.state_dict(), "epoch": epoch}
            if data_rng is not None:
                tree["data_rng"] = rng_states
            save_checkpoint(f"{log_dir}/ckpt", tree, step=epoch)
    return trainer
