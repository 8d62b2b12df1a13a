"""Main CLI: train / reconstruction / animate.

Counterpart of mrfa_tpu/cli/run.py (the reference's run.py):

  python -m mrfa_tpu_torch.cli.run --config config/vox1.yaml --mode train \\
      [--log_dir log] [--checkpoint <checkpoint dir | reference .pth>] \\
      [--device cuda|cpu]

Training logs into `<log_dir>/<config name> <date and time>`; the eval modes
log into the directory that holds the checkpoint (or `<log_dir>/<config
name>` without one). The config is copied into the log directory. The card
is the default device; `--device cpu` runs on the CPU.

`--distributed` trains data-parallel, one process a device, under torchrun:

  torchrun --nproc_per_node N -m mrfa_tpu_torch.cli.run --distributed \\
      --config config/vox1.yaml --mode train [--device cpu]

over NCCL on cuda:LOCAL_RANK, or gloo with `--device cpu`; the config's
batch_size is the global batch. Rank 0 writes the log directory. The eval
modes run on one device.
"""
from __future__ import annotations

import argparse
import os
import shutil
from datetime import datetime


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="path to config yaml")
    parser.add_argument("--mode", default="train", choices=["train", "reconstruction", "animate"])
    parser.add_argument("--log_dir", default="log", help="path to log into")
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory written by training, or a reference .pth")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max_steps_per_epoch", type=int, default=None,
                        help="debug: cap steps per epoch")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--distributed", action="store_true",
                        help="train data-parallel under torchrun, one process a device")
    args = parser.parse_args(argv)
    if args.distributed and args.mode != "train":
        parser.error("--distributed trains only; the eval modes run on one device")

    import torch

    from mrfa_tpu_torch.config import load_config, model_config
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.utils.device import resolve_device

    config = load_config(args.config)
    if args.checkpoint is not None and args.mode != "train":
        log_dir = os.path.join(*os.path.split(args.checkpoint)[:-1]) or "."
    else:
        log_dir = os.path.join(args.log_dir, os.path.basename(args.config).split(".")[0])
        if args.mode == "train":
            log_dir += " " + datetime.now().strftime("%d_%m_%y_%H.%M.%S")

    if args.distributed:
        import torch.distributed as dist

        from mrfa_tpu_torch.parallel.mesh import init_distributed, make_mesh

        device = init_distributed(args.device)
        try:
            mesh = make_mesh(device_type=device.type)
            shared = [log_dir]  # rank 0's clock names the directory
            dist.broadcast_object_list(shared, src=0)
            _train(args, config, shared[0], device, mesh, rank=dist.get_rank())
        finally:
            dist.destroy_process_group()
        return

    device = resolve_device(args.device)
    if args.mode == "train":
        _train(args, config, log_dir, device)
        return

    dataset = FramesDataset(is_train=False, **config["dataset_params"])
    _make_log_dir(log_dir, args.config)

    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import load_torch_weights_into, restore_checkpoint

    torch.manual_seed(args.seed)
    model = MRFA(model_config(config), device=device)
    if args.checkpoint is None:
        print("warning: evaluating with random weights (no --checkpoint)")
    elif args.checkpoint.endswith(".pth"):
        load_torch_weights_into(model, args.checkpoint)
    else:
        state, _ = restore_checkpoint(args.checkpoint)
        model.load_state_dict(state["trainer"]["model"])

    from mrfa_tpu_torch import evals

    if args.mode == "reconstruction":
        print("Reconstruction...")
        evals.reconstruction(config, model, log_dir, dataset, device=device)
    else:
        print("Animate...")
        evals.animate(config, model, log_dir, dataset, device=device)


def _make_log_dir(log_dir: str, config_path: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    if not os.path.exists(os.path.join(log_dir, os.path.basename(config_path))):
        shutil.copy(config_path, log_dir)


def _train(args, config, log_dir: str, device, mesh=None, rank: int = 0) -> None:
    from mrfa_tpu_torch.data.dataset import FramesDataset
    from mrfa_tpu_torch.train.loop import train

    dataset = FramesDataset(is_train=True, **config["dataset_params"])
    if rank == 0:
        _make_log_dir(log_dir, args.config)
        world = "" if mesh is None else f", {mesh.size()} ranks"
        print(f"Training... (device: {device}{world})")
    train(config, args.checkpoint, log_dir, dataset, seed=args.seed,
          max_steps_per_epoch=args.max_steps_per_epoch, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
