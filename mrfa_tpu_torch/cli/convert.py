"""Checkpoint conversion CLI: a reference .pth -> a port checkpoint directory.

Counterpart of mrfa_tpu/cli/convert.py:

  python -m mrfa_tpu_torch.cli.convert --config config/vox1.yaml \\
      --checkpoint vox.pth --out converted_ckpt [--report] \\
      [--drop_decoder_pos_embedding] [--device cuda|cpu]

The model is built on the card unless `--device cpu` is given; the leaves
the `.pth` does not fill keep their initial values (torch's initializers
under seed 0).
The output, `<out>/0`, holds the model's state as a training checkpoint
holds it (`{"trainer": {"model": ...}}`), so it restores through
`cli/run.py --checkpoint` (the eval modes) and `cli/demo.py --checkpoint`;
it carries no optimizer state, so training starts from the `.pth` instead.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", required=True, help="reference .pth")
    parser.add_argument("--out", required=True, help="output checkpoint directory")
    parser.add_argument("--report", action="store_true",
                        help="print all unmatched/unused leaves")
    parser.add_argument("--drop_decoder_pos_embedding", action="store_true",
                        help="the reference's train-resume rule")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mrfa_tpu_torch.config import load_config, model_config
    from mrfa_tpu_torch.models.mrfa import MRFA
    from mrfa_tpu_torch.utils.checkpoint import load_torch_weights_into, save_checkpoint
    from mrfa_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config)
    torch.manual_seed(0)  # the leaves the .pth does not fill keep these initial values
    model = MRFA(model_config(config), device=device)
    missing, unexpected = load_torch_weights_into(
        model, args.checkpoint, drop_decoder_pos_embedding=args.drop_decoder_pos_embedding,
        verbose=True,
    )
    if args.report:
        for m in missing:
            print(f"MISSING (kept init): {m}")
        for u in unexpected:
            print(f"UNUSED .pth leaf:    {u}")
    save_checkpoint(args.out, {"trainer": {"model": model.state_dict()}}, step=0)
    print(f"converted -> {args.out}/0 ({len(missing)} missing, {len(unexpected)} unused leaves)")
    return missing, unexpected


if __name__ == "__main__":
    main()
