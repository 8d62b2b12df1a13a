"""The benchmark's plain reference: a frozen copy of the PyTorch port's model,
losses and optimizer step, in plain PyTorch and f32.

The modules under `models/`, `nn/` and `ops/` were copied from
`mrfa_tpu_torch` and are kept as they are here, so that a later change to
the program cannot move the yardstick it is held to. The copy differs from
the port only where the port steers its own machinery: no CUDA kernel (the
lookup, its backward and the splat are the port's plain versions), no bf16
policy, no mesh (one process, torch's own BatchNorm). Nothing here imports
`jax`, the JAX package or the port.
"""
