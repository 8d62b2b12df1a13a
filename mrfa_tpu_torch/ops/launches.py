"""The launch counts of the port's hand-written kernels, read and advanced
together.

Each kernel wrapper counts the launches it makes. A CUDA graph that captured
some of them launches them again at every replay without the wrapper, so the
graph's owner adds the captured launches per replay (`add`), and takes back
the ones counted while capturing, which launched nothing.
"""
from __future__ import annotations

from typing import Dict


def kernels():
    from mrfa_tpu_torch.ops.corr_lookup import corr_lookup, corr_lookup_bwd, corr_lookup_pooled_bwd
    from mrfa_tpu_torch.ops.sampler import warp_bilinear
    from mrfa_tpu_torch.ops.splat import splat
    from mrfa_tpu_torch.ops.stream_probe import stream_probe

    return (corr_lookup, corr_lookup_bwd, splat, corr_lookup_pooled_bwd, stream_probe,
            warp_bilinear)


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in kernels()}


def add(delta: Dict[str, int], times: int = 1) -> None:
    for k in kernels():
        k.launches += times * delta.get(k.name, 0)
