"""Normalization layers: torch's own (eps 1e-5, momentum 0.1; in eval mode
BatchNorm normalizes with its running statistics), as the port's
single-process path uses them."""
from torch import nn

LayerNorm = nn.LayerNorm
BatchNorm = nn.BatchNorm2d
