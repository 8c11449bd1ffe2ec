"""Core layers: Linear (= 1x1 conv) + BatchNorm + ReLU blocks
(port of graspbalance_tpu/nn/layers.py, eval mode).

Parameter names follow the flax tree: ``<block>.dense.weight`` (O, I),
``<block>.bn.weight`` / ``.bn.bias`` (flax ``scale`` / ``bias``) and the
buffers ``<block>.bn.running_mean`` / ``.bn.running_var`` (flax
``batch_stats``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class BatchNorm(nn.Module):
    """BatchNorm over all axes but the last, with running statistics only:
    ``(x - mean) * (scale / sqrt(var + eps)) + bias``. The port runs the eval
    forward, so batch statistics are never computed."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * (1.0 / torch.sqrt(self.running_var + self.eps))
        return (x - self.running_mean) * inv + self.bias

    def fold(self, dense_weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fold this BN into the preceding bias-free dense layer:
        relu(x @ W^T) after BN == relu(x @ (W^T * a) + (beta - mean * a)),
        a = gamma / sqrt(var + eps). Returns (W_eff (I, O), b_eff (O,))."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return dense_weight.t() * a, self.bias - self.running_mean * a


class MLPBlock(nn.Module):
    """Linear + BN + optional ReLU ('conv-norm-act' order). The linear layer
    has no bias: BN follows it, as in the reference."""

    def __init__(self, in_features: int, features: int, *, act: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, features, bias=False)
        self.bn = BatchNorm(features)
        self.act = act

    def forward(self, x: torch.Tensor, *, stage: str | None = None) -> torch.Tensor:
        """stage=None: the full block; 'dense': only the linear layer;
        'post': only BN + ReLU on a precomputed pre-activation. The split
        lets a caller commute the linear layer with a gather."""
        if stage not in (None, "dense", "post"):
            raise ValueError(f"unknown stage {stage}")
        if stage != "post":
            x = self.dense(x)
            if stage == "dense":
                return x
        x = self.bn(x)
        return torch.relu(x) if self.act else x


class SharedMLP(nn.Sequential):
    """Stack of MLPBlocks over the trailing feature axis, named layer0, ..."""

    def __init__(self, in_features: int, layers: Sequence[int]):
        super().__init__()
        for i, width in enumerate(layers):
            self.add_module(f"layer{i}", MLPBlock(in_features, width))
            in_features = width
