"""Building blocks (torch.nn), channels-last; every 1x1 conv is a Linear
over the trailing feature axis."""

from graspbalance_tpu_torch.nn.layers import BatchNorm, MLPBlock, SharedMLP
from graspbalance_tpu_torch.nn.registry import create_act, create_norm
from graspbalance_tpu_torch.nn.sa_fp import (
    FeaturePropagation,
    LocalFeaturePropagationMSG,
    SetAbstraction,
    SetAbstractionMSG,
    SetAbstractionShift,
    SetAbstractionWOMLP,
)

__all__ = [
    "BatchNorm", "MLPBlock", "SharedMLP", "SetAbstraction", "SetAbstractionMSG", "SetAbstractionShift",
    "SetAbstractionWOMLP", "LocalFeaturePropagationMSG", "FeaturePropagation", "create_act", "create_norm",
]
