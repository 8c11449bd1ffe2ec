"""Building blocks (torch.nn), channels-last; every 1x1 conv is a Linear
over the trailing feature axis."""

from graspbalance_tpu_torch.nn.layers import BatchNorm, MLPBlock, SharedMLP
from graspbalance_tpu_torch.nn.sa_fp import FeaturePropagation, SetAbstraction

__all__ = ["BatchNorm", "MLPBlock", "SharedMLP", "SetAbstraction", "FeaturePropagation"]
