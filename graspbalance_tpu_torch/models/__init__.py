"""Model layer: DRP backbone, grasp heads, GraspBalance eval forward, decode."""

from graspbalance_tpu_torch.models.decode import pred_decode
from graspbalance_tpu_torch.models.drp import DRP
from graspbalance_tpu_torch.models.graspbalance import GraspBalance

__all__ = ["DRP", "GraspBalance", "pred_decode"]
