"""Model layer: DRP backbone, grasp heads, GraspBalance eval forward, decode,
and the DSN instance segmentation head."""

from graspbalance_tpu_torch.models.decode import pred_decode
from graspbalance_tpu_torch.models.drp import DRP
from graspbalance_tpu_torch.models.dsn import DSN
from graspbalance_tpu_torch.models.graspbalance import GraspBalance

__all__ = ["DRP", "DSN", "GraspBalance", "pred_decode"]
