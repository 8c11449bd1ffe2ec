"""Model layer: the DRP, PointNet++ SSG and Point Transformer backbones, grasp heads,
GraspBalance eval and training forward, decode, and the DSN instance
segmentation head."""

from graspbalance_tpu_torch.models.backbone import Pointnet2Backbone
from graspbalance_tpu_torch.models.decode import pred_decode
from graspbalance_tpu_torch.models.drp import DRP
from graspbalance_tpu_torch.models.dsn import DSN
from graspbalance_tpu_torch.models.graspbalance import GraspBalance
from graspbalance_tpu_torch.models.pt_backbone import PTBackbone

__all__ = ["DRP", "DSN", "GraspBalance", "PTBackbone", "Pointnet2Backbone", "pred_decode"]
