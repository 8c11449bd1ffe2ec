"""Point-cloud primitives. On a CUDA tensor, FPS, the multi-cylinder query
and the fused width MLP launch hand-written kernels; on a CPU tensor they
run their plain PyTorch versions. The other ops are PyTorch on any device."""

from graspbalance_tpu_torch.ops.fps import furthest_point_sample
from graspbalance_tpu_torch.ops.gather import gather_points, group_points
from graspbalance_tpu_torch.ops.interpolate import three_interpolate
from graspbalance_tpu_torch.ops.knn import three_nn
from graspbalance_tpu_torch.ops.query import ball_query, multi_cylinder_query

__all__ = [
    "furthest_point_sample",
    "ball_query",
    "multi_cylinder_query",
    "three_nn",
    "gather_points",
    "group_points",
    "three_interpolate",
]
