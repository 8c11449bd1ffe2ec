"""Point-cloud primitives. On a CUDA tensor, FPS (and its masked mode), the
multi-cylinder query, the fused width MLPs, kNN, the collision counts, the
scatter-add, the fused group MLP + reduction (ops/mlpmax.py), the class-plane
selection (ops/select.py), the table-gather probe (ops/table_gather.py) and
the train-mode BatchNorm + ReLU (ops/batchnorm.py) launch hand-written
kernels; on a CPU tensor they run their plain PyTorch
versions. The other ops (the queries' plain selections, nearest order
included, ``random_sample``, ``trilinear_sample``) are PyTorch on any
device."""

from graspbalance_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_masked, random_sample
from graspbalance_tpu_torch.ops.gather import gather_points, group_points
from graspbalance_tpu_torch.ops.interpolate import three_interpolate
from graspbalance_tpu_torch.ops.knn import knn, three_nn
from graspbalance_tpu_torch.ops.query import ball_query, cylinder_query, multi_cylinder_query
from graspbalance_tpu_torch.ops.trilinear import trilinear_sample

__all__ = [
    "furthest_point_sample",
    "furthest_point_sample_masked",
    "random_sample",
    "knn",
    "ball_query",
    "cylinder_query",
    "multi_cylinder_query",
    "three_nn",
    "gather_points",
    "group_points",
    "three_interpolate",
    "trilinear_sample",
]
