"""Data parallelism over torch.distributed ranks and the point-axis-sharded
DRP backbone (port of graspbalance_tpu/parallel/).

  mesh.py         the ('data', 'point') DeviceMesh, batch rows, the
                  data-parallel reductions of BatchNorm, losses, gradients
                  and metrics
  sharded_ops.py  furthest point sampling and the ball query with the
                  cloud's points split over the 'point' ranks, exact
  stage1.py       DRP stage 1's set abstraction on the split cloud
  backbone.py     the whole DRP eval forward on the split cloud
  ranks.py        S ranks on one host without torchrun (tests, smoke)
  faults.py       planted faults of the data-parallel step (tests, smoke)

Only ``mesh`` is imported here: the others import the models.
"""

from graspbalance_tpu_torch.parallel.mesh import make_mesh, replicate_, shard_batch

__all__ = ["make_mesh", "replicate_", "shard_batch"]
