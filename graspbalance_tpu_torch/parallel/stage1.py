"""DRP stage 1's set abstraction on a cloud whose points are split over the
'point' ranks (port of graspbalance_tpu/parallel/stage1.py).

Stage 1 is the only part of the backbone that touches all N points, and its
three phases split differently:

  1. FPS over the split cloud: ``sharded_fps`` (exact; the O(N) running
     distances stay on their rank);
  2. the ball query against the split support: ``sharded_ball_query``
     (exact: the ranks' first k merged);
  3. grouping + MLP + max: the SetAbstraction module itself over this
     rank's share of the centers, fed their FPS indices and query indices
     (``query_idx``), with the support xyz whole on every rank (3 floats a
     point, the one O(N) tensor every rank's gather reads); the shares are
     gathered back.

The module runs unchanged on a subset of its output rows, so the result is
the one-process module's (the per-center MLP + max is row-local).
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, gather_slots
from graspbalance_tpu_torch.parallel.sharded_ops import local_points, sharded_ball_query, sharded_fps


def center_rows(m: int, mesh) -> slice:
    """This point rank's share of ``m`` center rows."""
    s = axis_size(mesh, "point")
    if m % s:
        raise ValueError(f"{m} centers do not split over {s} point ranks")
    p = axis_rank(mesh, "point")
    return slice(p * m // s, (p + 1) * m // s)


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """(B, m, ...) shares of the point ranks, in rank order -> (B, S m, ...)
    on every point rank (``center_rows``' inverse)."""
    s = axis_size(mesh, "point")
    if s == 1:
        return x
    slots = gather_slots(x.contiguous(), axis_group(mesh, "point"), axis_rank(mesh, "point"), s)
    return slots.transpose(0, 1).reshape(x.shape[0], s * x.shape[1], *x.shape[2:])


@torch.no_grad()
def sharded_sa_forward(mesh, sa, xyz: torch.Tensor, npoint: int, *, skip_origin: bool = True):
    """The eval forward of ``sa`` (an ``nn.sa_fp.SetAbstraction`` without
    input features, DRP stage 1's shape) at ``npoint`` FPS centers of
    ``xyz`` (B, N, 3), this rank's 'data' rows with every point, split over
    the 'point' ranks inside. N and ``npoint`` must split evenly. Returns
    (new_xyz (B, npoint, 3), new_feats (B, npoint, C_out), inds
    (B, npoint) int32) on every point rank: the one-process module's."""
    local = local_points(xyz, mesh)
    inds = sharded_fps(mesh, local, npoint, skip_origin=skip_origin)
    new_xyz = ops.gather_points(xyz, inds)
    qidx = sharded_ball_query(mesh, local, new_xyz, sa.radius, sa.nsample, order=sa.query_order)
    rows = center_rows(npoint, mesh)
    _, feats = sa(xyz, None, inds[:, rows], query_idx=qidx[:, rows])
    return new_xyz, gather_rows(feats, mesh), inds
