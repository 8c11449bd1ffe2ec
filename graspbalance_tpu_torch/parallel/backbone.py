"""The whole DRP eval forward on a cloud whose points are split over the
'point' ranks (port of graspbalance_tpu/parallel/backbone.py).

Every phase runs the DRP's own modules on this rank's share of their output
rows, and the shares are gathered between phases:

  stage-1 FPS              sharded_fps over the split cloud
  stage-1 ball query       sharded_ball_query against the split support
  stage-1 group+MLP+max    the module over this rank's centers, the support
                           xyz whole (parallel/stage1.py)
  stages 2-4 SA            the module over this rank's centers; the
                           support (at most 2,048 rows after stage 1) whole
  InvResMLP blocks         the chunked-centers form (models/drp.py
                           ``centers=``, ``center_feats=``); support whole
  FP upsampling            the module over this rank's query rows

Each operation is row-local over its output rows, so indices and
coordinates equal the one-process forward's exactly, and the features
within the rounding of products over fewer rows (1e-6).
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.parallel.mesh import axis_size
from graspbalance_tpu_torch.parallel.stage1 import center_rows, gather_rows, sharded_sa_forward


@torch.no_grad()
def sharded_drp_forward(mesh, drp, pointcloud: torch.Tensor, *, skip_origin: bool = True) -> dict:
    """The eval forward of ``drp`` (a ``models.drp.DRP`` in eval mode) on
    ``pointcloud`` (B, N, 3): this rank's rows of the 'data' axis with
    every point, split over the 'point' ranks inside. N and every stage's
    npoint must split evenly over them. Returns, on every point rank, the
    dict ``drp(pointcloud)`` returns: input_xyz, input_features (None),
    sa1_inds, sa{1..4}_{xyz,features}, fp2_features, fp2_xyz, fp2_inds."""
    if drp.training:
        raise ValueError("sharded_drp_forward is the eval forward: put the DRP in eval mode")
    if pointcloud.ndim != 3 or pointcloud.shape[-1] != 3:
        raise ValueError(f"point clouds must be (B, N, 3), got {tuple(pointcloud.shape)}")
    s = axis_size(mesh, "point")
    for stage in drp.stages:
        if stage[0] % s:
            raise ValueError(f"stage npoint {stage[0]} does not split over {s} point ranks")
    b = pointcloud.shape[0]
    out = {"input_xyz": pointcloud, "input_features": None}

    stage_xyz, stage_feats = [], []
    for i, (npoint, _, _, _, n_blocks, _, _) in enumerate(drp.stages):
        rows = center_rows(npoint, mesh)
        if i == 0:
            cur_xyz, cur_feats, inds = sharded_sa_forward(mesh, drp.sa1, pointcloud, npoint, skip_origin=skip_origin)
            out["sa1_inds"] = inds
        else:  # nested-prefix FPS: the centers are the first npoint of the running order
            pref = torch.arange(npoint, device=pointcloud.device)[rows].expand(b, -1)
            new_xyz, new_feats = getattr(drp, f"sa{i + 1}")(cur_xyz, cur_feats, pref)
            cur_xyz, cur_feats = gather_rows(new_xyz, mesh), gather_rows(new_feats, mesh)
        for j in range(n_blocks):
            blk = getattr(drp, f"block{i + 1}_{j}")
            f = blk(cur_xyz, cur_feats, centers=cur_xyz[:, rows], center_feats=cur_feats[:, rows])
            cur_feats = gather_rows(f, mesh)
        out[f"sa{i + 1}_xyz"] = cur_xyz
        out[f"sa{i + 1}_features"] = cur_feats
        stage_xyz.append(cur_xyz)
        stage_feats.append(cur_feats)

    f = stage_feats[3]
    for k, fine in enumerate((2, 1)):  # fp1: up to stage 3's rows; fp2: up to stage 2's
        rows = center_rows(stage_xyz[fine].shape[1], mesh)
        fp = getattr(drp, f"fp{k + 1}")
        f = gather_rows(fp(stage_xyz[fine][:, rows], stage_xyz[fine + 1], stage_feats[fine][:, rows], f), mesh)
    out["fp2_features"] = f
    out["fp2_xyz"] = stage_xyz[1]
    out["fp2_inds"] = out["sa1_inds"][:, :drp.num_seed]
    return out
