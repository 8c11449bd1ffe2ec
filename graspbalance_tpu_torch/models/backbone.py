"""The plain PointNet++ SSG backbone (port of graspbalance_tpu/models/backbone.py).

The DRP backbone's four set-abstraction stages (npoint 2048/1024/512/256)
without its inverted-residual blocks, then two feature-propagation stages
back to the 1024-point seed level. One 2048-point FPS serves all four
stages: greedy FPS re-traces itself on its own output, so stage i samples
the first ``npoint`` points of the running FPS order, and the stages just
slice. The end-point keys are the DRP backbone's.
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.nn.sa_fp import FeaturePropagation, SetAbstraction
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_plain

# (npoint, radius, nsample, mlp)
SSG_STAGES = (
    (2048, 0.04, 64, (64, 64, 128)),
    (1024, 0.10, 32, (128, 128, 256)),
    (512, 0.20, 16, (128, 128, 256)),
    (256, 0.30, 16, (128, 128, 256)),
)


class Pointnet2Backbone(nn.Module):
    """Modules are named as in the flax tree: sa{i}, fp1, fp2.

    ``fused_backbone_min_nsample`` (None: off) fuses each set abstraction
    with ``nsample`` at least this in eval mode, float32 (``DRP``'s
    meaning: the BN-folded MLP and the max in the mlp-max kernel).
    ``query_order`` is every ball query's, ``dtype`` every module's compute
    dtype."""

    def __init__(self, stages=SSG_STAGES, num_seed: int = 1024, *, query_order: str = "index",
                 fused_backbone_min_nsample: int | None = None, dtype=torch.float32):
        super().__init__()
        self.stages = tuple(stages)
        self.num_seed = num_seed
        c = 0  # the clouds carry xyz only
        for i, (_, radius, nsample, mlp) in enumerate(self.stages):
            self.add_module(f"sa{i + 1}", SetAbstraction(
                c, radius, nsample, mlp, query_order=query_order,
                fused_min_nsample=fused_backbone_min_nsample, dtype=dtype,
            ))
            c = mlp[-1]
        widths = [s[3][-1] for s in self.stages]
        self.fp1 = FeaturePropagation(widths[3] + widths[2], (256, 256), dtype=dtype)
        self.fp2 = FeaturePropagation(256 + widths[1], (256, 256), dtype=dtype)

    @staticmethod
    def fps_prefix(stages) -> int:
        """The length of the one FPS of the raw cloud whose prefixes the
        stages of ``stages`` take."""
        return stages[0][0]

    def forward(self, pointcloud: torch.Tensor, *, sa_inds=None, plain: bool = False) -> dict:
        """pointcloud (B, N, 3); sa_inds optional (B, npoint_1) FPS indices.
        ``plain`` runs the plain PyTorch versions of FPS and of the fused
        branches' kernel instead of the kernels. Returns the keys of
        ``DRP.forward``."""
        if pointcloud.ndim != 3 or pointcloud.shape[-1] != 3:
            raise ValueError(f"point clouds must be (B, N, 3), got {tuple(pointcloud.shape)}")
        xyz = pointcloud
        out = {"input_xyz": xyz, "input_features": None}
        if sa_inds is None:
            fps = furthest_point_sample_plain if plain else ops.furthest_point_sample
            sa_inds = fps(xyz, self.fps_prefix(self.stages))
        out["sa1_inds"] = sa_inds

        stage_xyz, stage_feats = [], []
        cur_xyz, cur_feats = xyz, None
        for i, stage in enumerate(self.stages):
            npoint = stage[0]
            if i == 0:
                inds = sa_inds
            else:  # nested-prefix FPS: the first npoint of the running order
                inds = torch.arange(npoint, device=xyz.device).expand(xyz.shape[0], npoint)
            cur_xyz, cur_feats = getattr(self, f"sa{i + 1}")(cur_xyz, cur_feats, inds, plain=plain)
            out[f"sa{i + 1}_xyz"] = cur_xyz
            out[f"sa{i + 1}_features"] = cur_feats
            stage_xyz.append(cur_xyz)
            stage_feats.append(cur_feats)

        f = self.fp1(stage_xyz[2], stage_xyz[3], stage_feats[2], stage_feats[3])
        f = self.fp2(stage_xyz[1], stage_xyz[2], stage_feats[1], f)
        out["fp2_features"] = f
        out["fp2_xyz"] = stage_xyz[1]
        out["fp2_inds"] = sa_inds[:, : self.num_seed]
        return out
