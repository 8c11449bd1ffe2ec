"""The DRP backbone: set abstraction and inverted-residual blocks per stage,
then two feature-propagation stages back to the seeds. A stage is (npoint,
radius, nsample, mlp, blocks, block radius, block nsample). One FPS of the
raw cloud, the first stage's npoint long, serves every stage: stage i takes
the first npoint of its order. Module and parameter names are the
program's."""

from __future__ import annotations

import torch
from torch import nn

from bench_port.reference import ops
from bench_port.reference.layers import MLPBlock, SharedMLP

TINY_STAGES = [
    [64, 0.08, 8, [16, 16, 32], 1, 0.16, 8],
    [32, 0.20, 8, [16, 16, 32], 1, 0.40, 8],
    [16, 0.40, 4, [16, 16, 32], 1, 0.80, 4],
    [8, 0.60, 4, [16, 16, 32], 1, 1.20, 4],
]


class SetAbstraction(nn.Module):
    """Ball-query grouping at the given centers, offsets divided by the
    radius and joined to the features, shared MLP, max over K."""

    def __init__(self, in_features, radius, nsample, mlp):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.mlp = SharedMLP(3 + in_features, mlp)

    def forward(self, xyz, features, inds):
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample)
        grouped = (ops.group_points(xyz, idx) - new_xyz.unsqueeze(2)) / self.radius
        if features is not None:
            grouped = torch.cat([grouped, ops.group_points(features, idx)], dim=-1)
        return new_xyz, self.mlp(grouped).amax(dim=2)


class FeaturePropagation(nn.Module):
    def __init__(self, in_features, mlp):
        super().__init__()
        self.mlp = SharedMLP(in_features, mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        interp = ops.interpolate_features(unknown, known, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class LocalAggregation(nn.Module):
    """Ball query, [p_j - c_i, f_j] through one conv block, max over K; the
    block's linear layer applied before the gather (it commutes with it:
    ``[p_j - c_i, f_j] @ W == [p_j, f_j] @ W - [c_i, 0] @ W``)."""

    def __init__(self, channels, radius, nsample):
        super().__init__()
        self.radius, self.nsample = radius, nsample
        self.conv = MLPBlock(3 + channels, channels)

    def forward(self, xyz, feats):
        idx = ops.ball_query(xyz, xyz, self.radius, self.nsample)
        e = self.conv.dense(torch.cat([xyz, feats], dim=-1))
        cw = self.conv.dense(torch.cat([xyz, torch.zeros_like(feats)], dim=-1))
        pre = ops.group_points(e, idx) - cw.unsqueeze(2)
        return self.conv.post(pre).amax(dim=2)


class InvResMLP(nn.Module):
    def __init__(self, channels, radius, nsample):
        super().__init__()
        self.local_agg = LocalAggregation(channels, radius, nsample)
        self.pw1 = MLPBlock(channels, channels * 4)
        self.pw2 = MLPBlock(channels * 4, channels, act=False)

    def forward(self, xyz, feats):
        return torch.relu(self.pw2(self.pw1(self.local_agg(xyz, feats))) + feats)


class Backbone(nn.Module):
    SAMPLED = ("sa1_inds",)

    def __init__(self, stages, num_seed):
        super().__init__()
        self.stages = [list(s) for s in stages]
        self.num_seed = num_seed
        c = 0
        for i, (_, radius, nsample, mlp, blocks, block_radius, block_nsample) in enumerate(self.stages):
            self.add_module(f"sa{i + 1}", SetAbstraction(c, radius, nsample, mlp))
            c = mlp[-1]
            for j in range(blocks):
                self.add_module(f"block{i + 1}_{j}", InvResMLP(c, block_radius, block_nsample))
        widths = [s[3][-1] for s in self.stages]
        self.fp1 = FeaturePropagation(widths[3] + widths[2], (256, 256))
        self.fp2 = FeaturePropagation(256 + widths[1], (256, 256))

    @property
    def fps_prefix(self) -> int:
        return self.stages[0][0]

    def sample(self, xyz):
        return {"sa1_inds": ops.furthest_point_sample(xyz, self.fps_prefix)}

    def forward(self, xyz, sampled):
        sa_inds = sampled["sa1_inds"]
        out = {"input_xyz": xyz, "sa1_inds": sa_inds}
        stage_xyz, stage_feats = [], []
        cur_xyz, cur_feats = xyz, None
        for i, st in enumerate(self.stages):
            inds = sa_inds if i == 0 else torch.arange(st[0], device=xyz.device).expand(xyz.shape[0], st[0])
            cur_xyz, cur_feats = getattr(self, f"sa{i + 1}")(cur_xyz, cur_feats, inds)
            for j in range(st[4]):
                cur_feats = getattr(self, f"block{i + 1}_{j}")(cur_xyz, cur_feats)
            stage_xyz.append(cur_xyz)
            stage_feats.append(cur_feats)
        f = self.fp1(stage_xyz[2], stage_xyz[3], stage_feats[2], stage_feats[3])
        out["fp2_features"] = self.fp2(stage_xyz[1], stage_xyz[2], stage_feats[1], f)
        out["fp2_xyz"] = stage_xyz[1]
        out["fp2_inds"] = sa_inds[:, : self.num_seed]
        return out
