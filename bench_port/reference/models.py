"""The GraspBalance eval forward and its decode, plain PyTorch, float32:
the configuration's backbone (``backbones/<name>.py``, found by its
``model.backbone`` name), object-balanced re-seeding, the graspable head,
the multi-scale cylinder width grouping and the grasp parameter and
tolerance heads. Module and parameter names are the program's.

``GraspBalance.forward`` takes the seeds' top views as an argument when the
caller gives them (``top_view_inds``): the check then holds the program's
choice of view to the reference's scores by itself (a near tie decides it),
and compares every head output at the same views.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from bench_port.harness import load_named
from bench_port.reference import labels as ref_labels
from bench_port.reference import ops
from bench_port.reference.layers import Dense, MLPBlock, SharedMLP, einsum
from bench_port.reference.postprocess import object_balance_indices

SEED_FEATURES = 256
SCALES = (0.25, 0.5, 0.75, 1.0)
BACKBONES = Path(__file__).resolve().parent / "backbones"


def backbone_file(name: str, bench=None):
    """The reference backbone file of ``name``: ``<bench>/reference/backbones/<name>.py``
    (with no ``bench``, this package's); raises naming the file where there is none."""
    return load_named(Path(bench) / "reference" / "backbones" if bench else BACKBONES, name, "reference backbone")


class GraspableDetection(nn.Module):
    def __init__(self, num_view):
        super().__init__()
        self.num_view = num_view
        self.conv1 = MLPBlock(SEED_FEATURES, SEED_FEATURES)
        self.conv2 = MLPBlock(SEED_FEATURES, 2 + num_view)
        self.conv3 = Dense(2 + num_view, 2 + num_view)

    def forward(self, seed_features, top_view_inds=None):
        x = self.conv3(self.conv2(self.conv1(seed_features)))
        view_score = x[..., 2:]
        if top_view_inds is None:
            top_view_inds = torch.argmax(view_score, dim=-1)
        vp_xyz = ops.grasp_views(self.num_view, device=x.device)[top_view_inds.long()]
        vp_rot = ops.viewpoint_to_matrix(-vp_xyz, torch.zeros_like(vp_xyz[..., 0]))
        return {"objectness_score": x[..., :2], "view_score": view_score,
                "grasp_top_view_inds": top_view_inds.to(torch.int32), "grasp_top_view_xyz": vp_xyz,
                "grasp_top_view_rot": vp_rot}


class MultiScaleWidthGrouping(nn.Module):
    """Cylinders of radius s * cylinder_radius (s in ``scales``) and depth
    hmin < x' < hmax (each of ``hmax_list``), 64 neighbours each; every
    scale's MLP 3 -> 64 -> 128 -> 256 on the gripper-frame coordinates and
    the max over them. Returns (B, Ns, D, R * 256)."""

    def __init__(self, cylinder_radius, hmin, hmax_list, scales, nsample=64, mlp=(64, 128, 256)):
        super().__init__()
        self.radii = tuple(s * cylinder_radius for s in scales)
        self.hmin, self.hmax_list, self.nsample = hmin, tuple(hmax_list), nsample
        self.out_features = len(self.radii) * mlp[-1]
        for ri in range(len(self.radii)):
            self.add_module(f"mlp_scale{ri}", SharedMLP(3, mlp))

    def forward(self, seed_xyz, cloud_xyz, vp_rot):
        idx = ops.multi_cylinder_query(cloud_xyz, seed_xyz, vp_rot, self.radii, self.hmin, self.hmax_list,
                                       self.nsample)
        b, n_r, n_h, ns, k = idx.shape
        if self.training:  # batch statistics: each scale's MLP on the rotated offsets, unfolded
            grouped = ops.group_points(cloud_xyz, idx.reshape(b, n_r * n_h * ns, k))
            rel = grouped.reshape(b, n_r, n_h, ns, k, 3) - seed_xyz[:, None, None, :, None, :]
            rel = einsum("brhskj,bsji->brhski", rel, vp_rot)
            feats = [getattr(self, f"mlp_scale{ri}")(rel[:, ri]).amax(dim=3) for ri in range(n_r)]
            return torch.cat(feats, dim=-1).permute(0, 2, 1, 3)
        idx_t = idx.permute(0, 3, 1, 2, 4).reshape(b, ns * n_r * n_h, k)
        grouped = ops.group_points(cloud_xyz, idx_t).reshape(b, ns, n_r, n_h, k, 3)
        weights = tuple(getattr(self, f"mlp_scale{ri}").fold() for ri in range(n_r))
        return ops.width_mlps(grouped, seed_xyz, vp_rot, weights)


class GraspParametersHead(nn.Module):
    def __init__(self, num_angle):
        super().__init__()
        self.num_angle = num_angle
        self.conv1 = MLPBlock(256, 128)
        self.conv2 = MLPBlock(128, 128)
        self.conv3 = Dense(128, 3 * num_angle)

    def forward(self, vp):
        x = self.conv3(self.conv2(self.conv1(vp)))
        b, ns, d, _ = x.shape
        x = x.reshape(b, ns, d, 3, self.num_angle).movedim(2, -1)
        return {"grasp_score_pred": x[:, :, 0], "grasp_angle_cls_pred": x[:, :, 1], "grasp_width_pred": x[:, :, 2]}


class ToleranceHead(nn.Module):
    def __init__(self, num_angle):
        super().__init__()
        self.conv1 = MLPBlock(256, 128)
        self.conv2 = MLPBlock(128, 128)
        self.conv3 = Dense(128, num_angle)

    def forward(self, vp):
        return {"grasp_tolerance_pred": self.conv3(self.conv2(self.conv1(vp))).movedim(2, -1)}


class GraspBalance(nn.Module):
    """The program's ``GraspBalance`` constructor arguments that the
    benchmark's configurations set (the multi-scale model, index-order
    queries); ``bench`` is the benchmark's directory whose
    ``reference/backbones/`` holds the backbone's file (this package's by
    default)."""

    def __init__(self, *, backbone, backbone_stages, num_view=300, num_angle=12, num_depth=4, cylinder_radius=0.08,
                 hmin=-0.02, hmax_list=(0.01, 0.02, 0.03, 0.04), num_seed=1024, bench=None):
        super().__init__()
        if len(hmax_list) != num_depth:
            raise ValueError("hmax_list needs num_depth entries")
        self.backbone_name = backbone
        self.backbone = backbone_file(backbone, bench).Backbone(backbone_stages, num_seed)
        self.graspable = GraspableDetection(num_view)
        self.width_grouping = MultiScaleWidthGrouping(cylinder_radius, hmin, hmax_list, SCALES)
        self.fuse_multi_scale = Dense(self.width_grouping.out_features, 256)
        self.gate_fusion = Dense(SEED_FEATURES, 256)
        self.grasp_params = GraspParametersHead(num_angle)
        self.tolerance = ToleranceHead(num_angle)

    @torch.no_grad()
    def forward(self, xyz, sampled, *, seed_cluster=None, top_view_inds=None):
        """``sampled``: the indices the backbone takes from the raw cloud
        (its ``SAMPLED`` keys)."""
        ep = self.backbone(xyz, sampled)
        seed_xyz, seed_features = ep["fp2_xyz"], ep["fp2_features"]
        if seed_cluster is not None:
            obs_inds = object_balance_indices(xyz, seed_cluster, num_seed=self.backbone.num_seed)
            obs_xyz = ops.gather_points(xyz, obs_inds)
            seed_features = ep["fp2_features"] = ops.interpolate_features(obs_xyz, seed_xyz, seed_features)
            ep["fp2_inds_fps"] = ep["fp2_inds"]
            seed_xyz = ep["fp2_xyz"] = obs_xyz
            ep["fp2_inds"] = obs_inds
        ep.update(self.graspable(seed_features, top_view_inds))
        return self._stage2(ep, seed_xyz, ep["grasp_top_view_rot"])

    def forward_train(self, batch):
        """The training forward (the module in train mode: batch
        statistics) on a batch with its label tensors: the backbone on its
        own sampling of the cloud (its contract), the graspable head, label
        matching at the seeds' top views, then stage 2 at the matched label
        points and views."""
        xyz = batch["point_clouds"]
        ep = self.backbone(xyz, self.backbone.sample(xyz))
        ep.update(self.graspable(ep["fp2_features"]))
        ep.update(ref_labels.match_labels(ep["fp2_xyz"], ep["grasp_top_view_inds"], batch))
        return self._stage2(ep, ep["batch_grasp_point"], ep["batch_grasp_view_rot"])

    def _stage2(self, ep, centers, rot):
        seed_features = ep["fp2_features"]
        vp = self.width_grouping(centers, ep["input_xyz"], rot)
        gate = torch.sigmoid(self.gate_fusion(seed_features))
        vp = self.fuse_multi_scale(vp) + (gate * seed_features).unsqueeze(2)
        ep.update(self.grasp_params(vp))
        ep.update(self.tolerance(vp))
        return ep


def pred_decode(ep):
    """End points -> (grasps (B, Ns, 17), valid (B, Ns)): per seed the best
    angle of each depth, then the best depth; graspnetAPI's columns
    [score, width, height, depth, rotation (9), center (3), object id]."""
    objectness = ep["objectness_score"]
    score = ep["grasp_score_pred"]
    center = ep["fp2_xyz"]
    approaching = -ep["grasp_top_view_xyz"]
    angle_cls_score = ep["grasp_angle_cls_pred"]
    width = torch.clamp(1.2 * ep["grasp_width_pred"], 0.0, ops.GRASP_MAX_WIDTH)
    tolerance = ep["grasp_tolerance_pred"]
    a = angle_cls_score.shape[2]
    angle_cls = torch.argmax(angle_cls_score, dim=2, keepdim=True)
    angle = angle_cls[:, :, 0].float() / a * torch.pi
    score, width, tolerance = (x.gather(2, angle_cls)[:, :, 0] for x in (score, width, tolerance))
    depth_cls = torch.argmax(score, dim=2, keepdim=True)
    depth = (depth_cls.float() + 1.0) * 0.01
    score, angle, width, tolerance = (x.gather(2, depth_cls) for x in (score, angle, width, tolerance))
    valid = torch.argmax(objectness, dim=-1) == 1
    confidence = torch.softmax(objectness, dim=-1)[..., 1:2]
    score = score * confidence * tolerance / ops.GRASP_MAX_TOLERANCE
    rot = ops.viewpoint_to_matrix(approaching, angle[..., 0])
    rot9 = rot.reshape(rot.shape[:-2] + (9,))
    height = torch.full_like(score, 0.02)
    obj_ids = torch.full_like(score, -1.0)
    return torch.cat([score, width, height, depth, rot9, center, obj_ids], dim=-1), valid
