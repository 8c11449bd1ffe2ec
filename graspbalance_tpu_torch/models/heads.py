"""Grasp detection heads (port of graspbalance_tpu/models/heads.py).

Output layouts (channels-last):
  objectness_score      (B, Ns, 2)
  view_score            (B, Ns, V)
  grasp_score_pred      (B, Ns, A, D)
  grasp_angle_cls_pred  (B, Ns, A, D)
  grasp_width_pred      (B, Ns, A, D)
  grasp_tolerance_pred  (B, Ns, A, D)

Each head computes in its ``dtype`` and returns these outputs in float32
(the JAX heads cast them), so that label matching, the loss and decode run
in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from graspbalance_tpu_torch.labels.geometry import (
    batch_viewpoint_params_to_matrix,
    generate_grasp_views,
)
from graspbalance_tpu_torch.nn.layers import Dense, MLPBlock, SharedMLP
from graspbalance_tpu_torch.ops.gather import group_points
from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
from graspbalance_tpu_torch.ops.query import ORDERS, multi_cylinder_query
from graspbalance_tpu_torch.ops.widthmlp import (
    width_mlp_fused,
    width_mlp_fused_plain,
    width_mlp_fused_rot,
    width_mlp_fused_rot_plain,
)

SEED_FEATURES = 256
# the JAX package's defaults of the heads' fields
NUM_ANGLE = 12
CYLINDER_RADIUS = 0.08
HMIN = -0.02
HMAX_LIST = (0.01, 0.02, 0.03, 0.04)  # one gripper depth each
SCALES = (0.25, 0.5, 0.75, 1.0)  # cylinder radius multiples


class GraspableDetection(nn.Module):
    """Objectness + per-view score head: 256 -> 256 -> (2+V) -> (2+V); picks
    the top view per seed and builds its approach rotation (angle 0)."""

    def __init__(self, num_view: int = 300, *, dtype=torch.float32):
        super().__init__()
        self.num_view = num_view
        self.conv1 = MLPBlock(SEED_FEATURES, SEED_FEATURES, dtype=dtype)
        self.conv2 = MLPBlock(SEED_FEATURES, 2 + num_view, dtype=dtype)
        self.conv3 = Dense(2 + num_view, 2 + num_view, dtype=dtype)

    def forward(self, seed_xyz: torch.Tensor, seed_features: torch.Tensor) -> dict:
        x = self.conv3(self.conv2(self.conv1(seed_features)))
        view_score = x[..., 2:].float()
        top_view_scores, top_view_inds = torch.max(view_score, dim=-1)
        templates = generate_grasp_views(self.num_view, device=x.device)
        vp_xyz = templates[top_view_inds]  # (B, Ns, 3)
        vp_rot = batch_viewpoint_params_to_matrix(-vp_xyz, torch.zeros_like(vp_xyz[..., 0]))
        return {
            "objectness_score": x[..., :2].float(),
            "view_score": view_score,
            "grasp_top_view_inds": top_view_inds.to(torch.int32),
            "grasp_top_view_score": top_view_scores,
            "grasp_top_view_xyz": vp_xyz,
            "grasp_top_view_rot": vp_rot,
        }


class MultiScaleWidthGrouping(nn.Module):
    """The cylinder-radius scales of the width-grouping head: radius
    ``s * cylinder_radius`` for each s of ``scales`` (four in the default
    model, one in the single-scale model), a depth ``hmin < x' < hmax`` for
    each of ``hmax_list``.

    ``impl='auto'`` (the default):

    1. one multi-cylinder query computes the radii x depths neighbour
       indices (ops/multicyl.py; ``query_order='nearest'`` runs the plain
       nearest-order query, ops/query.py, which the JAX package also runs
       without a kernel);
    2. eval mode: a seed-major gather of the raw neighbour coordinates,
       then each scale's BN-folded MLP 3 -> 64 -> 128 -> 256 with the
       rotation and center folded into layer 0 and the max over K
       (ops/widthmlp.py:width_mlp_fused_rot);
    3. train mode (``self.training``: BatchNorm on batch statistics, which
       the fused MLP cannot fold): gather, subtract the center, rotate into
       the gripper frame, each scale's SharedMLP, max over K, as the JAX
       package's XLA path does.

    ``impl='fused_pallas'`` (the JAX package's name for it): the query also
    emits every neighbour's gripper-frame coordinates (no gradient flows
    through them); in eval mode each scale's BN-folded MLP and the max over
    K run on them (ops/widthmlp.py:width_mlp_fused), in train mode each
    scale's SharedMLP and the max. Its query is index-order only: the JAX
    package's fused query ignores ``query_order``, so the port refuses
    ``'nearest'`` with it.

    The fused MLPs are float32: with ``dtype`` bfloat16 the eval mode takes
    the train mode's path (the gripper-frame coordinates in float32, cast
    to bfloat16 for each scale's SharedMLP), as the JAX package does.

    Returns (B, Ns, D, n_scales * 256) in ``dtype``."""

    IMPLS = ("auto", "fused_pallas")

    def __init__(
        self,
        *,
        nsample: int = 64,
        cylinder_radius: float = CYLINDER_RADIUS,
        hmin: float = HMIN,
        hmax_list: Sequence[float] = HMAX_LIST,
        scales: Sequence[float] = SCALES,
        mlp: Sequence[int] = (64, 128, 256),
        query_order: str = "index",
        impl: str = "auto",
        dtype=torch.float32,
    ):
        super().__init__()
        if impl not in self.IMPLS:
            raise ValueError(f"impl must be one of {self.IMPLS}, got {impl!r}")
        if query_order not in ORDERS:
            raise ValueError(f"query_order must be one of {ORDERS}, got {query_order!r}")
        if impl == "fused_pallas" and query_order != "index":
            raise ValueError(
                "width_impl='fused_pallas' with query_order='nearest': the fused cylinder query keeps the "
                "first k by index; the JAX package's fused query ignores query_order there (a fault of the "
                "reference, ROADMAP), so the port refuses the combination"
            )
        self.impl = impl
        self.nsample = nsample
        self.query_order = query_order
        self.dtype = dtype
        self.radii = tuple(s * cylinder_radius for s in scales)
        self.hmin = hmin
        self.hmax_list = tuple(hmax_list)
        self.out_features = len(self.radii) * mlp[-1]
        for ri in range(len(self.radii)):
            self.add_module(f"mlp_scale{ri}", SharedMLP(3, mlp, dtype=dtype))

    @torch.no_grad()
    def folded_weights(self):
        """Per scale, every layer's (W_eff (I, O), b_eff) with BN folded in
        (eval only: the kernel has no backward)."""
        return tuple(getattr(self, f"mlp_scale{ri}").fold() for ri in range(len(self.radii)))

    def _scale_mlps(self, rel: torch.Tensor) -> torch.Tensor:
        """Each scale's SharedMLP in ``dtype`` and the max over K on the
        gripper-frame coordinates rel (B, R, H, Ns, K, 3) float32."""
        feats = [getattr(self, f"mlp_scale{ri}")(rel[:, ri].to(self.dtype)).amax(dim=3) for ri in range(rel.shape[1])]
        return torch.cat(feats, dim=-1).permute(0, 2, 1, 3)  # (B, Ns, D, 4C)

    def forward(self, seed_xyz, cloud_xyz, vp_rot, *, plain: bool = False) -> torch.Tensor:
        cloud_xyz, seed_xyz, vp_rot = (t.contiguous() for t in (cloud_xyz, seed_xyz, vp_rot))
        if self.query_order != "index":
            def query(cloud, seeds, rot, *args):
                return multi_cylinder_query(cloud, seeds, rot, *args, order=self.query_order), None
        else:
            query = multi_cylinder_group_plain if plain else multi_cylinder_group
        unfused = self.training or self.dtype != torch.float32
        if self.impl == "fused_pallas":
            _, rel = query(
                cloud_xyz.detach(), seed_xyz.detach(), vp_rot.detach(),
                self.radii, self.hmin, self.hmax_list, self.nsample, emit_rel=True,
            )  # (B, R, H, Ns, K, 3)
            if unfused:
                return self._scale_mlps(rel)
            mlp = width_mlp_fused_plain if plain else width_mlp_fused
            return mlp(rel, self.folded_weights()).permute(0, 2, 1, 3)
        idx, _ = query(cloud_xyz, seed_xyz, vp_rot, self.radii, self.hmin, self.hmax_list, self.nsample)
        b, n_r, n_h, ns, k = idx.shape
        if unfused:
            grouped = group_points(cloud_xyz, idx.reshape(b, n_r * n_h * ns, k))
            rel = grouped.reshape(b, n_r, n_h, ns, k, 3) - seed_xyz[:, None, None, :, None, :]
            return self._scale_mlps(torch.einsum("brhskj,bsji->brhski", rel, vp_rot))  # R^T (p - c)
        idx_t = idx.permute(0, 3, 1, 2, 4).reshape(b, ns * n_r * n_h, k)  # (B, S*R*H, K)
        grouped = group_points(cloud_xyz, idx_t).reshape(b, ns, n_r, n_h, k, 3)
        mlp = width_mlp_fused_rot_plain if plain else width_mlp_fused_rot
        return mlp(grouped, seed_xyz, vp_rot, self.folded_weights())


class GraspParametersHead(nn.Module):
    """Score / angle-class / width head: (B, Ns, D, 256) -> dict of
    (B, Ns, A, D), A = ``num_angle``; D is the input's (one per depth of the
    width head, ``num_depth`` in the model)."""

    def __init__(self, *, num_angle: int = NUM_ANGLE, num_depth: int = len(HMAX_LIST), dtype=torch.float32):
        super().__init__()
        self.num_angle, self.num_depth = num_angle, num_depth
        self.conv1 = MLPBlock(256, 128, dtype=dtype)
        self.conv2 = MLPBlock(128, 128, dtype=dtype)
        self.conv3 = Dense(128, 3 * num_angle, dtype=dtype)

    def forward(self, vp_features: torch.Tensor) -> dict:
        x = self.conv3(self.conv2(self.conv1(vp_features)))
        b, ns, d, _ = x.shape
        x = x.reshape(b, ns, d, 3, self.num_angle).float().movedim(2, -1)  # (B, Ns, 3, A, D)
        return {
            "grasp_score_pred": x[:, :, 0],
            "grasp_angle_cls_pred": x[:, :, 1],
            "grasp_width_pred": x[:, :, 2],
        }


class ToleranceHead(nn.Module):
    """Per-angle tolerance head: (B, Ns, D, 256) -> (B, Ns, A, D)."""

    def __init__(self, *, num_angle: int = NUM_ANGLE, num_depth: int = len(HMAX_LIST), dtype=torch.float32):
        super().__init__()
        self.num_angle, self.num_depth = num_angle, num_depth
        self.conv1 = MLPBlock(256, 128, dtype=dtype)
        self.conv2 = MLPBlock(128, 128, dtype=dtype)
        self.conv3 = Dense(128, num_angle, dtype=dtype)

    def forward(self, vp_features: torch.Tensor) -> dict:
        x = self.conv3(self.conv2(self.conv1(vp_features)))
        return {"grasp_tolerance_pred": x.float().movedim(2, -1)}
