"""Grasp decoding: head outputs -> 17-column grasp arrays
(port of graspbalance_tpu/models/decode.py).

Every seed is decoded and a validity mask carries the objectness filter, so
the output shape is fixed: (B, Ns, 17) + (B, Ns) bool. Columns (graspnetAPI
GraspGroup): [score, width, height=0.02, depth, rotation (9, row-major),
center (3), obj_id=-1].
"""

from __future__ import annotations

import math

import torch

from graspbalance_tpu_torch.labels.geometry import (
    GRASP_MAX_TOLERANCE,
    GRASP_MAX_WIDTH,
    batch_viewpoint_params_to_matrix,
)


def pred_decode(end_points: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (grasps (B, Ns, 17) float32, valid (B, Ns) bool)."""
    objectness = end_points["objectness_score"]  # (B, Ns, 2)
    score = end_points["grasp_score_pred"]  # (B, Ns, A, D)
    center = end_points["fp2_xyz"]  # (B, Ns, 3)
    approaching = -end_points["grasp_top_view_xyz"]
    angle_cls_score = end_points["grasp_angle_cls_pred"]
    width = torch.clamp(1.2 * end_points["grasp_width_pred"], 0.0, GRASP_MAX_WIDTH)
    tolerance = end_points["grasp_tolerance_pred"]
    a = angle_cls_score.shape[2]

    # best in-plane angle per (seed, depth)
    angle_cls = torch.argmax(angle_cls_score, dim=2, keepdim=True)  # (B, Ns, 1, D)
    angle = angle_cls[:, :, 0].float() / a * math.pi  # (B, Ns, D)
    score, width, tolerance = (x.gather(2, angle_cls)[:, :, 0] for x in (score, width, tolerance))

    # best depth per seed
    depth_cls = torch.argmax(score, dim=2, keepdim=True)  # (B, Ns, 1)
    depth = (depth_cls.float() + 1.0) * 0.01
    score, angle, width, tolerance = (
        x.gather(2, depth_cls) for x in (score, angle, width, tolerance)
    )

    valid = torch.argmax(objectness, dim=-1) == 1
    confidence = torch.softmax(objectness, dim=-1)[..., 1:2]
    score = score * confidence * tolerance / GRASP_MAX_TOLERANCE

    rot = batch_viewpoint_params_to_matrix(approaching, angle[..., 0])  # (B, Ns, 3, 3)
    rot9 = rot.reshape(rot.shape[:-2] + (9,))
    height = torch.full_like(score, 0.02)
    obj_ids = torch.full_like(score, -1.0)
    grasps = torch.cat([score, width, height, depth, rot9, center, obj_ids], dim=-1)
    return grasps.float(), valid
