"""Three-point inverse-distance interpolation, channels-last
(port of graspbalance_tpu/ops/interpolate.py)."""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.ops.gather import group_points
from graspbalance_tpu_torch.ops.knn import three_nn


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """feats (B, M, C), idx (B, N, 3), weight (B, N, 3) -> (B, N, C)."""
    return torch.sum(group_points(feats, idx) * weight.unsqueeze(-1), dim=2)


def inverse_distance_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(B, N, 3) euclidean distances -> normalised inverse-distance weights."""
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def interpolate_features(
    unknown: torch.Tensor, known: torch.Tensor, known_feats: torch.Tensor
) -> torch.Tensor:
    """Upsample ``known_feats`` from the ``known`` points onto ``unknown``."""
    dist, idx = three_nn(unknown, known)
    return three_interpolate(known_feats, idx, inverse_distance_weights(dist))
