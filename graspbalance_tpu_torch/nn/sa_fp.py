"""Set abstraction and feature propagation, channels-last
(port of graspbalance_tpu/nn/sa_fp.py: ``SetAbstraction`` with its opt-in
fused eval branch, and ``FeaturePropagation``)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.nn.layers import SharedMLP, fused_eval_ok
from graspbalance_tpu_torch.ops import mlpmax
from graspbalance_tpu_torch.ops.interpolate import inverse_distance_weights, three_interpolate


class SetAbstraction(nn.Module):
    """Sampled centers + ball-query grouping + shared MLP + max pool, with
    use_xyz and normalize_xyz as the DRP backbone sets them: the grouped
    offsets are divided by the radius and concatenated with the features.
    The centers are given as FPS indices ``inds``.

    ``fused_min_nsample`` (None: off) turns on the fused eval branch for
    ``nsample >= fused_min_nsample`` (``nn.layers.fused_eval_ok``): the
    BN-folded MLP and the max over K run in one kernel (ops/mlpmax.py), the
    xyz | features concatenation is never built, and the 1 / radius of the
    normalised offsets is folded into the xyz rows of layer 0. The branch
    is float32 only: in bfloat16 (``dtype``) the offsets are cast to the
    features' dtype where they join them, and the MLP runs in ``dtype``."""

    def __init__(
        self,
        in_features: int,
        radius: float,
        nsample: int,
        mlp: Sequence[int],
        *,
        fused_min_nsample: int | None = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.fused_min_nsample = fused_min_nsample
        self.dtype = dtype
        self.mlp = SharedMLP(3 + in_features, mlp, dtype=dtype)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None, inds: torch.Tensor, *, plain: bool = False):
        """xyz (B, N, 3); features (B, N, C) or None; inds (B, npoint).
        ``plain`` runs the fused branch's kernel as its plain version.
        Returns (new_xyz (B, npoint, 3), new_features (B, npoint, C_out))."""
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample)
        if fused_eval_ok(self, xyz):
            (w0, b0), *rest = self.mlp.fold()
            offsets = ops.group_points(xyz, idx) - new_xyz.unsqueeze(2)
            scale = 1.0 / self.radius
            if features is not None:
                parts, w0_parts = (offsets, ops.group_points(features, idx)), (w0[:3] * scale, w0[3:])
            else:
                parts, w0_parts = (offsets,), (w0 * scale,)
            fused = mlpmax.mlp_max_fused_plain if plain else mlpmax.mlp_max_fused
            return new_xyz, fused(parts, ((w0_parts, b0), *rest))
        grouped = (ops.group_points(xyz, idx) - new_xyz.unsqueeze(2)) / self.radius
        if features is not None:
            grouped_feats = ops.group_points(features, idx)
            grouped = torch.cat([grouped.to(grouped_feats.dtype), grouped_feats], dim=-1)
        return new_xyz, self.mlp(grouped.to(self.dtype)).amax(dim=2)


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN upsampling + skip concat + shared MLP in
    ``dtype``. The interpolation runs in float32 (the float32 weights
    promote bfloat16 features, as jnp does); the MLP's input is cast to
    ``dtype``."""

    def __init__(self, in_features: int, mlp: Sequence[int], *, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp = SharedMLP(in_features, mlp, dtype=dtype)

    def forward(self, unknown, known, unknown_feats, known_feats):
        """unknown (B, n, 3), known (B, m, 3), unknown_feats (B, n, C1) or
        None, known_feats (B, m, C2) -> (B, n, mlp[-1])."""
        dist, idx = ops.three_nn(unknown, known)
        interp = three_interpolate(known_feats, idx, inverse_distance_weights(dist))
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats.to(interp.dtype)], dim=-1)
        return self.mlp(interp.to(self.dtype))
