"""Set abstraction and feature propagation, channels-last
(port of graspbalance_tpu/nn/sa_fp.py): ``SetAbstraction`` with its opt-in
fused eval branch, ``FeaturePropagation``, and the reference's other
grouping modules, which the live model does not use: ``SetAbstractionMSG``,
``SetAbstractionShift``, ``SetAbstractionWOMLP`` (max, avg or rbf pooling)
and ``LocalFeaturePropagationMSG``. Every ball query takes ``query_order``
('index' | 'nearest', ops/query.py)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.nn.layers import SharedMLP, fused_eval_ok
from graspbalance_tpu_torch.ops import mlpmax
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_plain
from graspbalance_tpu_torch.ops.interpolate import inverse_distance_weights, three_interpolate


def mlp_in_features(in_features: int, use_xyz: bool) -> int:
    """The grouped rows' width: the offsets (when ``use_xyz``, or when there
    are no features) and ``in_features`` feature channels."""
    if in_features == 0:
        return 3
    return (3 if use_xyz else 0) + in_features


def group(xyz, features, centers, idx, *, radius=None, use_xyz: bool = True):
    """The grouped rows at ``centers`` (B, M, 3) of the (B, M, K) neighbour
    indices ``idx``: the offsets p_j - c (divided by ``radius`` unless it is
    None), joined by the neighbours' features when there are any (after the
    offsets, cast to the features' dtype, when ``use_xyz``). Returns
    (grouped (B, M, K, C), offsets (B, M, K, 3))."""
    offsets = ops.group_points(xyz, idx) - centers.unsqueeze(2)
    if radius is not None:
        offsets = offsets / radius
    if features is None:
        return offsets, offsets
    fj = ops.group_points(features, idx)
    return (torch.cat([offsets.to(fj.dtype), fj], dim=-1) if use_xyz else fj), offsets


def sample(xyz: torch.Tensor, inds, npoint: int, plain: bool) -> torch.Tensor:
    """The centers: ``inds`` (B, npoint) as given, else an FPS of ``xyz``."""
    if inds is None:
        inds = (furthest_point_sample_plain if plain else ops.furthest_point_sample)(xyz.contiguous(), npoint)
    return inds


class SetAbstraction(nn.Module):
    """Sampled centers + ball-query grouping + shared MLP + max pool, with
    use_xyz and normalize_xyz as the DRP and PointNet++ backbones set them:
    the grouped offsets are divided by the radius and concatenated with the
    features. The centers are given as FPS indices ``inds``.

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
        query_order: str = "index",
        fused_min_nsample: int | None = None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.radius = radius
        self.nsample = nsample
        self.query_order = query_order
        self.fused_min_nsample = fused_min_nsample
        self.dtype = dtype
        self.mlp = SharedMLP(3 + in_features, mlp, dtype=dtype)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None, inds: torch.Tensor, *,
                query_idx: torch.Tensor | None = None, plain: bool = False):
        """xyz (B, N, 3); features (B, N, C) or None; inds (B, npoint);
        query_idx optional (B, npoint, nsample) ball-query indices computed
        elsewhere (the point-axis-sharded path's exact sharded query,
        parallel/stage1.py), in place of the module's own query.
        ``plain`` runs the fused branch's kernel as its plain version.
        Returns (new_xyz (B, npoint, 3), new_features (B, npoint, C_out))."""
        new_xyz = ops.gather_points(xyz, inds)
        idx = query_idx
        if idx is None:
            idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample, order=self.query_order)
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
        grouped, _ = group(xyz, features, new_xyz, idx, radius=self.radius)
        return new_xyz, self.mlp(grouped.to(self.dtype)).amax(dim=2)


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping set abstraction: one FPS (or the given
    ``inds``), one (radius, nsample, mlp) branch a scale (``mlp{i}``), the
    scales' max-pooled features concatenated."""

    def __init__(self, in_features: int, npoint: int, radii, nsamples, mlps, *, normalize_xyz: bool = False,
                 use_xyz: bool = True, query_order: str = "index", dtype=torch.float32):
        super().__init__()
        self.npoint = npoint
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.normalize_xyz, self.use_xyz = normalize_xyz, use_xyz
        self.query_order = query_order
        self.dtype = dtype
        for si, mlp in enumerate(mlps):
            self.add_module(f"mlp{si}", SharedMLP(mlp_in_features(in_features, use_xyz), mlp, dtype=dtype))

    def forward(self, xyz, features=None, *, inds=None, plain: bool = False):
        """Returns (new_xyz (B, npoint, 3), features (B, npoint, sum of the
        scales' widths), inds)."""
        inds = sample(xyz, inds, self.npoint, plain)
        new_xyz = ops.gather_points(xyz, inds)
        outs = []
        for si, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx = ops.ball_query(xyz, new_xyz, radius, nsample, order=self.query_order)
            grouped, _ = group(xyz, features, new_xyz, idx, radius=radius if self.normalize_xyz else None,
                               use_xyz=self.use_xyz)
            outs.append(getattr(self, f"mlp{si}")(grouped.to(self.dtype)).amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1), inds


POOLINGS = ("max", "avg", "rbf")


def pool(out: torch.Tensor, offsets: torch.Tensor, pooling: str, sigma: float, nsample: int) -> torch.Tensor:
    """max / avg / rbf pooling over the neighbours (dim 2); the rbf weights
    exp(-|offset|^2 / sigma^2 / 2) read the grouper's offsets as they are
    (radius-normalised or not)."""
    if pooling == "max":
        return out.amax(dim=2)
    if pooling == "avg":
        return out.mean(dim=2)
    if pooling == "rbf":
        rbf = torch.exp(-(offsets * offsets).sum(dim=-1) / (sigma**2) / 2.0)  # (B, M, K)
        return (out * rbf.unsqueeze(-1)).sum(dim=2) / float(nsample)
    raise ValueError(f"unknown pooling: {pooling}")


class SetAbstractionShift(nn.Module):
    """Grouping + MLP + pooling at centers the caller gives (no FPS; the
    reference's vote-shift module). ``sigma`` (rbf pooling) defaults to
    radius / 2."""

    def __init__(self, in_features: int, radius: float, nsample: int, mlp: Sequence[int], *, pooling: str = "max",
                 sigma: float | None = None, normalize_xyz: bool = False, use_xyz: bool = True,
                 query_order: str = "index", dtype=torch.float32):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling: {pooling}")
        self.radius, self.nsample = radius, nsample
        self.pooling = pooling
        self.sigma = sigma if sigma is not None else radius / 2
        self.normalize_xyz, self.use_xyz = normalize_xyz, use_xyz
        self.query_order = query_order
        self.dtype = dtype
        self.mlp = SharedMLP(mlp_in_features(in_features, use_xyz), mlp, dtype=dtype)

    def forward(self, new_xyz, xyz, features=None):
        """new_xyz (B, M, 3) the centers; xyz (B, N, 3) -> (B, M, C_out)."""
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample, order=self.query_order)
        grouped, offsets = group(xyz, features, new_xyz, idx, radius=self.radius if self.normalize_xyz else None,
                                 use_xyz=self.use_xyz)
        out = self.mlp(grouped.to(self.dtype))
        return pool(out, offsets, self.pooling, self.sigma, self.nsample)


class SetAbstractionWOMLP(nn.Module):
    """FPS + grouping + pooling with no MLP: the grouped rows pooled as they
    are. It has no parameters."""

    def __init__(self, npoint: int, radius: float, nsample: int, *, pooling: str = "max", sigma: float | None = None,
                 normalize_xyz: bool = False, use_xyz: bool = True, query_order: str = "index"):
        super().__init__()
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling: {pooling}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.pooling = pooling
        self.sigma = sigma if sigma is not None else radius / 2
        self.normalize_xyz, self.use_xyz = normalize_xyz, use_xyz
        self.query_order = query_order

    def forward(self, xyz, features=None, *, inds=None, plain: bool = False):
        """Returns (new_xyz (B, npoint, 3), pooled (B, npoint, C), inds)."""
        inds = sample(xyz, inds, self.npoint, plain)
        new_xyz = ops.gather_points(xyz, inds)
        idx = ops.ball_query(xyz, new_xyz, self.radius, self.nsample, order=self.query_order)
        grouped, offsets = group(xyz, features, new_xyz, idx, radius=self.radius if self.normalize_xyz else None,
                                 use_xyz=self.use_xyz)
        return new_xyz, pool(grouped, offsets, self.pooling, self.sigma, self.nsample), inds


class LocalFeaturePropagationMSG(nn.Module):
    """Multi-scale grouping of level-1 features at level-2 points: a
    per-scale MLP (``mlp{i}``) + max pool, the level-2 skip features joined,
    one post-MLP (``post_mlp``) shared by every scale; the scales'
    results concatenated. ``in_features1`` / ``in_features2`` are the
    level-1 / level-2 feature widths (0: none)."""

    def __init__(self, in_features1: int, in_features2: int, radii, nsamples, mlps, post_mlp: Sequence[int], *,
                 use_xyz: bool = True, query_order: str = "index", dtype=torch.float32):
        super().__init__()
        self.radii, self.nsamples = tuple(radii), tuple(nsamples)
        self.use_xyz = use_xyz
        self.query_order = query_order
        self.dtype = dtype
        self.post_mlp = SharedMLP(mlps[0][-1] + in_features2, post_mlp, dtype=dtype)
        for si, mlp in enumerate(mlps):
            self.add_module(f"mlp{si}", SharedMLP(mlp_in_features(in_features1, use_xyz), mlp, dtype=dtype))

    def forward(self, xyz2, xyz1, features2, features1):
        """xyz2 (B, N2, 3) targets; xyz1 (B, N1, 3) sources; features2
        (B, N2, C2) or None; features1 (B, N1, C1) or None ->
        (B, N2, scales * post_mlp[-1])."""
        outs = []
        for si, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            idx = ops.ball_query(xyz1, xyz2, radius, nsample, order=self.query_order)
            grouped, _ = group(xyz1, features1, xyz2, idx, use_xyz=self.use_xyz)
            f = getattr(self, f"mlp{si}")(grouped.to(self.dtype)).amax(dim=2)
            if features2 is not None:
                f = torch.cat([f, features2.to(f.dtype)], dim=-1)
            outs.append(self.post_mlp(f))
        return torch.cat(outs, dim=-1)


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
