"""DRP backbone (port of graspbalance_tpu/models/drp.py).

Four set-abstraction stages (npoint 2048/1024/512/256), each followed by
3/6/3/3 inverted-residual blocks, then two feature-propagation stages back
to the 1024-point seed level. One 2048-point FPS serves all four stages:
greedy FPS re-traces itself on its own output, so stage i samples the first
``npoint`` points of the running FPS order, and the stages just slice.
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.nn.layers import MLPBlock, fused_eval_ok
from graspbalance_tpu_torch.nn.registry import CHANNEL_MAP
from graspbalance_tpu_torch.nn.sa_fp import FeaturePropagation, SetAbstraction
from graspbalance_tpu_torch.ops import mlpmax
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_plain
from graspbalance_tpu_torch.ops.knn import knn_plain


FEATURE_TYPES = ("dp_fj", "dp_fj_df", "pi_dp_fj_df", "dp_df")
REDUCTIONS = ("max", "mean", "avg", "sum")


class LocalAggregation(nn.Module):
    """Neighbourhood aggregation: ``grouper`` 'ballquery' (the live model's,
    at ``query_order``) or 'knn' (``ops.knn``: the kNN kernel at k <= 32);
    ``feature_type`` 'dp_fj' (the live model's: offsets | neighbour
    features), 'dp_fj_df', 'pi_dp_fj_df' or 'dp_df' (df = f_j - f_i, pi the
    center); one conv block with BN + ReLU, then ``reduction`` 'max' (the
    live model's), 'mean' ('avg') or 'sum' over the neighbours.

    'dp_fj' runs in the lifted form: the block's linear layer commutes with
    the gather, ``[p_j - c_i, f_j] @ W == [p_j, f_j] @ W - [c_i, 0] @ W``,
    so both products run on N rows and one gather moves their difference's
    terms. The other feature types run the block on the grouped rows.

    ``fused_min_nsample`` (None: off) turns on the fused eval branch of
    'dp_fj' for ``nsample >= fused_min_nsample`` (``nn.layers.fused_eval_ok``):
    the grouped ``dp | fj`` rows (two gathers, never concatenated) go through
    the BN-folded block and the reduction in one kernel (ops/mlpmax.py). It
    runs the block on N x K rows, where the lifted form runs it on N. In
    bfloat16 (``dtype``) the coordinates are cast to the features' dtype
    where they join them, and the block runs in ``dtype``.

    The chunked-centers form (the point-axis-sharded path,
    parallel/backbone.py): ``centers`` (B, M, 3) and ``center_feats``
    (B, M, C) restrict the output rows to those centers, while ``xyz`` and
    ``feats`` stay the whole support; ``query_idx`` (B, M, nsample) replaces
    the module's own query. Every operation is row-local over the centers,
    so a chunked call gives the matching rows of the full call (each row's
    products may round differently with the number of rows: within 1e-6)."""

    def __init__(self, channels: int, radius: float, nsample: int, *, grouper: str = "ballquery",
                 feature_type: str = "dp_fj", reduction: str = "max", query_order: str = "index",
                 fused_min_nsample: int | None = None, dtype=torch.float32):
        super().__init__()
        if grouper not in ("ballquery", "knn"):
            raise ValueError(f"unknown grouper {grouper}")
        if feature_type not in FEATURE_TYPES:
            raise ValueError(f"unknown feature_type {feature_type}")
        if reduction not in REDUCTIONS:
            raise ValueError(f"unknown reduction {reduction}")
        self.radius = radius
        self.nsample = nsample
        self.grouper = grouper
        self.feature_type = feature_type
        self.reduction = "mean" if reduction == "avg" else reduction
        self.query_order = query_order
        self.fused_min_nsample = fused_min_nsample
        self.dtype = dtype
        self.conv = MLPBlock(CHANNEL_MAP[feature_type](channels), channels, dtype=dtype)

    def _reduce(self, out: torch.Tensor) -> torch.Tensor:
        if self.reduction == "max":
            return out.amax(dim=2)
        return out.mean(dim=2) if self.reduction == "mean" else out.sum(dim=2)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, *, centers: torch.Tensor | None = None,
                center_feats: torch.Tensor | None = None, query_idx: torch.Tensor | None = None,
                plain: bool = False) -> torch.Tensor:
        """``plain`` runs the kernels (kNN, the fused branch's) as their
        plain versions; ``centers``, ``center_feats`` and ``query_idx``
        give the chunked-centers form (see the class docstring)."""
        cx = xyz if centers is None else centers
        cf = feats if center_feats is None else center_feats
        idx = query_idx
        if idx is None and self.grouper == "knn":
            _, idx = (knn_plain if plain else ops.knn)(xyz, cx, self.nsample)
        elif idx is None:
            idx = ops.ball_query(xyz, cx, self.radius, self.nsample, order=self.query_order)
        if self.feature_type == "dp_fj" and fused_eval_ok(self, feats):
            dp = ops.group_points(xyz, idx) - cx.unsqueeze(2)
            fj = ops.group_points(feats, idx)
            w0, b0 = self.conv.fold()
            fused = mlpmax.mlp_max_fused_plain if plain else mlpmax.mlp_max_fused
            return fused((dp, fj), (((w0[:3], w0[3:]), b0),), reduction=self.reduction)
        if self.feature_type == "dp_fj":
            xyz_f = xyz.to(feats.dtype)
            e = self.conv(torch.cat([xyz_f, feats], dim=-1), stage="dense")
            cw = self.conv(torch.cat([cx.to(feats.dtype), torch.zeros_like(cf)], dim=-1), stage="dense")
            pre = ops.group_points(e, idx) - cw.unsqueeze(2)
            return self._reduce(self.conv(pre, stage="post"))
        fj = ops.group_points(feats, idx)
        dp = (ops.group_points(xyz, idx) - cx.unsqueeze(2)).to(fj.dtype)
        df = fj - cf.unsqueeze(2)
        if self.feature_type == "dp_fj_df":
            grouped = torch.cat([dp, fj, df], dim=-1)
        elif self.feature_type == "pi_dp_fj_df":
            pi = cx.unsqueeze(2).to(fj.dtype).expand(dp.shape)
            grouped = torch.cat([pi, dp, fj, df], dim=-1)
        else:  # dp_df
            grouped = torch.cat([dp, df], dim=-1)
        return self._reduce(self.conv(grouped))


EXPANSION = 4  # InvResMLP's pointwise width multiple


class InvResMLP(nn.Module):
    """LocalAggregation -> [C -> 4C (BN+ReLU) -> C (BN)] -> +residual -> ReLU,
    in ``dtype``. ``centers``, ``center_feats`` and ``query_idx`` give
    LocalAggregation's chunked-centers form: the block's rows at those
    centers (the residual is ``center_feats``)."""

    def __init__(self, channels: int, radius: float, nsample: int, *, query_order: str = "index",
                 fused_min_nsample: int | None = None, dtype=torch.float32):
        super().__init__()
        self.local_agg = LocalAggregation(channels, radius, nsample, query_order=query_order,
                                          fused_min_nsample=fused_min_nsample, dtype=dtype)
        self.pw1 = MLPBlock(channels, channels * EXPANSION, dtype=dtype)
        self.pw2 = MLPBlock(channels * EXPANSION, channels, act=False, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, *, centers: torch.Tensor | None = None,
                center_feats: torch.Tensor | None = None, query_idx: torch.Tensor | None = None,
                plain: bool = False) -> torch.Tensor:
        f = self.local_agg(xyz, feats, centers=centers, center_feats=center_feats, query_idx=query_idx, plain=plain)
        f = self.pw2(self.pw1(f))
        return torch.relu(f + (feats if center_feats is None else center_feats))


# (npoint, sa_radius, sa_nsample, mlp, n_blocks, block_radius, block_nsample)
DRP_STAGES = (
    (2048, 0.04, 64, (64, 64, 128), 3, 0.08, 64),
    (1024, 0.10, 32, (128, 128, 256), 6, 0.20, 32),
    (512, 0.20, 16, (128, 128, 256), 3, 0.40, 16),
    (256, 0.30, 16, (128, 128, 256), 3, 0.60, 16),
)


class DRP(nn.Module):
    """Modules are named as in the flax tree: sa{i}, block{i}_{j}, fp1, fp2.

    ``fused_backbone_min_nsample`` is the fused eval configuration of the
    JAX package's ``fused_eval_ok``: None (the default) keeps it off; 0 fuses
    every set abstraction and local aggregation (``GB_FORCE_FUSED_EVAL``'s
    set), 64 those with K >= 64 (``GB_FUSED_BACKBONE``'s set). It applies in
    eval mode to float32 only. ``dtype`` is every module's compute dtype,
    ``query_order`` every ball query's."""

    def __init__(self, stages=DRP_STAGES, num_seed: int = 1024, *, query_order: str = "index",
                 fused_backbone_min_nsample: int | None = None, dtype=torch.float32):
        super().__init__()
        self.stages = tuple(stages)
        self.num_seed = num_seed
        kw = dict(query_order=query_order, fused_min_nsample=fused_backbone_min_nsample, dtype=dtype)
        c = 0  # the clouds carry xyz only
        for i, (_, radius, nsample, mlp, n_blocks, b_radius, b_nsample) in enumerate(self.stages):
            self.add_module(f"sa{i + 1}", SetAbstraction(c, radius, nsample, mlp, **kw))
            c = mlp[-1]
            for j in range(n_blocks):
                self.add_module(f"block{i + 1}_{j}", InvResMLP(c, b_radius, b_nsample, **kw))
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
        branches' kernel instead of the kernels.

        Returns input_xyz, input_features (None), sa1_inds,
        sa{1..4}_{xyz,features}, fp2_features (B, num_seed, 256), fp2_xyz,
        fp2_inds."""
        if pointcloud.ndim != 3 or pointcloud.shape[-1] != 3:
            raise ValueError(f"point clouds must be (B, N, 3), got {tuple(pointcloud.shape)}")
        xyz, features = pointcloud, None
        out = {"input_xyz": xyz, "input_features": features}
        if sa_inds is None:
            fps = furthest_point_sample_plain if plain else ops.furthest_point_sample
            sa_inds = fps(xyz, self.fps_prefix(self.stages))
        out["sa1_inds"] = sa_inds

        stage_xyz, stage_feats = [], []
        cur_xyz, cur_feats = xyz, features
        for i, stage in enumerate(self.stages):
            npoint, n_blocks = stage[0], stage[4]
            if i == 0:
                inds = sa_inds
            else:  # nested-prefix FPS: the first npoint of the running order
                inds = torch.arange(npoint, device=xyz.device).expand(xyz.shape[0], npoint)
            cur_xyz, cur_feats = getattr(self, f"sa{i + 1}")(cur_xyz, cur_feats, inds, plain=plain)
            for j in range(n_blocks):
                cur_feats = getattr(self, f"block{i + 1}_{j}")(cur_xyz, cur_feats, plain=plain)
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
