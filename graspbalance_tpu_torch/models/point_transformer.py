"""Lightweight Point Transformer segmentation backbone of the DSN (port of
graspbalance_tpu/models/point_transformer.py; eval and training forward,
BatchNorm following the module's mode).

  embed -> per stage: [down (FPS prefix + ball-group pooling) -> k-NN
  vector-attention blocks] -> proj, features at the seed level.

The k = 16 neighbour search is ``ops.knn.knn``: the CUDA kernel on CUDA
tensors (its plain version with ``plain=True``, or on CPU tensors). Modules
carry the flax names (embed, down{i}, block{i}_{j}, proj; ln1, attn, ln2,
mlp1, mlp2; q, k, v, pos1, pos2, attn1, attn2).

``dtype`` is every module's compute dtype (float32, or bfloat16 with the
JAX package's casts): parameters stay float32 and are cast at each product,
a LayerNorm computes its statistics in float32 and rounds its output to
``dtype``, the coordinates stay float32 (the ball query, the kNN and the
offsets, cast where they join the features) and the backbone's output is
float32.
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch import ops
from graspbalance_tpu_torch.nn.layers import Dense, MLPBlock
from graspbalance_tpu_torch.nn.registry import flax_norm
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_plain
from graspbalance_tpu_torch.ops.knn import knn, knn_plain

LN_EPS = 1e-6  # flax LayerNorm's default


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` in float32; in bfloat16 (``dtype``) flax's: the
    statistics and the normalisation in float32 on the input read as
    float32, the output rounded to bfloat16."""

    def __init__(self, features: int, eps: float = LN_EPS, *, dtype=torch.float32):
        super().__init__(features, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == torch.float32:
            return super().forward(x)
        return flax_norm(x, self.weight, self.bias, self.eps, (-1,), out_dtype=self.dtype)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.softmax``'s steps in x's dtype: exp(x - max), divided by
    its sum (accumulated in float32, rounded once)."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


class VectorAttention(nn.Module):
    """Local vector self-attention over the k nearest neighbours."""

    def __init__(self, channels: int, *, dtype=torch.float32):
        super().__init__()
        c = channels
        self.q, self.k, self.v = (Dense(c, c, dtype=dtype) for _ in range(3))
        self.pos1, self.pos2 = Dense(3, c, dtype=dtype), Dense(c, c, dtype=dtype)
        self.attn1, self.attn2 = Dense(c, c, dtype=dtype), Dense(c, c, dtype=dtype)

    def forward(self, xyz: torch.Tensor, feats: torch.Tensor, knn_idx: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3), feats (B, N, C), knn_idx (B, N, K) -> (B, N, C)."""
        q = self.q(feats)
        kg = ops.group_points(self.k(feats), knn_idx)  # (B, N, K, C)
        vg = ops.group_points(self.v(feats), knn_idx)
        rel = ops.group_points(xyz, knn_idx) - xyz.unsqueeze(2)  # (B, N, K, 3)
        pos = self.pos2(torch.relu(self.pos1(rel)))
        w = self.attn2(torch.relu(self.attn1(q.unsqueeze(2) - kg + pos)))
        w = softmax(w, dim=2)
        return torch.sum(w * (vg + pos), dim=2)


class PTBlock(nn.Module):
    """Pre-norm residual vector-attention block + pointwise MLP."""

    def __init__(self, channels: int, *, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(channels, dtype=dtype)
        self.attn = VectorAttention(channels, dtype=dtype)
        self.ln2 = LayerNorm(channels, dtype=dtype)
        self.mlp1 = Dense(channels, channels * 2, dtype=dtype)
        self.mlp2 = Dense(channels * 2, channels, dtype=dtype)

    def forward(self, xyz, feats, knn_idx):
        feats = feats + self.attn(xyz, self.ln1(feats), knn_idx)
        return feats + self.mlp2(torch.relu(self.mlp1(self.ln2(feats))))


# (npoint, radius, nsample, channels, n_blocks)
PT_STAGES = (
    (2048, 0.05, 32, 64, 1),
    (1024, 0.1, 16, 128, 2),
)


class PointTransformerSeg(nn.Module):
    """(B, N, 3) -> dict(seed_xyz (B, S, 3), seed_features (B, S, out))."""

    def __init__(self, stages=PT_STAGES, out_channels: int = 256, knn: int = 16, *, dtype=torch.float32):
        super().__init__()
        self.stages = tuple(stages)
        self.knn = knn
        c = self.stages[0][3]
        self.embed = MLPBlock(3, c, dtype=dtype)
        for i, (_, _, _, channels, n_blocks) in enumerate(self.stages):
            self.add_module(f"down{i}", MLPBlock(3 + c, channels, dtype=dtype))
            c = channels
            for j in range(n_blocks):
                self.add_module(f"block{i}_{j}", PTBlock(channels, dtype=dtype))
        self.proj = Dense(c, out_channels, dtype=dtype)

    def forward(self, pointcloud: torch.Tensor, *, sa_inds=None, plain: bool = False) -> dict:
        """pointcloud (B, N, 3); sa_inds optional (B, npoint_0) FPS indices.
        ``plain`` runs the kernels' plain versions (FPS, kNN)."""
        xyz = pointcloud[..., :3]
        feats = self.embed(pointcloud)
        if sa_inds is None:
            fps = furthest_point_sample_plain if plain else ops.furthest_point_sample
            sa_inds = fps(xyz.contiguous(), self.stages[0][0])
        knn_fn = knn_plain if plain else knn
        for i, (npoint, radius, nsample, _, n_blocks) in enumerate(self.stages):
            if i == 0:
                inds = sa_inds
            else:  # nested-prefix FPS: the first npoint of the running order
                inds = torch.arange(npoint, device=xyz.device).expand(xyz.shape[0], npoint)
            new_xyz = ops.gather_points(xyz, inds)
            idx = ops.ball_query(xyz, new_xyz, radius, nsample)
            grouped_xyz = (ops.group_points(xyz, idx) - new_xyz.unsqueeze(2)) / radius
            grouped_feats = ops.group_points(feats, idx)
            grouped = torch.cat([grouped_xyz.to(grouped_feats.dtype), grouped_feats], dim=-1)
            feats = getattr(self, f"down{i}")(grouped).amax(dim=2)
            xyz = new_xyz.contiguous()
            # one kNN per stage: every block at this resolution shares it
            if n_blocks > 0:
                _, knn_idx = knn_fn(xyz, xyz, self.knn)
            for j in range(n_blocks):
                feats = getattr(self, f"block{i}_{j}")(xyz, feats, knn_idx)
        return {"seed_xyz": xyz, "seed_features": self.proj(feats).float()}
