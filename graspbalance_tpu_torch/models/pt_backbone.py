"""Point Transformer (Zhao, Jiang, Jia, Torr, Koltun, ICCV 2021) as
GraspBalance's backbone: Pointcept's PointTransformerSeg50 (blocks
1, 2, 3, 5, 2 after each transition-down, one decoder block a stage) over
channels-last clouds (B, N, 3), the coordinates its input features.

A stage is a row ``(npoint, k, channels, blocks)`` of ``PT_STAGES``:

  stage 1   keeps every point of the cloud (stride 1; its npoint is the
            cloud size the table was written for):
            x = ReLU(BN(Linear_nobias(xyz)))
  stage i   the first npoint indices of one FPS of the raw cloud,
            ``fps_prefix`` = stage 2's npoint long (greedy FPS from the
            same first point re-traces itself, so each prefix is an FPS of
            the stage before, up to ties); transition-down:
            x' = max_j ReLU(BN(Linear_nobias([p_j - p'_i, x_j]))) over the
            k nearest stage-(i-1) points of each p'_i

then ``blocks`` Bottlenecks, y = ReLU(BN1(Linear1_nobias(x))),
y = ReLU(BN2(PTLayer(y))), x = ReLU(BN3(Linear3_nobias(y)) + x), whose
vector attention (``PointTransformerLayer``) runs over one kNN of the
stage's points (the query among them), shared by the stage's encoder and
decoder blocks. The decoder: stage 5's transition-up
x = ReLU(BN(Linear([x, ReLU(Linear(mean over the cloud of x))]))), the
others' x = ReLU(BN(Linear(x_skip))) + interp3(ReLU(BN(Linear(x_coarse))))
(inverse-distance weights over the 3 nearest coarse points), each followed
by one Bottleneck; then the seg head Linear -> BN -> ReLU -> Linear to 256
channels at every point. Linear layers have a bias unless "nobias".

The seeds are the first ``num_seed`` indices of the FPS (``fp2_inds``),
their points and the head's output there. The end points also carry the
FPS under ``fps_inds``; the forward takes it as ``sa_inds`` (OBS shares it
with the DSN). Every kNN search (the stages', the transition-downs' and
the 3-NN of the transition-ups) is ``ops.knn``: K9 on CUDA tensors.

Spans (``trace.py``): ``gb.pt.knn`` (each kNN search), ``gb.pt.down``,
``gb.pt.attention`` (each PTLayer) and ``gb.pt.up``. Every BatchNorm is
``nn/layers.BatchNorm`` under a ``.bn`` name (train mode on the card: the
fused BatchNorm + ReLU kernels), over all rows of its input: (B, N) or
(B, N, k).
"""

from __future__ import annotations

import torch
from torch import nn

from graspbalance_tpu_torch import ops, trace
from graspbalance_tpu_torch.nn.layers import BatchNorm, Dense
from graspbalance_tpu_torch.ops.fps import furthest_point_sample_plain
from graspbalance_tpu_torch.ops.gather import gather_points, group_points
from graspbalance_tpu_torch.ops.interpolate import inverse_distance_weights, three_interpolate
from graspbalance_tpu_torch.ops.knn import knn_plain

SHARE_PLANES = 8  # channels that share one attention weight
HEAD_FEATURES = 256  # the seg head's output width: the seed features the heads read

# (npoint, k, channels, blocks); npoint 5,000 / 1,250 / 312 / 78 is the
# published stride 4 with floor division on 20,000-point clouds
PT_STAGES = (
    (20000, 8, 32, 1),
    (5000, 16, 64, 2),
    (1250, 16, 128, 3),
    (312, 16, 256, 5),
    (78, 16, 512, 2),
)


class LinearBN(nn.Module):
    """Linear (``bias`` or not) -> BatchNorm -> ReLU (``act=False``: no ReLU)."""

    def __init__(self, in_features: int, features: int, *, bias: bool, act: bool = True):
        super().__init__()
        self.act = act
        self.dense = Dense(in_features, features, bias=bias)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.dense(x), act=self.act)


class Norm(nn.Module):
    """A BatchNorm on its own, then a ReLU; its tensors named ``<name>.bn.*``."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x, act=True)


def share_planes_sum(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """values (B, N, k, C), weights (B, N, k, C/S) -> (B, N, C):
    out[..., s * C/S + c] = sum_j weights[..., j, c] * values[..., j, s * C/S + c],
    so that weight c serves the S channels c, c + C/S, ..., strided."""
    b, n, k, c = values.shape
    g = weights.shape[-1]
    return (values.view(b, n, k, c // g, g) * weights.unsqueeze(3)).sum(dim=2).reshape(b, n, c)


class PointTransformerLayer(nn.Module):
    """Grouped vector attention at C channels over each point's k
    neighbours: q, k, v = Linear(y); delta_ij = Linear_p2(ReLU(BN_p(
    Linear_p1(p_j - p_i)))); r_ij = k_j - q_i + delta_ij;
    w_ij = Linear_w2(ReLU(BN_w2(Linear_w1(ReLU(BN_w1(r_ij)))))) at C/8
    channels; a softmax over j; out = share_planes_sum(v_j + delta_ij, a)."""

    def __init__(self, channels: int):
        super().__init__()
        planes = channels // SHARE_PLANES
        self.q = Dense(channels, channels)
        self.k = Dense(channels, channels)
        self.v = Dense(channels, channels)
        self.p1 = Dense(3, 3)
        self.p_norm = Norm(3)
        self.p2 = Dense(3, channels)
        self.w_norm1 = Norm(channels)
        self.w1 = Dense(channels, planes)
        self.w_norm2 = Norm(planes)
        self.w2 = Dense(planes, planes)

    def forward(self, rel: torch.Tensor, y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """rel (B, N, k, 3) the neighbours' offsets p_j - p_i, y (B, N, C),
        idx (B, N, k) the neighbours."""
        with trace.span("gb.pt.attention"):
            q, k, v = self.q(y), self.k(y), self.v(y)
            delta = self.p2(self.p_norm(self.p1(rel)))
            r = group_points(k, idx) - q.unsqueeze(2) + delta
            w = self.w2(self.w_norm2(self.w1(self.w_norm1(r))))
            return share_planes_sum(group_points(v, idx) + delta, torch.softmax(w, dim=2))


class Bottleneck(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.lin1 = LinearBN(channels, channels, bias=False)
        self.attn = PointTransformerLayer(channels)
        self.norm2 = Norm(channels)
        self.lin3 = LinearBN(channels, channels, bias=False, act=False)

    def forward(self, rel: torch.Tensor, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        y = self.norm2(self.attn(rel, self.lin1(x), idx))
        return torch.relu(self.lin3(y) + x)


class HeadUp(nn.Module):
    """The coarsest stage's transition-up: each point's features joined to
    a projection of the cloud's mean."""

    def __init__(self, channels: int):
        super().__init__()
        self.lin2 = Dense(channels, channels)
        self.lin1 = LinearBN(2 * channels, channels, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.relu(self.lin2(x.mean(dim=1, keepdim=True))).expand_as(x)
        return self.lin1(torch.cat([x, g], dim=-1))


class Up(nn.Module):
    """Transition-up: the skip's features plus the coarser stage's,
    interpolated from its 3 nearest points."""

    def __init__(self, coarse_channels: int, channels: int):
        super().__init__()
        self.lin1 = LinearBN(channels, channels, bias=True)
        self.lin2 = LinearBN(coarse_channels, channels, bias=True)

    def forward(self, p, x, p_coarse, x_coarse, knn) -> torch.Tensor:
        with trace.span("gb.pt.knn"):
            dist, idx = knn(p_coarse, p, 3)
        return self.lin1(x) + three_interpolate(self.lin2(x_coarse), idx, inverse_distance_weights(dist))


class PTBackbone(nn.Module):
    """Modules: down{i} (transition-down), block{i}_{j} (the encoder's
    Bottlenecks), up{i} and dec{i} (the decoder's transition-up and
    Bottleneck), head and cls (the seg head), for stages i = 1..5.

    Its neighbourhoods are kNN sets, so ``query_order`` (which
    ``GraspBalance`` passes on to the width head's ball queries as well)
    leaves it as it is. It has no grouping to fuse, so it refuses a
    ``fused_backbone_min_nsample``, and it computes in float32 only."""

    def __init__(self, stages=PT_STAGES, num_seed: int = 1024, *, query_order: str = "index",
                 fused_backbone_min_nsample: int | None = None, dtype=torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise ValueError(f"the pt backbone computes in float32 only, got {dtype}")
        if fused_backbone_min_nsample is not None:
            raise ValueError("the pt backbone has no grouping to fuse, got "
                             f"fused_backbone_min_nsample={fused_backbone_min_nsample}")
        self.stages = tuple(tuple(s) for s in stages)
        if len(self.stages) < 2:
            raise ValueError("the pt backbone needs at least two stages")
        if not num_seed <= self.stages[1][0]:
            raise ValueError(f"num_seed={num_seed} exceeds stage 2's {self.stages[1][0]} points")
        for _, _, c, _ in self.stages:
            if c % SHARE_PLANES:
                raise ValueError(f"channels {c} not a multiple of {SHARE_PLANES}")
        self.num_seed = num_seed
        c_in = 3
        for i, (_, _, c, blocks) in enumerate(self.stages, start=1):
            self.add_module(f"down{i}", LinearBN(c_in if i == 1 else 3 + c_in, c, bias=False))
            for j in range(blocks):
                self.add_module(f"block{i}_{j}", Bottleneck(c))
            c_in = c
        widths = [s[2] for s in self.stages]
        last = len(self.stages)
        self.add_module(f"up{last}", HeadUp(widths[-1]))
        for i in range(1, last):
            self.add_module(f"up{i}", Up(widths[i], widths[i - 1]))
        for i in range(1, last + 1):
            self.add_module(f"dec{i}", Bottleneck(widths[i - 1]))
        self.head = LinearBN(widths[0], widths[0], bias=True)
        self.cls = Dense(widths[0], HEAD_FEATURES)

    @staticmethod
    def fps_prefix(stages) -> int:
        """The length of the one FPS of the raw cloud whose prefixes the
        stages of ``stages`` take."""
        return stages[1][0]

    def forward(self, pointcloud: torch.Tensor, *, sa_inds=None, plain: bool = False) -> dict:
        """pointcloud (B, N, 3); sa_inds optional (B, >= fps_prefix) FPS
        indices. ``plain`` runs the plain PyTorch versions of FPS and kNN.

        Returns input_xyz, input_features (None), fps_inds (B, fps_prefix),
        fp2_inds (B, num_seed), fp2_xyz and fp2_features (B, num_seed, 256)."""
        if pointcloud.ndim != 3 or pointcloud.shape[-1] != 3:
            raise ValueError(f"point clouds must be (B, N, 3), got {tuple(pointcloud.shape)}")
        xyz = pointcloud
        n_fps = self.fps_prefix(self.stages)
        if sa_inds is None:
            fps = furthest_point_sample_plain if plain else ops.furthest_point_sample
            sa_inds = fps(xyz.contiguous(), n_fps)
        elif sa_inds.shape[1] < n_fps:
            raise ValueError(f"sa_inds holds {sa_inds.shape[1]} FPS indices, the stages need {n_fps}")
        sa_inds = sa_inds[:, :n_fps]
        knn = knn_plain if plain else ops.knn
        ps, xs, rels, idxs = [], [], [], []
        for i, (npoint, k, _, blocks) in enumerate(self.stages, start=1):
            with trace.span("gb.pt.down"):
                if i == 1:
                    p = xyz
                    x = self.down1(xyz)
                else:
                    p = gather_points(xyz, sa_inds[:, :npoint])
                    with trace.span("gb.pt.knn"):
                        _, gidx = knn(ps[-1], p, k)
                    g = torch.cat([group_points(ps[-1], gidx) - p.unsqueeze(2), group_points(xs[-1], gidx)], dim=-1)
                    x = getattr(self, f"down{i}")(g).amax(dim=2)
            with trace.span("gb.pt.knn"):
                _, idx = knn(p, p, k)
            rel = group_points(p, idx) - p.unsqueeze(2)
            for j in range(blocks):
                x = getattr(self, f"block{i}_{j}")(rel, x, idx)
            ps.append(p)
            xs.append(x)
            rels.append(rel)
            idxs.append(idx)

        last = len(self.stages)
        for i in range(last, 0, -1):
            with trace.span("gb.pt.up"):
                if i == last:
                    x = getattr(self, f"up{i}")(x)
                else:
                    x = getattr(self, f"up{i}")(ps[i - 1], xs[i - 1], ps[i], x, knn)
            x = getattr(self, f"dec{i}")(rels[i - 1], x, idxs[i - 1])
        x = self.cls(self.head(x))
        seeds = sa_inds[:, : self.num_seed]
        return {"input_xyz": xyz, "input_features": None, "fps_inds": sa_inds, "fp2_inds": seeds,
                "fp2_xyz": gather_points(xyz, seeds), "fp2_features": gather_points(x, seeds)}
