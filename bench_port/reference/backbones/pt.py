"""Point Transformer (Zhao et al. ICCV 2021), Pointcept's
PointTransformerSeg50, as GraspBalance's backbone. A stage is (npoint, k,
channels, blocks). Stage 1 keeps every point of the cloud (its npoint is
the cloud size the table was written for): x = ReLU(BN(Linear_nobias(xyz))).
Stage i > 1 takes the first npoint indices of one FPS of the raw cloud,
stage 2's npoint long (its sampling contract, ``fps_prefix``), and pools
max_j ReLU(BN(Linear_nobias([p_j - p'_i, x_j]))) over the k nearest
stage-(i-1) points; then ``blocks`` Bottlenecks over one kNN of the stage's
points (the query among them), each
ReLU(BN3(Linear3_nobias(ReLU(BN2(PTLayer(ReLU(BN1(Linear1_nobias(x))))))) + x),
with the grouped vector attention
delta = Linear_p2(ReLU(BN_p(Linear_p1(p_j - p_i)))),
w = Linear_w2(ReLU(BN_w2(Linear_w1(ReLU(BN_w1(k_j - q_i + delta)))))) at C/8,
a = softmax over j, out[s * C/8 + c] = sum_j a[c] (v_j + delta)[s * C/8 + c].
The decoder: the last stage's ReLU(BN(Linear([x, ReLU(Linear(mean x))]))),
the others' ReLU(BN(Linear(x_skip))) + interp3(ReLU(BN(Linear(x_coarse)))),
each then one Bottleneck at the stage's kNN; the head Linear -> BN -> ReLU
-> Linear to 256 at every point, gathered at the seeds, the FPS's first
``num_seed``. Module and parameter names are the program's; every norm's
tensors lie under a ``.bn.`` segment."""

from __future__ import annotations

import torch
from torch import nn

from bench_port.reference import layers, ops
from bench_port.reference.layers import BatchNorm, Dense

SHARE_PLANES = 8
HEAD_FEATURES = 256

TINY_STAGES = [
    [256, 4, 16, 1],
    [64, 8, 16, 1],
    [32, 8, 32, 1],
    [16, 4, 32, 1],
    [8, 4, 64, 1],
]


class LinearBN(nn.Module):
    def __init__(self, in_features, features, *, bias, act=True):
        super().__init__()
        self.act = act
        self.dense = Dense(in_features, features, bias=bias)
        self.bn = BatchNorm(features)

    def forward(self, x):
        y = self.bn(self.dense(x))
        return torch.relu(y) if self.act else y


class Norm(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.bn = BatchNorm(features)

    def forward(self, x):
        return torch.relu(self.bn(x))


def share_planes_sum(values, weights):
    """values (B, N, k, C), weights (B, N, k, C/8) -> (B, N, C), weight c
    on the channels c, c + C/8, ..., c + 7C/8: a product, so its operands
    are TF32 in the control."""
    values, weights = layers._operands(values, weights)
    b, n, k, c = values.shape
    g = weights.shape[-1]
    return (values.view(b, n, k, c // g, g) * weights.unsqueeze(3)).sum(dim=2).reshape(b, n, c)


class PointTransformerLayer(nn.Module):
    def __init__(self, channels):
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

    def forward(self, rel, y, idx):
        q, k, v = self.q(y), self.k(y), self.v(y)
        delta = self.p2(self.p_norm(self.p1(rel)))
        r = ops.group_points(k, idx) - q.unsqueeze(2) + delta
        w = self.w2(self.w_norm2(self.w1(self.w_norm1(r))))
        return share_planes_sum(ops.group_points(v, idx) + delta, torch.softmax(w, dim=2))


class Bottleneck(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.lin1 = LinearBN(channels, channels, bias=False)
        self.attn = PointTransformerLayer(channels)
        self.norm2 = Norm(channels)
        self.lin3 = LinearBN(channels, channels, bias=False, act=False)

    def forward(self, rel, x, idx):
        y = self.norm2(self.attn(rel, self.lin1(x), idx))
        return torch.relu(self.lin3(y) + x)


class HeadUp(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.lin2 = Dense(channels, channels)
        self.lin1 = LinearBN(2 * channels, channels, bias=True)

    def forward(self, x):
        g = torch.relu(self.lin2(x.mean(dim=1, keepdim=True))).expand_as(x)
        return self.lin1(torch.cat([x, g], dim=-1))


class Up(nn.Module):
    def __init__(self, coarse_channels, channels):
        super().__init__()
        self.lin1 = LinearBN(channels, channels, bias=True)
        self.lin2 = LinearBN(coarse_channels, channels, bias=True)

    def forward(self, p, x, p_coarse, x_coarse):
        dist, idx = ops.knn(p_coarse, p, 3)
        return self.lin1(x) + ops.three_interpolate(self.lin2(x_coarse), idx, ops.inverse_distance_weights(dist))


class Backbone(nn.Module):
    SAMPLED = ("fps_inds",)

    def __init__(self, stages, num_seed):
        super().__init__()
        self.stages = [list(s) for s in stages]
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

    @property
    def fps_prefix(self) -> int:
        return self.stages[1][0]

    def sample(self, xyz):
        return {"fps_inds": ops.furthest_point_sample(xyz, self.fps_prefix)}

    def forward(self, xyz, sampled):
        fps = sampled["fps_inds"][:, : self.fps_prefix]
        ps, xs, rels, idxs = [], [], [], []
        for i, (npoint, k, _, blocks) in enumerate(self.stages, start=1):
            if i == 1:
                p, x = xyz, self.down1(xyz)
            else:
                p = ops.gather_points(xyz, fps[:, :npoint])
                _, gidx = ops.knn(ps[-1], p, k)
                g = torch.cat([ops.group_points(ps[-1], gidx) - p.unsqueeze(2), ops.group_points(xs[-1], gidx)],
                              dim=-1)
                x = getattr(self, f"down{i}")(g).amax(dim=2)
            _, idx = ops.knn(p, p, k)
            rel = ops.group_points(p, idx) - p.unsqueeze(2)
            for j in range(blocks):
                x = getattr(self, f"block{i}_{j}")(rel, x, idx)
            ps.append(p)
            xs.append(x)
            rels.append(rel)
            idxs.append(idx)
        last = len(self.stages)
        for i in range(last, 0, -1):
            up = getattr(self, f"up{i}")
            x = up(x) if i == last else up(ps[i - 1], xs[i - 1], ps[i], x)
            x = getattr(self, f"dec{i}")(rels[i - 1], x, idxs[i - 1])
        x = self.cls(self.head(x))
        seeds = fps[:, : self.num_seed]
        return {"input_xyz": xyz, "fps_inds": fps, "fp2_inds": seeds, "fp2_xyz": ops.gather_points(xyz, seeds),
                "fp2_features": ops.gather_points(x, seeds)}
