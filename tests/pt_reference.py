"""A plain PyTorch reference of the port's Point Transformer backbone
(``graspbalance_tpu_torch/models/pt_backbone.py``), for the CPU tests:
no kernel, nothing of the port or of JAX imported. It computes in the
dtype of its parameters and inputs: float32 (TF32 off), or float64 after
``.double()``, which sizes the tests' tolerances.

The equations (Zhao et al. ICCV 2021; Pointcept's PointTransformerSeg50):
stage 1 keeps every point, x = ReLU(BN(Linear_nobias(xyz))); stage i > 1
takes the first npoint indices of one FPS of the raw cloud and pools
max_j ReLU(BN(Linear_nobias([p_j - p'_i, x_j]))) over its k nearest
stage-(i-1) points; each Bottleneck is ReLU(BN3(Linear3(ReLU(BN2(
PTLayer(ReLU(BN1(Linear1(x))))))) + x), its grouped vector attention over
the stage's kNN (the query among its neighbours):
delta = Linear_p2(ReLU(BN_p(Linear_p1(p_j - p_i)))),
w = Linear_w2(ReLU(BN_w2(Linear_w1(ReLU(BN_w1(k_j - q_i + delta)))))),
a = softmax over j, out[s * C/8 + c] = sum_j a[c] (v_j + delta)[s * C/8 + c].
The decoder: the coarsest stage's ReLU(BN(Linear([x, ReLU(Linear(mean x))]))),
the others' ReLU(BN(Linear(x_skip))) + interp3(ReLU(BN(Linear(x_coarse)))),
each then one Bottleneck; the head Linear -> BN -> ReLU -> Linear(256).
The seeds are the FPS's first ``num_seed`` indices. Parameter names are the
port's, so that one state dict loads into both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SHARE_PLANES = 8
HEAD_FEATURES = 256


def fps(xyz, n: int):
    """Greedy FPS from index 0, never a point with |p|^2 <= 1e-3."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.where(x * x + y * y + z * z > 1e-3, 1e10, -1.0).to(xyz.dtype)
    last = torch.zeros((xyz.shape[0], 1), dtype=torch.int64)
    out = [last]
    for _ in range(1, n):
        dx, dy, dz = x - x.gather(1, last), y - y.gather(1, last), z - z.gather(1, last)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(dist, dim=1, keepdim=True)
        out.append(last)
    return torch.cat(out, dim=1).to(torch.int32)


def knn(ref, query, k: int):
    """(dist, idx) of the k nearest ``ref`` points of each query, nearest
    first, ties to the lower index."""
    q, r = query.unsqueeze(2), ref.unsqueeze(1)
    dx, dy, dz = q[..., 0] - r[..., 0], q[..., 1] - r[..., 1], q[..., 2] - r[..., 2]
    d2 = dx * dx + dy * dy + dz * dz
    vals, idxs = [], []
    for _ in range(k):
        v, i = torch.min(d2, dim=-1, keepdim=True)
        vals.append(v)
        idxs.append(i)
        d2 = d2.scatter(-1, i, float("inf"))
    return torch.sqrt(torch.clamp(torch.cat(vals, dim=-1), min=0.0)), torch.cat(idxs, dim=-1)


def gather(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b = points.shape[0]
    flat = idx.long().reshape(b, -1)
    out = torch.stack([points[i].index_select(0, flat[i]) for i in range(b)])
    return out.reshape(idx.shape + (points.shape[-1],))


class BatchNorm(nn.Module):
    """Over every axis but the last: batch statistics in train mode (the
    variance mean(x^2) - mean^2), the running ones in eval mode."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        mean, var = self.running_mean, self.running_var
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = (x * x).mean(dim=axes) - mean * mean
        return (x - mean) * (self.weight * (1.0 / torch.sqrt(var + self.eps))) + self.bias


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LinearBN(nn.Module):
    def __init__(self, i, o, *, bias, act=True):
        super().__init__()
        self.act = act
        self.dense = Linear(i, o, bias=bias)
        self.bn = BatchNorm(o)

    def forward(self, x):
        y = self.bn(self.dense(x))
        return torch.relu(y) if self.act else y


class Norm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.bn = BatchNorm(c)

    def forward(self, x):
        return torch.relu(self.bn(x))


class PTLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        g = c // SHARE_PLANES
        self.q, self.k, self.v = Linear(c, c), Linear(c, c), Linear(c, c)
        self.p1, self.p_norm, self.p2 = Linear(3, 3), Norm(3), Linear(3, c)
        self.w_norm1, self.w1, self.w_norm2, self.w2 = Norm(c), Linear(c, g), Norm(g), Linear(g, g)

    def forward(self, rel, y, idx):
        q, k, v = self.q(y), self.k(y), self.v(y)
        delta = self.p2(self.p_norm(self.p1(rel)))
        a = torch.softmax(self.w2(self.w_norm2(self.w1(self.w_norm1(gather(k, idx) - q.unsqueeze(2) + delta)))), dim=2)
        vals = gather(v, idx) + delta
        b, n, kk, c = vals.shape
        g = a.shape[-1]
        return (vals.view(b, n, kk, c // g, g) * a.unsqueeze(3)).sum(dim=2).reshape(b, n, c)


class Bottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.lin1 = LinearBN(c, c, bias=False)
        self.attn = PTLayer(c)
        self.norm2 = Norm(c)
        self.lin3 = LinearBN(c, c, bias=False, act=False)

    def forward(self, rel, x, idx):
        return torch.relu(self.lin3(self.norm2(self.attn(rel, self.lin1(x), idx))) + x)


class HeadUp(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.lin2 = Linear(c, c)
        self.lin1 = LinearBN(2 * c, c, bias=True)

    def forward(self, x):
        g = torch.relu(self.lin2(x.mean(dim=1, keepdim=True))).expand_as(x)
        return self.lin1(torch.cat([x, g], dim=-1))


class Up(nn.Module):
    def __init__(self, c_coarse, c):
        super().__init__()
        self.lin1 = LinearBN(c, c, bias=True)
        self.lin2 = LinearBN(c_coarse, c, bias=True)

    def forward(self, p, x, p_coarse, x_coarse):
        dist, idx = knn(p_coarse, p, 3)
        recip = 1.0 / (dist + 1e-8)
        w = recip / recip.sum(dim=-1, keepdim=True)
        return self.lin1(x) + (gather(self.lin2(x_coarse), idx) * w.unsqueeze(-1)).sum(dim=2)


class PTReference(nn.Module):
    """``stages``: rows (npoint, k, channels, blocks), the first keeping
    every point."""

    def __init__(self, stages, num_seed):
        super().__init__()
        self.stages = [tuple(s) for s in stages]
        self.num_seed = num_seed
        c_in = 3
        for i, (_, _, c, blocks) in enumerate(self.stages, start=1):
            self.add_module(f"down{i}", LinearBN(c_in if i == 1 else 3 + c_in, c, bias=False))
            for j in range(blocks):
                self.add_module(f"block{i}_{j}", Bottleneck(c))
            c_in = c
        w = [s[2] for s in self.stages]
        last = len(w)
        self.add_module(f"up{last}", HeadUp(w[-1]))
        for i in range(1, last):
            self.add_module(f"up{i}", Up(w[i], w[i - 1]))
        for i in range(1, last + 1):
            self.add_module(f"dec{i}", Bottleneck(w[i - 1]))
        self.head = LinearBN(w[0], w[0], bias=True)
        self.cls = Linear(w[0], HEAD_FEATURES)

    def forward(self, xyz, fps_inds=None, *, stage_knn=True):
        """End points of the port's keys; ``fps_inds`` default: the
        reference's own FPS. ``stage_knn=False`` searches each layer's
        neighbours anew instead of once a stage."""
        if fps_inds is None:
            fps_inds = fps(xyz, self.stages[1][0])
        ps, xs, idxs = [], [], []
        for i, (npoint, k, _, blocks) in enumerate(self.stages, start=1):
            if i == 1:
                p, x = xyz, self.down1(xyz)
            else:
                p = gather(xyz, fps_inds[:, :npoint])
                _, gi = knn(ps[-1], p, k)
                g = torch.cat([gather(ps[-1], gi) - p.unsqueeze(2), gather(xs[-1], gi)], dim=-1)
                x = getattr(self, f"down{i}")(g).amax(dim=2)
            shared = knn(p, p, k)[1] if stage_knn else None
            for j in range(blocks):
                idx = shared if stage_knn else knn(p, p, k)[1]
                x = getattr(self, f"block{i}_{j}")(gather(p, idx) - p.unsqueeze(2), x, idx)
            ps.append(p)
            xs.append(x)
            idxs.append(shared)
        last = len(self.stages)
        for i in range(last, 0, -1):
            x = getattr(self, f"up{i}")(x) if i == last else getattr(self, f"up{i}")(ps[i - 1], xs[i - 1], ps[i], x)
            p = ps[i - 1]
            idx = idxs[i - 1] if stage_knn else knn(p, p, self.stages[i - 1][1])[1]
            x = getattr(self, f"dec{i}")(gather(p, idx) - p.unsqueeze(2), x, idx)
        x = self.cls(self.head(x))
        seeds = fps_inds[:, : self.num_seed]
        return {"fps_inds": fps_inds, "fp2_inds": seeds, "fp2_xyz": gather(xyz, seeds), "fp2_features": gather(x, seeds)}
