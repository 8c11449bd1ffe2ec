"""The DSN (point-transformer instance segmentation) and the mean-shift
clustering of OBS, plain PyTorch, float32. Module and parameter names are
the program's."""

from __future__ import annotations

import torch
from torch import nn

from bench_port.reference import ops
from bench_port.reference.layers import Dense, MLPBlock, matmul


class VectorAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.q, self.k, self.v = Dense(c, c), Dense(c, c), Dense(c, c)
        self.pos1, self.pos2 = Dense(3, c), Dense(c, c)
        self.attn1, self.attn2 = Dense(c, c), Dense(c, c)

    def forward(self, xyz, feats, knn_idx):
        q = self.q(feats)
        kg = ops.group_points(self.k(feats), knn_idx)
        vg = ops.group_points(self.v(feats), knn_idx)
        rel = ops.group_points(xyz, knn_idx) - xyz.unsqueeze(2)
        pos = self.pos2(torch.relu(self.pos1(rel)))
        w = torch.softmax(self.attn2(torch.relu(self.attn1(q.unsqueeze(2) - kg + pos))), dim=2)
        return torch.sum(w * (vg + pos), dim=2)


class PTBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.ln1 = nn.LayerNorm(c, eps=1e-6)
        self.attn = VectorAttention(c)
        self.ln2 = nn.LayerNorm(c, eps=1e-6)
        self.mlp1 = Dense(c, 2 * c)
        self.mlp2 = Dense(2 * c, c)

    def forward(self, xyz, feats, knn_idx):
        feats = feats + self.attn(xyz, self.ln1(feats), knn_idx)
        return feats + self.mlp2(torch.relu(self.mlp1(self.ln2(feats))))


class PointTransformerSeg(nn.Module):
    """embed -> per stage (npoint, radius, nsample, channels, blocks): the
    first npoint of the FPS order, ball-group pooling, k-NN (k = 16)
    vector-attention blocks -> proj to 256 at the seed level."""

    def __init__(self, stages, out_channels=256, knn=16):
        super().__init__()
        self.stages = [list(s) for s in stages]
        self.knn = knn
        c = self.stages[0][3]
        self.embed = MLPBlock(3, c)
        for i, (_, _, _, channels, n_blocks) in enumerate(self.stages):
            self.add_module(f"down{i}", MLPBlock(3 + c, channels))
            c = channels
            for j in range(n_blocks):
                self.add_module(f"block{i}_{j}", PTBlock(channels))
        self.proj = Dense(c, out_channels)

    def forward(self, xyz, sa_inds):
        feats = self.embed(xyz)
        for i, (npoint, radius, nsample, _, n_blocks) in enumerate(self.stages):
            inds = sa_inds if i == 0 else torch.arange(npoint, device=xyz.device).expand(xyz.shape[0], npoint)
            new_xyz = ops.gather_points(xyz, inds)
            idx = ops.ball_query(xyz, new_xyz, radius, nsample)
            grouped = torch.cat([(ops.group_points(xyz, idx) - new_xyz.unsqueeze(2)) / radius,
                                 ops.group_points(feats, idx)], dim=-1)
            feats = getattr(self, f"down{i}")(grouped).amax(dim=2)
            xyz = new_xyz
            if n_blocks > 0:
                _, knn_idx = ops.knn(xyz, xyz, self.knn)
            for j in range(n_blocks):
                feats = getattr(self, f"block{i}_{j}")(xyz, feats, knn_idx)
        return xyz, self.proj(feats)


class DSN(nn.Module):
    def __init__(self, pt_stages):
        super().__init__()
        self.pt_stages = [list(s) for s in pt_stages]
        self.backbone = PointTransformerSeg(self.pt_stages)
        self.fg1 = MLPBlock(256, 256)
        self.fg2 = Dense(256, 2)
        self.off1 = MLPBlock(256, 256)
        self.off2 = Dense(256, 3)

    @torch.no_grad()
    def forward(self, xyz, sa_inds):
        """(foreground logits (B, N, 2), center offsets (B, N, 3)), upsampled
        from the seeds to every point."""
        seed_xyz, feats = self.backbone(xyz, sa_inds)
        both = ops.interpolate_features(xyz, seed_xyz, torch.cat([self.fg2(self.fg1(feats)),
                                                                  self.off2(self.off1(feats))], dim=-1))
        return both[..., :2], both[..., 2:]


def _norm3(d):
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def mean_shift(points, fg_mask, gumbel, *, num_seeds=50, max_iters=10, epsilon=0.05, sigma=0.02,
               subsample_factor=5, min_cluster_size=10):
    """Gaussian mean shift over the foreground of ``points`` (B, N, 3) (the
    predicted centers), seeds drawn distance-proportionally with the Gumbel
    noise ``gumbel`` (B, 1 + num_seeds, m), m = points seen
    (every ``subsample_factor``-th): labels (B, N) int32, 0 = background,
    1..K the components of at least ``min_cluster_size`` foreground points,
    in seed order."""
    b, n, _ = points.shape
    s = num_seeds
    x = points[:, ::subsample_factor]
    xm = fg_mask[:, ::subsample_factor]
    m = x.shape[1]
    if gumbel.shape != (b, 1 + s, m):
        raise ValueError(f"gumbel must be {(b, 1 + s, m)}, got {tuple(gumbel.shape)}")
    dev = points.device
    w = torch.where(xm, 1.0, 0.0)
    i = torch.argmax(gumbel[:, 0] + torch.log(w + 1e-20), dim=1)
    min_d = torch.full((b, m), 1e9, device=dev)
    seed_idx = []
    for t in range(s):
        seed_idx.append(i)
        xi = x.gather(1, i.view(b, 1, 1).expand(b, 1, 3))
        min_d = torch.minimum(min_d, _norm3(x - xi))
        w = torch.where(xm, min_d, 0.0)
        i = torch.argmax(gumbel[:, 1 + t] + torch.log(w + 1e-20), dim=1)
    seed_idx = torch.stack(seed_idx, dim=1)
    z = x.gather(1, seed_idx.unsqueeze(-1).expand(b, s, 3))
    inv2s2 = 0.5 / (sigma * sigma)
    xmf = xm.to(points.dtype).unsqueeze(1)
    for _ in range(max_iters):
        d = z.unsqueeze(2) - x.unsqueeze(1)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        wk = torch.exp(-inv2s2 * d2) * xmf
        z = matmul(wk / torch.clamp(wk.sum(dim=2, keepdim=True), min=1e-20), x)
    reach = (_norm3(z.unsqueeze(2) - z.unsqueeze(1)) <= epsilon).to(torch.float32)
    hops = 1
    while hops < s:
        reach = ((reach @ reach) > 0).to(torch.float32)  # 0/1 counts below 2^11: exact in any precision
        hops *= 2
    comp = torch.argmax(reach, dim=2)
    nearest = torch.argmin(_norm3(points.unsqueeze(2) - z.unsqueeze(1)), dim=2)
    point_comp = comp.gather(1, nearest)
    sizes = torch.zeros((b, s), dtype=torch.int64, device=dev).scatter_add_(1, point_comp, fg_mask.to(torch.int64))
    keep = (comp == torch.arange(s, device=dev)) & (sizes >= min_cluster_size)
    label_of_comp = torch.where(keep, torch.cumsum(keep.to(torch.int32), dim=1), 0)
    return torch.where(fg_mask, label_of_comp.gather(1, point_comp), 0).to(torch.int32)


def cluster(xyz, offsets, fg_logits, gumbel):
    """Instance labels from the DSN's outputs: mean shift over xyz + offsets
    of the points whose foreground logit is the larger."""
    return mean_shift(xyz + offsets, torch.argmax(fg_logits, dim=-1) == 1, gumbel)
