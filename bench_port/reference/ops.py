"""Point-cloud operations of the plain reference, in plain PyTorch: furthest
point sampling (and its masked form), gathers, the ball and cylinder
queries in index order, nearest neighbours, three-point interpolation, the
width MLPs, and the grasp view geometry.

Their semantics are the program's (first-k-by-index selection with the
reference padding, ties to the lower index, FPS never picking near-origin
points); every distance is written in one fixed order of operations, so
that two devices and two implementations that keep it agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference.layers import einsum, matmul

INIT_DIST = 1e10
ORIGIN_EPS = 1e-3


# ----------------------------------------------------------------- sampling
def _greedy(xyz, dist, seed, num_samples):
    """Greedy max-min selection from running distances ``dist`` (B, N)."""
    b = xyz.shape[0]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=xyz.device)
    out[:, 0] = seed[:, 0].to(torch.int32)
    last = seed
    for j in range(1, num_samples):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(dist, dim=1, keepdim=True)
        out[:, j] = last[:, 0].to(torch.int32)
    return out


def furthest_point_sample(xyz, num_samples: int):
    """(B, N, 3) -> (B, num_samples) int32: index 0 first, then the point
    furthest from those chosen; near-origin points (|p|^2 <= 1e-3) never."""
    xyz = xyz.float()
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.where(x * x + y * y + z * z > ORIGIN_EPS, INIT_DIST, -1.0).float()
    seed = torch.zeros((xyz.shape[0], 1), dtype=torch.int64, device=xyz.device)
    return _greedy(xyz, dist, seed, num_samples)


def furthest_point_sample_masked(xyz, valid, num_samples: int):
    """FPS within each row's valid points, seeded at the first valid one."""
    seed = torch.argmax(valid.to(torch.int32), dim=1, keepdim=True)
    dist = torch.where(valid, INIT_DIST, -1.0).float()
    return _greedy(xyz.float(), dist, seed, num_samples)


# ------------------------------------------------------------------ gathers
def gather_points(points, idx):
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    b, n, c = points.shape
    offs = (torch.arange(b, device=idx.device, dtype=torch.int64) * n).reshape((b,) + (1,) * (idx.ndim - 1))
    rows = (idx.to(torch.int64) + offs).reshape(-1)
    return points.reshape(b * n, c).index_select(0, rows).reshape(idx.shape + (c,))


group_points = gather_points


# ------------------------------------------------------------------ queries
def first_k_by_index(hit, nsample: int):
    """(..., N) bool -> (..., nsample) int32: the first nsample hits in index
    order, padded with the first hit (0 when there is none)."""
    n = hit.shape[-1]
    rank = torch.cumsum(hit, dim=-1, dtype=torch.int32)
    count = rank[..., -1:]
    slot = torch.where(hit & (rank <= nsample), rank - 1, nsample).to(torch.int64)
    pos = torch.arange(n, device=hit.device, dtype=torch.int32).expand(hit.shape)
    out = torch.zeros(hit.shape[:-1] + (nsample + 1,), dtype=torch.int32, device=hit.device)
    out.scatter_(-1, slot, pos)
    out = out[..., :nsample]
    js = torch.arange(nsample, device=hit.device, dtype=torch.int32)
    return torch.where(js < count, out, out[..., :1])


def f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


def ball_query(xyz, centers, radius: float, nsample: int, *, chunk: int = 512):
    """Points with |p - c|^2 < radius^2 (the float32 radius squared in
    float32), first nsample by index: (B, M, nsample) int32."""
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = float(r * r)
    px, py, pz = (xyz[..., i].unsqueeze(1) for i in range(3))
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        c = centers[:, lo: lo + chunk]
        dx = c[..., 0:1] - px
        dy = c[..., 1:2] - py
        dz = c[..., 2:3] - pz
        outs.append(first_k_by_index(dx * dx + dy * dy + dz * dz < r2, nsample))
    return torch.cat(outs, dim=1)


def rot_planes(xyz, centers, rot):
    """p' = R^T (p - c) for every center and point: three (B, C, N) planes."""
    px, py, pz = (xyz[..., i].unsqueeze(1) for i in range(3))
    dx = px - centers[..., 0:1]
    dy = py - centers[..., 1:2]
    dz = pz - centers[..., 2:3]

    def axis(i):
        return dx * rot[..., 0, i: i + 1] + dy * rot[..., 1, i: i + 1] + dz * rot[..., 2, i: i + 1]

    return axis(0), axis(1), axis(2)


def multi_cylinder_query(xyz, centers, rot, radii, hmin: float, hmaxs, nsample: int, *, chunk: int = 256):
    """Every (radius, depth) gripper cylinder: a point hits (r, h) iff
    y'^2 + z'^2 < r^2 and hmin < x' < h (r^2 formed in float64, rounded
    once). Returns (B, R, H, M, nsample) int32, first nsample by index."""
    r2 = [f32(r * r) for r in radii for _ in hmaxs]
    hm = [f32(h) for _ in radii for h in hmaxs]
    hmin32 = f32(hmin)
    n_r, n_h = len(radii), len(hmaxs)
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        xr, yr, zr = rot_planes(xyz, centers[:, lo: lo + chunk], rot[:, lo: lo + chunk])
        d2 = yr * yr + zr * zr
        inside = xr > hmin32
        combos = [first_k_by_index(inside & (d2 < r2[c]) & (xr < hm[c]), nsample) for c in range(n_r * n_h)]
        outs.append(torch.stack(combos, dim=1))
    b, m = centers.shape[:2]
    return torch.cat(outs, dim=2).reshape(b, n_r, n_h, m, nsample)


# --------------------------------------------------------------- neighbours
def _pairwise_d2(query, ref):
    q = query.unsqueeze(2)
    r = ref.unsqueeze(1)
    dx = q[..., 0] - r[..., 0]
    dy = q[..., 1] - r[..., 1]
    dz = q[..., 2] - r[..., 2]
    return dx * dx + dy * dy + dz * dz


def _argmin_passes(d2, k: int):
    idxs, vals = [], []
    cur = d2
    for _ in range(k):
        val, i = torch.min(cur, dim=-1, keepdim=True)
        idxs.append(i)
        vals.append(val)
        cur = cur.scatter(-1, i, float("inf"))
    dist = torch.sqrt(torch.clamp(torch.cat(vals, dim=-1), min=0.0))
    return dist, torch.cat(idxs, dim=-1).to(torch.int32)


def knn(ref, query, k: int, *, chunk: int = 1024):
    """k nearest ``ref`` points of every query: (dist, idx int32), nearest
    first, ties to the lower index."""
    outs = [_argmin_passes(_pairwise_d2(query[:, lo: lo + chunk], ref), k)
            for lo in range(0, query.shape[1], chunk)]
    return torch.cat([o[0] for o in outs], dim=1), torch.cat([o[1] for o in outs], dim=1)


def inverse_distance_weights(dist, eps: float = 1e-8):
    recip = 1.0 / (dist + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def three_interpolate(feats, idx, weight):
    return torch.sum(group_points(feats, idx) * weight.unsqueeze(-1), dim=2)


def interpolate_features(unknown, known, known_feats):
    dist, idx = knn(known, unknown, 3, chunk=4096)
    return three_interpolate(known_feats, idx, inverse_distance_weights(dist))


# ------------------------------------------------------------- width MLPs
def width_mlps(grouped, centers, rot, weights, *, seed_chunk: int = 128):
    """Each scale's BN-folded MLP on the gripper-frame neighbour coordinates,
    then the max over K: grouped (B, S, R, H, K, 3) raw coordinates, the
    rotation and center folded into layer 0 per seed,
    ``((p - c) @ rot) @ W0 + b0 == p @ (rot @ W0) + (b0 - c @ (rot @ W0))``.
    Returns (B, S, H, R * C_last)."""
    w0_cat = torch.cat([w[0][0] for w in weights], dim=1)
    b0_cat = torch.cat([w[0][1] for w in weights])
    w0_eff = (rot.unsqueeze(-1) * w0_cat).sum(dim=-2)  # (B, S, 3, R*C1)
    b0_eff = b0_cat - (centers.unsqueeze(-1) * w0_eff).sum(dim=-2)
    c1 = weights[0][0][0].shape[1]
    outs = []
    for lo in range(0, grouped.shape[1], seed_chunk):
        hi = lo + seed_chunk
        per_scale = []
        for ri, layers in enumerate(weights):
            w0 = w0_eff[:, lo:hi, :, ri * c1:(ri + 1) * c1]
            b0 = b0_eff[:, lo:hi, ri * c1:(ri + 1) * c1]
            x = torch.relu(einsum("bshkj,bsjc->bshkc", grouped[:, lo:hi, ri], w0) + b0[:, :, None, None, :])
            for w, bias in layers[1:]:
                x = torch.relu(matmul(x, w) + bias)
            per_scale.append(x.amax(dim=3))
        outs.append(torch.cat(per_scale, dim=-1))
    return torch.cat(outs, dim=1)


# ----------------------------------------------------------------- geometry
GRASP_MAX_WIDTH = 0.1
GRASP_MAX_TOLERANCE = 0.05


def grasp_views(n: int, device=None):
    """Fibonacci-sphere view directions (n, 3), in float64 rounded once."""
    phi = (np.sqrt(5.0) - 1.0) / 2.0
    i = np.arange(n, dtype=np.float64)
    zi = (2.0 * i + 1.0) / n - 1.0
    r = np.sqrt(1.0 - zi * zi)
    v = np.stack([r * np.cos(2.0 * np.pi * i * phi), r * np.sin(2.0 * np.pi * i * phi), zi], axis=-1)
    return torch.from_numpy(v.astype(np.float32)).to(device)


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]).unsqueeze(-1)


def viewpoint_to_matrix(towards, angle):
    """Approach direction (..., 3) and in-plane angle (...) -> (..., 3, 3)."""
    ax = towards
    zeros = torch.zeros_like(ax[..., 0])
    ay = torch.stack([-ax[..., 1], ax[..., 0], zeros], dim=-1)
    fallback = torch.tensor([0.0, 1.0, 0.0], dtype=ax.dtype, device=ax.device)
    ay = torch.where(_norm3(ay) == 0, fallback, ay)
    ax = ax / _norm3(ax)
    ay = ay / _norm3(ay)
    az = torch.stack([ax[..., 1] * ay[..., 2] - ax[..., 2] * ay[..., 1],
                      ax[..., 2] * ay[..., 0] - ax[..., 0] * ay[..., 2],
                      ax[..., 0] * ay[..., 1] - ax[..., 1] * ay[..., 0]], dim=-1)
    sin, cos = torch.sin(angle), torch.cos(angle)
    ones = torch.ones_like(cos)
    r1 = torch.stack([ones, zeros, zeros, zeros, cos, -sin, zeros, sin, cos], dim=-1).reshape(angle.shape + (3, 3))
    r2 = torch.stack([ax, ay, az], dim=-1)
    return (r2.unsqueeze(-1) * r1.unsqueeze(-3)).sum(dim=-2)
