"""Ball query and cylinder queries, first-k-by-index
(port of graspbalance_tpu/ops/query.py, ``order='index'``).

The reference kernels scan points in index order and keep the first
``nsample`` hits; slots past the hit count hold the first hit's index, and a
center with no hit keeps index 0 everywhere.

Both queries build (centers, N) hit planes, so they run over chunks of
centers: at (4, 1024, 20000) x 16 combos a dense mask with its int cumsum
would be several GB.
"""

from __future__ import annotations

from typing import Sequence

import torch


def first_k_by_index(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """(..., N) bool -> (..., nsample) int32: indices of the first nsample
    hits in index order, padded with the first hit (0 when there is none)."""
    n = hit.shape[-1]
    rank = torch.cumsum(hit, dim=-1, dtype=torch.int32)  # inclusive hit count
    count = rank[..., -1:]
    # each kept hit owns slot rank-1; every other point goes to a spill slot
    slot = torch.where(hit & (rank <= nsample), rank - 1, nsample).to(torch.int64)
    pos = torch.arange(n, device=hit.device, dtype=torch.int32).expand(hit.shape)
    out = torch.zeros(hit.shape[:-1] + (nsample + 1,), dtype=torch.int32, device=hit.device)
    out.scatter_(-1, slot, pos)
    out = out[..., :nsample]
    js = torch.arange(nsample, device=hit.device, dtype=torch.int32)
    return torch.where(js < count, out, out[..., :1])  # out[..., 0] is 0 when count == 0


def ball_query(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    chunk: int = 512,
) -> torch.Tensor:
    """xyz (B, N, 3), centers (B, M, 3) -> (B, M, nsample) int32 indices of
    the first nsample points with |p - c|^2 < radius^2."""
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=xyz.device)
    px, py, pz = (xyz[..., i].unsqueeze(1) for i in range(3))  # (B, 1, N)
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        c = centers[:, lo : lo + chunk]
        dx = c[..., 0:1] - px
        dy = c[..., 1:2] - py
        dz = c[..., 2:3] - pz
        outs.append(first_k_by_index(dx * dx + dy * dy + dz * dz < r2, nsample))
    return torch.cat(outs, dim=1)


def rot_planes(xyz: torch.Tensor, centers: torch.Tensor, rot: torch.Tensor):
    """Gripper-frame coordinates of every point for every center:
    xyz (B, N, 3), centers (B, C, 3), rot (B, C, 3, 3) -> xr, yr, zr, each
    (B, C, N), with p' = R^T (p - c), in the op order of the JAX package's
    ``_rot_planes`` (every product and sum rounded on its own)."""
    px, py, pz = (xyz[..., i].unsqueeze(1) for i in range(3))  # (B, 1, N)
    dx = px - centers[..., 0:1]
    dy = py - centers[..., 1:2]
    dz = pz - centers[..., 2:3]

    def axis(i):
        return dx * rot[..., 0, i : i + 1] + dy * rot[..., 1, i : i + 1] + dz * rot[..., 2, i : i + 1]

    return axis(0), axis(1), axis(2)


def cylinder_thresholds(radii: Sequence[float], hmin: float, hmaxs: Sequence[float]):
    """Per-combo (radius^2, hmax) and hmin as float32 values, radius-major.
    radius^2 is formed in float64 and rounded once, as the JAX package does."""
    r2 = [float(torch.tensor(r * r, dtype=torch.float32)) for r in radii for _ in hmaxs]
    hm = [float(torch.tensor(h, dtype=torch.float32)) for _ in radii for h in hmaxs]
    return r2, float(torch.tensor(hmin, dtype=torch.float32)), hm


def multi_cylinder_query(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radii: Sequence[float],
    hmin: float,
    hmaxs: Sequence[float],
    nsample: int,
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """All (radius, hmax) cylinder queries, the rotated coordinates computed
    once per chunk of centers. A point hits combo (r, h) iff
    y'^2 + z'^2 < r^2 and hmin < x' < hmax[h].

    Returns (B, len(radii), len(hmaxs), M, nsample) int32."""
    r2, hmin32, hm = cylinder_thresholds(radii, hmin, hmaxs)
    n_r, n_h = len(radii), len(hmaxs)
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        xr, yr, zr = rot_planes(xyz, centers[:, lo : lo + chunk], rot[:, lo : lo + chunk])
        d2 = yr * yr + zr * zr
        inside = xr > hmin32
        combos = [
            first_k_by_index(inside & (d2 < r2[c]) & (xr < hm[c]), nsample)
            for c in range(n_r * n_h)
        ]
        outs.append(torch.stack(combos, dim=1))  # (B, RH, C, k)
    b, m = centers.shape[:2]
    return torch.cat(outs, dim=2).reshape(b, n_r, n_h, m, nsample)
