"""Ball query and cylinder queries, first-k-by-index
(port of graspbalance_tpu/ops/query.py, ``order='index'``).

The reference kernels scan points in index order and keep the first
``nsample`` hits; slots past the hit count hold the first hit's index, and a
center with no hit keeps index 0 everywhere.

Both queries build (centers, N) hit planes, so they run over chunks of
centers: at (4, 1024, 20000) x 16 combos a dense mask with its int cumsum
would be several GB.

``multi_cylinder_query(impl="select")`` is the JAX package's
``impl='pallas_select'``: every point's combo membership is compressed into
one class plane (``class_plane``), and the selection kernel
(ops/select.py) takes the first k hits of every combo from it.
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


NEVER_HIT = 63  # the class of a point that no combo takes (rc = hc = 7)


def check_ascending(radii: Sequence[float], hmaxs: Sequence[float]) -> None:
    """The class encoding holds at most 7 radii and 7 depths, and its decode
    (rc <= ri and hc <= hi) equals the per-combo test only for ascending
    thresholds."""
    if len(radii) > 7 or len(hmaxs) > 7:
        raise ValueError("class encoding supports at most 7 radii/hmaxs")
    if list(radii) != sorted(radii) or list(hmaxs) != sorted(hmaxs):
        raise ValueError(
            "the class-plane query requires ascending radii and hmaxs "
            f"(got radii={radii}, hmaxs={hmaxs}); sort them and remap the output combo axes"
        )


def class_plane(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radii: Sequence[float],
    hmin: float,
    hmaxs: Sequence[float],
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """(B, M, N) uint8: rc * 8 + hc for every (center, point), with
    rc = #{radii r: y'^2 + z'^2 >= r^2} and hc = #{hmaxs h: x' >= h}, or
    NEVER_HIT where x' <= hmin. The point hits combo (ri, hi) iff
    rc <= ri and hc <= hi, every comparison against the same float32
    thresholds as ``multi_cylinder_query``. Built over chunks of centers."""
    check_ascending(radii, hmaxs)
    r2, hmin32, hm = cylinder_thresholds(radii, hmin, hmaxs)
    n_h = len(hmaxs)
    planes = []
    for lo in range(0, centers.shape[1], chunk):
        xr, yr, zr = rot_planes(xyz, centers[:, lo : lo + chunk], rot[:, lo : lo + chunk])
        d2 = yr * yr + zr * zr
        rc = sum((d2 >= r2[ri * n_h]).to(torch.uint8) for ri in range(len(radii)))
        hc = sum((xr >= hm[hi]).to(torch.uint8) for hi in range(n_h))
        planes.append(torch.where(xr > hmin32, rc * 8 + hc, NEVER_HIT).to(torch.uint8))
    return torch.cat(planes, dim=1)


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
    impl: str = "default",
) -> torch.Tensor:
    """All (radius, hmax) cylinder queries, the rotated coordinates computed
    once per chunk of centers. A point hits combo (r, h) iff
    y'^2 + z'^2 < r^2 and hmin < x' < hmax[h].

    impl: 'default' (per-combo hit masks, plain PyTorch) | 'select' (the
    class plane, then the selection kernel of ops/select.py, which runs its
    plain version on CPU tensors); both give the same indices.

    Returns (B, len(radii), len(hmaxs), M, nsample) int32."""
    if impl == "select":
        # imported here: ops/select.py takes first_k_by_index from this module
        from graspbalance_tpu_torch.ops.select import multicyl_select

        b, m = centers.shape[:2]
        cls = class_plane(xyz, centers, rot, radii, hmin, hmaxs, chunk=chunk)
        out = multicyl_select(cls.reshape(b * m, -1), len(radii), len(hmaxs), nsample)
        return out.reshape(b, m, len(radii), len(hmaxs), nsample).permute(0, 2, 3, 1, 4).contiguous()
    if impl != "default":
        raise ValueError(f"impl must be 'default' or 'select', got {impl!r}")
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
