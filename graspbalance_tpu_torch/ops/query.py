"""Ball query and cylinder queries (port of graspbalance_tpu/ops/query.py).

``order='index'`` (the default, the reference's): the reference kernels scan
points in index order and keep the first ``nsample`` hits; slots past the
hit count hold the first hit's index, and a center with no hit keeps index 0
everywhere. ``order='nearest'``: the ``nsample`` hits of least squared
distance (the cylinder's radial y'^2 + z'^2), nearest first, ties to the
lower index (as ``lax.top_k`` keeps them); slots past the hit count hold
the nearest hit, and a center with no hit gets index 0. The JAX package's
``'nearest_approx'`` (the TPU's approximate top-k unit) is not ported.

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


ORDERS = ("index", "nearest")


def f32_square(radius: float) -> float:
    """radius^2 as the JAX queries that take the radius as an argument form
    it: the float32 radius times itself, in float32."""
    r = torch.tensor(radius, dtype=torch.float32)
    return float(r * r)


_INF_BITS = 0x7F800000  # float32 +inf: the key of a point that is no hit


def nearest_k(hit: torch.Tensor, d2: torch.Tensor, nsample: int) -> torch.Tensor:
    """(..., N) bool hits and their (..., N) float32 squared distances ->
    (..., nsample) int32: the hits of least d2, nearest first, ties to the
    lower index; slots past the hit count hold the nearest hit, 0 when there
    is none. The selection is a top-k of unique int64 keys (d2's bits, which
    order as d2 does for d2 >= 0, above the index), so it does not depend on
    how the device's top-k orders ties."""
    n = hit.shape[-1]
    bits = torch.where(hit, d2.float(), float("inf")).view(torch.int32).to(torch.int64)
    pos = torch.arange(n, device=hit.device, dtype=torch.int64)
    keys = torch.topk((bits << 32) | pos, nsample, dim=-1, largest=False, sorted=True).values
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    is_hit = (keys >> 32) < _INF_BITS
    first = torch.where(is_hit[..., :1], idx[..., :1], 0)
    return torch.where(is_hit, idx, first)


def select_k(hit: torch.Tensor, d2: torch.Tensor, nsample: int, order: str) -> torch.Tensor:
    """The query's selection: ``first_k_by_index`` or ``nearest_k``."""
    if order == "index":
        return first_k_by_index(hit, nsample)
    if order == "nearest":
        return nearest_k(hit, d2, nsample)
    raise ValueError(f"query order must be one of {ORDERS}, got {order!r}")


def ball_query(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    radius: float,
    nsample: int,
    *,
    valid: torch.Tensor | None = None,
    order: str = "index",
    chunk: int = 512,
) -> torch.Tensor:
    """xyz (B, N, 3), centers (B, M, 3) -> (B, M, nsample) int32 indices of
    points with |p - c|^2 < radius^2, selected by ``order``; ``valid``
    (B, N) bool, optional: an invalid point is never a hit."""
    if order not in ORDERS:
        raise ValueError(f"query order must be one of {ORDERS}, got {order!r}")
    r2 = f32_square(radius)
    px, py, pz = (xyz[..., i].unsqueeze(1) for i in range(3))  # (B, 1, N)
    vld = None if valid is None else valid.unsqueeze(1)
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        c = centers[:, lo : lo + chunk]
        dx = c[..., 0:1] - px
        dy = c[..., 1:2] - py
        dz = c[..., 2:3] - pz
        d2 = dx * dx + dy * dy + dz * dz
        hit = d2 < r2 if vld is None else (d2 < r2) & vld
        outs.append(select_k(hit, d2, nsample, order))
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


def cylinder_query(
    xyz: torch.Tensor,
    centers: torch.Tensor,
    rot: torch.Tensor,
    radius: float,
    hmin: float,
    hmax: float,
    nsample: int,
    *,
    valid: torch.Tensor | None = None,
    order: str = "index",
    chunk: int = 256,
) -> torch.Tensor:
    """One gripper-aligned cylinder: xyz (B, N, 3), centers (B, M, 3), rot
    (B, M, 3, 3) -> (B, M, nsample) int32. With p' = R^T (p - c), a point
    hits iff y'^2 + z'^2 < radius^2 and hmin < x' < hmax (and ``valid``,
    when given); ``order`` as for ``ball_query`` (nearest: least
    y'^2 + z'^2)."""
    if order not in ORDERS:
        raise ValueError(f"query order must be one of {ORDERS}, got {order!r}")
    _, hmin32, (hm,) = cylinder_thresholds((radius,), hmin, (hmax,))
    r2 = f32_square(radius)
    vld = None if valid is None else valid.unsqueeze(1)
    outs = []
    for lo in range(0, centers.shape[1], chunk):
        xr, yr, zr = rot_planes(xyz, centers[:, lo : lo + chunk], rot[:, lo : lo + chunk])
        d2 = yr * yr + zr * zr
        hit = (d2 < r2) & (xr > hmin32) & (xr < hm)
        if vld is not None:
            hit = hit & vld
        outs.append(select_k(hit, d2, nsample, order))
    return torch.cat(outs, dim=1)


def cylinder_thresholds(radii: Sequence[float], hmin: float, hmaxs: Sequence[float]):
    """Per-combo (radius^2, hmax) and hmin as float32 values, radius-major.
    radius^2 is formed in float64 and rounded once, as the JAX package does."""
    r2 = [float(torch.tensor(r * r, dtype=torch.float32)) for r in radii for _ in hmaxs]
    hm = [float(torch.tensor(h, dtype=torch.float32)) for _ in radii for h in hmaxs]
    return r2, float(torch.tensor(hmin, dtype=torch.float32)), hm


NEVER_HIT = 63  # the class of a point that no combo takes (rc = hc = 7)


def check_ascending(radii: Sequence[float], hmaxs: Sequence[float]) -> None:
    """What the JAX package's index-order multi-cylinder query takes: at most
    7 radii and 7 depths (its class encoding), in ascending order (the
    encoding's decode, rc <= ri and hc <= hi, equals the per-combo test only
    then)."""
    if len(radii) > 7 or len(hmaxs) > 7:
        raise ValueError("class encoding supports at most 7 radii/hmaxs")
    if list(radii) != sorted(radii) or list(hmaxs) != sorted(hmaxs):
        raise ValueError(
            "the index-order multi-cylinder query requires ascending radii and hmaxs "
            f"(got radii={radii}, hmaxs={hmaxs}); sort them and remap the output combo axes, "
            "or use order='nearest'"
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
    order: str = "index",
    chunk: int = 256,
    impl: str = "default",
) -> torch.Tensor:
    """All (radius, hmax) cylinder queries, the rotated coordinates computed
    once per chunk of centers. A point hits combo (r, h) iff
    y'^2 + z'^2 < r^2 and hmin < x' < hmax[h].

    order: 'index' (ascending radii and hmaxs only, as in the JAX package)
    or 'nearest' (any order of the thresholds; see the module docstring).
    impl: 'default' (per-combo hit masks, plain PyTorch) | 'select' (the
    class plane, then the selection kernel of ops/select.py, which runs its
    plain version on CPU tensors; index order only); both give the same
    indices.

    Returns (B, len(radii), len(hmaxs), M, nsample) int32."""
    if order not in ORDERS:
        raise ValueError(f"query order must be one of {ORDERS}, got {order!r}")
    if order == "index":
        check_ascending(radii, hmaxs)
    elif impl != "default":
        raise ValueError("impl='select' takes order='index' only")
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
            select_k(inside & (d2 < r2[c]) & (xr < hm[c]), d2, nsample, order)
            for c in range(n_r * n_h)
        ]
        outs.append(torch.stack(combos, dim=1))  # (B, RH, C, k)
    b, m = centers.shape[:2]
    return torch.cat(outs, dim=2).reshape(b, n_r, n_h, m, nsample)
