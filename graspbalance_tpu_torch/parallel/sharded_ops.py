"""Point-axis-sharded sampling and query (port of
graspbalance_tpu/parallel/sharded_ops.py).

For clouds too large for one card the point axis is split over the mesh's
'point' ranks: point rank p holds points [p n, (p + 1) n) of each cloud
(n = N / S, ``local_points``). Both ops are exact: they give, on every
point rank, what the one-process op gives on the whole cloud.

  - ``sharded_fps``: each rank keeps the running distances of its own
    points. A step updates them, takes the local winner, and exchanges one
    (key, x, y, z) row per rank: the key packs the winner's distance (its
    float bits, ordered as the floats) above its negated global index, so
    the largest key is the farthest point with ties to the lowest index,
    and the coordinates travel as their bits. One collective a step (the
    JAX function makes three: pmax, pmin, psum).
  - ``sharded_ball_query``: each rank takes the first k hits among its own
    points (or the k nearest, ``order='nearest'``), the candidates of every
    rank are gathered, and a sort of their global indices (of their
    (distance, index) keys) keeps the first k. The global first k hits are
    among the union of the ranks' first k.

The local steps are plain PyTorch, as the JAX functions are plain jnp.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.ops.fps import INIT_DIST, initial_distances
from graspbalance_tpu_torch.ops.query import _INF_BITS, ORDERS, f32_square, first_k_by_index
from graspbalance_tpu_torch.parallel.mesh import axis_group, axis_rank, axis_size, gather_slots

_BIG = 0x3FFFFFFF  # an empty candidate slot's index, above every point's
_LOW = 0xFFFFFFFF
QUERY_CHUNK = 512  # centers a ball-query pass holds, bounding its (chunk, n) distances


def local_points(xyz: torch.Tensor, mesh) -> torch.Tensor:
    """This point rank's share of the point axis of (B, N, ...) clouds."""
    s, n = axis_size(mesh, "point"), xyz.shape[1]
    if n % s:
        raise ValueError(f"{n} points do not split over {s} point ranks")
    p = axis_rank(mesh, "point")
    return xyz[:, p * n // s:(p + 1) * n // s]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its bits as int64 (sign-extended from int32)."""
    return x.contiguous().view(torch.int32).to(torch.int64)


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in the floats' order, negative floats too."""
    b = _bits(x)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def sharded_fps(mesh, xyz_local: torch.Tensor, num_samples: int, *, skip_origin: bool = True) -> torch.Tensor:
    """Furthest point sampling of the clouds whose points are split over
    the 'point' ranks: ``xyz_local`` (B, n, 3) this rank's points
    (``local_points``) -> (B, num_samples) int32 global indices, the same on
    every point rank and bit-equal to ``ops.furthest_point_sample`` on the
    whole clouds: index 0 first, greedy max-min over squared distances,
    ties to the lowest index, near-origin points (|p|^2 <= 1e-3) never
    selected unless ``skip_origin=False``."""
    group, s, p = axis_group(mesh, "point"), axis_size(mesh, "point"), axis_rank(mesh, "point")
    xyz_l = xyz_local.float()
    b, n, _ = xyz_l.shape
    x, y, z = xyz_l[..., 0], xyz_l[..., 1], xyz_l[..., 2]
    dist = initial_distances(xyz_l) if skip_origin else torch.full((b, n), INIT_DIST, device=xyz_l.device)
    out = torch.zeros((b, num_samples), dtype=torch.int32, device=xyz_l.device)

    def exchange(key, local):
        """The (B,) global winner of the ranks' keys and its coordinates."""
        cx, cy, cz = (c.gather(1, local[:, None])[:, 0] for c in (x, y, z))
        rows = gather_slots(torch.stack([key, _bits(cx), _bits(cy), _bits(cz)], dim=-1), group, p, s)
        best = rows.gather(0, rows[..., :1].argmax(dim=0, keepdim=True).expand(1, b, 4))[0]
        coords = best[:, 1:].to(torch.int32).view(torch.float32)
        return best[:, 0], coords[:, 0:1], coords[:, 1:2], coords[:, 2:3]

    zero = torch.zeros((b,), dtype=torch.int64, device=xyz_l.device)
    _, lx, ly, lz = exchange(zero + int(p == 0), zero)  # the seed, index 0, lies on point rank 0
    for j in range(1, num_samples):
        dx, dy, dz = x - lx, y - ly, z - lz
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        local = torch.argmax(dist, dim=1)  # first max: lowest index
        key = _float_key(dist.gather(1, local[:, None])[:, 0]) * (1 << 32) + (_LOW - (local + p * n))
        key, lx, ly, lz = exchange(key, local)
        out[:, j] = (_LOW - (key & _LOW)).to(torch.int32)
    return out


def sharded_ball_query(mesh, xyz_local: torch.Tensor, centers: torch.Tensor, radius: float, nsample: int, *,
                       order: str = "index") -> torch.Tensor:
    """Ball query of ``centers`` (B, M, 3), the same on every point rank,
    against the clouds whose points are split over the 'point' ranks
    (``xyz_local`` (B, n, 3) this rank's) -> (B, M, nsample) int32 global
    indices, bit-equal to ``ops.ball_query(xyz, centers, radius, nsample,
    order=order)`` on the whole clouds: slots past the hit count repeat the
    first (nearest) hit, a center with no hit gets 0."""
    if order not in ORDERS:
        raise ValueError(f"query order must be one of {ORDERS}, got {order!r}")
    group, s, p = axis_group(mesh, "point"), axis_size(mesh, "point"), axis_rank(mesh, "point")
    b, n, _ = xyz_local.shape
    base = p * n
    r2 = f32_square(radius)
    px, py, pz = (xyz_local[..., i].unsqueeze(1) for i in range(3))  # (B, 1, n)
    js = torch.arange(nsample, device=centers.device)
    outs = []
    for lo in range(0, centers.shape[1], QUERY_CHUNK):
        c = centers[:, lo:lo + QUERY_CHUNK]
        dx, dy, dz = c[..., 0:1] - px, c[..., 1:2] - py, c[..., 2:3] - pz
        d2 = dx * dx + dy * dy + dz * dz  # as ops.ball_query forms it
        hit = d2 < r2
        if order == "index":
            count = hit.sum(dim=-1, keepdim=True)
            cand = torch.where(js < count, first_k_by_index(hit, nsample).to(torch.int64) + base, _BIG)
        else:
            gidx = torch.arange(base, base + n, device=centers.device)
            keys = _bits(torch.where(hit, d2, float("inf"))) * (1 << 32) + gidx
            cand = torch.topk(keys, min(nsample, n), dim=-1, largest=False, sorted=True).values
        merged = gather_slots(cand, group, p, s).permute(1, 2, 0, 3).reshape(b, c.shape[1], -1)
        vals = torch.sort(merged, dim=-1).values[..., :nsample]
        if order == "index":
            idx, is_hit = vals, vals < _BIG
        else:
            idx, is_hit = vals & _LOW, (vals >> 32) < _INF_BITS
        first = torch.where(is_hit[..., :1], idx[..., :1], 0)
        outs.append(torch.where(is_hit, idx, first).to(torch.int32))
    return torch.cat(outs, dim=1)
