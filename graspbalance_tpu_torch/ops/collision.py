"""Box-occupancy counts of the collision filter (port of
graspbalance_tpu/ops/pallas/collision_kernel.py).

For every grasp and every valid scene point: the point's gripper-frame
coordinates, the eight box tests of graspbalance_tpu/eval/collision.py and
six counts ``[left, right, bottom, shifting, overall, inner]``.

``collision_counts`` launches the CUDA kernel (``csrc/collision.cu``) on CUDA
tensors and runs ``collision_counts_plain`` on CPU tensors. Both take a
leading batch axis: points (B, N, 3), valid (B, N) bool, params (B, G, 24)
from ``pack_grasp_params``, and return (B, G, 6) float32 integer counts.

The kernel ranks each scene's grasps by center x (``grasp_order``) and skips
every (32 ranked grasps, 32 points) tile in which no grasp can count a point.
``tile_may_hit`` is the plain twin of its per-grasp test, on the tiles'
bounding boxes from ``tile_bounds``; ``cull_share`` counts the tiles that
the kernel skips, as ``collision_cull_stats`` reads them from the kernel.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch import _build

N_COUNTS = 6  # left, right, bottom, shifting, overall, inner
N_PARAMS = 24
N_RANKED = 28  # the kernel's ranked fields: 20 parameters, 6 world bounds, index, cull flag
TILE = 32  # points per culled tile, and grasps per culled group
TILE_RECORD = 8  # the kernel's record per tile: the box's lo and hi, any valid point, any finite one
MAX_POINTS = 1 << 24  # float counts stay exact below it
GAMMA = 2.0**-21  # 8u: bounds the rounding of a gripper coordinate (4u) with room
SLACK = 2.0**-40  # the world bounds' own double rounding


def pack_grasp_params(
    grasps: torch.Tensor, approach_dist: float, finger_width: float, finger_length: float
) -> torch.Tensor:
    """(..., G, 17) decoded grasp rows -> (..., G, 24) f32 parameters.

    Columns: 0-2 rx, 3-5 ry, 6-8 rz (gripper-frame axes = rotation
    columns), 9-11 translation, 12 -h/2, 13 h/2, 14 depth, 15 d-FL,
    16 d-FL-FW, 17 d-FL-FW-A, 18 w/2, 19 w/2+FW, 20-23 zero."""
    widths, heights, depths = grasps[..., 1], grasps[..., 2], grasps[..., 3]
    rot = grasps[..., 4:13].reshape(grasps.shape[:-1] + (3, 3))
    cols = [
        rot[..., :, 0], rot[..., :, 1], rot[..., :, 2],
        grasps[..., 13:16],
        (-heights / 2)[..., None],
        (heights / 2)[..., None],
        depths[..., None],
        (depths - finger_length)[..., None],
        (depths - finger_length - finger_width)[..., None],
        (depths - finger_length - finger_width - approach_dist)[..., None],
        (widths / 2)[..., None],
        (widths / 2 + finger_width)[..., None],
        torch.zeros(grasps.shape[:-1] + (4,), dtype=grasps.dtype, device=grasps.device),
    ]
    return torch.cat(cols, dim=-1).float()


def _check(points, valid, params):
    b, n, _ = points.shape
    if points.shape[-1] != 3 or valid.shape != (b, n) or params.ndim != 3 or params.shape[0] != b \
            or params.shape[-1] != N_PARAMS:
        raise ValueError(
            f"need points (B, N, 3), valid (B, N), params (B, G, {N_PARAMS}); got "
            f"{tuple(points.shape)}, {tuple(valid.shape)}, {tuple(params.shape)}"
        )


def _pair_masks(points: torch.Tensor, valid: torch.Tensor, par: torch.Tensor):
    """The six count masks (B, g, N) of the grasps ``par`` (B, g, 24) on
    every point, in the kernel's association ``x = (d0*rx0 + d1*rx1) +
    d2*rx2``, every operation rounded on its own."""
    vld = valid.bool().unsqueeze(1)  # (B, 1, N)
    p = [points[..., j].unsqueeze(1) for j in range(3)]  # (B, 1, N)
    par = par.unsqueeze(-1)  # (B, g, 24, 1)

    def col(c):
        return par[:, :, c]  # (B, g, 1)

    d = [p[j] - col(9 + j) for j in range(3)]
    x = d[0] * col(0) + d[1] * col(1) + d[2] * col(2)
    y = d[0] * col(3) + d[1] * col(4) + d[2] * col(5)
    z = d[0] * col(6) + d[1] * col(7) + d[2] * col(8)
    dfl, dflw, w2, w2fw = col(15), col(16), col(18), col(19)
    m_h = (z > col(12)) & (z < col(13)) & vld
    m_d = (x > dfl) & (x < col(14))
    m_lo, m_li = y > -w2fw, y < -w2
    m_ro, m_ri = y < w2fw, y > w2
    m_b = (x <= dfl) & (x > dflw)
    m_s = (x <= dflw) & (x > col(17))
    left = m_h & m_d & m_lo & m_li
    right = m_h & m_d & m_ro & m_ri
    bottom = m_h & m_lo & m_ro & m_b
    shifting = m_h & m_lo & m_ro & m_s
    overall = left | right | bottom | shifting
    inner = m_h & m_d & ~m_li & ~m_ri
    return left, right, bottom, shifting, overall, inner


def collision_counts_plain(
    points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor, *, chunk: int = 256
) -> torch.Tensor:
    """Plain PyTorch version: the (grasps, N) coordinate planes of a chunk
    of grasps at a time (``_pair_masks``), summed per count."""
    _check(points, valid, params)
    outs = [
        torch.stack([m.sum(dim=-1) for m in _pair_masks(points, valid, params[:, lo : lo + chunk])], dim=-1)
        for lo in range(0, params.shape[1], chunk)
    ]
    return torch.cat(outs, dim=1).float()


def grasp_order(params: torch.Tensor) -> torch.Tensor:
    """(B, G, 24) -> (B, G) int64: the grasps of each scene by center x, as
    the kernel ranks them (a total order on the float bits, ties to the
    lower index); entry r is the grasp of rank r."""
    bits = params[..., 9].contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 2**31, 0xFFFFFFFF - bits, bits | 2**31)
    return torch.sort(key, dim=-1, stable=True).indices


def _round_out(x: torch.Tensor, down: bool) -> torch.Tensor:
    """float64 -> float32 rounded toward -inf (``down``) or +inf."""
    f = x.float()
    if down:
        return torch.where(f.double() > x, torch.nextafter(f, torch.full_like(f, -float("inf"))), f)
    return torch.where(f.double() < x, torch.nextafter(f, torch.full_like(f, float("inf"))), f)


def _all_finite(p: torch.Tensor) -> torch.Tensor:
    """(..., 20) -> (...): the kernel's test that a grasp's parameters are
    finite (their absolute sum, in its order, is)."""
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for c in range(20):
        total = total + p[..., c].float().abs()
    return total <= torch.finfo(torch.float32).max


def world_bounds(params: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, G, 24) -> lo, hi (B, G, 3) float32: world bounds that hold every
    point any count of the grasp takes, (-inf, inf) where a parameter is not
    finite or the rotation rows are too far from orthonormal; the kernel's
    computation (``csrc/collision.cu:world_bounds``), operation for
    operation in float64.

    A counted point has its rounded gripper coordinates g in the boxes'
    union; |g - M d| <= GAMMA |M| |d| for d = p - t, and with R = I - M^T M,
    |d - M^T g| <= K |d| for K = GAMMA |M^T| |M| + |R|, which bounds
    ||d||_inf by max_j |M^T g|_j / (1 - ||K||_inf) and then each d_j."""
    p = params[..., :20]
    m = p[..., :9].double().unflatten(-1, (3, 3))  # m[..., a, j]: row a = rx, ry, rz
    xl = torch.minimum(torch.minimum(p[..., 15], p[..., 16]), p[..., 17]).double()
    xh = torch.maximum(torch.maximum(p[..., 14], p[..., 15]), p[..., 16]).double()
    ym = torch.maximum(p[..., 18].abs(), p[..., 19].abs()).double()
    zl, zh = p[..., 12].double(), p[..., 13].double()
    bc = ((xl + xh) * 0.5, torch.zeros_like(xl), (zl + zh) * 0.5)
    bh = (((xh - xl) * 0.5).clamp(min=0.0), ym, ((zh - zl) * 0.5).clamp(min=0.0))
    kappa = torch.zeros_like(xl)
    cmax = torch.zeros_like(xl)
    kr, cen, hal = [], [], []
    for j in range(3):
        acc = torch.zeros_like(xl)
        for k in range(3):
            mm = torch.zeros_like(xl)
            aa = torch.zeros_like(xl)
            for a in range(3):
                mm = mm + m[..., a, j] * m[..., a, k]
                aa = aa + m[..., a, j].abs() * m[..., a, k].abs()
            acc = acc + (GAMMA * aa + ((1.0 if j == k else 0.0) - mm).abs())
        kr.append(acc)
        kappa = torch.fmax(kappa, acc)
        c = torch.zeros_like(xl)
        h = torch.zeros_like(xl)
        for a in range(3):
            c = c + m[..., a, j] * bc[a]
            h = h + m[..., a, j].abs() * bh[a]
        cen.append(c)
        hal.append(h)
        cmax = torch.fmax(cmax, c.abs() + h)
    dmax = cmax / (1.0 - kappa)
    ok = _all_finite(p) & (kappa <= 0.5)
    lo, hi = [], []
    for j in range(3):
        t = p[..., 9 + j].double()
        c = t + cen[j]
        h = hal[j] + kr[j] * dmax
        h = h + (SLACK * ((t.abs() + cen[j].abs()) + h) + 1e-35)
        lo.append(_round_out(c - h, down=True))
        hi.append(_round_out(c + h, down=False))
    lo, hi = torch.stack(lo, dim=-1), torch.stack(hi, dim=-1)
    fmax = torch.finfo(torch.float32).max
    ok = ok & (lo.abs() <= fmax).all(-1) & (hi.abs() <= fmax).all(-1)
    inf = float("inf")
    return torch.where(ok.unsqueeze(-1), lo, -inf), torch.where(ok.unsqueeze(-1), hi, inf)


def tile_bounds(points: torch.Tensor, valid: torch.Tensor):
    """(B, N, 3), (B, N) -> lo, hi (B, T, 3) float32 and any_valid (B, T):
    the bounding box of each TILE-point tile's valid points with finite
    coordinates ((inf, -inf) where there is none), as the kernel builds it,
    and whether the tile holds a valid point at all."""
    b, n, _ = points.shape
    pad = -n % TILE
    pts = torch.nn.functional.pad(points, (0, 0, 0, pad)).unflatten(1, (-1, TILE))  # (B, T, TILE, 3)
    vld = torch.nn.functional.pad(valid.bool(), (0, pad)).unflatten(1, (-1, TILE))  # (B, T, TILE)
    fin = vld & torch.isfinite(pts).all(dim=-1)
    inf = float("inf")
    lo = torch.where(fin.unsqueeze(-1), pts, inf).amin(dim=2)
    hi = torch.where(fin.unsqueeze(-1), pts, -inf).amax(dim=2)
    return lo, hi, vld.any(dim=2)


def _axis_range(a, t, lo, hi):
    """The range of one gripper coordinate over the boxes [lo, hi] (B, 1, T,
    3), rows a and translations t (B, g, 1, 3): the endpoint products'
    minima and maxima summed in the counting order."""
    pl = (lo - t) * a
    ph = (hi - t) * a
    mn, mx = torch.minimum(pl, ph), torch.maximum(pl, ph)
    return (mn[..., 0] + mn[..., 1]) + mn[..., 2], (mx[..., 0] + mx[..., 1]) + mx[..., 2]


def tile_may_hit(params: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(B, G, 24), tile boxes lo, hi (B, T, 3) -> (B, G, T) bool: whether
    the kernel keeps the tile for the grasp. False only where no point in
    the box can be counted: the box misses the grasp's ``world_bounds``, or
    the ranges of the gripper coordinates over it (by interval arithmetic in
    the kernel's rounding) miss every count's conditions. An empty box
    (lo > hi) is never kept, a grasp with a non-finite parameter always."""
    p = params[..., :20].float()
    cull = _all_finite(p)
    wlo, whi = world_bounds(params)
    lo4, hi4 = lo.unsqueeze(1), hi.unsqueeze(1)  # (B, 1, T, 3)
    world_miss = ((hi4 < wlo.unsqueeze(2)) | (lo4 > whi.unsqueeze(2))).any(dim=-1)
    t = p[..., None, 9:12]  # (B, G, 1, 3)
    x0, x1 = _axis_range(p[..., None, 0:3], t, lo4, hi4)
    y0, y1 = _axis_range(p[..., None, 3:6], t, lo4, hi4)
    z0, z1 = _axis_range(p[..., None, 6:9], t, lo4, hi4)
    finite = (((x0 + x1) + (y0 + y1)) + (z0 + z1)).abs() <= torch.finfo(torch.float32).max

    def col(c):
        return p[..., c, None]  # (B, G, 1)

    zlo, zhi, dep, dfl, dflw, dflwa, w2, w2fw = (col(c) for c in range(12, 20))
    h = (z1 > zlo) & (z0 < zhi)
    xd = (x1 > dfl) & (x0 < dep)
    xb = (x1 > dflw) & (x0 <= dfl)
    xs = (x1 > dflwa) & (x0 <= dflw)
    yl = (y1 > -w2fw) & (y0 < -w2)
    yr = (y1 > w2) & (y0 < w2fw)
    ybs = (y1 > -w2fw) & (y0 < w2fw)
    yi = (y1 >= -w2) & (y0 <= w2)
    boxes = h & ((xd & (yl | yr | yi)) | ((xb | xs) & ybs))
    nonempty = (lo <= hi).all(dim=-1).unsqueeze(1)  # (B, 1, T)
    return ~cull.unsqueeze(-1) | (nonempty & ~world_miss & (~finite | boxes))


def cull_share(points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor) -> tuple[int, int]:
    """(kept, considered) (group, tile) pairs of the kernel on these inputs:
    a group is TILE grasps of consecutive rank (``grasp_order``), a tile
    TILE points holding a valid point; a pair is kept when a grasp of the
    group may hit the tile (``tile_may_hit``)."""
    _check(points, valid, params)
    lo, hi, any_valid = tile_bounds(points, valid)
    ranked = params.gather(1, grasp_order(params).unsqueeze(-1).expand(-1, -1, params.shape[-1]))
    keep = tile_may_hit(ranked, lo, hi)  # (B, G, T)
    g = params.shape[1]
    keep = torch.nn.functional.pad(keep, (0, 0, 0, -g % TILE)).unflatten(1, (-1, TILE)).any(dim=2)  # (B, groups, T)
    keep = keep & any_valid.unsqueeze(1)
    return int(keep.sum()), int(any_valid.sum()) * keep.shape[1]


def _launch(points, valid, params, stats):
    _check(points, valid, params)
    _build.require_cuda("points", points, torch.float32, 3)
    _build.require_cuda("valid", valid, torch.bool, 2)
    _build.require_cuda("params", params, torch.float32, 3)
    b, n, _ = points.shape
    g = params.shape[1]
    if n >= MAX_POINTS:
        raise ValueError(f"the collision kernel takes N < {MAX_POINTS} points, got {n}")
    counts = torch.empty((b, g, N_COUNTS), dtype=torch.float32, device=points.device)
    ranked = torch.empty((b, N_RANKED, g), dtype=torch.float32, device=points.device)
    tiles = torch.empty((b, -(-n // TILE), TILE_RECORD), dtype=torch.float32, device=points.device)
    lib = _build.library()
    with torch.cuda.device(points.device):
        err = lib.gb_collision(
            points.data_ptr(), valid.data_ptr(), params.data_ptr(), counts.data_ptr(), ranked.data_ptr(),
            tiles.data_ptr(), 0 if stats is None else stats.data_ptr(), b, n, g, _build.stream_of(points),
        )
    _build.check(err, "collision")
    return counts


def collision_counts(points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, N) bool, (B, G, 24) -> (B, G, 6) float32 counts."""
    if points.device.type == "cpu":
        return collision_counts_plain(points, valid, params)
    return _launch(points, valid, params, None)


def collision_cull_stats(points: torch.Tensor, valid: torch.Tensor, params: torch.Tensor):
    """The kernel on CUDA tensors, also counting its (group, tile) pairs:
    counts, and (kept, considered) as ``cull_share`` defines them."""
    stats = torch.zeros(2, dtype=torch.int64, device=points.device)
    counts = _launch(points, valid, params, stats)
    return counts, tuple(int(v) for v in stats.tolist())
