"""Object-balanced seed sampling, grasp NMS, the voxel downsample and the
collision filter of the plain reference (plain PyTorch)."""

from __future__ import annotations

import math

import torch

from bench_port.reference import ops
from bench_port.reference.layers import matmul

MAX_OBJECTS = 16
COMPACT_CAP = 4096
FPS_CAP = 512


# ---------------------------------------------------------------------- OBS
def _compact_mask(pts, mask, cap):
    """Each slot's masked points in index order, index-strided down to
    ``cap`` when there are more: (xyz (B, O, cap, 3), original indices,
    valid)."""
    b, o, n = mask.shape
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int64)
    count = torch.clamp(rank[..., -1:], min=1)
    hi = torch.div((rank - 1) * cap, count, rounding_mode="floor")
    lo = torch.div((rank - 2) * cap, count, rounding_mode="floor")
    keep = mask & (hi > lo)
    kcount = keep.sum(dim=-1, keepdim=True)
    cvalid = torch.arange(cap, device=pts.device) < kcount
    table = torch.where(cvalid, ops.first_k_by_index(keep, cap), 0)
    cxyz = ops.gather_points(pts, table.reshape(b, o * cap)).reshape(b, o, cap, 3)
    return cxyz, table, cvalid


def object_balance_indices(points, seed_cluster, *, num_seed=1024, fps_cap=FPS_CAP, max_objects=MAX_OBJECTS,
                           compact_cap=COMPACT_CAP):
    """(B, N, 3), instance ids (B, N) (0 = background) -> (B, num_seed)
    int32: ``num_seed // k`` seeds by FPS from each of the k objects, the
    remainder to the last, each object's FPS order cycled past ``fps_cap``;
    the identity prefix for a scene with no object."""
    b, n, _ = points.shape
    o = max_objects
    dev = points.device
    masks = seed_cluster.unsqueeze(1) == torch.arange(1, o + 1, device=dev).view(1, o, 1)
    cxyz, table, cvalid = _compact_mask(points[..., :3], masks, compact_cap)
    present = masks.any(dim=2)
    seqs_c = ops.furthest_point_sample_masked(cxyz.reshape(b * o, compact_cap, 3),
                                              cvalid.reshape(b * o, compact_cap), fps_cap)
    seqs = table.gather(2, seqs_c.reshape(b, o, fps_cap).to(torch.int64))
    k = torch.clamp(present.sum(dim=1, keepdim=True), min=1)
    quota = torch.where(present, num_seed // k, 0)
    last = (o - 1) - torch.argmax(present.flip(1).to(torch.int32), dim=1, keepdim=True)
    quota = quota.scatter_add(1, last, num_seed % k)
    starts = torch.cumsum(quota, dim=1) - quota
    p = torch.arange(num_seed, device=dev)
    slot_of_p = torch.clamp((starts.unsqueeze(1) <= p.view(1, -1, 1)).sum(dim=2) - 1, 0, o - 1)
    rank = (p - starts.gather(1, slot_of_p)) % fps_cap
    inds = seqs.reshape(b, o * fps_cap).gather(1, slot_of_p * fps_cap + rank)
    inds = torch.where(present.any(dim=1, keepdim=True), inds, p.to(torch.int32))
    return inds.to(torch.int32)


# ---------------------------------------------------------------------- NMS
def grasp_nms(grasps, valid, *, translation_thresh=0.03, rotation_thresh=30.0 / 180.0 * math.pi):
    """Greedy suppression in score order: keep (B, G) bool. Two grasps
    conflict iff their centers are closer than ``translation_thresh`` and
    their rotations differ by less than ``rotation_thresh``. Solved as the
    fixpoint of ``keep[i] = valid[i] & ~any_{j<i}(C[j, i] & keep[j])``."""
    b, g, _ = grasps.shape
    scores = torch.where(valid, grasps[..., 0], -math.inf)
    trans = grasps[..., 13:16]
    rot = grasps[..., 4:13]
    delta = trans.unsqueeze(2) - trans.unsqueeze(1)
    d2 = (delta * delta).sum(dim=-1)
    tr = matmul(rot, rot.transpose(1, 2))
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    conflict = (d2 < translation_thresh ** 2) & (torch.arccos(cos) < rotation_thresh)
    conflict &= valid.unsqueeze(2) & valid.unsqueeze(1)
    order = torch.sort(-scores, dim=1, stable=True).indices
    conflict_o = conflict.gather(1, order.unsqueeze(2).expand(b, g, g))
    conflict_o = conflict_o.gather(2, order.unsqueeze(1).expand(b, g, g))
    valid_o = valid.gather(1, order)
    ii = torch.arange(g, device=grasps.device)
    lower = conflict_o & (ii.unsqueeze(1) < ii.unsqueeze(0))

    def step(k):
        return valid_o & ~(lower & k.unsqueeze(2)).any(dim=1)

    prev, k, sweeps = valid_o, step(valid_o), 1
    while sweeps < g and bool((k != prev).any()):
        prev, k, sweeps = k, step(k), sweeps + 1
    return torch.zeros_like(valid_o).scatter_(1, order, k)


# ------------------------------------------------------------ voxel + collision
FINGER_WIDTH = 0.01
FINGER_LENGTH = 0.06
INVALID_COORD = 2 ** 30


def _segment_sums(values, start, count):
    """Sums of contiguous segments, each added in index order from 0."""
    b, n, c = values.shape
    longest = int(count.max()) if count.numel() else 0
    acc = torch.zeros(count.shape + (c,), dtype=values.dtype, device=values.device)
    for j in range(longest):
        pos = (start + j).clamp(max=n - 1).to(torch.int64)
        term = values.gather(1, pos.unsqueeze(-1).expand(-1, -1, c))
        acc = acc + torch.where((j < count).unsqueeze(-1), term, 0.0)
    return acc


def voxel_downsample(points, voxel_size=0.005):
    """(B, N, 3) -> (centroids (B, N, 3), valid (B, N)): one centroid per
    occupied voxel in the leading slots, voxels in lexicographic order."""
    b, n, _ = points.shape
    dev = points.device
    c = torch.floor(points / voxel_size).to(torch.int32)
    p = points
    for axis in (2, 1, 0):
        o = torch.sort(c[..., axis], dim=1, stable=True).indices
        c = c.gather(1, o.unsqueeze(-1).expand(-1, -1, 3))
        p = p.gather(1, o.unsqueeze(-1).expand(-1, -1, 3))
    changed = (c[:, 1:] != c[:, :-1]).any(dim=-1)
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), changed], dim=1)
    num_groups = first.sum(dim=1, keepdim=True)
    seg = torch.cumsum(first, dim=1) - 1
    slot = torch.where(first, seg, n).to(torch.int64)
    pos = torch.arange(n, device=dev, dtype=torch.int64).expand(b, n)
    start = torch.zeros((b, n + 1), dtype=torch.int64, device=dev).scatter_(1, slot, pos)[:, :n]
    js = torch.arange(n, device=dev).expand(b, n)
    end = torch.cat([start[:, 1:], torch.full((b, 1), n, device=dev)], dim=1)
    end = torch.where(js + 1 < num_groups, end, n)
    count = torch.where(js < num_groups, end - start, 0)
    centroids = _segment_sums(p, start, count) / torch.clamp(count, min=1).to(points.dtype).unsqueeze(-1)
    return centroids, js < num_groups


def _box_counts(points, valid, grasps, approach_dist, chunk=256):
    """Per grasp the voxels inside its left / right finger, bottom plate,
    approach sweep, their union and the space between the fingers: (B, G, 6)."""
    widths, heights, depths = grasps[..., 1], grasps[..., 2], grasps[..., 3]
    rot = grasps[..., 4:13].reshape(grasps.shape[:-1] + (3, 3))
    cols = [rot[..., :, 0], rot[..., :, 1], rot[..., :, 2], grasps[..., 13:16],
            (-heights / 2)[..., None], (heights / 2)[..., None], depths[..., None],
            (depths - FINGER_LENGTH)[..., None], (depths - FINGER_LENGTH - FINGER_WIDTH)[..., None],
            (depths - FINGER_LENGTH - FINGER_WIDTH - approach_dist)[..., None],
            (widths / 2)[..., None], (widths / 2 + FINGER_WIDTH)[..., None]]
    params = torch.cat(cols, dim=-1)
    vld = valid.unsqueeze(1)
    p = [points[..., j].unsqueeze(1) for j in range(3)]
    outs = []
    for lo in range(0, params.shape[1], chunk):
        par = params[:, lo: lo + chunk].unsqueeze(-1)

        def col(i):
            return par[:, :, i]

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
        outs.append(torch.stack([m.sum(dim=-1) for m in (left, right, bottom, shifting, overall, inner)], dim=-1))
    return torch.cat(outs, dim=1).float()


def collision(scene, scene_valid, grasps, *, voxel_size=0.005, approach_dist=0.03, collision_thresh=0.05):
    """(B, G) bool: the occupied voxels in a grasp's boxes exceed
    ``collision_thresh`` of the boxes' voxel volume."""
    approach_dist = max(approach_dist, FINGER_WIDTH)
    widths, heights = grasps[..., 1], grasps[..., 2]
    n_overall = _box_counts(scene, scene_valid, grasps, approach_dist)[..., 4]
    v3 = voxel_size ** 3
    lr_vol = heights * FINGER_LENGTH * FINGER_WIDTH / v3
    bottom_vol = heights * (widths + 2 * FINGER_WIDTH) * FINGER_WIDTH / v3
    shift_vol = heights * (widths + 2 * FINGER_WIDTH) * approach_dist / v3
    volume = lr_vol * 2 + bottom_vol + shift_vol
    return n_overall / (volume + 1e-6) > collision_thresh


def postprocess(grasps, valid, cloud, *, collision_thresh=0.05):
    """Grasp NMS, then the collision filter against the 5 mm voxel-downsampled
    scene: keep (B, G) bool."""
    keep = grasp_nms(grasps, valid)
    scene, scene_valid = voxel_downsample(cloud)
    return keep & ~collision(scene, scene_valid, grasps, collision_thresh=collision_thresh)
