"""Object-balanced seed sampling, OBS (port of graspbalance_tpu/eval/obs.py).

At inference the grasp seeds are re-drawn with an equal budget per detected
object (``num_seed // k`` each for k objects, the remainder to the last
object), so that small objects get as many grasp candidates as large ones.
Each object's points are compacted into a ``compact_cap`` buffer (index-
strided down to the cap when the object is larger), and one batched masked
FPS over all B x ``max_objects`` slots yields up to ``fps_cap`` candidates
per object; the output is assembled from quota intervals.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.ops.fps import (
    furthest_point_sample_masked,
    furthest_point_sample_masked_plain,
)
from graspbalance_tpu_torch.ops.gather import gather_points
from graspbalance_tpu_torch.ops.query import first_k_by_index

MAX_OBJECTS = 16  # instance slots per scene
COMPACT_CAP = 4096  # points kept per object before its FPS
FPS_CAP = 512  # FPS candidates per object


def _compact_mask(pts: torch.Tensor, mask: torch.Tensor, cap: int):
    """Gather the masked subset of pts into a dense (cap, 3) buffer per slot.

    pts (B, N, 3), mask (B, O, N) bool -> (cxyz (B, O, cap, 3), table
    (B, O, cap) int32 original indices, cvalid (B, O, cap) bool). Exact (all
    masked points, in index order) when a subset has <= cap points; index-
    strided down to exactly cap points otherwise (the first masked point is
    always kept)."""
    b, o, n = mask.shape
    rank = torch.cumsum(mask, dim=-1, dtype=torch.int64)  # 1-based at masked points
    count = torch.clamp(rank[..., -1:], min=1)
    hi = torch.div((rank - 1) * cap, count, rounding_mode="floor")
    lo = torch.div((rank - 2) * cap, count, rounding_mode="floor")
    keep = mask & (hi > lo)
    kcount = keep.sum(dim=-1, keepdim=True)
    js = torch.arange(cap, device=pts.device)
    cvalid = js < kcount
    table = torch.where(cvalid, first_k_by_index(keep, cap), 0)  # zero-padded
    cxyz = gather_points(pts, table.reshape(b, o * cap)).reshape(b, o, cap, 3)
    return cxyz, table, cvalid


def object_masks(seed_cluster: torch.Tensor, max_objects: int = MAX_OBJECTS) -> torch.Tensor:
    """seed_cluster (B, N) int instance ids (0 = background) -> (B, O, N)
    bool, one mask per instance slot 1..max_objects."""
    slots = torch.arange(1, max_objects + 1, device=seed_cluster.device)
    return seed_cluster.unsqueeze(1) == slots.view(1, max_objects, 1)


def max_needed_steps(present: torch.Tensor, num_seed: int, fps_cap: int = FPS_CAP) -> torch.Tensor:
    """The largest per-slot quota any scene of the batch reads, as an int64
    scalar on the device: the last present object of a scene with k objects
    gets num_seed // k + num_seed % k slots, cycled into fps_cap, and no
    other object of the scene gets more. present (B, O) bool; a zero-object
    scene reads nothing and counts as the cheapest case (k = O).

    The maximum is taken over the scenes' own quotas: the quota of the
    scene with the fewest objects is not always the largest, since the
    remainder num_seed % k does not fall with k (at num_seed=32 a 6-object
    scene's last object takes 7 slots, a 7-object scene's 8)."""
    o = present.shape[1]
    counts = present.sum(dim=1)
    k = torch.where(counts > 0, counts, o).clamp(min=1)
    return torch.clamp(num_seed // k + num_seed % k, max=fps_cap).amax()


def object_balance_indices(
    points: torch.Tensor,
    seed_cluster: torch.Tensor,
    *,
    num_seed: int = 1024,
    fps_cap: int = FPS_CAP,
    max_objects: int = MAX_OBJECTS,
    compact_cap: int = COMPACT_CAP,
    plain: bool = False,
) -> torch.Tensor:
    """points (B, N, 3); seed_cluster (B, N) int instance ids (0 =
    background) -> obs_inds (B, num_seed) int32.

    The masked FPS launches the CUDA kernel on CUDA tensors (its plain
    version with ``plain``, or on CPU tensors). Its step count, the largest
    quota any scene of the batch reads (``max_needed_steps``), stays on the
    device: no host sync. The plain version selects every slot."""
    b, n, _ = points.shape
    o = max_objects
    dev = points.device
    masks = object_masks(seed_cluster, o)  # (B, O, N)
    cxyz, table, cvalid = _compact_mask(points[..., :3], masks, compact_cap)
    present = masks.any(dim=2)  # (B, O)

    cxyz = cxyz.reshape(b * o, compact_cap, 3).contiguous()
    cvalid = cvalid.reshape(b * o, compact_cap).contiguous()
    if plain:
        seqs_c = furthest_point_sample_masked_plain(cxyz, cvalid, fps_cap)
    else:
        needed = max_needed_steps(present, num_seed, fps_cap)
        seqs_c = furthest_point_sample_masked(cxyz, cvalid, fps_cap, max_needed=needed)
    seqs_c = seqs_c.reshape(b, o, fps_cap)
    seqs = table.gather(2, seqs_c.to(torch.int64))  # original indices

    # assemble: quota intervals, the remainder to the last present object
    k = torch.clamp(present.sum(dim=1, keepdim=True), min=1)  # (B, 1)
    quota = torch.where(present, num_seed // k, 0)
    last = (o - 1) - torch.argmax(present.flip(1).to(torch.int32), dim=1, keepdim=True)
    quota = quota.scatter_add(1, last, num_seed % k)
    starts = torch.cumsum(quota, dim=1) - quota  # exclusive prefix sum
    p = torch.arange(num_seed, device=dev)
    slot_of_p = (starts.unsqueeze(1) <= p.view(1, -1, 1)).sum(dim=2) - 1  # (B, num_seed)
    slot_of_p = torch.clamp(slot_of_p, 0, o - 1)
    rank = (p - starts.gather(1, slot_of_p)) % fps_cap
    inds = seqs.reshape(b, o * fps_cap).gather(1, slot_of_p * fps_cap + rank)
    # no object at all: the identity prefix (degenerate scenes)
    inds = torch.where(present.any(dim=1, keepdim=True), inds, p.to(torch.int32))
    return inds.to(torch.int32)


def object_balance_sampling(
    points: torch.Tensor,
    features: torch.Tensor,
    seed_cluster: torch.Tensor,
    *,
    num_seed: int = 1024,
    fps_cap: int = FPS_CAP,
    max_objects: int = MAX_OBJECTS,
):
    """points (B, N, 3); features (B, N, C) full-cloud features;
    seed_cluster (B, N) -> (obs_xyz (B, num_seed, 3), obs_features
    (B, num_seed, C), obs_inds (B, num_seed) int32)."""
    inds = object_balance_indices(
        points, seed_cluster, num_seed=num_seed, fps_cap=fps_cap, max_objects=max_objects
    )
    return gather_points(points, inds), gather_points(features, inds), inds


def foreground_indices(points: torch.Tensor, fg_mask: torch.Tensor, *, num_seed: int = 1024) -> torch.Tensor:
    """Selection-only ForegroundSampling: one masked FPS over all foreground
    points, (B, num_seed) int32 indices."""
    return furthest_point_sample_masked(points[..., :3].contiguous(), fg_mask.contiguous(), num_seed)


def foreground_sampling(
    points: torch.Tensor, features: torch.Tensor, fg_mask: torch.Tensor, *, num_seed: int = 1024
):
    """ForegroundSampling: (obs_xyz, obs_features, obs_inds) from one FPS
    over all foreground points."""
    inds = foreground_indices(points, fg_mask, num_seed=num_seed)
    return gather_points(points, inds), gather_points(features, inds), inds

