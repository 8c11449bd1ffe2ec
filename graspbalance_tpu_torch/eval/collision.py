"""Model-free collision detection on a voxel-downsampled scene (port of
graspbalance_tpu/eval/collision.py).

Each grasp defines four boxes in the gripper frame (left and right finger,
bottom plate, approach sweep); a grasp collides when the occupied voxels
inside them exceed ``collision_thresh`` of the boxes' voxel volume. The
counts come from ``ops.collision.collision_counts``: the CUDA kernel on CUDA
tensors, its plain version on CPU tensors (or with ``plain=True``).

The device functions take one scene, as the JAX package's do, or a batch
with a leading axis. ``voxel_downsample`` is the host (numpy) version of the
downsample, for offline tools and the native library's fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.ops.collision import (
    collision_counts,
    collision_counts_plain,
    pack_grasp_params,
)

FINGER_WIDTH = 0.01
FINGER_LENGTH = 0.06
INVALID_COORD = 2**30  # invalid points' voxel coordinate: they sort last


def voxel_downsample(points: np.ndarray, voxel_size: float = 0.005) -> np.ndarray:
    """Centroid voxel downsample on the host (numpy), Open3D's
    voxel_down_sample semantics: one centroid per occupied voxel, the
    voxels in lexicographic order of their integer coordinates."""
    coords = np.floor(points / voxel_size).astype(np.int64)
    # lexicographic unique via a dense key
    c = coords - coords.min(axis=0)
    dims = c.max(axis=0) + 1
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    order = np.argsort(key, kind="stable")
    boundaries = np.flatnonzero(np.diff(key[order])) + 1
    groups = np.split(points[order], boundaries)
    return np.stack([g.mean(axis=0) for g in groups]).astype(points.dtype)


def _batched(x: torch.Tensor, ndim: int):
    return (x.unsqueeze(0), True) if x.ndim == ndim else (x, False)


def segment_sums_sorted(values: torch.Tensor, start: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Sums of contiguous segments, deterministic on any device.

    values (B, N, C); segment s of row b covers values[b, start[b, s] :
    start[b, s] + count[b, s]]. Each sum adds its terms one at a time in
    index order, starting from 0 (the order of a sequential segment sum), by
    a gather per position of the longest segment: no atomics, so the card
    gives the same bits on every run. Reads the longest segment's length on
    the host (one sync: ``trace.host_read`` site "voxel", since the voxel
    downsample is its caller)."""
    b, n, c = values.shape
    longest = trace.host_read("voxel", lambda: int(count.max())) if count.numel() else 0
    acc = torch.zeros(count.shape + (c,), dtype=values.dtype, device=values.device)
    for j in range(longest):
        pos = (start + j).clamp(max=n - 1).to(torch.int64)
        term = values.gather(1, pos.unsqueeze(-1).expand(-1, -1, c))
        acc = acc + torch.where((j < count).unsqueeze(-1), term, 0.0)
    return acc


def voxel_downsample_fixed(
    points: torch.Tensor, valid: torch.Tensor | None = None, voxel_size: float = 0.005
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape voxel downsample: ([B,] N, 3)[, ([B,] N) valid] ->
    (([B,] N, 3) centroids, ([B,] N) valid), one centroid per occupied voxel
    in the leading slots, in lexicographic voxel order.

    Lexicographic grouping by three stable sorts (least significant axis
    first), as the JAX package does; the centroids are ``segment_sums_sorted``
    over the sorted points divided by the counts."""
    points, single = _batched(points, 2)
    b, n, _ = points.shape
    if valid is None:
        valid = torch.ones((b, n), dtype=torch.bool, device=points.device)
    elif single:
        valid = valid.unsqueeze(0)
    coords = torch.floor(points / voxel_size).to(torch.int32)
    c = torch.where(valid.unsqueeze(-1), coords, INVALID_COORD)
    p, v = points, valid
    for axis in (2, 1, 0):
        o = torch.sort(c[..., axis], dim=1, stable=True).indices
        c = c.gather(1, o.unsqueeze(-1).expand(-1, -1, 3))
        p = p.gather(1, o.unsqueeze(-1).expand(-1, -1, 3))
        v = v.gather(1, o)
    changed = (c[:, 1:] != c[:, :-1]).any(dim=-1)
    first = v & torch.cat([torch.ones((b, 1), dtype=torch.bool, device=points.device), changed], dim=1)
    num_groups = first.sum(dim=1, keepdim=True)
    num_valid = v.sum(dim=1, keepdim=True)  # the valid points are the sorted prefix
    # start of segment s: the position of the (s+1)-th segment head
    seg = torch.cumsum(first, dim=1) - 1
    slot = torch.where(first, seg, n).to(torch.int64)  # non-heads go to a spill slot
    pos = torch.arange(n, device=points.device, dtype=torch.int64).expand(b, n)
    start = torch.zeros((b, n + 1), dtype=torch.int64, device=points.device).scatter_(1, slot, pos)[:, :n]
    js = torch.arange(n, device=points.device).expand(b, n)
    end = torch.cat([start[:, 1:], torch.full((b, 1), n, device=points.device)], dim=1)
    end = torch.where(js + 1 < num_groups, end, num_valid)
    count = torch.where(js < num_groups, end - start, 0)
    sums = segment_sums_sorted(p, start, count)
    centroids = sums / torch.clamp(count, min=1).to(points.dtype).unsqueeze(-1)
    out_valid = js < num_groups
    if single:
        return centroids[0], out_valid[0]
    return centroids, out_valid


def collision_detect(
    scene_points: torch.Tensor,
    grasps: torch.Tensor,
    *,
    scene_valid: torch.Tensor | None = None,
    voxel_size: float = 0.005,
    approach_dist: float = 0.03,
    collision_thresh: float = 0.05,
    empty_thresh: float = 0.01,
    return_empty_grasp: bool = False,
    return_ious: bool = False,
    plain: bool = False,
):
    """scene_points ([B,] N, 3) voxel-downsampled scene; grasps ([B,] G, 17)
    decoded rows [score, width, height, depth, rot9, center3, obj_id];
    scene_valid optional ([B,] N) mask.

    Returns the collision mask ([B,] G) bool, plus the empty mask and the
    iou tuple (global, left, right, bottom, shifting) on request. On CUDA
    tensors the counts always come from the kernel unless ``plain`` asks for
    the plain version (to compare against it on the card)."""
    scene_points, single = _batched(scene_points, 2)
    grasps = grasps.unsqueeze(0) if single else grasps
    b, n, _ = scene_points.shape
    if scene_valid is None:
        scene_valid = torch.ones((b, n), dtype=torch.bool, device=scene_points.device)
    elif single:
        scene_valid = scene_valid.unsqueeze(0)
    approach_dist = max(approach_dist, FINGER_WIDTH)
    widths, heights = grasps[..., 1], grasps[..., 2]

    params = pack_grasp_params(grasps, approach_dist, FINGER_WIDTH, FINGER_LENGTH)
    count_fn = collision_counts_plain if plain else collision_counts
    counts = count_fn(scene_points.contiguous(), scene_valid.bool().contiguous(), params.contiguous())
    n_left, n_right, n_bottom, n_shift, n_overall, n_inner = counts.unbind(-1)

    v3 = voxel_size**3
    lr_vol = heights * FINGER_LENGTH * FINGER_WIDTH / v3
    bottom_vol = heights * (widths + 2 * FINGER_WIDTH) * FINGER_WIDTH / v3
    shift_vol = heights * (widths + 2 * FINGER_WIDTH) * approach_dist / v3
    volume = lr_vol * 2 + bottom_vol + shift_vol
    global_iou = n_overall / (volume + 1e-6)
    collision = global_iou > collision_thresh

    def unbatch(x):
        return x[0] if single else x

    if not (return_empty_grasp or return_ious):
        return unbatch(collision)
    out = [unbatch(collision)]
    if return_empty_grasp:
        inner_vol = heights * FINGER_LENGTH * widths / v3
        out.append(unbatch(n_inner / torch.clamp(inner_vol, min=1e-6) < empty_thresh))
    if return_ious:
        out.append(
            tuple(
                unbatch(x)
                for x in (
                    global_iou,
                    n_left / (lr_vol + 1e-6),
                    n_right / (lr_vol + 1e-6),
                    n_bottom / (bottom_vol + 1e-6),
                    n_shift / (shift_vol + 1e-6),
                )
            )
        )
    return tuple(out)
