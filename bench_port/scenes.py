"""Synthetic table-top scenes for the benchmark: random boxes on a table
plane, the scene geometry of ``graspbalance_tpu_torch/data/synthetic.py``
frozen here (so that a change to the program cannot change the inputs it is
measured on), with the number of objects drawn per scene.

A pool's object counts are one fixed multiset (``lo..hi`` repeated until the
pool is full) in an order drawn from the seed: every seed gives the pool the
same amount of work, in another order and with other geometry.
"""

from __future__ import annotations

import numpy as np


def object_counts(rng: np.random.Generator, pool: int, lo: int, hi: int) -> np.ndarray:
    """(pool,) object counts: ``lo..hi`` cycled to ``pool`` entries, shuffled."""
    return rng.permutation(np.resize(np.arange(lo, hi + 1), pool))


TABLE_FRAC = 0.4  # share of the points on the table plane
TABLE_EXTENT = 0.3  # table half-width in x and y
OBJECT_SCATTER = 0.25  # object centers within +-this in x and y


def scene_geometry(rng: np.random.Generator, num_points: int, n_obj: int, *, max_objects: int = 12,
                   max_grasp_points: int = 4096, grasp_points_per_object: int = 300, resting: bool = False) -> dict:
    """One scene: its cloud (num_points, 3) float32, instance labels (0 =
    table, 1..n_obj the boxes), the boxes' poses, sizes and masks padded to
    ``max_objects``, and each box's label points (object frame, padded to
    ``max_grasp_points``). ``resting`` puts each box on the table, a few mm
    clear (the analytic labels' layout)."""
    n_table = int(num_points * TABLE_FRAC)
    n_obj_pts = num_points - n_table

    te = TABLE_EXTENT
    table = np.empty((n_table, 3), np.float32)
    table[:, 0] = rng.uniform(-te, te, n_table)
    table[:, 1] = rng.uniform(-te, te, n_table)
    table[:, 2] = 0.5 + rng.normal(0, 0.002, n_table)

    sizes = rng.uniform(0.02, 0.08, (n_obj, 3)).astype(np.float32)
    cz = rng.uniform(0.42, 0.48, n_obj)
    if resting:
        cz = 0.5 - sizes[:, 2] / 2.0 - rng.uniform(0.002, 0.01, n_obj)
    oe = OBJECT_SCATTER
    centers = np.stack(
        [rng.uniform(-oe, oe, n_obj), rng.uniform(-oe, oe, n_obj), cz], axis=-1
    ).astype(np.float32)

    per_obj = n_obj_pts // n_obj
    parts, ids = [table], [np.zeros(n_table, np.int32)]
    for i in range(n_obj):
        parts.append((rng.random((per_obj, 3), dtype=np.float32) - 0.5) * sizes[i] + centers[i])
        ids.append(np.full(per_obj, i + 1, np.int32))
    rem = n_obj_pts - per_obj * n_obj
    if rem:
        parts.append(table[:rem])
        ids.append(np.zeros(rem, np.int32))
    perm = rng.permutation(num_points)
    cloud = np.concatenate(parts, axis=0)[perm]
    seg = np.concatenate(ids)[perm]

    poses = np.zeros((max_objects, 3, 4), np.float32)
    obj_mask = np.zeros(max_objects, bool)
    poses[:n_obj, :, :3] = np.eye(3, dtype=np.float32)
    poses[:n_obj, :, 3] = centers
    obj_mask[:n_obj] = True

    p_max, k = max_grasp_points, grasp_points_per_object
    gpts = np.zeros((p_max, 3), np.float32)
    gobj = np.zeros(p_max, np.int32)
    gmask = np.zeros(p_max, bool)
    for i in range(n_obj):
        lo, hi = i * k, min((i + 1) * k, p_max)
        if lo >= p_max:
            break
        gpts[lo:hi] = (rng.random((hi - lo, 3), dtype=np.float32) - 0.5) * sizes[i]
        gobj[lo:hi] = i
        gmask[lo:hi] = True
    sizes_padded = np.zeros((max_objects, 3), np.float32)
    sizes_padded[:n_obj] = sizes
    return {
        "point_clouds": cloud,
        "objectness_label": (seg > 0).astype(np.int32),
        "instance_label": seg,
        "object_poses": poses,
        "obj_mask": obj_mask,
        "obj_sizes": sizes_padded,
        "grasp_points": gpts,
        "grasp_pt_obj": gobj,
        "grasp_pt_mask": gmask,
    }


def cloud_pool(seed: int, pool: int, num_points: int, objects: tuple[int, int]) -> tuple[np.ndarray, np.ndarray]:
    """``pool`` scene clouds from ``seed``: (clouds (pool, num_points, 3)
    float32, object counts (pool,))."""
    rng = np.random.default_rng(int(seed) % 2**63)
    counts = object_counts(rng, pool, *objects)
    clouds = np.stack([scene_geometry(rng, num_points, int(n))["point_clouds"] for n in counts])
    return clouds, counts
