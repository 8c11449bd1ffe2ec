"""Synthetic scene clouds: the point clouds and instance labels of
graspbalance_tpu/data/synthetic.py:make_batch (random boxes on a table
plane), drawn from the same numpy stream, without the grasp label tensors.

``make_scenes(seed, b, cfg)`` equals ``make_batch(seed, b, cfg)``'s
``point_clouds`` and ``instance_label`` (0 = table, 1..num_objects = the
boxes) of the JAX package for the same geometry settings (and
``analytic_labels=False``), so the port can be fed the scenes the JAX package
is measured on without importing it.
"""

from __future__ import annotations

import dataclasses

import numpy as np


TABLE_FRAC = 0.4  # share of the points on the table plane
TABLE_EXTENT = 0.3  # table half-width in x and y
OBJECT_SCATTER = 0.25  # object centers within +-this in x and y


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_points: int = 20000
    num_objects: int = 8
    # label-point draws share the numpy stream with the next scene's geometry
    max_grasp_points: int = 4096
    grasp_points_per_object: int = 300


def make_scene(rng: np.random.Generator, cfg: SceneConfig) -> tuple[np.ndarray, np.ndarray]:
    """One scene: (num_points, 3) float32 cloud and (num_points,) int32
    instance labels; consumes ``rng`` exactly as the JAX package's
    make_scene does."""
    n_obj = cfg.num_objects
    n_table = int(cfg.num_points * TABLE_FRAC)
    n_obj_pts = cfg.num_points - n_table

    te = TABLE_EXTENT
    table = np.empty((n_table, 3), np.float32)
    table[:, 0] = rng.uniform(-te, te, n_table)
    table[:, 1] = rng.uniform(-te, te, n_table)
    table[:, 2] = 0.5 + rng.normal(0, 0.002, n_table)

    sizes = rng.uniform(0.02, 0.08, (n_obj, 3)).astype(np.float32)
    cz = rng.uniform(0.42, 0.48, n_obj)
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
    perm = rng.permutation(cfg.num_points)
    cloud = np.concatenate(parts, axis=0)[perm]
    seg = np.concatenate(ids)[perm]

    # the label points and label-tensor shifts the JAX package draws next
    k, p_max = cfg.grasp_points_per_object, cfg.max_grasp_points
    for i in range(n_obj):
        lo, hi = i * k, min((i + 1) * k, p_max)
        if lo >= p_max:
            break
        rng.random((hi - lo, 3), dtype=np.float32)
    rng.integers(0, p_max, 3)
    return cloud, seg


def make_scenes(seed: int, batch_size: int, cfg: SceneConfig | None = None):
    """(clouds (batch_size, num_points, 3) float32, instance_label
    (batch_size, num_points) int32) from ``seed``."""
    cfg = cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, cfg) for _ in range(batch_size)]
    return np.stack([c for c, _ in scenes]), np.stack([s for _, s in scenes])


def make_point_clouds(seed: int, batch_size: int, cfg: SceneConfig | None = None) -> np.ndarray:
    """(batch_size, num_points, 3) float32 scene clouds from ``seed``."""
    return make_scenes(seed, batch_size, cfg)[0]
