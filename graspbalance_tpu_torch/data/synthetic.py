"""Synthetic grasp scenes: random boxes on a table plane with padded label
tensors, drawn from the same numpy stream as
graspbalance_tpu/data/synthetic.py (``analytic_labels=False``,
``static_labels=False``).

``make_batch(seed, b, cfg)`` equals the JAX package's ``make_batch`` key for
key and value for value: point_clouds, objectness_label, instance_label (0 =
table, 1..num_objects = the boxes), object_poses, obj_mask, obj_sizes,
grasp_points, grasp_pt_obj, grasp_pt_mask, and the (P, V, A, D) label
tensors grasp_labels / grasp_widths / grasp_tolerance, each a per-scene roll
along the point axis of base tensors drawn once from seed 0xC0FFEE.
``make_scenes(seed, b, cfg)`` gives only the clouds and instance labels of
the same scenes, without building the label tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


TABLE_FRAC = 0.4  # share of the points on the table plane
TABLE_EXTENT = 0.3  # table half-width in x and y
OBJECT_SCATTER = 0.25  # object centers within +-this in x and y
LABEL_SEED = 0xC0FFEE  # the base label tensors' generator


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    num_points: int = 20000
    num_views: int = 300
    num_angles: int = 12
    num_depths: int = 4
    max_objects: int = 12
    max_grasp_points: int = 4096
    grasp_points_per_object: int = 300
    num_objects: int = 8


@functools.lru_cache(maxsize=2)
def _base_label_tensors(vad: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(labels, widths, tolerance) of shape ``vad``, drawn once per shape;
    callers only read them (each scene rolls a copy)."""
    rng = np.random.default_rng(LABEL_SEED)
    labels = np.zeros(vad, np.float32)
    graspable = rng.random(vad) < 0.5
    labels[graspable] = rng.uniform(0.1, 1.2, int(graspable.sum()))
    widths = rng.uniform(0.0, 0.12, vad).astype(np.float32)
    tolerance = rng.uniform(0.0, 0.05, vad).astype(np.float32)
    return labels, widths, tolerance


def make_scene(rng: np.random.Generator, cfg: SceneConfig) -> tuple[dict, np.ndarray]:
    """One scene in the padded collate layout, without the label tensors,
    and the three roll shifts of its label tensors; consumes ``rng`` exactly
    as the JAX package's make_scene does."""
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

    # poses: identity rotation + the box center (label points are in the
    # object frame: sampled box points minus the center)
    o_max = cfg.max_objects
    poses = np.zeros((o_max, 3, 4), np.float32)
    obj_mask = np.zeros(o_max, bool)
    poses[:n_obj, :, :3] = np.eye(3, dtype=np.float32)
    poses[:n_obj, :, 3] = centers
    obj_mask[:n_obj] = True

    p_max, k = cfg.max_grasp_points, cfg.grasp_points_per_object
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
    sizes_padded = np.zeros((o_max, 3), np.float32)
    sizes_padded[:n_obj] = sizes

    scene = {
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
    return scene, rng.integers(0, p_max, 3)


def make_batch(seed: int, batch_size: int, cfg: SceneConfig | None = None) -> dict:
    """``batch_size`` scenes from ``seed``, stacked (see the module
    docstring for the keys)."""
    cfg = cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, cfg) for _ in range(batch_size)]
    vad = (cfg.max_grasp_points, cfg.num_views, cfg.num_angles, cfg.num_depths)
    base = _base_label_tensors(vad)
    out = {key: np.stack([s[key] for s, _ in scenes]) for key in scenes[0][0]}
    for i, key in enumerate(("grasp_labels", "grasp_widths", "grasp_tolerance")):
        out[key] = np.stack([np.roll(base[i], int(shifts[i]), axis=0) for _, shifts in scenes])
    out["grasp_labels"][~out["grasp_pt_mask"]] = 0.0
    return out


def make_scenes(seed: int, batch_size: int, cfg: SceneConfig | None = None):
    """(clouds (batch_size, num_points, 3) float32, instance_label
    (batch_size, num_points) int32) from ``seed``: the scenes of
    ``make_batch``."""
    cfg = cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, cfg)[0] for _ in range(batch_size)]
    return np.stack([s["point_clouds"] for s in scenes]), np.stack([s["instance_label"] for s in scenes])


def make_point_clouds(seed: int, batch_size: int, cfg: SceneConfig | None = None) -> np.ndarray:
    """(batch_size, num_points, 3) float32 scene clouds from ``seed``."""
    return make_scenes(seed, batch_size, cfg)[0]
