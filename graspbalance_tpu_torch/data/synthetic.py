"""Synthetic grasp scenes: random boxes on a table plane with padded label
tensors, drawn from the same numpy stream as
graspbalance_tpu/data/synthetic.py, in every mode of its ``SceneConfig``.

``make_batch(seed, b, cfg)`` equals the JAX package's ``make_batch`` key for
key and value for value: point_clouds, objectness_label, instance_label (0 =
table, 1..num_objects = the boxes), object_poses, obj_mask, obj_sizes,
grasp_points, grasp_pt_obj, grasp_pt_mask, and the (P, V, A, D) label
tensors grasp_labels / grasp_widths / grasp_tolerance:

  - by default each a per-scene roll along the point axis of base tensors
    drawn once from seed 0xC0FFEE, the labels of invalid points zeroed;
  - ``static_labels``: the base tensors themselves, as one read-only
    broadcast view per (key, batch size, shape), the same array object on
    every call (the training loop's transfer cache uploads it once);
  - ``analytic_labels``: the analytic rule of labels/analytic.py, boxes
    resting on the table; with ``emit_label_tensors=False`` the batch
    carries no label tensors and the training step expands them on the
    device.

``make_scenes(seed, b, cfg)`` gives only the clouds and instance labels of
the same scenes, without building the label tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from graspbalance_tpu_torch.labels.analytic import analytic_label_tensors

LABEL_SEED = 0xC0FFEE  # the base label tensors' generator
LABEL_KEYS = ("grasp_labels", "grasp_widths", "grasp_tolerance")


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
    table_frac: float = 0.4  # share of the points on the table plane
    table_extent: float = 0.3  # table half-width in x and y
    object_scatter: float = 0.25  # object centers within +-this in x and y
    # one base label tensor shared by every scene and batch (see the module
    # docstring); the scene geometry still varies
    static_labels: bool = False
    # labels a function of the scene geometry (labels/analytic.py)
    analytic_labels: bool = False
    # with analytic_labels: build the label tensors on the host (True) or
    # leave them to the training step (False)
    emit_label_tensors: bool = True


@functools.lru_cache(maxsize=2)
def _base_label_tensors(vad: tuple) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(labels, widths, tolerance) of shape ``vad``, drawn once per shape;
    callers only read them."""
    rng = np.random.default_rng(LABEL_SEED)
    labels = np.zeros(vad, np.float32)
    graspable = rng.random(vad) < 0.5
    labels[graspable] = rng.uniform(0.1, 1.2, int(graspable.sum()))
    widths = rng.uniform(0.0, 0.12, vad).astype(np.float32)
    tolerance = rng.uniform(0.0, 0.05, vad).astype(np.float32)
    for a in (labels, widths, tolerance):
        a.flags.writeable = False
    return labels, widths, tolerance


_BCAST_CACHE: dict = {}  # (key, batch size, *shape) -> the static labels' broadcast view


def _scene_geometry(rng: np.random.Generator, cfg: SceneConfig) -> dict:
    """One scene in the padded collate layout, without the label tensors;
    consumes ``rng`` as the JAX package's make_scene does up to them."""
    n_obj = cfg.num_objects
    n_table = int(cfg.num_points * cfg.table_frac)
    n_obj_pts = cfg.num_points - n_table

    te = cfg.table_extent
    table = np.empty((n_table, 3), np.float32)
    table[:, 0] = rng.uniform(-te, te, n_table)
    table[:, 1] = rng.uniform(-te, te, n_table)
    table[:, 2] = 0.5 + rng.normal(0, 0.002, n_table)

    sizes = rng.uniform(0.02, 0.08, (n_obj, 3)).astype(np.float32)
    cz = rng.uniform(0.42, 0.48, n_obj)
    if cfg.analytic_labels:  # each box rests on the table, a few mm clear
        cz = 0.5 - sizes[:, 2] / 2.0 - rng.uniform(0.002, 0.01, n_obj)
    oe = cfg.object_scatter
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


def make_scene(rng: np.random.Generator, cfg: SceneConfig) -> dict:
    """One scene in the padded collate layout (unbatched), its label tensors
    as ``cfg`` asks; consumes ``rng`` exactly as the JAX package's
    make_scene does."""
    scene = _scene_geometry(rng, cfg)
    if cfg.analytic_labels:
        if cfg.emit_label_tensors:
            scene.update(zip(LABEL_KEYS, analytic_label_tensors(
                scene["obj_sizes"], scene["grasp_pt_obj"], scene["grasp_pt_mask"],
                cfg.num_views, cfg.num_angles, cfg.num_depths,
            )))
        return scene
    vad = (cfg.max_grasp_points, cfg.num_views, cfg.num_angles, cfg.num_depths)
    base = _base_label_tensors(vad)
    shifts = rng.integers(0, cfg.max_grasp_points, 3)  # drawn in both modes
    if cfg.static_labels:
        # invalid point slots keep their labels: label matching never picks them
        scene.update(zip(LABEL_KEYS, base))
    else:
        scene.update((key, np.roll(b, int(s), axis=0)) for key, b, s in zip(LABEL_KEYS, base, shifts))
        scene["grasp_labels"][~scene["grasp_pt_mask"]] = 0.0
    return scene


def make_batch(seed: int, batch_size: int, cfg: SceneConfig | None = None) -> dict:
    """``batch_size`` scenes from ``seed``, stacked (see the module
    docstring for the keys and the modes)."""
    cfg = cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    scenes = [make_scene(rng, cfg) for _ in range(batch_size)]
    out = {}
    for key, first in scenes[0].items():
        if cfg.static_labels and not cfg.analytic_labels and key in LABEL_KEYS:
            ck = (key, batch_size) + first.shape
            if ck not in _BCAST_CACHE:
                _BCAST_CACHE[ck] = np.broadcast_to(first[None], (batch_size,) + first.shape)
            out[key] = _BCAST_CACHE[ck]
        else:
            out[key] = np.stack([s[key] for s in scenes])
    return out


def make_scenes(seed: int, batch_size: int, cfg: SceneConfig | None = None):
    """(clouds (batch_size, num_points, 3) float32, instance_label
    (batch_size, num_points) int32) from ``seed``: the scenes of
    ``make_batch``."""
    cfg = cfg or SceneConfig()
    rng = np.random.default_rng(seed)
    scenes = []
    for _ in range(batch_size):
        scenes.append(_scene_geometry(rng, cfg))
        if not cfg.analytic_labels:
            rng.integers(0, cfg.max_grasp_points, 3)  # the label rolls' shifts
    return np.stack([s["point_clouds"] for s in scenes]), np.stack([s["instance_label"] for s in scenes])


def make_point_clouds(seed: int, batch_size: int, cfg: SceneConfig | None = None) -> np.ndarray:
    """(batch_size, num_points, 3) float32 scene clouds from ``seed``."""
    return make_scenes(seed, batch_size, cfg)[0]
