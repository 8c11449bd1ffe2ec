"""Closed-loop grasp quality on synthetic analytic scenes (port of
graspbalance_tpu/eval/quality.py).

Chains the whole inference stack, model forward -> pred_decode -> grasp NMS
-> collision filter, on held-out synthetic scenes and scores every
surviving grasp against the analytic rule that made the training labels
(labels/analytic.py). The oracle sends rule-made grasps through the same
NMS and collision filter: the ceiling of those numbers. The model and the
postprocess run on ``device`` (the card by default); the scoring runs in
numpy on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
from graspbalance_tpu_torch.eval.pipeline import GraspInference, make_postprocess, resolve_device
from graspbalance_tpu_torch.labels.analytic import (
    GRASP_MAX_WIDTH,
    WIDTH_MARGIN,
    analytic_average_precision,
    analytic_grasp_quality,
)

METRICS = ("quality_mean", "good_frac", "on_object_frac")


class _Scores:
    """The survivor-weighted metrics and the per-scene AP over batches."""

    def __init__(self):
        self.totals = dict.fromkeys(METRICS, 0.0)
        self.kept = 0.0
        self.scenes = 0
        self.ap_sum = 0.0

    def add(self, grasps, keep, batch, num_depths):
        centers = batch["object_poses"][:, :, :, 3]
        geometry = (centers, batch["obj_sizes"], batch["obj_mask"])
        m = analytic_grasp_quality(grasps, keep, *geometry, num_depths=num_depths)
        for k in METRICS:
            self.totals[k] += m[k] * m["kept"]
        self.kept += m["kept"]
        # graspnetAPI-style AP: per-scene top 50 by decode score, success
        # the analytic quality over a threshold sweep
        self.ap_sum += analytic_average_precision(grasps, keep, *geometry, num_depths=num_depths) * len(grasps)
        self.scenes += len(grasps)

    def result(self) -> dict:
        out = {k: v / max(self.kept, 1.0) for k, v in self.totals.items()}
        out["kept_per_scene"] = self.kept / max(self.scenes, 1)
        out["ap_analytic"] = self.ap_sum / max(self.scenes, 1)
        return out


def _eval_scenes(scene_cfg: SceneConfig) -> SceneConfig:
    return dataclasses.replace(scene_cfg, analytic_labels=True, emit_label_tensors=False)


def evaluate_quality(
    model,
    scene_cfg: SceneConfig,
    num_batches: int = 4,
    batch_size: int = 2,
    seed0: int = 10_000,
    collision_thresh: float = 0.05,
    *,
    device="cuda",
) -> dict:
    """Run the full inference pipeline (``GraspInference`` on ``device``,
    which puts ``model`` there in eval mode) over held-out synthetic scenes
    and score the survivors against the analytic rule.

    ``seed0`` should lie outside the training stream's seeds, so that the
    scenes are held out. Returns quality_mean, good_frac and
    on_object_frac weighted by each batch's survivor count, kept_per_scene
    and ap_analytic."""
    infer = GraspInference(model, collision_thresh=collision_thresh, device=device)
    scene_cfg = _eval_scenes(scene_cfg)
    scores = _Scores()
    for i in range(num_batches):
        batch = make_batch(seed0 + i, batch_size, scene_cfg)
        grasps, keep = infer(batch["point_clouds"])
        scores.add(grasps, keep, batch, scene_cfg.num_depths)
    return scores.result()


def oracle_decode_rows(batch: dict, num_seed: int = 1024) -> tuple[np.ndarray, np.ndarray]:
    """The decode rows a perfect model would emit for these scenes, made
    from the analytic label rule: the upper anchor of the closed-loop
    metrics.

    Per scene, one grasp at each labelled grasp point: approach straight
    down (+z, align 1), in-plane angle 0 (sin^2 = 0), depth 0.01, width the
    object's extent along the closing axis plus the margin, score 1.0 when
    graspable. Depth 0.01 is the first depth bin for any number of depths
    (the scorer's bin is round(depth / 0.01) - 1, clipped), so the rows
    need no depth count. (The JAX twin takes a ``num_depths`` it never
    reads.) Rows are ranked graspable first, then topmost (smallest z,
    nearest the visible top face), and truncated to ``num_seed``, the
    model's per-scene budget. Returns (grasps (B, num_seed, 17) float32,
    valid (B, num_seed) bool) for eval/pipeline.make_postprocess."""
    centers_o = batch["object_poses"][:, :, :, 3]  # (B, O, 3)
    sizes = batch["obj_sizes"]  # (B, O, 3)
    gpts = batch["grasp_points"]  # (B, P, 3), object frame
    gobj = batch["grasp_pt_obj"].astype(np.int64)  # (B, P)
    gmask = batch["grasp_pt_mask"].astype(bool)  # (B, P)
    b = gmask.shape[0]

    # approach +z (down, toward the table), closing +y at angle 0: the frame
    # batch_viewpoint_params_to_matrix builds for the vertical view (columns:
    # rot[:, 0] = approach, rot[:, 1] = closing)
    rot = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)

    grasps = np.zeros((b, num_seed, 17), np.float32)
    valid = np.zeros((b, num_seed), bool)
    for i in range(b):
        world = centers_o[i][gobj[i]] + gpts[i]  # (P, 3)
        req = sizes[i][gobj[i], 1] + WIDTH_MARGIN  # closing = +y
        graspable = gmask[i] & (req <= GRASP_MAX_WIDTH)
        order = np.lexsort((world[:, 2], ~graspable))  # graspable first, then topmost; stable
        order = order[gmask[i][order]][:num_seed]
        s = order.shape[0]
        grasps[i, :s, 0] = np.where(graspable[order], 1.0, 0.0)  # score
        grasps[i, :s, 1] = np.minimum(req[order], GRASP_MAX_WIDTH)
        grasps[i, :s, 2] = 0.02  # height
        grasps[i, :s, 3] = 0.01  # depth: the first bin
        grasps[i, :s, 4:13] = rot.reshape(-1)
        grasps[i, :s, 13:16] = world[order]
        grasps[i, :s, 16] = -1.0
        valid[i, :s] = graspable[order]
    return grasps, valid


def oracle_keep(batch: dict, num_seed: int = 1024, collision_thresh: float = 0.05, *, device="cuda",
                plain: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """The oracle rows of ``batch`` and the postprocess's survivors
    (grasp NMS + the collision filter on ``device``; ``plain`` runs the
    collision counts' plain version): (grasps, keep (B, num_seed) bool)."""
    dev = resolve_device(device)
    grasps, valid = oracle_decode_rows(batch, num_seed=num_seed)
    keep = make_postprocess(collision_thresh)(
        torch.from_numpy(grasps).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(np.ascontiguousarray(batch["point_clouds"][..., :3])).to(dev), plain=plain,
    )
    return grasps, keep.cpu().numpy()


def evaluate_oracle_quality(
    scene_cfg: SceneConfig,
    num_batches: int = 4,
    batch_size: int = 2,
    seed0: int = 10_000,
    collision_thresh: float = 0.05,
    num_seed: int = 1024,
    *,
    device="cuda",
    plain: bool = False,
) -> dict:
    """The ceiling of ``evaluate_quality``'s numbers: oracle grasps
    (``oracle_decode_rows``) through the same NMS + collision stack on the
    same held-out scenes, scored with the same metrics. ``plain`` runs the
    collision counts' plain version. Returns the keys of
    ``evaluate_quality``."""
    scene_cfg = _eval_scenes(scene_cfg)
    scores = _Scores()
    for i in range(num_batches):
        batch = make_batch(seed0 + i, batch_size, scene_cfg)
        grasps, keep = oracle_keep(batch, num_seed, collision_thresh, device=device, plain=plain)
        scores.add(grasps, keep, batch, scene_cfg.num_depths)
    return scores.result()
