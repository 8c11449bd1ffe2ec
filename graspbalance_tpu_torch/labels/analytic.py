"""Analytic synthetic grasp labels and the closed-loop quality metric (port
of graspbalance_tpu/labels/analytic.py: the label tensors, their expansion
on the device, and the host-side scorers of decoded grasps).

Synthetic scenes get labels that are a deterministic function of the scene
geometry, so training has a learnable target:

  align(view)    = clip(approach_z, 0, 1), approach = -view
  friction u     = clip(1.2 * exp(-2 * align + 0.3 * sin^2(angle)
                        + 0.1 * depth_idx / (D - 1)), 1e-4, 1.2)
  width          = sum_i |closing_axis_i| * obj_size_i + 0.005
  graspable      = (align > ALIGN_MIN) & (width <= GRASP_MAX_WIDTH)
  label          = u where graspable else 0
  tolerance      = GRASP_MAX_TOLERANCE * align

``analytic_label_tensors`` builds one scene's (P, V, A, D) tensors in numpy
(the host generator, data/synthetic.py), in the JAX package's operations.
``expand_batch_labels`` builds a batch's on the device from the small
geometry arrays: the per-(view, angle, depth) grids are the numpy ones,
uploaded, and only the width, a sum of three float32 products in numpy's
order with no matrix product (so no TF32 on the card), is computed per
point. The width decides graspability at GRASP_MAX_WIDTH, so the two sides
agree everywhere except, at most, where a width lies within an ulp of it.

``analytic_grasp_quality``, ``analytic_average_precision`` and
``_per_grasp_quality`` score decoded grasp rows (the pipeline's numpy
outputs) against the same rule, in numpy on the host, in the JAX package's
operations and order: their thresholds (``ok``, quality > 0.3, the AP bars)
see the same float32 values as the reference's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.labels.geometry import GRASP_MAX_TOLERANCE, GRASP_MAX_WIDTH, _grasp_views_np

WIDTH_MARGIN = 0.005  # gripper opening margin over the object extent
ON_OBJECT_DIST = 0.02  # max distance from a grasp center to its object box
# friction falls as exp(-gain * align): after the log(u_max / u) rescale of
# label matching the per-view score is gain * align (see the JAX package)
ALIGN_GAIN = 2.0
ANGLE_PENALTY = 0.3  # friction exponent penalty at sin^2(angle) = 1
DEPTH_PENALTY = 0.1  # friction exponent penalty at the deepest bin
U_MAX = 1.2  # friction at align = 0 (the raw GraspNet friction ceiling)
ALIGN_MIN = 0.03  # minimum alignment to be graspable


def _friction(align, sin2, depth_frac):
    """The analytic friction rule (lower = better); numpy inputs broadcast."""
    return np.clip(
        U_MAX * np.exp(-ALIGN_GAIN * align + ANGLE_PENALTY * sin2 + DEPTH_PENALTY * depth_frac),
        1e-4,
        U_MAX,
    )


def _frame_axes(towards):
    """Grasp-frame axes (ax, ay, az) of approach directions (..., 3), the
    batch_viewpoint_params_to_matrix construction (fallback +y when
    vertical)."""
    ax = towards
    ay = np.stack([-ax[..., 1], ax[..., 0], np.zeros_like(ax[..., 0])], axis=-1)
    norm_ay = np.sqrt(np.sum(ay * ay, axis=-1, keepdims=True))
    fallback = np.broadcast_to(np.asarray([0.0, 1.0, 0.0], dtype=ax.dtype), ay.shape)
    ay = np.where(norm_ay == 0, fallback, ay / np.maximum(norm_ay, 1e-12))
    ax = ax / np.sqrt(np.sum(ax * ax, axis=-1, keepdims=True))
    return ax, ay, np.cross(ax, ay)


@functools.lru_cache(maxsize=4)
def _view_grids(num_views: int, num_angles: int, num_depths: int):
    """Per-(view, angle, depth) geometry, float32 numpy: (align (V,),
    closing axes (V, A, 3), friction u (V, A, D)). Callers only read them."""
    towards = -_grasp_views_np(num_views)
    align = np.clip(towards[:, 2], 0.0, 1.0)
    _, ay, az = _frame_axes(towards)
    angles = np.arange(num_angles, dtype=np.float32) / num_angles * np.pi
    closing = np.cos(angles)[None, :, None] * ay[:, None, :] + np.sin(angles)[None, :, None] * az[:, None, :]
    depth_frac = np.arange(num_depths, dtype=np.float32) / max(num_depths - 1, 1)
    u = _friction(align[:, None, None], np.sin(angles)[None, :, None] ** 2, depth_frac[None, None, :])
    return align, closing, u


def analytic_label_tensors(obj_sizes, grasp_pt_obj, grasp_pt_mask, num_views: int, num_angles: int,
                           num_depths: int):
    """One scene's padded (P, V, A, D) float32 (labels, widths, tolerance),
    numpy. obj_sizes (O, 3) box extents per object slot; grasp_pt_obj (P,)
    owning slot; grasp_pt_mask (P,) valid slots."""
    align, closing, u = _view_grids(num_views, num_angles, num_depths)
    sizes_p = np.take(obj_sizes, grasp_pt_obj.astype(np.int32), axis=0)
    req = np.einsum("vai,pi->pva", np.abs(closing), sizes_p) + WIDTH_MARGIN  # (P, V, A)
    widths = np.broadcast_to(req[..., None].astype(np.float32), req.shape + (num_depths,))
    graspable = (align[None, :, None] > ALIGN_MIN) & (req <= GRASP_MAX_WIDTH) & grasp_pt_mask[:, None, None]
    labels = np.where(graspable[..., None], u[None].astype(np.float32), 0.0).astype(np.float32)
    tolerance = np.broadcast_to(
        (GRASP_MAX_TOLERANCE * align).astype(np.float32)[None, :, None, None], labels.shape
    )
    return labels, widths, tolerance


def expand_batch_labels(batch: dict, num_views: int, num_angles: int, num_depths: int) -> dict:
    """``batch`` plus grasp_labels / grasp_widths / grasp_tolerance
    (B, P, V, A, D) float32, computed on the device of its obj_sizes
    (B, O, 3) from grasp_pt_obj (B, P) and grasp_pt_mask (B, P). The widths
    and the tolerance are broadcast views over the depth axis (and the
    tolerance over the points), as in the numpy version. The view grids'
    uploads wait for the card (``trace.host_read`` site "label_grids")."""
    sizes = batch["obj_sizes"]
    dev = sizes.device
    grids = [torch.from_numpy(np.ascontiguousarray(a)) for a in _view_grids(num_views, num_angles, num_depths)]
    align, closing, u = (trace.host_read("label_grids", functools.partial(g.to, dev)) for g in grids)
    c = closing.abs()  # (V, A, 3)
    pt_obj = batch["grasp_pt_obj"].long()
    s = sizes.gather(1, pt_obj[..., None].expand(-1, -1, 3))[:, :, None, None, :]  # (B, P, 1, 1, 3)
    # the closing-axis extent as numpy's einsum sums it: in order, each
    # product and each sum rounded to float32, no fused multiply-add
    req = c[..., 0] * s[..., 0]
    req = req + c[..., 1] * s[..., 1]
    req = req + c[..., 2] * s[..., 2]
    req = req + WIDTH_MARGIN  # (B, P, V, A)
    graspable = (align[:, None] > ALIGN_MIN) & (req <= GRASP_MAX_WIDTH) & batch["grasp_pt_mask"][:, :, None, None]
    labels = torch.where(graspable[..., None], u, 0.0)
    tol = (GRASP_MAX_TOLERANCE * align)[:, None, None]  # (V, 1, 1)
    out = dict(batch)
    out["grasp_labels"] = labels
    out["grasp_widths"] = req[..., None].expand(labels.shape)
    out["grasp_tolerance"] = tol.expand(labels.shape)
    return out


def analytic_grasp_quality(grasps, keep, obj_centers, obj_sizes, obj_mask, num_depths: int = 4) -> dict:
    """Score decoded grasps against the analytic rule, numpy on the host.

    grasps (..., G, 17) decode rows (models/decode.py column layout), keep
    (..., G) bool survivors (NMS + collision), obj_centers / obj_sizes
    (..., O, 3), obj_mask (..., O) valid slots. Returns floats:
    quality_mean (mean analytic quality of the survivors, 0..1), good_frac
    (share of survivors with quality > 0.3), on_object_frac, kept."""
    rot = grasps[..., 4:13].reshape(grasps.shape[:-1] + (3, 3))
    approach = rot[..., :, 0]
    closing = rot[..., :, 1]
    center = grasps[..., 13:16]
    width = grasps[..., 1]
    depth = grasps[..., 3]

    # distance from the grasp center to each object's box surface
    disp = np.abs(center[..., :, None, :] - obj_centers[..., None, :, :])
    excess = np.maximum(disp - obj_sizes[..., None, :, :] / 2.0, 0.0)
    dist = np.sqrt(np.sum(excess * excess, axis=-1))  # (..., G, O)
    dist = np.where(obj_mask[..., None, :], dist, np.asarray(1e9, dtype=dist.dtype))
    iobj = np.argmin(dist, axis=-1)
    on_object = np.min(dist, axis=-1) <= ON_OBJECT_DIST
    nearest_size = np.take_along_axis(obj_sizes, iobj[..., None], axis=-2)  # (..., G, 3)

    align = np.clip(approach[..., 2], 0.0, 1.0)
    # sin^2(angle) from geometry: closing = cos * ay0 + sin * az0, both unit
    # and orthogonal, az0 the angle-0 vertical axis of the approach frame
    _, _, az0 = _frame_axes(approach)
    sin2 = np.sum(closing * az0, axis=-1) ** 2
    d_idx = np.clip(np.round(depth / 0.01) - 1.0, 0, num_depths - 1)
    u = _friction(align, sin2, d_idx / max(num_depths - 1, 1))
    req = np.sum(np.abs(closing) * nearest_size, axis=-1) + WIDTH_MARGIN
    ok = on_object & (align > ALIGN_MIN) & (req <= GRASP_MAX_WIDTH) & (width >= 0.9 * req)
    # the log-rescaled score over the alignment gain: ~align for an
    # on-object, wide-enough, axis-aligned grasp; 1.0 perfect
    quality = np.where(ok, np.clip(np.log(U_MAX / u) / ALIGN_GAIN, 0.0, 1.0), 0.0)

    keep_f = keep.astype(np.float32)
    kept = np.sum(keep_f)
    denom = np.maximum(kept, 1.0)
    return {
        "quality_mean": float(np.sum(quality * keep_f) / denom),
        "good_frac": float(np.sum((quality > 0.3).astype(np.float32) * keep_f) / denom),
        "on_object_frac": float(np.sum(on_object.astype(np.float32) * keep_f) / denom),
        "kept": float(kept),
    }


AP_TOP_K = 50  # graspnetAPI ranks the top 50 grasps per scene
AP_QUALITY_THRESHOLDS = (0.2, 0.4, 0.6, 0.8)  # analytic analogs of its friction sweep


def analytic_average_precision(grasps, keep, obj_centers, obj_sizes, obj_mask, num_depths: int = 4) -> float:
    """graspnetAPI-style AP under the analytic rule (numpy, per batch): per
    scene the survivors ranked by decode score (column 0, stable), the top
    AP_TOP_K kept, each a success when its analytic quality reaches the
    bar; AP = mean over k = 1..AP_TOP_K of precision@k (absent grasps
    fail), averaged over AP_QUALITY_THRESHOLDS, then over the scenes.
    grasps (B, G, 17), keep (B, G); the geometry as for
    ``analytic_grasp_quality``. Returns the AP in [0, 1]."""
    b = grasps.shape[0]
    ap_sum = 0.0
    for i in range(b):
        rows = grasps[i][keep[i]]
        q = np.zeros((0,), np.float32)
        if rows.shape[0]:
            q = _per_grasp_quality(rows, obj_centers[i], obj_sizes[i], obj_mask[i], num_depths)
            order = np.argsort(-rows[:, 0], kind="stable")
            q = q[order][:AP_TOP_K]
        scene_ap = 0.0
        for t in AP_QUALITY_THRESHOLDS:
            padded = np.zeros(AP_TOP_K)
            padded[: q.shape[0]] = (q >= t).astype(np.float64)
            scene_ap += float((np.cumsum(padded) / (np.arange(AP_TOP_K) + 1)).mean())
        ap_sum += scene_ap / len(AP_QUALITY_THRESHOLDS)
    return ap_sum / max(b, 1)


def _per_grasp_quality(rows, centers, sizes, mask, num_depths):
    """(G, 17) decode rows -> (G,) float32 analytic qualities (numpy)."""
    rot = rows[:, 4:13].reshape(-1, 3, 3)
    approach = rot[:, :, 0]
    closing = rot[:, :, 1]
    center = rows[:, 13:16]
    width = rows[:, 1]
    depth = rows[:, 3]
    disp = np.abs(center[:, None, :] - centers[None, :, :])
    excess = np.maximum(disp - sizes[None, :, :] / 2.0, 0.0)
    dist = np.sqrt((excess**2).sum(-1))
    dist = np.where(mask[None, :], dist, 1e9)
    iobj = dist.argmin(-1)
    on_object = dist.min(-1) <= ON_OBJECT_DIST
    nearest_size = sizes[iobj]
    align = np.clip(approach[:, 2], 0.0, 1.0)
    _, _, az0 = _frame_axes(approach)
    sin2 = (closing * az0).sum(-1) ** 2
    d_idx = np.clip(np.round(depth / 0.01) - 1.0, 0, num_depths - 1)
    u = _friction(align, sin2, d_idx / max(num_depths - 1, 1))
    req = (np.abs(closing) * nearest_size).sum(-1) + WIDTH_MARGIN
    ok = on_object & (align > ALIGN_MIN) & (req <= GRASP_MAX_WIDTH) & (width >= 0.9 * req)
    return np.where(ok, np.clip(np.log(U_MAX / u) / ALIGN_GAIN, 0.0, 1.0), 0.0).astype(np.float32)
